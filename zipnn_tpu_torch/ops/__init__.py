"""Host golden model (byte_group, entropy) and the CUDA decode pipeline."""
