"""Ecosystem integration plugins of the PyTorch/CUDA port (reference L4,
zipnn/zipnn.py:1221-1643), decoding on the card:

* :mod:`.safetensors` -- transparent per-tensor decompression inside
  ``safetensors.safe_open`` (``znn_compressed_vectors`` metadata schema);
* :mod:`.hf` -- transformers monkey-patch so ``from_pretrained`` finds and
  decodes ``.znn`` checkpoints;
* :mod:`.patch` -- propagate monkey-patches into spawned worker processes
  (how vLLM/accelerate workers see the patched loader).
"""
