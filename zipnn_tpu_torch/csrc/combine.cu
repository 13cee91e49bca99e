// Plane assembly of decoded chunks: fill each (chunk, plane) cell as
// stored, RLE or Huffman, interleave the planes and revert the bf16 sign
// rotation, writing the output words in place.
//
// Replaces the Pallas kernel zipnn_tpu/ops/pallas_combine.py
// `_build_kernel` (K2, launched by `_combine_call_cached`).  The Pallas
// kernel DMA'd tile-aligned rows and realigned stored cells in registers
// because a TPU reads HBM in (8, 128) tiles; here a thread reads the bytes
// it needs at any offset, so stored cells come straight from the payload
// with no alignment pass.
//
// Design.  One thread produces one output uint32 word of one chunk: it
// gathers its four bytes from the cells of that chunk (kind 0 stored:
// payload at a byte offset; kind 1 RLE: the byte; kind 2 Huffman: the
// symbols K1 wrote for that cell ordinal), applies byte_group.combine's
// layout (mode 10 interleave, modes 1/8 zero-fill) and the inverse sign
// rotation.  In the ragged tail chunk only the first chunk_len / 4 words
// are reverted, the trailing 1-3 bytes pass through unrotated, and bytes
// past the chunk's end are written as zero (they are the output's padding).
//
// What bounds it: bytes.  Each output byte reads one plane byte, so the
// least traffic is the output written once plus the plane bytes read once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t revert_sign_16(uint32_t w) {
  const uint32_t sign = (w << 8) & 0x80008000u;
  const uint32_t exp = (w >> 1) & 0x7F807F80u;
  const uint32_t man = w & 0x007F007Fu;
  return sign | exp | man;
}

__global__ void combine_cells_kernel(
    const uint8_t* __restrict__ payload,
    const uint8_t* __restrict__ hsym,
    const int32_t* __restrict__ kinds,
    const int64_t* __restrict__ srcs,
    int64_t hsym_row,
    int64_t chunk_size,
    int64_t total_bytes,
    int num_buf,
    int byte_reorder,
    int bit_reorder,
    uint32_t* __restrict__ out) {
  const int64_t chunk_words = chunk_size >> 2;
  const int64_t n_words = (total_bytes + 3) >> 2;
  const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n_words) return;
  const int64_t c = g / chunk_words;
  const int64_t j = g - c * chunk_words;
  const int64_t rem = total_bytes - c * chunk_size;
  const int64_t chunk_len = rem < chunk_size ? rem : chunk_size;

  // plane lengths of this chunk (byte_group.plane_lengths)
  int64_t plen0, plen1;
  if (num_buf == 2 && byte_reorder != 10) {
    plen0 = chunk_len >> 1;
    plen1 = 0;
  } else if (num_buf == 2) {
    plen0 = (chunk_len + 1) >> 1;
    plen1 = chunk_len >> 1;
  } else {
    plen0 = chunk_len;
    plen1 = 0;
  }

  uint32_t w = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int64_t p = 4 * j + q;  // byte within the chunk
    if (p >= chunk_len) break;
    int b;
    int64_t i;
    if (num_buf == 1) {
      b = 0;
      i = p;
    } else if (byte_reorder == 10) {
      b = (int)(p & 1);
      i = p >> 1;
    } else {
      // mode 1 keeps the even (low) bytes in plane 0, mode 8 the odd ones
      if ((int)(p & 1) != (byte_reorder == 8 ? 1 : 0)) continue;
      b = 0;
      i = p >> 1;
    }
    if (i >= (b ? plen1 : plen0)) continue;
    const int64_t cell = c * num_buf + b;
    const int kind = kinds[cell];
    const int64_t src = srcs[cell];
    uint32_t v;
    if (kind == 0) {
      v = payload[src + i];
    } else if (kind == 1) {
      v = (uint32_t)src & 0xFFu;
    } else {
      v = hsym[src * hsym_row + i];
    }
    w |= v << (8 * q);
  }
  if (bit_reorder && num_buf == 2 && j < (chunk_len >> 2)) w = revert_sign_16(w);
  out[g] = w;
}

}  // namespace

extern "C" int combine_cells(
    const void* payload, const void* hsym, const void* kinds,
    const void* srcs, long long hsym_row, long long chunk_size,
    long long total_bytes, int num_buf, int byte_reorder, int bit_reorder,
    void* out, void* stream) {
  const long long n_words = (total_bytes + 3) >> 2;
  if (n_words <= 0) return 0;
  const int threads = 256;
  const long long blocks = (n_words + threads - 1) / threads;
  combine_cells_kernel<<<(unsigned int)blocks, threads, 0,
                         (cudaStream_t)stream>>>(
      (const uint8_t*)payload, (const uint8_t*)hsym, (const int32_t*)kinds,
      (const int64_t*)srcs, (int64_t)hsym_row, (int64_t)chunk_size,
      (int64_t)total_bytes, num_buf, byte_reorder, bit_reorder,
      (uint32_t*)out);
  return (int)cudaGetLastError();
}
