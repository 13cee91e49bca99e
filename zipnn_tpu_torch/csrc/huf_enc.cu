// Shared-table Huffman encode of HUF streams (codes of at most 8 bits).
//
// Replaces the Pallas kernel zipnn_tpu/ops/pallas_huf_enc.py
// `_build_kernel` (K7, launched by `_encode_call_cached`).
//
// What it computes, per stream (bit-exact with ops/entropy/huf.py
// `encode_stream`): the stream's symbols in descending index order, each
// code appended LSB-first, then one closing sentinel bit, zero-padded to a
// whole byte.  `total_bits` is the code bits plus the sentinel; bit 30 is
// set when a symbol has no code (table entry nb == 0, possible only under a
// sampled table), and such a stream's bytes are not a valid encoding.
//
// Design.  The 256-entry table (`val | nb << 8`) is copied into shared
// memory once per block.  One thread encodes one stream: it reads its
// segment from the end, 16 bytes per load where the segment is 16-byte
// aligned (else 4), and appends four codes per 32-bit input word into a
// 64-bit accumulator (a word's codes add at most 32 bits to the < 32 held),
// flushing one 32-bit word to its own output row per input word.  The TPU
// kernel's w8/W3 window hierarchy and masked spill trees exist because a
// TPU lane cannot write at its own pace; a thread can.  Codes are at most
// 8 bits, so a row of seg/4 + 1 words holds any stream (8 bits per symbol
// plus the sentinel): no overflow path, no host re-encode.  Row and stream
// offsets are 64-bit.
//
// What bounds it.  Its bytes (the symbols read once, the stream bytes
// written once) would take ~0.1 ms for a 512 MB batch's exponent plane;
// the kernel is bound instead by each thread's serial append chain
// (table load -> shift by the running bit count -> or) over ~32 K symbols,
// with only ~8 K threads (~2 warps per SM) to hide it.  The table loads of
// one word are independent of each other, so only the bit-count adds and
// the or/shift sit on the chain.  A warp-cooperative encoder (code lengths,
// a warp prefix sum of bit offsets, coalesced stores) is the next step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Writer {
  uint64_t acc;    // pending bits, LSB first
  int nbits;       // bits held in acc (< 32 between words)
  int64_t words;   // words flushed so far
  uint32_t bad;    // a symbol without a code was seen
};

// Append the codes of one input word's four symbols, highest byte first
// (symbols run in descending index order), then flush one word if full.
__device__ __forceinline__ void put_word(Writer& w, uint32_t x,
                                         const uint16_t* tbl,
                                         uint32_t* __restrict__ dst) {
#pragma unroll
  for (int k = 3; k >= 0; --k) {
    const uint32_t e = tbl[(x >> (8 * k)) & 0xFFu];
    const uint32_t nb = e >> 8;
    w.bad |= (nb == 0u);
    w.acc |= (uint64_t)(e & 0xFFu) << w.nbits;
    w.nbits += (int)nb;
  }
  if (w.nbits >= 32) {
    dst[w.words++] = (uint32_t)w.acc;
    w.acc >>= 32;
    w.nbits -= 32;
  }
}

__global__ void huf_shared_encode_kernel(
    const uint32_t* __restrict__ planes,
    const int64_t* __restrict__ streams,
    const uint16_t* __restrict__ table,
    int n_streams, int seg_words, int row_words,
    uint32_t* __restrict__ rows,
    int32_t* __restrict__ total_bits) {
  __shared__ uint16_t tbl[256];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) tbl[i] = table[i];
  __syncthreads();
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n_streams) return;
  const uint32_t* src = planes + streams[s];
  uint32_t* dst = rows + (int64_t)s * row_words;
  Writer w{0ull, 0, 0, 0u};
  const bool vec = ((seg_words & 3) == 0) && (((uintptr_t)src & 15) == 0);
  if (vec) {
    const uint4* v = reinterpret_cast<const uint4*>(src);
    for (int q = (seg_words >> 2) - 1; q >= 0; --q) {
      const uint4 x = __ldg(v + q);
      put_word(w, x.w, tbl, dst);
      put_word(w, x.z, tbl, dst);
      put_word(w, x.y, tbl, dst);
      put_word(w, x.x, tbl, dst);
    }
  } else {
    for (int i = seg_words - 1; i >= 0; --i) put_word(w, __ldg(src + i), tbl, dst);
  }
  const int64_t code_bits = 32 * w.words + w.nbits;
  // closing sentinel, then the last partial words (zero-padded)
  w.acc |= 1ull << w.nbits;
  w.nbits += 1;
  while (w.nbits > 0) {
    dst[w.words++] = (uint32_t)w.acc;
    w.acc >>= 32;
    w.nbits -= 32;
  }
  total_bits[s] = (int32_t)(code_bits + 1) | (int32_t)(w.bad << 30);
}

}  // namespace

extern "C" int huf_shared_encode(const void* planes, const void* streams,
                                 const void* table, int n_streams,
                                 int seg_words, int row_words, void* rows,
                                 void* total_bits, void* stream) {
  if (n_streams <= 0) return 0;
  // 8 bits per symbol plus the sentinel must fit the row and stay below
  // bit 30 of total_bits
  if (seg_words < 0 || row_words < seg_words + 1 || seg_words >= (1 << 25))
    return (int)cudaErrorInvalidValue;
  const int threads = 64;
  const int blocks = (n_streams + threads - 1) / threads;
  huf_shared_encode_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)planes, (const int64_t*)streams,
      (const uint16_t*)table, n_streams, seg_words, row_words,
      (uint32_t*)rows, (int32_t*)total_bits);
  return (int)cudaGetLastError();
}
