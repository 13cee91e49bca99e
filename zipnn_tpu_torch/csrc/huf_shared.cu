// Shared-table Huffman decode of backward HUF bitstreams (tableLog <= 8).
//
// Replaces the Pallas kernel zipnn_tpu/ops/pallas_huf.py `_build_kernel`
// (K6, launched by `_decode_call_cached`), and does the row-gather job of
// zipnn_tpu/ops/pallas_gather.py `_gather_call_cached` (K3) on this path.
//
// Design.  Every Huffman cell of a shared-table container carries the same
// weight header, so one 256-entry table (sym | nb << 8, indexed by the 8
// stream bits below the cursor) serves every stream.  The block copies it
// into shared memory once; every peek is then a shared-memory load, with
// no per-cell table index.  One thread decodes one stream: it keeps a
// 64-bit register window of its stream, loaded from the payload at a byte
// offset, and writes four symbols per 32-bit store.  A symbol consumes at
// most 8 bits, so four consume at most 32: the window is checked once per
// four symbols (it is refilled when fewer than 32 bits below the cursor
// remain in it), where the per-cell kernel checks per symbol.  The TPU
// kernel's window slides, right-aligned 512 B rows and p0/pend geometry
// exist because a TPU lane cannot fetch from its own stream; a thread can.
//
// What bounds it.  Each stream is a serial chain (peek -> table ->
// bits consumed -> next peek), so the kernel is bound by that chain's
// latency, not by bytes: ~4 streams per 64 KB of plane output give only a
// few thousand threads for a 512 MB container.  The design shortens the
// chain (a shared-memory table load, one window check per four symbols)
// but does not add parallelism.
//
// Semantics (held against zipnn_tpu/ops/jax_entropy.py decode_streams):
// bits_left starts at the sentinel position; each step peeks the 8 bits
// below bits_left, shifting in zeros below the stream's first bit (the
// bytes before a stream in the payload are real data, so they are masked,
// never read), looks up the entry and retreats by its nb.  No byte outside
// [start, start + len) is read, whatever the input.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Window {
  uint64_t bits;  // stream bits [base, base + 64)
  int base;       // a multiple of 8
};

// Load the 8 stream bytes whose top byte holds the bit below `bl`, or the
// stream's first 8 bytes when `bl` is within them.
__device__ __forceinline__ void refill(Window& w, const uint8_t* src, int len,
                                       int bl) {
  int byte0 = ((bl + 7) >> 3) - 8;
  byte0 = byte0 > 0 ? byte0 : 0;
  uint64_t v = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int p = byte0 + j;
    if (p < len) v |= (uint64_t)__ldg(src + p) << (8 * j);
  }
  w.bits = v;
  w.base = 8 * byte0;
}

// One symbol: peek the 8 bits below `bl` (zeros below bit 0), look it up.
__device__ __forceinline__ uint32_t decode1(const Window& w,
                                            const uint16_t* tbl, int& bl) {
  const int lo = bl - 8 - w.base;
  uint32_t x;
  if (lo >= 0) {
    x = (uint32_t)(w.bits >> lo) & 0xFFu;
  } else {
    // only at base 0: the low bl bits, shifted up (0 when bl <= 0)
    const int sh = -lo < 63 ? -lo : 63;
    x = (uint32_t)(w.bits << sh) & 0xFFu;
  }
  const uint32_t e = tbl[x];
  bl -= (int)(e >> 8);
  return e & 0xFFu;
}

__global__ void huf_shared_decode_kernel(
    const uint8_t* __restrict__ payload,
    const int64_t* __restrict__ starts,
    const int32_t* __restrict__ lens,
    const int32_t* __restrict__ bits0,
    const int64_t* __restrict__ out_offs,
    const int32_t* __restrict__ out_lens,
    const uint16_t* __restrict__ table,
    int n_streams,
    uint8_t* __restrict__ out,
    int32_t* __restrict__ bits_left_out) {
  __shared__ uint16_t tbl[256];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) tbl[i] = table[i];
  __syncthreads();
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n_streams) return;
  const uint8_t* src = payload + starts[s];
  const int len = lens[s];
  const int n = out_lens[s];
  const int64_t off = out_offs[s];
  uint8_t* dst = out + off;

  int bl = bits0[s];
  Window w;
  refill(w, src, len, bl);  // > 56 bits below bl, or base 0
  // head: single bytes up to a 4-byte aligned output address (<= 3
  // symbols, within the first window)
  int head = (int)((4 - (off & 3)) & 3);
  head = head < n ? head : n;
  int k = 0;
  for (; k < head; ++k) dst[k] = (uint8_t)decode1(w, tbl, bl);
  // body: four symbols per word store, one window check per word
  for (; k + 4 <= n; k += 4) {
    if (w.base > 0 && bl - 32 < w.base) refill(w, src, len, bl);
    uint32_t v = decode1(w, tbl, bl);
    v |= decode1(w, tbl, bl) << 8;
    v |= decode1(w, tbl, bl) << 16;
    v |= decode1(w, tbl, bl) << 24;
    *reinterpret_cast<uint32_t*>(dst + k) = v;
  }
  // tail: the last 1-3 symbols
  if (k < n && w.base > 0 && bl - 32 < w.base) refill(w, src, len, bl);
  for (; k < n; ++k) dst[k] = (uint8_t)decode1(w, tbl, bl);
  bits_left_out[s] = bl;
}

}  // namespace

extern "C" int huf_shared_decode(
    const void* payload, const void* starts, const void* lens,
    const void* bits0, const void* out_offs, const void* out_lens,
    const void* table, int n_streams, void* out, void* bits_left,
    void* stream) {
  if (n_streams <= 0) return 0;
  const int threads = 64;
  const int blocks = (n_streams + threads - 1) / threads;
  huf_shared_decode_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)payload, (const int64_t*)starts, (const int32_t*)lens,
      (const int32_t*)bits0, (const int64_t*)out_offs,
      (const int32_t*)out_lens, (const uint16_t*)table, n_streams,
      (uint8_t*)out, (int32_t*)bits_left);
  return (int)cudaGetLastError();
}
