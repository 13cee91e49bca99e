// Shared-table Huffman decode of backward HUF bitstreams (tableLog <= 8).
//
// Replaces the Pallas kernel zipnn_tpu/ops/pallas_huf.py:239
// `_decode_call_cached` (K6, kernel body `_build_kernel`), and does the
// row-gather job of zipnn_tpu/ops/pallas_gather.py:84 `_gather_call_cached`
// (K3) on this path: a warp reads its stream at its byte offset in the
// uploaded payload.  The TPU kernel's window slides, right-aligned 512 B
// rows and p0/pend geometry exist because a TPU lane cannot fetch from its
// own stream; a CUDA lane can.
//
// What bounded it.  Not bytes (~0.11 ms at 3.35 TB/s for the first bf16
// batch) but the serial chain of each stream: peek -> table -> bits
// consumed -> next peek.  With one thread per stream the table already sat
// in shared memory and the chain ran at ~131 ns per symbol, ~2 warps per
// SM, nothing to hide its latency.
//
// What the design does.  Every Huffman cell of a shared-table container
// carries the same weight header, so one 256-entry table (sym | nb << 8,
// indexed by the 8 stream bits below the cursor) serves every stream; a
// block of 8 warps expands it into pair entries in shared memory, so a
// lookup often yields two symbols.  One warp decodes one stream by the
// self-synchronising schedule of huf_decode.cuh: up to 32 chains per
// stream.  Symbols leave through shared-memory staging rows as whole
// 32-byte sectors.  A launch of short streams (group = 32: small chunks,
// the tail chunk) decodes one stream per lane by the serial chain instead.
//
// What bounds it now.  It runs at ~9x its byte bound, presumably on the
// instruction rate of the per-lane chains: variants timed on the card ran
// slower with fewer registers and more warps, so blocks get 64 registers
// a thread (32 warps per SM), the least that ptxas meets without spills.
//
// Semantics (held against zipnn_tpu/ops/jax_entropy.py decode_streams):
// bits_left starts at bits0; each step peeks the 8 bits below it, zeros
// below the stream's first bit (the bytes before a stream in the payload
// are real data: masked, never read), looks the entry up and retreats by
// its nb.

#include "huf_decode.cuh"

namespace {

constexpr int kWarps = 8;  // streams per block

struct Table {
  const uint32_t* p;  // pair entries, shared memory
  __device__ __forceinline__ uint32_t operator()(uint32_t i) const {
    return p[i];
  }
};

__global__ void __launch_bounds__(32 * kWarps, 4) huf_shared_decode_kernel(
    const uint8_t* __restrict__ payload,
    const int64_t* __restrict__ starts,
    const int32_t* __restrict__ lens,
    const int32_t* __restrict__ bits0,
    const int64_t* __restrict__ out_offs,
    const int32_t* __restrict__ out_lens,
    const uint16_t* __restrict__ table,
    int n_streams,
    int lanes,
    int min_seg_bits,
    int group,
    uint8_t* __restrict__ out,
    int32_t* __restrict__ bits_left_out,
    int32_t* __restrict__ passes_out) {
  __shared__ uint32_t pairs[256];
  __shared__ __align__(16) uint8_t stage[kWarps * hufdec::kStageBytes];
  const int warp = blockIdx.x * kWarps + (int)(threadIdx.x >> 5);
  if (group > 1) {  // short streams: one per lane, the table unpaired
    for (int i = threadIdx.x; i < 256; i += blockDim.x) pairs[i] = table[i];
    __syncthreads();
    const int s = warp * 32 + (int)(threadIdx.x & 31);
    if (s < n_streams)
      hufdec::decode_lane(payload + starts[s], lens[s], bits0[s], out_lens[s],
                          out + out_offs[s], Table{pairs}, 8,
                          bits_left_out + s, passes_out + s);
    return;
  }
  hufdec::build_pairs(table, 8, pairs);
  const int s = warp;
  if (s >= n_streams) return;  // the whole warp
  hufdec::decode_warp(payload + starts[s], lens[s], bits0[s], out_lens[s],
                      out + out_offs[s], Table{pairs}, 8, lanes, min_seg_bits,
                      stage + (threadIdx.x >> 5) * hufdec::kStageBytes,
                      bits_left_out + s, passes_out + s);
}

}  // namespace

extern "C" int huf_shared_decode(
    const void* payload, const void* starts, const void* lens,
    const void* bits0, const void* out_offs, const void* out_lens,
    const void* table, int n_streams, int lanes, int min_seg_bits, int group,
    void* out, void* bits_left, void* passes, void* stream) {
  if (n_streams <= 0) return 0;
  if (lanes < 1 || lanes > 32 || min_seg_bits < 1 || (group != 1 && group != 32))
    return (int)cudaErrorInvalidValue;
  const int per_block = kWarps * group;
  const int blocks = (n_streams + per_block - 1) / per_block;
  huf_shared_decode_kernel<<<blocks, 32 * kWarps, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)payload, (const int64_t*)starts, (const int32_t*)lens,
      (const int32_t*)bits0, (const int64_t*)out_offs,
      (const int32_t*)out_lens, (const uint16_t*)table, n_streams, lanes,
      min_seg_bits, group, (uint8_t*)out, (int32_t*)bits_left,
      (int32_t*)passes);
  return (int)cudaGetLastError();
}
