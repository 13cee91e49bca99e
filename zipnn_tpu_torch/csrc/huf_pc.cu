// Per-cell-table Huffman decode of backward HUF bitstreams (tableLog <= 12).
//
// Replaces the Pallas kernels zipnn_tpu/ops/pallas_huf_pc.py:425
// `_decode_call_cached` (K1, kernel body `_build_kernel`) and
// zipnn_tpu/ops/pallas_gather.py:84 `_gather_call_cached` (K3, the DMA row
// gather that fed K1 right-aligned stream rows), and does the d-index ->
// symbol job of pallas_huf_pc.py:540 `_post_call_cached` (K4): a warp reads
// its stream at its byte offset in the uploaded payload and writes symbol
// bytes.
//
// What bounded it.  Not bytes (the first bf16 batch moves ~0.36 GB, ~0.11 ms
// at 3.35 TB/s) but the serial chain of each stream: peek -> table -> bits
// consumed -> next peek.  One thread per stream gave 8 192 threads for the
// first bf16 batch, ~2 warps per SM, ~355 ns per symbol.
//
// What the design does.  One warp decodes one stream by the
// self-synchronising schedule of huf_decode.cuh: up to 32 chains per
// stream.  A block of 4 warps takes the 4 streams of one cell as the
// decode plan lays them out and expands that cell's table into pair
// entries in shared memory (at most 16 KB), so a lookup often yields two
// symbols; a warp whose stream belongs to another cell reads its own row
// from device memory, unpaired, so any `cells` array decodes exactly.
// Symbols leave through shared-memory staging rows as whole 32-byte
// sectors.  A launch of short streams (group = 32: small chunks, the tail
// chunk) decodes one stream per lane by the serial chain instead, each
// lane reading its cell's row from device memory.
//
// What bounds it now.  It runs at ~9x its byte bound, presumably on the
// instruction rate of the per-lane chains (window slide, funnel-shift
// peek, lookup, cursor update): no profiler counters run on the card's
// machine, but variants timed there ran slower with fewer registers and
// more warps.  So blocks get 64 registers a thread (32 warps per SM), the
// least that ptxas meets without spills.
//
// Semantics (held against zipnn_tpu/ops/jax_entropy.py decode_streams):
// bits_left starts at bits0; each step peeks the tl bits below it, zeros
// below the stream's first bit (the bytes before a stream in the payload
// are real data: masked, never read), looks the entry up and retreats by
// its nb.  Preconditions (as cell_tables gives them): 1 <= tl <= 12 and
// 2^tl <= table_stride.

#include "huf_decode.cuh"

namespace {

constexpr int kWarps = 4;              // streams per block: one cell
constexpr int kMaxSmemEntries = 4096;  // tableLog 12

struct PairTable {
  const uint32_t* p;  // the block's cell: pair entries, shared memory
  __device__ __forceinline__ uint32_t operator()(uint32_t i) const {
    return p[i];
  }
};

struct RowTable {
  const uint16_t* p;  // another cell: its row in device memory, unpaired
  __device__ __forceinline__ uint32_t operator()(uint32_t i) const {
    return __ldg(p + i);
  }
};

__global__ void __launch_bounds__(32 * kWarps, 8) huf_pc_decode_kernel(
    const uint8_t* __restrict__ payload,
    const int64_t* __restrict__ starts,
    const int32_t* __restrict__ lens,
    const int32_t* __restrict__ bits0,
    const int64_t* __restrict__ out_offs,
    const int32_t* __restrict__ out_lens,
    const int32_t* __restrict__ cells,
    const int32_t* __restrict__ tlogs,
    const uint16_t* __restrict__ tables,
    int64_t table_stride,
    int smem_entries,
    int n_streams,
    int lanes,
    int min_seg_bits,
    int group,
    uint8_t* __restrict__ out,
    int32_t* __restrict__ bits_left_out,
    int32_t* __restrict__ passes_out) {
  extern __shared__ __align__(16) uint8_t smem[];  // staging rows, then pairs
  uint32_t* pairs = reinterpret_cast<uint32_t*>(smem + kWarps * hufdec::kStageBytes);
  if (group > 1) {  // short streams: one per lane, its cell's row read directly
    const int s = (blockIdx.x * kWarps + (int)(threadIdx.x >> 5)) * 32 +
                  (int)(threadIdx.x & 31);
    if (s < n_streams) {
      const int cell = cells[s];
      hufdec::decode_lane(payload + starts[s], lens[s], bits0[s], out_lens[s],
                          out + out_offs[s],
                          RowTable{tables + (int64_t)cell * table_stride},
                          tlogs[cell], bits_left_out + s, passes_out + s);
    }
    return;
  }
  const int s0 = blockIdx.x * kWarps;
  const int cell0 = cells[s0];
  const int tl0 = tlogs[cell0];
  const bool staged = (1 << tl0) <= smem_entries;
  if (staged) hufdec::build_pairs(tables + (int64_t)cell0 * table_stride, tl0, pairs);
  const int s = s0 + (int)(threadIdx.x >> 5);
  if (s >= n_streams) return;  // the whole warp
  const int cell = cells[s];
  uint8_t* stage = smem + (threadIdx.x >> 5) * hufdec::kStageBytes;
  if (cell == cell0 && staged) {
    hufdec::decode_warp(payload + starts[s], lens[s], bits0[s], out_lens[s],
                        out + out_offs[s], PairTable{pairs}, tl0, lanes,
                        min_seg_bits, stage, bits_left_out + s, passes_out + s);
  } else {
    hufdec::decode_warp(payload + starts[s], lens[s], bits0[s], out_lens[s],
                        out + out_offs[s],
                        RowTable{tables + (int64_t)cell * table_stride},
                        tlogs[cell], lanes, min_seg_bits, stage,
                        bits_left_out + s, passes_out + s);
  }
}

}  // namespace

extern "C" int huf_pc_decode(
    const void* payload, const void* starts, const void* lens,
    const void* bits0, const void* out_offs, const void* out_lens,
    const void* cells, const void* tlogs, const void* tables,
    long long table_stride, int n_streams, int lanes, int min_seg_bits,
    int group, void* out, void* bits_left, void* passes, void* stream) {
  if (n_streams <= 0) return 0;
  if (lanes < 1 || lanes > 32 || min_seg_bits < 1 || (group != 1 && group != 32))
    return (int)cudaErrorInvalidValue;
  const int smem_entries =
      table_stride < kMaxSmemEntries ? (int)table_stride : kMaxSmemEntries;
  const int per_block = kWarps * group;
  const int blocks = (n_streams + per_block - 1) / per_block;
  // one stream per lane reads its table from device memory, no staging
  const int smem = group > 1 ? 0 : kWarps * hufdec::kStageBytes + 4 * smem_entries;
  huf_pc_decode_kernel<<<blocks, 32 * kWarps, smem,
                         (cudaStream_t)stream>>>(
      (const uint8_t*)payload, (const int64_t*)starts, (const int32_t*)lens,
      (const int32_t*)bits0, (const int64_t*)out_offs,
      (const int32_t*)out_lens, (const int32_t*)cells,
      (const int32_t*)tlogs, (const uint16_t*)tables, (int64_t)table_stride,
      smem_entries, n_streams, lanes, min_seg_bits, group, (uint8_t*)out,
      (int32_t*)bits_left, (int32_t*)passes);
  return (int)cudaGetLastError();
}
