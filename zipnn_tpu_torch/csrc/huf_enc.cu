// Huffman encode of HUF streams: the shared-table profile (codes of at most
// 8 bits, one table for the launch) and the per-chunk profile (codes of at
// most 12 bits, a table per cell).
//
// `huf_shared_encode` replaces the Pallas kernel
// zipnn_tpu/ops/pallas_huf_enc.py:225 (`_encode_call_cached`, K7;
// `_build_kernel` :43).  `huf_pc_encode` replaces XLA device code of the
// JAX package, not a Pallas kernel: zipnn_tpu/ops/jax_entropy.py:89
// `encode_streams` (a lockstep scan over every stream's symbols and a
// segment_sum of the code words), which its per-chunk encode runs.
//
// What it computes, per stream (bit-exact with ops/entropy/huf.py
// `encode_stream`): the stream's symbols in descending index order, each
// code appended LSB-first, then one closing sentinel bit, zero-padded to a
// whole byte.  `total_bits` is the code bits plus the sentinel; bit 30 is
// set when a symbol has no code (table entry nb == 0, possible only under a
// sampled table), and such a stream's bytes are not a valid encoding.
// Codes are at most 8 bits, so a row of seg/4 + 1 words holds any stream
// (8 bits per symbol plus the sentinel): no overflow path, no host
// re-encode.  The TPU kernel's w8/W3 window hierarchy and masked spill
// trees exist because a TPU lane cannot write at its own pace; here the
// 256-entry table (`val | nb << 8`) sits in shared memory, once per block.
//
// What bounded the first design (one thread per stream, a serial append
// chain over the whole segment): the bf16 exponent plane's 8 192 streams
// of 32 K symbols made 128 blocks of 64 threads, ~2 warps per SM, so the
// chain's latency was not hidden; and each thread flushed words into its
// own row, so one warp store touched 32 rows and 32 sectors.
//
// Design (a warp per stream, `group` 1).  Blocks of 8 warps.  A warp walks
// its segment from the end in tiles of 512 symbols: each lane loads 4
// words (one 16-byte load; lane 0 holds the highest addresses), looks up
// its 16 codes and sums their lengths (<= 128 bits); an exclusive warp
// scan (__shfl_up_sync) gives each lane its bit offset after the bits
// carried from the previous tile.  Lanes then or their bits into the
// warp's staging row in shared memory (atomicOr: a word may hold the bits
// of several lanes; <= 129 words: 4 096 code bits plus < 32 carried), the
// warp stores the tile's complete words to the stream's row, coalesced,
// and carries the last partial word into the next tile.  Bit 30 comes from
// __any_sync over the lanes' uncoded symbols.  Tiles end on the 16-byte
// boundary at or above the segment's end, so every lane group inside the
// segment is one aligned 16-byte load whatever the stream's word offset;
// the groups that straddle the segment's ends are read word by word, and
// words outside the segment give no symbols.
//
// A launch of short streams (`group` 32, which the host picks from the
// stream length: ops/huf_enc.py `streams_per_warp`) runs a second kernel
// that gives each lane a stream of its own and the first design's serial
// code (`encode_lane`), in its 64-thread blocks: 256 B bf16 chunks make
// streams of 32 symbols, where a warp would leave 30 lanes idle.  One
// kernel for both schedules cost the lane schedule ~25 % at 256 B chunks
// (the warp path's registers and size).
//
// The per-chunk profile (`huf_pc_encode`) runs the same two schedules,
// instantiated for 12-bit codes and a table per stream (the templates'
// CodeBits and PerStream; the 8-bit shared instance is unchanged).  Its
// stream s takes the table of cell s / 4: the host lists the 4 streams of
// each Huffman cell in turn and a [cells, 256] uint16 table array of
// `val | nb << 12` entries, which a signed 16-bit entry would not hold.
// Rows are ceil((12 seg + 1) / 32) words; the staging row holds a tile of
// 512 symbols at 12 bits (192 words) plus the carry, 196 words; the codes
// are or-ed into the 64-bit accumulator two symbols between flushes, not
// four.  Neighbouring warps of a block encode other cells, so each warp
// copies its table (256 entries) into its own 1 KB of shared memory; the
// lane schedule reads each lane's table through L1.
//
// What bounds it now.  Its bytes (the symbols read once, the stream bytes
// written once) would take 0.107 ms for a 512 MiB bf16 batch's exponent
// plane; it takes ~3.5x that.  With one load per lane and tile, a warp
// waited on that load every tile: ~3.8 us a tile at 4 096 streams.  So
// each lane keeps its groups of the next kAhead = 2 tiles in flight (a
// ring of registers; 1 and 3 measured slower or no faster on the card).
// What remains is issue by estimate (the card gives no counters): ~300
// warp instructions a tile (16 table loads, the length sum, the 5-step
// scan, the shifted or of the codes, <= 5 shared atomics a lane, the
// staging row's reset and the stores), with 32 warps an SM at 64
// registers.  ptxas: the warp kernel 64 registers and 5 248 bytes of
// shared memory, the lane kernel 32 and 1 024, no spills (chip_smoke.py
// phase 1 prints them).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;          // warps per block, warp schedule
constexpr int kLaneThreads = 64;   // threads per block, lane schedule
constexpr int kLaneWords = 4;      // input words per lane and tile
constexpr int kTileWords = 32 * kLaneWords;  // 512 symbols
constexpr int kAhead = 2;          // tiles a lane's loads run ahead

// A table entry is `val | nb << CB` for codes of at most CB bits (8: the
// shared profile, 12: the per-chunk profile).
template <int CB>
struct Code {
  static constexpr uint32_t kVal = (1u << CB) - 1;
  // codes appended between flushes: < 32 carried bits plus kFlush codes
  // fit the 64-bit accumulator
  static constexpr int kFlush = 32 / CB;
  // staging words per warp: a tile's code bits plus < 32 carried, and the
  // carry word (132 at 8 bits, 196 at 12)
  static constexpr int kStage = ((4 * kTileWords * CB + 31) / 32 + 1 + 3) & ~3;
};

// A lane's table in device memory (read through L1), indexed as the
// shared-memory tables are.
struct GlobalTable {
  const uint16_t* p;
  __device__ __forceinline__ uint32_t operator[](uint32_t i) const { return __ldg(p + i); }
};

struct Writer {
  uint64_t acc;    // pending bits, LSB first
  int nbits;       // bits held in acc (< 32 between words)
  int64_t words;   // words flushed so far
  uint32_t bad;    // a symbol without a code was seen
};

// Append the codes of one input word's four symbols, highest byte first
// (symbols run in descending index order), flushing a word when full.
template <int CB, typename Tbl>
__device__ __forceinline__ void put_word(Writer& w, uint32_t x, const Tbl& tbl,
                                         uint32_t* __restrict__ dst) {
#pragma unroll
  for (int k = 3; k >= 0; --k) {
    const uint32_t e = tbl[(x >> (8 * k)) & 0xFFu];
    const uint32_t nb = e >> CB;
    w.bad |= (nb == 0u);
    w.acc |= (uint64_t)(e & Code<CB>::kVal) << w.nbits;
    w.nbits += (int)nb;
    if (k % Code<CB>::kFlush == 0 && w.nbits >= 32) {
      dst[w.words++] = (uint32_t)w.acc;
      w.acc >>= 32;
      w.nbits -= 32;
    }
  }
}

// One stream by one thread (the lane schedule): 16-byte loads from the
// segment's end where the segment is 16-byte aligned, else 4.
template <int CB, typename Tbl>
__device__ void encode_lane(const uint32_t* src, int seg_words, const Tbl& tbl,
                            uint32_t* __restrict__ dst, int32_t* total_bits) {
  Writer w{0ull, 0, 0, 0u};
  const bool vec = ((seg_words & 3) == 0) && (((uintptr_t)src & 15) == 0);
  if (vec) {
    const uint4* v = reinterpret_cast<const uint4*>(src);
    for (int q = (seg_words >> 2) - 1; q >= 0; --q) {
      const uint4 x = __ldg(v + q);
      put_word<CB>(w, x.w, tbl, dst);
      put_word<CB>(w, x.z, tbl, dst);
      put_word<CB>(w, x.y, tbl, dst);
      put_word<CB>(w, x.x, tbl, dst);
    }
  } else {
    for (int i = seg_words - 1; i >= 0; --i) put_word<CB>(w, __ldg(src + i), tbl, dst);
  }
  const int64_t code_bits = 32 * w.words + w.nbits;
  // closing sentinel, then the last partial word (zero-padded)
  dst[w.words] = (uint32_t)(w.acc | (1ull << w.nbits));
  *total_bits = (int32_t)(code_bits + 1) | (int32_t)(w.bad << 30);
}

// A lane's 4 words from word `lo` of the segment (x = word lo), one
// 16-byte load where all four lie in it (then aligned: tiles end on a
// 16-byte boundary); words outside [0, seg_words) read as 0, unloaded.
__device__ __forceinline__ uint4 load_group(const uint32_t* src, int seg_words, int lo) {
  if (lo >= 0 && lo + kLaneWords <= seg_words)
    return __ldg(reinterpret_cast<const uint4*>(src + lo));
  uint32_t x[kLaneWords];
#pragma unroll
  for (int k = 0; k < kLaneWords; ++k) {
    const int i = lo + k;
    x[k] = i >= 0 && i < seg_words ? __ldg(src + i) : 0u;
  }
  return make_uint4(x[0], x[1], x[2], x[3]);
}

struct WarpState {
  uint32_t carry;  // the bits of the last, partial word (pos & 31 of them)
  int pos;         // code bits so far
  int words;       // words stored so far
  uint32_t bad;    // this lane met a symbol without a code
};

// One tile: the lane's group `v` (from word `lo`) coded, scanned, or-ed
// into the staging row, the row's complete words stored.
template <int CB>
__device__ __forceinline__ void encode_tile(uint4 v, int lo, int seg_words,
                                            const uint32_t* tbl,
                                            uint32_t* __restrict__ dst,
                                            uint32_t* stage, int lane, WarpState& st) {
  const uint32_t x[kLaneWords] = {v.w, v.z, v.y, v.x};  // highest word first
  // the lane's 16 codes, highest symbol first, and their length
  uint32_t e[4 * kLaneWords];
  int len = 0;
#pragma unroll
  for (int k = 0; k < kLaneWords; ++k) {
    const int i = lo + kLaneWords - 1 - k;
    const uint32_t keep = i >= 0 && i < seg_words ? 0xFFFFFFFFu : 0u;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const uint32_t ent = tbl[(x[k] >> (8 * (3 - r))) & 0xFFu] & keep;
      st.bad |= keep & (ent < (1u << CB));
      e[4 * k + r] = ent;
      len += (int)(ent >> CB);
    }
  }
  int incl = len;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  const int tile_bits = __shfl_sync(kFull, incl, 31);
  const int first = (st.pos & 31) + incl - len;  // the lane's first bit in the row
  for (int i = lane; i < Code<CB>::kStage; i += 32) stage[i] = i ? 0u : st.carry;
  __syncwarp();
  uint64_t acc = 0;
  int nbits = first & 31;
  int wi = first >> 5;
#pragma unroll
  for (int g = 0; g < kLaneWords; ++g) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const uint32_t ent = e[4 * g + r];
      acc |= (uint64_t)(ent & Code<CB>::kVal) << nbits;
      nbits += (int)(ent >> CB);
      if ((r + 1) % Code<CB>::kFlush == 0 && nbits >= 32) {
        if ((uint32_t)acc) atomicOr(stage + wi, (uint32_t)acc);
        ++wi;
        acc >>= 32;
        nbits -= 32;
      }
    }
  }
  if ((uint32_t)acc) atomicOr(stage + wi, (uint32_t)acc);
  __syncwarp();
  const int full = ((st.pos & 31) + tile_bits) >> 5;  // complete words in the row
  for (int i = lane; i < full; i += 32) dst[st.words + i] = stage[i];
  st.carry = stage[full];
  st.words += full;
  st.pos += tile_bits;
  __syncwarp();  // every lane has read the row before the next tile resets it
}

// One stream by one warp (the warp schedule); `stage` is the warp's
// staging row.  Each lane keeps its groups of the next kAhead tiles in
// flight while it codes one.
template <int CB>
__device__ void encode_warp(const uint32_t* src, int seg_words,
                            const uint32_t* tbl, uint32_t* __restrict__ dst,
                            uint32_t* stage, int lane, int32_t* total_bits) {
  // tiles end at `top`, the first 16-byte boundary at or above the
  // segment's end, and run down from there
  const int pad = (int)(((uintptr_t)(src + seg_words) >> 2) & 3);
  const int top = seg_words + (pad ? 4 - pad : 0);
  const int n_tiles = (top + kTileWords - 1) / kTileWords;
  const int lo0 = top - kLaneWords * (lane + 1);  // the lane's lowest word in tile 0
  uint4 ring[kAhead];
#pragma unroll
  for (int a = 0; a < kAhead; ++a) ring[a] = load_group(src, seg_words, lo0 - a * kTileWords);
  WarpState st{0u, 0, 0, 0u};
  for (int t = 0; t < n_tiles; t += kAhead) {
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      if (t + a >= n_tiles) break;
      const int lo = lo0 - (t + a) * kTileWords;
      const uint4 v = ring[a];
      ring[a] = load_group(src, seg_words, lo - kAhead * kTileWords);
      encode_tile<CB>(v, lo, seg_words, tbl, dst, stage, lane, st);
    }
  }
  const uint32_t bad = __any_sync(kFull, st.bad != 0);
  if (lane == 0) {
    dst[st.words] = st.carry | (1u << (st.pos & 31));  // closing sentinel
    *total_bits = (int32_t)(st.pos + 1) | (int32_t)(bad << 30);
  }
}

// The 256-entry table into shared memory, once per block.
__device__ __forceinline__ void load_table(uint32_t* tbl, const uint16_t* __restrict__ table) {
  for (int i = threadIdx.x; i < 256; i += blockDim.x) tbl[i] = table[i];
  __syncthreads();
}

// PerStream: stream s codes with table s / 4 of `tables`, copied by its
// warp into the warp's own shared table; else one table for the launch.
template <int CB, bool PerStream>
__global__ void __launch_bounds__(32 * kWarps) huf_encode_warps_kernel(
    const uint32_t* __restrict__ planes,
    const int64_t* __restrict__ streams,
    const uint16_t* __restrict__ tables,
    int n_streams, int seg_words, int row_words,
    uint32_t* __restrict__ rows,
    int32_t* __restrict__ total_bits) {
  __shared__ uint32_t tbl[PerStream ? kWarps : 1][256];
  __shared__ uint32_t stage[kWarps][Code<CB>::kStage];
  if constexpr (!PerStream) load_table(tbl[0], tables);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * kWarps + warp;
  if (s >= n_streams) return;  // the whole warp
  uint32_t* t = tbl[0];
  if constexpr (PerStream) {
    t = tbl[warp];
    const uint16_t* src = tables + (int64_t)(s >> 2) * 256;
    for (int i = lane; i < 256; i += 32) t[i] = __ldg(src + i);
    __syncwarp();
  }
  encode_warp<CB>(planes + streams[s], seg_words, t, rows + (int64_t)s * row_words,
                  stage[warp], lane, total_bits + s);
}

// A kernel of its own, so the lane schedule keeps the first design's
// registers and block size rather than the warp schedule's.
template <int CB, bool PerStream>
__global__ void __launch_bounds__(kLaneThreads) huf_encode_lanes_kernel(
    const uint32_t* __restrict__ planes,
    const int64_t* __restrict__ streams,
    const uint16_t* __restrict__ tables,
    int n_streams, int seg_words, int row_words,
    uint32_t* __restrict__ rows,
    int32_t* __restrict__ total_bits) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if constexpr (PerStream) {
    if (s >= n_streams) return;
    const GlobalTable tbl{tables + (int64_t)(s >> 2) * 256};
    encode_lane<CB>(planes + streams[s], seg_words, tbl, rows + (int64_t)s * row_words,
                    total_bits + s);
  } else {
    __shared__ uint32_t tbl[256];
    load_table(tbl, tables);
    if (s >= n_streams) return;
    const uint32_t* t = tbl;
    encode_lane<CB>(planes + streams[s], seg_words, t, rows + (int64_t)s * row_words,
                    total_bits + s);
  }
}

template <int CB, bool PerStream>
int encode(const void* planes, const void* streams, const void* tables, int n_streams,
           int seg_words, int row_words, int group, void* rows, void* total_bits,
           void* stream) {
  if (n_streams <= 0) return 0;
  // CB bits per symbol plus the sentinel must fit the row and stay below
  // bit 30 of total_bits
  const int64_t most = (int64_t)seg_words * 4 * CB + 1;
  if (seg_words < 0 || most >= (1 << 30) || (int64_t)row_words * 32 < most ||
      (group != 1 && group != 32))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (group == 1) {
    huf_encode_warps_kernel<CB, PerStream>
        <<<(n_streams + kWarps - 1) / kWarps, 32 * kWarps, 0, st>>>(
            (const uint32_t*)planes, (const int64_t*)streams, (const uint16_t*)tables,
            n_streams, seg_words, row_words, (uint32_t*)rows, (int32_t*)total_bits);
  } else {
    huf_encode_lanes_kernel<CB, PerStream>
        <<<(n_streams + kLaneThreads - 1) / kLaneThreads, kLaneThreads, 0, st>>>(
            (const uint32_t*)planes, (const int64_t*)streams, (const uint16_t*)tables,
            n_streams, seg_words, row_words, (uint32_t*)rows, (int32_t*)total_bits);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int huf_shared_encode(const void* planes, const void* streams,
                                 const void* table, int n_streams,
                                 int seg_words, int row_words, int group,
                                 void* rows, void* total_bits, void* stream) {
  return encode<8, false>(planes, streams, table, n_streams, seg_words, row_words, group,
                          rows, total_bits, stream);
}

extern "C" int huf_pc_encode(const void* planes, const void* streams,
                             const void* tables, int n_streams,
                             int seg_words, int row_words, int group,
                             void* rows, void* total_bits, void* stream) {
  return encode<12, true>(planes, streams, tables, n_streams, seg_words, row_words, group,
                          rows, total_bits, stream);
}
