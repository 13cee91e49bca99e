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
// What bounds K7 now.  Its bytes (the symbols read once, the stream bytes
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
//
// The per-chunk profile (`huf_pc_encode`, E) codes with 12-bit codes and
// a table per cell: stream s takes the table of cell s / 4 (the host
// lists the 4 streams of each Huffman cell in turn and a [cells, 256]
// uint16 array of `val | nb << 12` entries).  Rows are ceil((12 seg + 1) /
// 32) words.  Short streams take the lane schedule above, instantiated
// for 12-bit codes and a table per stream read through L1.
//
// What bounded E's first schedule (K7's warp schedule at 12 bits, a table
// a warp), on an NVIDIA H100 80GB HBM3 at 700 W: at the main path's batch
// (8 192 streams of 32 768 symbols) ~0.36 ms of kernel against a 0.106 ms
// byte bound, ~200 SM cycles a 512-symbol warp-tile, by its code the
// tile's fixed work (two address multiplies a table load, shared atomics
// with bank conflicts, the 196-word row reset, the syncs); at a 1 MiB
// frame's batch (16 streams) 0.12 ms: 16 warps each walking its 64 tiles
// in a row, latency, with 116 SMs idle.
//
// E's design (`huf_pc_split_kernel`, `group` 1): each stream is split into
// `parts` (1 to 16, a power of 2, which the host picks from the launch's
// stream count and length: ops/huf_enc.py `parts_per_stream`) runs of
// whole tiles, a warp a part, the parts of a stream in one block of
// max(parts, 8) warps.  (a) Each warp sums its part's code lengths
// (lookups only, holding up to kPcKeep tiles in registers for (c)); (b)
// shared memory gives each part its first bit, the bits of the parts
// before it (part 0 holds the stream's highest addresses); (c) each warp
// codes its part from that bit, tile by tile.  A tile is 1 024 symbols,
// 32 a lane (two 16-byte loads, G 2), so the per-tile work (scans, votes,
// the copy) is spread over twice K7's symbols.  In a tile each lane looks its
// symbols up in its cell's table (1 KB-aligned in shared memory, entries
// `val | nb << 16 | uncoded << 27`: an address is a shift and an or, and
// 16 entries summed give their code bits and uncoded count at once),
// takes its first bit from a warp scan of the lengths, codes its codes
// two at a time into a 32-bit word (funnel shifts) and stores each word
// it completes to the warp's staging row.  The lane holding a word's last
// bit writes it, so each word of the row is written once, by a plain
// store, and the row needs no reset; the bits that lower lanes leave in a
// lane's first word are the previous lane's pending word, or-ed down
// through lanes that complete no word (an or-scan, run only when such a
// lane exists, as with 1-bit codes).  The warp copies the complete words
// out, coalesced.  After a block barrier the words that parts share are
// finished: each part's first word, or-ed with the earlier parts' bits in
// it, and by the last part the stream's last word with the sentinel and
// `total_bits`, bit 30 the or over every part.  One part a stream skips
// (a) and (b).  The kernel allocates nothing and writes each row byte
// below ceil(bits / 8) once.
//
// What bounds E now (same card, time_kernels.py): the main path's batch
// takes ~0.21 ms of kernel, ~2x its byte bound, one part a stream:
// instruction throughput, by its code the codes' shifts and ors and the
// lookups, at 16 warps an SM (119 registers; 16 symbols a lane, at 64
// registers and 32 warps an SM, was slower).  The frame's batch takes
// ~0.019 ms at 16 parts: the latency of two passes over 2 tiles and two
// barriers, on 16 SMs.
// Splitting costs the extra pass of (a), so from 1 024 streams a launch
// takes one part.  Streams under 1 024 symbols take tiles of 512 (G 1):
// a 1 024-symbol tile left half the lanes of a 512-symbol stream idle.
// ptxas: G 2 119 registers, G 1 64, both 2 048 bytes of static shared
// memory (the tables), no spills; 25 152 dynamic bytes at 16 warps (G 2).

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
};

// K7's staging words per warp: a tile's code bits plus < 32 carried, and
// the carry word (132 at 8 bits)
template <int CB>
constexpr int kStage = ((4 * kTileWords * CB + 31) / 32 + 1 + 3) & ~3;

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
  for (int i = lane; i < kStage<CB>; i += 32) stage[i] = i ? 0u : st.carry;
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

// One table for the launch (the shared profile, K7).
template <int CB>
__global__ void __launch_bounds__(32 * kWarps) huf_encode_warps_kernel(
    const uint32_t* __restrict__ planes,
    const int64_t* __restrict__ streams,
    const uint16_t* __restrict__ table,
    int n_streams, int seg_words, int row_words,
    uint32_t* __restrict__ rows,
    int32_t* __restrict__ total_bits) {
  __shared__ uint32_t tbl[256];
  __shared__ uint32_t stage[kWarps][kStage<CB>];
  load_table(tbl, table);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * kWarps + warp;
  if (s >= n_streams) return;  // the whole warp
  encode_warp<CB>(planes + streams[s], seg_words, tbl, rows + (int64_t)s * row_words,
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

// ---- E: the per-chunk encode, a stream split over the warps of a block ----

constexpr int kPcMaxParts = 16;  // warps a stream may take
constexpr int kPcMinWarps = 8;   // warps a block holds when its streams take fewer
constexpr int kPcKeep = 2;       // tiles a part holds in registers from (a) to (c)
constexpr int kPcAhead = 2;      // tiles a lane's loads run ahead
constexpr int kPcSlots = 5;      // shared words a part: bits, end, head, tail, bad
constexpr int kPcLongSymbols = 1024;  // streams this long take tiles of G = 2

// A tile of E's: G 16-byte groups a lane (32 G words a warp).  G = 2 from
// streams of kPcLongSymbols on, else 1: a tile longer than the stream
// would leave lanes idle.
template <int G>
struct PcTile {
  static constexpr int kWords = kLaneWords * G;  // a lane's words
  static constexpr int kSymbols = 4 * kWords;     // a lane's symbols
  static constexpr int kTileWords = 32 * kWords;
  // staging words a warp: a tile's complete words, 12 bits a symbol
  static constexpr int kStage = 12 * kSymbols + 4;
  static constexpr int kShared = 4 * kPcMaxParts * (kStage + kPcSlots) + 2048;
};
static_assert(PcTile<2>::kShared <= 48 * 1024,
              "E's shared memory must fit a block's default 48 KB");
// A shared-memory entry is val | nb << 16 | (nb == 0) << 27: a lane's 16
// entries summed keep the values' sum below bit 16, the code lengths' in
// bits 16-23 and the count of uncoded symbols from bit 27.
constexpr int kNb = 16;
constexpr int kUncoded = 27;

__device__ __forceinline__ uint32_t pc_entry(uint32_t t) {
  const uint32_t nb = t >> 12;
  return (t & 0xFFFu) | nb << kNb | (uint32_t)(nb == 0u) << kUncoded;
}

// A lane's words of a tile: G 16-byte groups from word `lo`, the highest
// first.
template <int G>
struct PcWords {
  uint4 q[G];
};

template <int G>
__device__ __forceinline__ PcWords<G> pc_load(const uint32_t* src, int seg_words, int lo) {
  PcWords<G> w;
#pragma unroll
  for (int g = 0; g < G; ++g)
    w.q[g] = load_group(src, seg_words, lo + kLaneWords * (G - 1 - g));
  return w;
}

// A lane's entries (its words from word `lo`), highest symbol first;
// returns their code bits and ors into `bad` whether one has no code.
// Edge: the tile reaches outside the segment, whose words give 0.
template <int G, bool Edge>
__device__ __forceinline__ int pc_lookup(const PcWords<G>& w, int lo, int seg_words,
                                         uint32_t tbl, uint32_t (&e)[PcTile<G>::kSymbols],
                                         uint32_t& bad) {
  int bits = 0;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    uint32_t sum = 0;  // a group's 16 entries summed (see kNb)
    const uint32_t x[kLaneWords] = {w.q[g].w, w.q[g].z, w.q[g].y, w.q[g].x};
#pragma unroll
    for (int k = 0; k < kLaneWords; ++k) {
      const int i = lo + PcTile<G>::kWords - 1 - kLaneWords * g - k;
      const uint32_t keep = !Edge || (i >= 0 && i < seg_words) ? 0xFFFFFFFFu : 0u;
#pragma unroll
      for (int r = 3; r >= 0; --r) {
        // byte r's entry: the table is 1 KB-aligned, so its address is an or
        const uint32_t at = tbl | (r ? x[k] >> (8 * r - 2) : x[k] << 2) & 0x3FCu;
        uint32_t ent;
        asm volatile("ld.shared.u32 %0, [%1];" : "=r"(ent) : "r"(at));
        const int j = 16 * g + 4 * k + 3 - r;
        e[j] = ent & keep;
        sum += e[j];
      }
    }
    bits += (int)((sum >> kNb) & 0x7FFu);
    bad |= sum >> kUncoded;
  }
  return bits;
}

// Whether the warp's tile (the lanes' words from word `lo`) reaches
// outside the segment.
template <int G>
__device__ __forceinline__ bool pc_edge(int lo, int seg_words) {
  return __any_sync(kFull, lo < 0 || lo + PcTile<G>::kWords > seg_words);
}

// The code bits of a lane's words (phase a).
template <int G>
__device__ __forceinline__ int pc_bits(const PcWords<G>& v, int lo, int seg_words,
                                       uint32_t tbl) {
  uint32_t e[PcTile<G>::kSymbols];
  uint32_t bad = 0;
  return pc_edge<G>(lo, seg_words) ? pc_lookup<G, true>(v, lo, seg_words, tbl, e, bad)
                                   : pc_lookup<G, false>(v, lo, seg_words, tbl, e, bad);
}

struct PcPart {
  uint32_t carry;  // the part's bits in word pos >> 5, below bit pos & 31
  int pos;         // the next code's bit in the stream's row
  int head;        // word first >> 5, finished after the block's parts are coded
  uint32_t bad;    // this lane met a symbol without a code
};

// One tile of a part (phase c).  Each lane codes its 16 G symbols
// from its first bit b (a warp scan of the lengths), two codes at a time,
// into its pending word, and stores every word it completes to the warp's
// staging row: the lane holding a row word's last bit writes it, so each
// word of the row is written once, by a plain store.  A lane's first word
// also holds the bits that lower lanes left in it: `ex`, the previous
// lane's pending word, or-ed down through lanes that complete no word (an
// or-scan, taken only when such a lane exists).  The warp then copies the
// complete words to the stream's row, coalesced, all but the part's head
// word, which waits in `head` for the bits of earlier parts.
template <int G>
__device__ __forceinline__ void pc_code_tile(const PcWords<G>& v, int lo, int seg_words,
                                             uint32_t tbl, uint32_t* __restrict__ dst,
                                             uint32_t* stage, uint32_t* head, int lane,
                                             PcPart& st) {
  uint32_t e[PcTile<G>::kSymbols];
  const int len = pc_edge<G>(lo, seg_words)
                      ? pc_lookup<G, true>(v, lo, seg_words, tbl, e, st.bad)
                      : pc_lookup<G, false>(v, lo, seg_words, tbl, e, st.bad);
  int incl = len;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  const int tile_bits = __shfl_sync(kFull, incl, 31);
  const int b = (st.pos & 31) + incl - len;  // the lane's first bit, from word pos >> 5
  uint32_t* const lead = stage + (b >> 5);   // the first word the lane would complete
  uint32_t* out = lead;
  uint32_t acc = lane == 0 ? st.carry : 0u;  // the pending word's bits
  int nbits = b & 31;
#pragma unroll
  for (int j = 0; j < PcTile<G>::kSymbols; j += 2) {
    // a pair of codes (<= 24 bits), the second past the first: the funnel
    // shift takes its amount mod 32, so the uncoded flag does not reach it;
    // the two values' sum stays below bit 16, so the lengths' sum is clean
    const uint32_t pair =
        (e[j] & 0xFFFu) | __funnelshift_l(0u, e[j + 1] & 0xFFFu, e[j] >> kNb);
    const int pair_bits = (int)(((e[j] + e[j + 1]) >> kNb) & 0x1Fu);
    const uint32_t over = __funnelshift_l(pair, 0u, nbits);  // its bits past the word
    acc |= pair << nbits;
    nbits += pair_bits;
    if (nbits >= 32) {  // < 32 pending bits and a pair: at most one word completes
      *out++ = acc;
      acc = over;
      nbits -= 32;
    }
  }
  // the pending word's bits, or-ed down through lanes that complete none
  const bool open = out == lead;
  uint32_t pend = acc;
  if (__any_sync(kFull, open && lane > 0)) {
    bool start = !open;  // a segment of the or-scan starts here
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t y = __shfl_up_sync(kFull, pend, d);
      const bool ys = __shfl_up_sync(kFull, start, d);
      if (lane >= d) {
        if (!start) pend |= y;
        start = start || ys;
      }
    }
  }
  const uint32_t ex = __shfl_up_sync(kFull, pend, 1);
  if (!open && lane > 0) *lead |= ex;
  const uint32_t carry = __shfl_sync(kFull, pend, 31);
  const int full = ((st.pos & 31) + tile_bits) >> 5;  // complete words in the row
  const int base = st.pos >> 5;
  uint32_t* const to = dst + base;
  __syncwarp();
  if (st.head >= base && st.head < base + full) {  // the part's head word is in this row
    for (int i = lane; i < full; i += 32) {
      const uint32_t x = stage[i];
      if (base + i == st.head)
        *head = x;
      else
        to[i] = x;
    }
  } else {
    for (int i = lane; i < full; i += 32) to[i] = stage[i];
  }
  st.carry = carry;
  st.pos += tile_bits;
  __syncwarp();  // every lane has read the row before the next tile writes it
}

// Calls fn(words, lo) on the n tiles from the lane's word lo0 down, its
// loads kPcAhead tiles ahead.
template <int G, typename Fn>
__device__ __forceinline__ void pc_walk(const uint32_t* src, int seg_words, int lo0, int n,
                                        Fn&& fn) {
  constexpr int kStep = PcTile<G>::kTileWords;
  PcWords<G> ring[kPcAhead];
#pragma unroll
  for (int a = 0; a < kPcAhead; ++a) ring[a] = pc_load<G>(src, seg_words, lo0 - a * kStep);
  for (int i = 0; i < n; i += kPcAhead) {
#pragma unroll
    for (int a = 0; a < kPcAhead; ++a) {
      if (i + a >= n) break;
      const int lo = lo0 - (i + a) * kStep;
      const PcWords<G> v = ring[a];
      ring[a] = pc_load<G>(src, seg_words, lo - kPcAhead * kStep);
      fn(v, lo);
    }
  }
}

// A block holds max(parts, 8) warps: parts consecutive warps a stream.
// Part p of a stream codes the p-th of `parts` runs of the stream's tiles
// (bitstream order: part 0 holds the highest addresses).  (a) Each warp
// sums its part's code lengths (table lookups only), holding up to kPcKeep
// tiles in registers; (b) a warp's first bit is the sum over the parts
// before it; (c) each warp codes its part from that bit; then the words
// that parts share are finished: each part's head word (or-ed with the
// earlier parts' bits in it) and the stream's last word with the sentinel.
// With one part a stream, (a) and (b) are skipped.
template <int G>
__global__ void __launch_bounds__(32 * kPcMaxParts) huf_pc_split_kernel(
    const uint32_t* __restrict__ planes,
    const int64_t* __restrict__ streams,
    const uint16_t* __restrict__ tables,
    int n_streams, int seg_words, int row_words, int parts,
    uint32_t* __restrict__ rows,
    int32_t* __restrict__ total_bits) {
  __shared__ __align__(1024) uint32_t tbl[2][256];
  extern __shared__ uint32_t smem[];  // staging rows, then the parts' slots
  const int nw = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int s0 = blockIdx.x * (nw / parts);
  const int c0 = s0 >> 2;  // the block's first cell: its streams take <= 2 tables
  const int s_last = min(s0 + nw / parts, n_streams) - 1;
  using T = PcTile<G>;
  uint32_t* stage = smem + warp * T::kStage;
  uint32_t* slot = smem + nw * T::kStage;  // [nw][kPcSlots]
  for (int i = threadIdx.x; i < ((s_last >> 2) - c0 + 1) * 256; i += blockDim.x)
    tbl[0][i] = pc_entry(__ldg(tables + (int64_t)c0 * 256 + i));
  __syncthreads();
  const int s = s0 + warp / parts;
  const int p = warp % parts;
  const bool live = s < n_streams;
  const uint32_t* src = planes + (live ? streams[s] : 0);
  const uint32_t t = (uint32_t)__cvta_generic_to_shared(tbl[((s >> 2) - c0) & 1]);
  // tiles end at `top`, the first 16-byte boundary at or above the
  // segment's end, and run down from there
  const int pad = (int)(((uintptr_t)(src + seg_words) >> 2) & 3);
  const int top = seg_words + (pad ? 4 - pad : 0);
  const int n_tiles = (top + T::kTileWords - 1) / T::kTileWords;
  const int t0 = (int)((int64_t)p * n_tiles / parts);
  const int n = (int)((int64_t)(p + 1) * n_tiles / parts) - t0;
  const int lo0 = top - T::kWords * (lane + 1) - t0 * T::kTileWords;
  PcWords<G> keep[kPcKeep];
  int first = 0;
  if (parts > 1) {
    int bits = 0;
    if (live && n <= kPcKeep) {
#pragma unroll
      for (int i = 0; i < kPcKeep; ++i) {
        if (i < n) {
          keep[i] = pc_load<G>(src, seg_words, lo0 - i * T::kTileWords);
          bits += pc_bits<G>(keep[i], lo0 - i * T::kTileWords, seg_words, t);
        }
      }
    } else if (live) {
      pc_walk<G>(src, seg_words, lo0, n,
                 [&](const PcWords<G>& v, int lo) { bits += pc_bits<G>(v, lo, seg_words, t); });
    }
    bits = __reduce_add_sync(kFull, bits);
    if (lane == 0) slot[warp * kPcSlots] = (uint32_t)bits;
    __syncthreads();
    first = __reduce_add_sync(kFull, lane < p ? (int)slot[(warp - p + lane) * kPcSlots] : 0);
  }
  uint32_t* my = slot + warp * kPcSlots;
  PcPart st{0u, first, first >> 5, 0u};
  uint32_t* dst = rows + (int64_t)s * row_words;
  if (live) {
    if (parts > 1 && n <= kPcKeep) {
#pragma unroll
      for (int i = 0; i < kPcKeep; ++i)
        if (i < n)
          pc_code_tile<G>(keep[i], lo0 - i * T::kTileWords, seg_words, t, dst, stage,
                          my + 2, lane, st);
    } else {
      pc_walk<G>(src, seg_words, lo0, n, [&](const PcWords<G>& v, int lo) {
        pc_code_tile<G>(v, lo, seg_words, t, dst, stage, my + 2, lane, st);
      });
    }
  }
  const uint32_t bad = __any_sync(kFull, st.bad != 0);
  if (lane == 0) {
    my[1] = (uint32_t)st.pos;
    my[3] = st.carry;
    my[4] = bad;
  }
  __syncthreads();
  if (!live || lane != 0) return;
  const uint32_t* part0 = slot + (warp - p) * kPcSlots;
  const int e = st.pos;
  if ((e >> 5) > (first >> 5)) {  // the part completed its head word
    uint32_t x = my[2];
    for (int q = p - 1; q >= 0 && (int)(part0[q * kPcSlots + 1] >> 5) == first >> 5; --q)
      x |= part0[q * kPcSlots + 3];
    dst[first >> 5] = x;
  }
  if (p == parts - 1) {  // the stream's last word: the parts' bits in it and the sentinel
    uint32_t x = 1u << (e & 31);
    uint32_t any_bad = 0;
    for (int q = p; q >= 0; --q) {
      any_bad |= part0[q * kPcSlots + 4];
      if ((int)(part0[q * kPcSlots + 1] >> 5) == e >> 5) x |= part0[q * kPcSlots + 3];
    }
    dst[e >> 5] = x;
    total_bits[s] = (int32_t)(e + 1) | (int32_t)(any_bad << 30);
  }
}

// The arguments both entries take: CB bits per symbol plus the sentinel
// must fit the row and stay below bit 30 of total_bits.
bool bad_args(int code_bits, int seg_words, int row_words, int group) {
  const int64_t most = (int64_t)seg_words * 4 * code_bits + 1;
  return seg_words < 0 || most >= (1 << 30) || (int64_t)row_words * 32 < most ||
         (group != 1 && group != 32);
}

}  // namespace

extern "C" int huf_shared_encode(const void* planes, const void* streams,
                                 const void* table, int n_streams,
                                 int seg_words, int row_words, int group,
                                 void* rows, void* total_bits, void* stream) {
  if (n_streams <= 0) return 0;
  if (bad_args(8, seg_words, row_words, group)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (group == 1) {
    huf_encode_warps_kernel<8><<<(n_streams + kWarps - 1) / kWarps, 32 * kWarps, 0, st>>>(
        (const uint32_t*)planes, (const int64_t*)streams, (const uint16_t*)table, n_streams,
        seg_words, row_words, (uint32_t*)rows, (int32_t*)total_bits);
  } else {
    huf_encode_lanes_kernel<8, false>
        <<<(n_streams + kLaneThreads - 1) / kLaneThreads, kLaneThreads, 0, st>>>(
            (const uint32_t*)planes, (const int64_t*)streams, (const uint16_t*)table,
            n_streams, seg_words, row_words, (uint32_t*)rows, (int32_t*)total_bits);
  }
  return (int)cudaGetLastError();
}

// `parts` (1, 2, 4, 8 or 16): the warps each stream takes under `group` 1.
extern "C" int huf_pc_encode(const void* planes, const void* streams,
                             const void* tables, int n_streams,
                             int seg_words, int row_words, int group, int parts,
                             void* rows, void* total_bits, void* stream) {
  if (n_streams <= 0) return 0;
  if (bad_args(12, seg_words, row_words, group) || parts < 1 || parts > kPcMaxParts ||
      (parts & (parts - 1)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (group == 1) {
    const int nw = max(parts, kPcMinWarps);
    const int per_block = nw / parts;
    const int grid = (n_streams + per_block - 1) / per_block;
    const auto* src = (const uint32_t*)planes;
    const auto* at = (const int64_t*)streams;
    const auto* tbl = (const uint16_t*)tables;
    if (4 * seg_words >= kPcLongSymbols)
      huf_pc_split_kernel<2><<<grid, 32 * nw, 4 * nw * (PcTile<2>::kStage + kPcSlots), st>>>(
          src, at, tbl, n_streams, seg_words, row_words, parts, (uint32_t*)rows,
          (int32_t*)total_bits);
    else
      huf_pc_split_kernel<1><<<grid, 32 * nw, 4 * nw * (PcTile<1>::kStage + kPcSlots), st>>>(
          src, at, tbl, n_streams, seg_words, row_words, parts, (uint32_t*)rows,
          (int32_t*)total_bits);
  } else {
    huf_encode_lanes_kernel<12, true>
        <<<(n_streams + kLaneThreads - 1) / kLaneThreads, kLaneThreads, 0, st>>>(
            (const uint32_t*)planes, (const int64_t*)streams, (const uint16_t*)tables,
            n_streams, seg_words, row_words, (uint32_t*)rows, (int32_t*)total_bits);
  }
  return (int)cudaGetLastError();
}
