// Warp-per-stream, self-synchronising decode of one backward HUF bitstream:
// the device core of K1 (huf_pc.cu) and K6 (huf_shared.cu).
//
// The serial chain of a stream (peek the tl bits below the cursor, zeros
// below bit 0; look the entry up; retreat by its nb) has one step per
// symbol and nothing to overlap it with, so one thread per stream leaves
// an SM with ~2 warps and the kernel runs at the chain's latency.  A
// Huffman bitstream synchronises itself: a decoder started at an
// arbitrary bit falls onto the true codeword boundaries within a few
// dozen symbols (Weissenberger & Schmidt, ICPP 2018).  So one warp decodes
// one stream, its bits cut into L <= lanes sub-segments from the top:
//
//   A  each lane steps from the top of its sub-segment (lane 0 from bits0)
//      until its cursor is at or below the sub-segment's lower edge, and
//      keeps its step count c and exit position x;
//   B  while some lane's start is not its left neighbour's exit, each such
//      lane restarts there, walking its new and its old path together
//      (always advancing the higher cursor): where they meet, the old
//      path's remaining count and exit hold.  A pass fixes at least the
//      first unsynchronised lane, so at most L passes run;
//   C  an exclusive warp scan of c gives each lane its first output index;
//      each lane re-decodes its range.  Symbols go to a 32-byte staging
//      row per lane in shared memory, one row per 32-byte aligned piece of
//      the lane's output, and the warp stores four rows at a time, eight
//      lanes to a row: whole 32-byte sectors, where one lane per row would
//      store 4 bytes into each of 32 sectors.  A word that holds bytes
//      outside the row's range (a neighbour lane's) is stored byte by byte.
//
// A launch of short streams (streams per warp `group` = 32, which the host
// picks from the launch's mean stream length) gives each lane a stream of
// its own instead, decoded by the serial chain (decode_lane): a stream of
// a few hundred symbols has a few sub-segments, and a warp on it would
// leave most lanes idle.
//
// Exactly the serial chain's function, for any input: if the counts sum to
// less than n (a corrupt stream ran past bit 0), the chain would read
// entry 0 from then on, so the rest are entry 0's symbol and bits_left
// falls by its nb each.  A lane that takes `seg` steps (2 * seg in a merge
// walk) while still above its lower edge has met an entry with nb == 0;
// its stream is then decoded by the serial chain in lane 0, inside the
// kernel.  zipnn_tpu_torch/ops/huf_sync.py models this schedule on
// tensors; the tests hold the model against the serial chain.
//
// Stream bits are read through a window of two aligned 32-bit words that
// slides down one word at a time, with the word below it loaded one slide
// ahead, so a lane never waits on a load that the lane beside it started.
// A word that straddles the stream's ends is assembled from single bytes,
// masked, so no byte outside [src, src + len) is read, whatever the input.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace hufdec {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowStride = 36;  // staging row: 32 bytes, 9 words (distinct banks)
constexpr int kStageBytes = 32 * kRowStride;  // one warp's staging rows

// The bytes [0, len) of one stream.  Bit positions are taken in "word
// coordinates": Q = q + 8 * a0, counted from the aligned word that holds
// stream byte 0 (a0 = its misalignment).
struct Reader {
  const uint8_t* src;
  int lim;  // len - 4: the last byte offset of a whole word in the stream
  int a0;

  __device__ __forceinline__ Reader(const uint8_t* s, int len)
      : src(s), lim(len - 4), a0((int)((uintptr_t)s & 3)) {}

  // The 4 stream bytes [r, r + 4) (r = 4k - a0: an aligned word), 0 outside.
  __device__ __forceinline__ uint32_t load(int r) const {
    if (r >= 0 && r <= lim)
      return __ldg(reinterpret_cast<const uint32_t*>(src + r));
    uint32_t v = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = r + j;
      if (p >= 0 && p < lim + 4) v |= (uint32_t)__ldg(src + p) << (8 * j);
    }
    return v;
  }
};

// Bits [floor - tl, floor - tl + 64) in word coordinates (lo | hi << 32),
// floor - tl a multiple of 32, and the word below them (nxt, at stream byte
// nr), loaded ahead.  A peek at Q needs floor <= Q < floor + 32.
struct Window {
  uint32_t lo, hi, nxt;
  int floor, nr;
};

// The window for a peek at Q.
__device__ __forceinline__ void seek(Window& w, const Reader& rd, int Q,
                                     int tl) {
  const int k = (Q - tl) >> 5;
  w.floor = 32 * k + tl;
  w.nr = 4 * (k - 1) - rd.a0;
  w.lo = rd.load(w.nr + 4);
  w.hi = rd.load(w.nr + 8);
  w.nxt = rd.load(w.nr);
}

// The tl bits below Q (Q > 8 * a0, i.e. cursor q > 0), zeros below bit 0.
__device__ __forceinline__ uint32_t peek(Window& w, const Reader& rd, int Q,
                                         uint32_t mask) {
  while (Q < w.floor) {
    w.hi = w.lo;
    w.lo = w.nxt;
    w.floor -= 32;
    w.nr -= 4;
    w.nxt = rd.load(w.nr);
  }
  return __funnelshift_r(w.lo, w.hi, (uint32_t)(Q - w.floor)) & mask;
}

// Table entries are pair entries: bits 0-15 hold the entry of the peek
// (sym | nb << 8), bits 16-31 the entry of the next symbol when its code
// lies inside the same tl-bit peek, else 0 (see build_pairs).

// One step at Q: returns the entry (sym | nb << 8), retreats Q by its nb.
// Serial steps may run at Q <= zero (cursor q <= 0), where the chain reads
// entry 0.
template <bool kSerial, class Table>
__device__ __forceinline__ uint32_t step(Window& w, const Reader& rd,
                                         const Table& tab, uint32_t mask,
                                         int zero, int& Q) {
  uint32_t idx;
  if (kSerial && Q <= zero) {
    idx = 0;
  } else {
    idx = peek(w, rd, Q, mask);
  }
  const uint32_t e = tab(idx) & 0xFFFFu;
  Q -= (int)(e >> 8);
  return e;
}

// One or two symbols at Q: returns the pair entry, retreats Q by the bits
// both consume.
template <class Table>
__device__ __forceinline__ uint32_t step2(Window& w, const Reader& rd,
                                          const Table& tab, uint32_t mask,
                                          int& Q) {
  const uint32_t e = tab(peek(w, rd, Q, mask));
  Q -= (int)(((e >> 8) & 0xFFu) + (e >> 24));
  return e;
}

// Pair entries D[0, 2^tl) of the tl-bit table T (sym | nb << 8), built by
// the whole block.  Two symbols pair only in a canonical table (every
// entry fills the aligned block of 2^(tl - nb) indices that share its top
// nb bits, 1 <= nb <= tl), where the code below a code of nb1 bits is then
// read from the peek shifted up by nb1 whenever both fit in tl bits; in
// any other table no entry pairs, so every table decodes exactly.
__device__ __forceinline__ void build_pairs(const uint16_t* __restrict__ T,
                                            int tl, uint32_t* D) {
  const uint32_t size = 1u << tl;
  bool canonical = true;
  for (uint32_t y = threadIdx.x; y < size; y += blockDim.x) {
    const uint32_t e = __ldg(T + y);
    const int nb = (int)(e >> 8);
    canonical = canonical && nb >= 1 && nb <= tl &&
                __ldg(T + (y & ~((1u << (tl - nb)) - 1u))) == e;
  }
  canonical = __syncthreads_and(canonical);
  for (uint32_t x = threadIdx.x; x < size; x += blockDim.x) {
    const uint32_t e = __ldg(T + x);
    uint32_t d = e;
    if (canonical) {
      const int nb1 = (int)(e >> 8);
      const uint32_t e2 = __ldg(T + ((x << nb1) & (size - 1u)));
      if (nb1 + (int)(e2 >> 8) <= tl) d |= e2 << 16;
    }
    D[x] = d;
  }
  __syncthreads();
}

// The serial chain from Q: n symbols into p[0, n), bytes up to a 4-byte
// aligned address, then four symbols per 32-bit store, then bytes.
// Returns the cursor after them.
template <class Table>
__device__ __noinline__ int serial_chain(const Reader rd, const Table tab,
                                         int tl, int Q, uint8_t* p, int n) {
  const int zero = 8 * rd.a0;
  const uint32_t mask = (1u << tl) - 1u;
  Window w;
  if (Q > zero) seek(w, rd, Q, tl);
  int head = (int)((4u - ((uint32_t)(uintptr_t)p & 3u)) & 3u);
  head = head < n ? head : n;
  int k = 0;
  for (; k < head; ++k) p[k] = (uint8_t)step<true>(w, rd, tab, mask, zero, Q);
  for (; k + 4 <= n; k += 4) {
    uint32_t v = step<true>(w, rd, tab, mask, zero, Q) & 0xFFu;
    v |= (step<true>(w, rd, tab, mask, zero, Q) & 0xFFu) << 8;
    v |= (step<true>(w, rd, tab, mask, zero, Q) & 0xFFu) << 16;
    v |= (step<true>(w, rd, tab, mask, zero, Q) & 0xFFu) << 24;
    *reinterpret_cast<uint32_t*>(p + k) = v;
  }
  for (; k < n; ++k) p[k] = (uint8_t)step<true>(w, rd, tab, mask, zero, Q);
  return Q;
}

// Decode one stream with the calling lane alone, by the serial chain: the
// schedule for launches of short streams, whose few sub-segments would
// leave most of a warp idle.  Writes n symbols at dst, *bits_left and
// *passes (0: no synchronisation).
template <class Table>
__device__ __forceinline__ void decode_lane(const uint8_t* src, int len,
                                            int b0, int n, uint8_t* dst,
                                            const Table& tab, int tl,
                                            int32_t* bits_left,
                                            int32_t* passes) {
  const Reader rd(src, len);
  const int zero = 8 * rd.a0;
  *bits_left = serial_chain(rd, tab, tl, zero + b0, dst, n) - zero;
  *passes = 0;
}

// Decode one stream with the calling warp (all 32 lanes must call).
// `tab(i)` returns pair entry i of a tl-bit table (build_pairs); `stage`
// is the warp's kStageBytes of shared memory.  Writes n symbols at dst,
// *bits_left and *passes (the synchronisation passes in which some lane
// re-decoded; -1 if the serial chain ran).
template <class Table>
__device__ __forceinline__ void decode_warp(
    const uint8_t* src, int len, int b0, int n, uint8_t* dst,
    const Table& tab, int tl, int lanes, int min_seg_bits, uint8_t* stage,
    int32_t* bits_left, int32_t* passes) {
  const int lane = threadIdx.x & 31;
  const Reader rd(src, len);
  const int zero = 8 * rd.a0;  // bit 0 of the stream, in word coordinates
  const uint32_t mask = (1u << tl) - 1u;
  Window w;
  int L = b0 / min_seg_bits;
  L = L < 1 ? 1 : (L > lanes ? lanes : L);
  const int seg = b0 > 0 ? (b0 + L - 1) / L : 0;
  const bool valid = lane < L;
  // lane i owns (lo, start]: cursor positions, in word coordinates
  int start = zero + (lane == 0 ? b0 : b0 - lane * seg);
  int lo = zero;
  if (lane + 1 < L) lo += max(b0 - (lane + 1) * seg, 0);

  // A: speculative count
  int Q = start;
  int c = 0;
  if (valid && Q > lo) {
    seek(w, rd, Q, tl);
    // a paired symbol starts less than tl bits below Q: above lo
    while (Q - lo > tl && c < seg) {
      c += 1 + (step2(w, rd, tab, mask, Q) >= (1u << 24));
    }
    while (Q > lo && c < seg) {
      step<false>(w, rd, tab, mask, zero, Q);
      ++c;
    }
  }
  int x = Q;
  bool stuck = __any_sync(kFull, valid && Q > lo);

  // B: synchronisation
  int npass = 0;
  for (int r = 0; r < 32 && !stuck; ++r) {
    int xprev = __shfl_up_sync(kFull, x, 1);
    if (lane == 0) xprev = start;
    const bool need = valid && lane > 0 && start != xprev;
    if (!__any_sync(kFull, need)) break;
    ++npass;
    bool st = false;
    if (need) {
      int a = start, b = xprev, na = 0, nn = 0;
      if (a != b && max(a, b) > lo) {
        seek(w, rd, max(a, b), tl);
        while (a != b && max(a, b) > lo && na + nn < 2 * seg) {
          if (a > b) {
            step<false>(w, rd, tab, mask, zero, a);
            ++na;
          } else {
            step<false>(w, rd, tab, mask, zero, b);
            ++nn;
          }
        }
      }
      st = a != b && max(a, b) > lo;
      const bool met = a == b;
      c = met ? nn + c - na : nn;
      x = met ? x : b;
      start = xprev;
    }
    stuck = __any_sync(kFull, st);
  }

  if (stuck) {
    // an nb == 0 step: the serial chain, in lane 0
    if (lane == 0) {
      *bits_left = serial_chain(rd, tab, tl, zero + b0, dst, n) - zero;
      *passes = -1;
    }
    return;
  }

  // C: write at prefix-sum offsets
  const int cc = valid ? c : 0;
  int incl = cc;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += v;
  }
  const int o = incl - cc;
  const int total = __shfl_sync(kFull, incl, 31);
  const int x_last = __shfl_sync(kFull, x, L - 1) - zero;
  int m = n - o;
  m = m < 0 ? 0 : (m > cc ? cc : m);
  // this lane's output [off, off + m), counted from the 32-byte aligned
  // address at or below dst, in rows of 32 bytes
  const int a32 = (int)((uintptr_t)dst & 31);
  uint8_t* base = dst - a32;
  const int off = a32 + o;
  const int row0 = off >> 5;
  const int rows = m > 0 ? ((off + m - 1) >> 5) - row0 + 1 : 0;
  uint8_t* mine = stage + lane * kRowStride;
  Q = start;
  if (m > 0) seek(w, rd, Q, tl);
  for (int r = 0; __any_sync(kFull, r < rows); ++r) {
    const int rb = (row0 + r) << 5;
    int span = 0;  // p0 | p1 << 8: this row's bytes [p0, p1)
    if (r < rows) {
      const int p0 = off > rb ? off - rb : 0;
      const int p1 = off + m < rb + 32 ? off + m - rb : 32;
      int p = p0;
      while (p + 1 < p1) {
        const uint32_t e = step2(w, rd, tab, mask, Q);
        mine[p] = (uint8_t)e;
        if (e >= (1u << 24)) mine[++p] = (uint8_t)(e >> 16);
        ++p;
      }
      if (p < p1) mine[p] = (uint8_t)step<false>(w, rd, tab, mask, zero, Q);
      span = p0 | (p1 << 8);
    }
    __syncwarp();
    const int j = 4 * (lane & 7);
#pragma unroll
    for (int it = 0; it < 8; ++it) {
      const int row = 4 * it + (lane >> 3);
      const int rbr = __shfl_sync(kFull, rb, row);
      const int sp = __shfl_sync(kFull, span, row);
      const int p0 = sp & 0xFF, p1 = sp >> 8;
      const uint8_t* from = stage + row * kRowStride;
      if (p0 <= j && j + 4 <= p1) {
        *reinterpret_cast<uint32_t*>(base + rbr + j) =
            *reinterpret_cast<const uint32_t*>(from + j);
      } else {
        for (int b = j > p0 ? j : p0; b < p1 && b < j + 4; ++b)
          base[rbr + b] = from[b];
      }
    }
    __syncwarp();
  }
  if (o < n && n <= o + cc) *bits_left = Q - zero;
  if (total < n) {
    // past bit 0 the chain reads entry 0
    const uint32_t e0 = tab(0) & 0xFFFFu;
    for (int i = total + lane; i < n; i += 32) dst[i] = (uint8_t)e0;
    if (lane == 0)
      *bits_left = (int32_t)((int64_t)x_last -
                             (int64_t)(n - total) * (int64_t)(e0 >> 8));
  }
  if (lane == 0) {
    if (n == 0) *bits_left = b0;
    *passes = npass;
  }
}

}  // namespace hufdec
