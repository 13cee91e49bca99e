// Plane assembly of decoded chunks: fill each (chunk, plane) cell as
// stored, RLE or Huffman, interleave the planes and revert the bf16 or
// fp32 sign rotation, writing the output in place.
//
// Replaces the Pallas kernel zipnn_tpu/ops/pallas_combine.py:249
// (`_combine_call_cached`, K2; `_build_kernel` :49) together with the
// alignment kernel zipnn_tpu/ops/pallas_gather.py:172 (`_align_call_cached`,
// K5), which realigned stored cells for the TPU's (8, 128) tiles before the
// fp32 combine.  Here stored cells are read at any byte offset of the
// payload, so no alignment pass exists.
//
// What bounded the first design (one thread per output word): every word
// divided its index by the chunk's words in 64 bits, then ran four
// iterations of a data-dependent loop, each loading the cell's kind and
// source and then one single byte: ~12 loads and a long integer chain per
// 4 output bytes.  It moved ~0.92 TB/s, 28 % of the card's memory rate.
//
// Design.  One warp assembles one 512-byte tile of one chunk (a 1-D grid
// of (chunk, tile) units, one 32-bit division per warp, so a batch of
// 2 M small chunks fits where gridDim.y would stop at 65 535).  The warp
// loads the chunk's <= 4 cell descriptors once (lanes 0-3, then
// shuffles), so every branch on a cell's kind is uniform across the warp.
// Each lane makes 16 output bytes:
//   1 plane             a 16-byte copy;
//   2 planes, mode 10   8 bytes of each plane, interleaved by __byte_perm
//                       (0x5140, 0x7362), revert_sign_16 on the 4 words;
//   modes 1 and 8       the same with the other plane zero;
//   4 planes, mode 220  4 bytes of each plane, a 4 x 4 byte transpose by
//                       __byte_perm, revert_sign_32;
// and stores them with one 16-byte store.  A cell's bytes are read with
// loads as wide as their alignment allows (one 16-, 8- or 4-byte load),
// else as aligned words funnel-shifted into place: only words holding a
// byte the output needs are loaded, so nothing past the payload's or a
// symbol row's end is touched.  RLE cells splat their byte.  The kernel
// is instantiated once per plane layout, so the layout costs no branch.
//
// The words the vector path cannot take (the ragged end of a chunk, where
// plane b holds q + (b < r) bytes and only chunk_len / 4 words are
// reverted; every word where `out` is not 16-byte aligned, as in chunks
// of a size that is not a multiple of 16) are made by the per-word code of
// the first design (word_at), in the same launch: the same function, word
// by word.  Bytes past the chunk's end are written as zero (the output's
// padding).
//
// Chunks of a size that is not a multiple of 4 (1 and 2 bytes: such cells
// are stored or RLE, never Huffman, as a HUF block under 12 bytes is never
// written) start off word boundaries, so a word of `out` may hold bytes of
// several chunks.  They take a second kernel, a thread per output byte,
// which keeps that byte of the chunk's word_at: the same function, byte
// by byte.
//
// What bounds it now: bytes.  Each output byte reads one plane byte (none
// for RLE cells), so the least traffic is the plane bytes read once and
// the output written once; per 512 output bytes a warp issues two to four
// coalesced loads and one coalesced store, and per lane a handful of
// byte permutes.  It reaches ~75 % of the 3.35 TB/s rate on the 512 MiB
// batches.  ptxas: 20-31 registers over the four layouts, no spills, so
// 64 warps an SM (chip_smoke.py phase 1 prints them).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;         // warps per block
constexpr int kVec = 16;          // output bytes per lane
constexpr int kTile = 32 * kVec;  // output bytes per warp

// plane layouts of byte_group.combine
enum Layout { kOne, kTwo, kKeep, kFour };  // 1 plane; mode 10; modes 1/8; mode 220

template <int L>
__host__ __device__ constexpr int planes_of() { return L == kOne ? 1 : L == kFour ? 4 : 2; }

__device__ __forceinline__ uint32_t revert_sign_16(uint32_t w) {
  const uint32_t sign = (w << 8) & 0x80008000u;
  const uint32_t exp = (w >> 1) & 0x7F807F80u;
  const uint32_t man = w & 0x007F007Fu;
  return sign | exp | man;
}

__device__ __forceinline__ uint32_t revert_sign_32(uint32_t w) {
  const uint32_t sign = (w << 8) & 0x80000000u;
  const uint32_t exp = (w >> 1) & 0x7F800000u;
  const uint32_t man = w & 0x007FFFFFu;
  return sign | exp | man;
}

// One chunk's cells (kind 0 stored, 1 RLE, 2 Huffman), the same in every
// lane of the warp.
template <int NB>
struct Cells {
  int kind[NB];
  int64_t src[NB];
};

struct Bufs {
  const uint8_t* payload;
  const uint8_t* hsym;
  int64_t hsym_row;

  // first byte of a stored or Huffman cell
  __device__ __forceinline__ const uint8_t* cell(int kind, int64_t src) const {
    return kind == 0 ? payload + src : hsym + src * hsym_row;
  }
};

// byte_group.plane_lengths: bytes of plane b in a chunk of chunk_len bytes
template <int L>
__device__ __forceinline__ int plane_len(int chunk_len, int b) {
  if constexpr (L == kOne) {
    return chunk_len;
  } else if constexpr (L == kKeep) {
    return b ? 0 : chunk_len >> 1;
  } else {
    constexpr int nb = planes_of<L>();
    return chunk_len / nb + (b < (chunk_len & (nb - 1)) ? 1 : 0);
  }
}

// Output word j of a chunk of chunk_len bytes, byte by byte (the first
// design's per-word code).
template <int L>
__device__ uint32_t word_at(const Cells<planes_of<L>()>& d, const Bufs& bufs,
                            int j, int chunk_len, int keep, int bit_reorder) {
  uint32_t w = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int p = 4 * j + q;  // byte within the chunk
    int b, i;
    if constexpr (L == kOne) {
      b = 0;
      i = p;
    } else if constexpr (L == kFour) {
      b = q;
      i = p >> 2;
    } else if constexpr (L == kTwo) {
      b = q & 1;
      i = p >> 1;
    } else {
      // mode 1 keeps the even (low) bytes in plane 0, mode 8 the odd ones
      if ((q & 1) != keep) continue;
      b = 0;
      i = p >> 1;
    }
    if (p >= chunk_len || i >= plane_len<L>(chunk_len, b)) continue;
    const uint32_t v = d.kind[b] == 1 ? (uint32_t)d.src[b] & 0xFFu
                                      : __ldg(bufs.cell(d.kind[b], d.src[b]) + i);
    w |= v << (8 * q);
  }
  if (bit_reorder && j < (chunk_len >> 2)) {
    if constexpr (L == kTwo || L == kKeep) w = revert_sign_16(w);
    if constexpr (L == kFour) w = revert_sign_32(w);
  }
  return w;
}

// N (4, 8 or 16) bytes of a cell from its byte i0 on, as N / 4 words.
template <int N>
__device__ __forceinline__ void fetch(int kind, int64_t src, const Bufs& bufs,
                                      int i0, uint32_t (&w)[N / 4]) {
  if (kind == 1) {
#pragma unroll
    for (int k = 0; k < N / 4; ++k) w[k] = 0x01010101u * ((uint32_t)src & 0xFFu);
    return;
  }
  const uint8_t* p = bufs.cell(kind, src) + i0;
  const uintptr_t a = (uintptr_t)p;
  if ((a & (N - 1)) == 0) {
    if constexpr (N == 16) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
      w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
    } else if constexpr (N == 8) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = v.x, w[1] = v.y;
    } else {
      w[0] = __ldg(reinterpret_cast<const uint32_t*>(p));
    }
    return;
  }
  const int sh = (int)(a & 3);
  const uint32_t* q = reinterpret_cast<const uint32_t*>(a - sh);
  uint32_t x[N / 4 + 1];
#pragma unroll
  for (int k = 0; k < N / 4; ++k) x[k] = __ldg(q + k);
  if (sh) {
    x[N / 4] = __ldg(q + N / 4);
#pragma unroll
    for (int k = 0; k < N / 4; ++k) w[k] = __funnelshift_r(x[k], x[k + 1], 8 * sh);
  } else {
#pragma unroll
    for (int k = 0; k < N / 4; ++k) w[k] = x[k];
  }
}

// The 16 output bytes from chunk byte p0 (a multiple of 16; all 16 lie in
// the chunk's whole words).
template <int L>
__device__ __forceinline__ uint4 group16(const Cells<planes_of<L>()>& d,
                                         const Bufs& bufs, int p0, int keep,
                                         int bit_reorder) {
  uint32_t o[4];
  if constexpr (L == kOne) {
    fetch<16>(d.kind[0], d.src[0], bufs, p0, o);
  } else if constexpr (L == kFour) {
    uint32_t p[4][1];
#pragma unroll
    for (int b = 0; b < 4; ++b) fetch<4>(d.kind[b], d.src[b], bufs, p0 >> 2, p[b]);
    // word j takes byte j of each plane
    const uint32_t lo01 = __byte_perm(p[0][0], p[1][0], 0x5140);
    const uint32_t lo23 = __byte_perm(p[2][0], p[3][0], 0x5140);
    const uint32_t hi01 = __byte_perm(p[0][0], p[1][0], 0x7362);
    const uint32_t hi23 = __byte_perm(p[2][0], p[3][0], 0x7362);
    o[0] = __byte_perm(lo01, lo23, 0x5410);
    o[1] = __byte_perm(lo01, lo23, 0x7632);
    o[2] = __byte_perm(hi01, hi23, 0x5410);
    o[3] = __byte_perm(hi01, hi23, 0x7632);
    if (bit_reorder) {
#pragma unroll
      for (int k = 0; k < 4; ++k) o[k] = revert_sign_32(o[k]);
    }
  } else {
    uint32_t a[2], b[2];
    fetch<8>(d.kind[0], d.src[0], bufs, p0 >> 1, a);
    if constexpr (L == kTwo) {
      fetch<8>(d.kind[1], d.src[1], bufs, p0 >> 1, b);
    } else {
      b[0] = b[1] = 0u;
      if (keep) {  // mode 8: plane 0 in the odd bytes
#pragma unroll
        for (int k = 0; k < 2; ++k) b[k] = a[k], a[k] = 0u;
      }
    }
    o[0] = __byte_perm(a[0], b[0], 0x5140);
    o[1] = __byte_perm(a[0], b[0], 0x7362);
    o[2] = __byte_perm(a[1], b[1], 0x5140);
    o[3] = __byte_perm(a[1], b[1], 0x7362);
    if (bit_reorder) {
#pragma unroll
      for (int k = 0; k < 4; ++k) o[k] = revert_sign_16(o[k]);
    }
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// One warp's 512-byte tile of chunk c, whose chunk_len bytes start at byte
// `base` of `out`: lane `lane` assembles the 16 bytes from p0 (the padding
// of a ragged last chunk up to its next word is zero).
template <int L>
__device__ __forceinline__ void combine_tile(
    const Bufs& bufs,
    const int32_t* __restrict__ kinds,
    const int64_t* __restrict__ srcs,
    uint32_t c,
    int lane,
    int p0,
    int64_t base,
    int chunk_len,
    int keep,
    int bit_reorder,
    uint8_t* __restrict__ out) {
  constexpr int NB = planes_of<L>();
  int kind = 0;
  int64_t src = 0;
  if (lane < NB) {
    kind = __ldg(kinds + (int64_t)c * NB + lane);
    src = __ldg(srcs + (int64_t)c * NB + lane);
  }
  Cells<NB> d;
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    d.kind[b] = __shfl_sync(kFull, kind, b);
    d.src[b] = __shfl_sync(kFull, src, b);
  }
  if (p0 >= chunk_len) return;
  uint8_t* dst = out + base + p0;
  if (p0 + kVec <= (chunk_len & ~(kVec - 1)) && ((uintptr_t)dst & 15) == 0) {
    *reinterpret_cast<uint4*>(dst) = group16<L>(d, bufs, p0, keep, bit_reorder);
    return;
  }
#pragma unroll
  for (int k = 0; k < kVec / 4; ++k) {
    const int j = (p0 >> 2) + k;
    if (4 * j >= chunk_len) break;
    reinterpret_cast<uint32_t*>(dst)[k] = word_at<L>(d, bufs, j, chunk_len, keep, bit_reorder);
  }
}

template <int L>
__global__ void __launch_bounds__(32 * kWarps) combine_cells_kernel(
    Bufs bufs,
    const int32_t* __restrict__ kinds,
    const int64_t* __restrict__ srcs,
    int chunk_size,
    int64_t total_bytes,
    uint32_t tiles,    // tiles per chunk
    uint32_t n_units,  // chunks * tiles
    int keep,
    int bit_reorder,
    uint8_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const uint32_t u = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (u >= n_units) return;  // the whole warp
  const uint32_t c = u / tiles;
  const int p0 = (int)(u - c * tiles) * kTile + lane * kVec;
  const int64_t base = (int64_t)c * chunk_size;
  const int64_t rem = total_bytes - base;
  combine_tile<L>(bufs, kinds, srcs, c, lane, p0, base,
                  rem < chunk_size ? (int)rem : chunk_size, keep, bit_reorder, out);
}

// The grouped instance: the chunks of many containers of one geometry (a
// launch set of ops/decode.py) in one launch.  Chunk c holds
// chunk_lens[c] <= chunk_size bytes from byte chunk_offs[c] of `out` (a
// multiple of 4); its tiles are combine_cells_kernel's, so each
// container's ragged last chunk is zero-padded to its next word.
template <int L>
__global__ void __launch_bounds__(32 * kWarps) combine_cells_grouped_kernel(
    Bufs bufs,
    const int32_t* __restrict__ kinds,
    const int64_t* __restrict__ srcs,
    const int64_t* __restrict__ chunk_offs,
    const int32_t* __restrict__ chunk_lens,
    uint32_t tiles,    // tiles per chunk of chunk_size bytes
    uint32_t n_units,  // chunks * tiles
    int keep,
    int bit_reorder,
    uint8_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const uint32_t u = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (u >= n_units) return;  // the whole warp
  const uint32_t c = u / tiles;
  const int p0 = (int)(u - c * tiles) * kTile + lane * kVec;
  combine_tile<L>(bufs, kinds, srcs, c, lane, p0, __ldg(chunk_offs + c),
                  __ldg(chunk_lens + c), keep, bit_reorder, out);
}

// A thread per output byte (chunks off word boundaries): byte p & 3 of
// word p >> 2 of its chunk; the padding up to the next word is zero.
template <int L>
__global__ void __launch_bounds__(32 * kWarps) combine_bytes_kernel(
    Bufs bufs,
    const int32_t* __restrict__ kinds,
    const int64_t* __restrict__ srcs,
    int chunk_size,
    int64_t total_bytes,
    int64_t n_out,  // total_bytes rounded up to a word
    int keep,
    int bit_reorder,
    uint8_t* __restrict__ out) {
  constexpr int NB = planes_of<L>();
  const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n_out) return;
  if (g >= total_bytes) {
    out[g] = 0;
    return;
  }
  const int64_t c = g / chunk_size;
  const int p = (int)(g - c * chunk_size);
  const int64_t rem = total_bytes - c * chunk_size;
  const int chunk_len = rem < chunk_size ? (int)rem : chunk_size;
  Cells<NB> d;
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    d.kind[b] = __ldg(kinds + c * NB + b);
    d.src[b] = __ldg(srcs + c * NB + b);
  }
  const uint32_t w = word_at<L>(d, bufs, p >> 2, chunk_len, keep, bit_reorder);
  out[g] = (uint8_t)(w >> (8 * (p & 3)));
}

}  // namespace

extern "C" int combine_cells(
    const void* payload, const void* hsym, const void* kinds,
    const void* srcs, long long hsym_row, long long chunk_size,
    long long total_bytes, int num_buf, int byte_reorder, int bit_reorder,
    void* out, void* stream) {
  if (total_bytes <= 0) return 0;
  if (chunk_size <= 0 || chunk_size >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const long long n_chunks = (total_bytes + chunk_size - 1) / chunk_size;
  const long long tiles = (chunk_size + kTile - 1) / kTile;
  const long long units = n_chunks * tiles;
  const long long n_out = (total_bytes + 3) & ~3LL;
  const bool bytewise = chunk_size % 4 != 0;
  if (bytewise ? n_out / (32 * kWarps) >= (1LL << 31) - 1 : units >= (1LL << 32) - kWarps)
    return (int)cudaErrorInvalidValue;
  const unsigned int blocks = bytewise
      ? (unsigned int)((n_out + 32 * kWarps - 1) / (32 * kWarps))
      : (unsigned int)((units + kWarps - 1) / kWarps);
  const Bufs bufs{(const uint8_t*)payload, (const uint8_t*)hsym, (int64_t)hsym_row};
  const int keep = byte_reorder == 8;
  cudaStream_t st = (cudaStream_t)stream;
#define ZIPNN_COMBINE(L)                                                         \
  if (bytewise)                                                                \
    combine_bytes_kernel<L><<<blocks, 32 * kWarps, 0, st>>>(                   \
        bufs, (const int32_t*)kinds, (const int64_t*)srcs, (int)chunk_size,    \
        (int64_t)total_bytes, (int64_t)n_out, keep, bit_reorder, (uint8_t*)out); \
  else                                                                         \
    combine_cells_kernel<L><<<blocks, 32 * kWarps, 0, st>>>(                   \
        bufs, (const int32_t*)kinds, (const int64_t*)srcs, (int)chunk_size,    \
        (int64_t)total_bytes, (uint32_t)tiles, (uint32_t)units, keep,          \
        bit_reorder, (uint8_t*)out)
  if (num_buf == 1) {
    ZIPNN_COMBINE(kOne);
  } else if (num_buf == 2 && byte_reorder == 10) {
    ZIPNN_COMBINE(kTwo);
  } else if (num_buf == 2) {
    ZIPNN_COMBINE(kKeep);
  } else if (num_buf == 4) {
    ZIPNN_COMBINE(kFour);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef ZIPNN_COMBINE
  return (int)cudaGetLastError();
}

extern "C" int combine_cells_grouped(
    const void* payload, const void* hsym, const void* kinds,
    const void* srcs, const void* chunk_offs, const void* chunk_lens,
    long long n_chunks, long long chunk_size, long long hsym_row, int num_buf,
    int byte_reorder, int bit_reorder, void* out, void* stream) {
  if (n_chunks <= 0) return 0;
  if (chunk_size <= 0 || chunk_size >= (1LL << 31) || chunk_size % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const long long tiles = (chunk_size + kTile - 1) / kTile;
  const long long units = n_chunks * tiles;
  if (units >= (1LL << 32) - kWarps) return (int)cudaErrorInvalidValue;
  const unsigned int blocks = (unsigned int)((units + kWarps - 1) / kWarps);
  const Bufs bufs{(const uint8_t*)payload, (const uint8_t*)hsym, (int64_t)hsym_row};
  const int keep = byte_reorder == 8;
  cudaStream_t st = (cudaStream_t)stream;
#define ZIPNN_GROUPED(L)                                                       \
  combine_cells_grouped_kernel<L><<<blocks, 32 * kWarps, 0, st>>>(             \
      bufs, (const int32_t*)kinds, (const int64_t*)srcs,                       \
      (const int64_t*)chunk_offs, (const int32_t*)chunk_lens, (uint32_t)tiles, \
      (uint32_t)units, keep, bit_reorder, (uint8_t*)out)
  if (num_buf == 1) {
    ZIPNN_GROUPED(kOne);
  } else if (num_buf == 2 && byte_reorder == 10) {
    ZIPNN_GROUPED(kTwo);
  } else if (num_buf == 2) {
    ZIPNN_GROUPED(kKeep);
  } else if (num_buf == 4) {
    ZIPNN_GROUPED(kFour);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef ZIPNN_GROUPED
  return (int)cudaGetLastError();
}
