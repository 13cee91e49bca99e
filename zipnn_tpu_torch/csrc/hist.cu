// Per-cell byte histograms for the per-chunk encode: how often each byte
// value occurs in each (chunk, plane) cell.
//
// Replaces XLA device code of the JAX package, not a Pallas kernel:
// zipnn_tpu/ops/jax_entropy.py:139 `histogram_cells`, which one-hots the
// two nibbles of every byte and multiplies them on the TPU's matrix unit
// (a scatter lowered to serial updates there).  Here each SM has fast
// shared-memory atomics, so the kernel counts directly.
//
// Output per row: int32 [256], row r at out + 256 r.
//
// What bounds it.  Every byte is read once, so the least time is the row
// bytes over the memory rate (0.16 ms for a 512 MiB batch).  The work per
// byte is one shared-memory atomic add, and the bf16 exponent plane is
// skewed: one byte value is ~32 % of the plane, so lanes of a warp adding
// into one bin collide and the hardware serialises them.  Design: one
// block of 8 warps per row, each warp with its own sub-histogram in shared
// memory (1 KB; 8 KB a block).  More sub-histograms a warp (lane l adding
// into copy l % C, the copies of one bin in neighbouring banks) were
// measured and dropped: on the bf16 per-chunk batches one copy a warp was
// never slower than 2 or 4 (as fast at 256 KB chunks, faster at
// 256 B-16 KB; PERF.md, PR 6), since the extra copies cost shared memory
// (fewer blocks an SM), their clearing and a longer merge.  Each thread
// reads 16 bytes a load, two loads in flight; at the end the block sums
// the 8 sub-histograms of each bin and writes the row's 256 counts.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // threads per block (a block per row)
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;

__device__ __forceinline__ void add_word(uint32_t* h, uint32_t x) {
  atomicAdd(h + (x & 0xFFu), 1u);
  atomicAdd(h + ((x >> 8) & 0xFFu), 1u);
  atomicAdd(h + ((x >> 16) & 0xFFu), 1u);
  atomicAdd(h + (x >> 24), 1u);
}

__device__ __forceinline__ void add_vec(uint32_t* h, uint4 v) {
  add_word(h, v.x);
  add_word(h, v.y);
  add_word(h, v.z);
  add_word(h, v.w);
}

__global__ void __launch_bounds__(kThreads) hist_cells_kernel(
    const uint32_t* __restrict__ rows, int64_t width, int vec,
    int32_t* __restrict__ out) {
  __shared__ uint32_t h[kWarps * kBins];
  for (int i = threadIdx.x; i < kWarps * kBins; i += kThreads) h[i] = 0u;
  __syncthreads();
  const uint32_t* row = rows + (int64_t)blockIdx.x * width;
  uint32_t* mine = h + (threadIdx.x >> 5) * kBins;
  int64_t done = 0;  // words counted by the 16-byte loop
  if (vec) {
    const uint4* v = reinterpret_cast<const uint4*>(row);
    const int64_t n4 = width >> 2;
    int64_t i = threadIdx.x;
    for (; i + kThreads < n4; i += 2 * kThreads) {
      const uint4 a = __ldg(v + i);
      const uint4 b = __ldg(v + i + kThreads);
      add_vec(mine, a);
      add_vec(mine, b);
    }
    if (i < n4) add_vec(mine, __ldg(v + i));
    done = n4 << 2;
  }
  for (int64_t i = done + threadIdx.x; i < width; i += kThreads) add_word(mine, __ldg(row + i));
  __syncthreads();
  for (int bin = threadIdx.x; bin < kBins; bin += kThreads) {
    uint32_t s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += h[w * kBins + bin];
    out[(int64_t)blockIdx.x * kBins + bin] = (int32_t)s;
  }
}

}  // namespace

extern "C" int hist_cells(const void* rows, long long n_rows, long long width,
                          void* out, void* stream) {
  if (n_rows <= 0) return 0;
  // counts are int32: a row holds fewer than 2^31 bytes
  if (width < 0 || width >= (1LL << 29) || n_rows > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  // 16-byte loads need every row on a 16-byte boundary
  const int vec = ((width & 3) == 0) && (((uintptr_t)rows & 15) == 0);
  hist_cells_kernel<<<(unsigned)n_rows, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)rows, (int64_t)width, vec, (int32_t*)out);
  return (int)cudaGetLastError();
}
