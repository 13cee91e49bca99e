// Per-row constant scan for the shared-table encode: is every byte of a
// (chunk, plane) row equal to its first byte (an RLE cell)?
//
// Replaces the Pallas kernel zipnn_tpu/ops/pallas_gather.py
// `_const_scan_call_cached` (K8; kernel body `kernel`, wrapper
// `const_scan_rows`).
//
// Output per row: int32 `b0 | is_const << 8`, b0 the row's first byte.
//
// What bounds it.  Every row byte is read once and nothing is reused, so
// the bound is the row bytes over the memory rate.  The design: one block
// per row, each thread reading 16 bytes per load (neighbouring threads on
// neighbouring addresses) and comparing each word with `b0 * 0x01010101`;
// one `__syncthreads_and` combines the block.  A row of a 256 KB bf16
// chunk's plane is 128 KB, so a 512 MB batch gives thousands of blocks,
// enough to keep every SM's loads in flight.  The scan never ends early:
// every row is read whole, whatever its bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void const_scan_kernel(const uint32_t* __restrict__ rows,
                                  int64_t width, int vec,
                                  int32_t* __restrict__ out) {
  const int64_t r = blockIdx.x;
  const uint32_t* row = rows + r * width;
  const uint32_t b0 = __ldg(row) & 0xFFu;
  const uint32_t splat = b0 * 0x01010101u;
  int ok = 1;
  if (vec) {
    const uint4* v = reinterpret_cast<const uint4*>(row);
    const int64_t n4 = width >> 2;
    for (int64_t i = threadIdx.x; i < n4; i += blockDim.x) {
      const uint4 x = __ldg(v + i);
      ok &= (x.x == splat) & (x.y == splat) & (x.z == splat) & (x.w == splat);
    }
  } else {
    for (int64_t i = threadIdx.x; i < width; i += blockDim.x) {
      ok &= (__ldg(row + i) == splat);
    }
  }
  ok = __syncthreads_and(ok);
  if (threadIdx.x == 0) out[r] = (int32_t)(b0 | ((uint32_t)(ok != 0) << 8));
}

}  // namespace

extern "C" int const_scan_rows(const void* rows, long long n_rows,
                               long long width, void* out, void* stream) {
  if (n_rows <= 0) return 0;
  if (width <= 0 || n_rows > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  // 16-byte loads need every row on a 16-byte boundary
  const int vec = ((width & 3) == 0) && (((uintptr_t)rows & 15) == 0);
  const int threads = 256;
  const_scan_kernel<<<(unsigned)n_rows, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)rows, (int64_t)width, vec, (int32_t*)out);
  return (int)cudaGetLastError();
}
