// Cells into the container's layout: each cell of one encode batch written
// at its offset in a device buffer, in the payload's plane-major order.
//
// The JAX package has no device kernel for this step: its assembly is host
// code (zipnn_tpu/ops/jax_codec.py `_assemble`, 1004-1280, and the native
// core's splice).  The port writes the cells on the card, so a batch's
// bytes leave the card once, already in place (ops/splice.py,
// ops/encode.py).
//
// Input: a descriptor array of int64: `n_groups` source base addresses,
// `n_groups` row strides in bytes, then 4 fields a cell:
//   dst   byte offset of the cell in `out`
//   info  size | kind << 32 | group << 40 | hlen << 48
//         (stored bytes; kind 0 raw, 1 RLE, 2 Huffman; source group;
//         a Huffman cell's header bytes)
//   src   row | hoff << 32  (source row in the group, a Huffman cell's
//         stream s in row + s; its weight header's offset in `hpool`)
//   sb    a Huffman cell's four stream lengths, 16 bits each
// A raw or RLE cell is the first `size` bytes of its row (an RLE cell's
// one byte is its plane's first byte).  A Huffman cell is its header
// (`hlen` bytes of `hpool` from `hoff`), the jump table (sb0, sb1, sb2 as
// little-endian uint16) and its four streams, stream s being the first
// sb_s bytes of row `row + s`.
//
// What bounds it.  Every stored byte is read once and written once, so the
// bound is those bytes (and the descriptors) over the memory rate.  The
// design: one block per cell; each of a cell's pieces (a raw plane, a
// header, a stream) is copied by the whole block, 16 bytes a thread per
// step on 16-byte-aligned destination words.  The destination offsets are
// arbitrary (they follow the stored sizes), so a source piece is in general
// not aligned with its destination: each step loads the four or five
// aligned source words that hold its 16 bytes and funnel-shifts them
// together (every word loaded holds at least one byte of the piece, so no
// load leaves the source's allocation).  The ragged ends of a piece are
// written a byte a thread; neighbouring cells share no byte, so no write
// races.  A simple kernel: no staging in shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void copy_piece(uint8_t* __restrict__ out, long long dst,
                                           const uint8_t* __restrict__ src, long long n) {
  if (n <= 0) return;
  uint8_t* d = out + dst;
  long long head = (long long)((16 - ((uintptr_t)d & 15)) & 15);
  if (head > n) head = n;
  const long long body = (n - head) & ~15LL;
  for (long long i = threadIdx.x; i < head; i += blockDim.x) d[i] = src[i];
  for (long long i = head + body + threadIdx.x; i < n; i += blockDim.x) d[i] = src[i];
  if (body == 0) return;
  uint4* dv = reinterpret_cast<uint4*>(d + head);
  const uint8_t* s = src + head;
  const long long nv = body >> 4;
  const uintptr_t sa = (uintptr_t)s;
  if ((sa & 15) == 0) {
    const uint4* sv = reinterpret_cast<const uint4*>(s);
    for (long long v = threadIdx.x; v < nv; v += blockDim.x) dv[v] = __ldg(sv + v);
    return;
  }
  const uint32_t* sw = reinterpret_cast<const uint32_t*>(sa & ~(uintptr_t)3);
  const unsigned shift = 8u * (unsigned)(sa & 3);
  if (shift == 0) {
    for (long long v = threadIdx.x; v < nv; v += blockDim.x) {
      const uint32_t* w = sw + 4 * v;
      dv[v] = make_uint4(__ldg(w), __ldg(w + 1), __ldg(w + 2), __ldg(w + 3));
    }
    return;
  }
  for (long long v = threadIdx.x; v < nv; v += blockDim.x) {
    const uint32_t* w = sw + 4 * v;
    const uint32_t w0 = __ldg(w), w1 = __ldg(w + 1), w2 = __ldg(w + 2), w3 = __ldg(w + 3),
                   w4 = __ldg(w + 4);
    dv[v] = make_uint4(__funnelshift_r(w0, w1, shift), __funnelshift_r(w1, w2, shift),
                       __funnelshift_r(w2, w3, shift), __funnelshift_r(w3, w4, shift));
  }
}

__global__ void __launch_bounds__(kThreads)
splice_kernel(uint8_t* __restrict__ out, const long long* __restrict__ desc, int n_groups,
              const uint8_t* __restrict__ hpool) {
  const long long* cell = desc + 2 * n_groups + 4 * (long long)blockIdx.x;
  const long long dst = cell[0];
  const unsigned long long info = (unsigned long long)cell[1];
  const unsigned long long src = (unsigned long long)cell[2];
  const long long size = (long long)(info & 0xFFFFFFFFull);
  const int kind = (int)((info >> 32) & 0xFF);
  const int group = (int)((info >> 40) & 0xFF);
  const long long row = (long long)(src & 0xFFFFFFFFull);
  const uint8_t* base = reinterpret_cast<const uint8_t*>(desc[group]);
  const long long stride = desc[n_groups + group];
  if (kind != 2) {
    copy_piece(out, dst, base + row * stride, size);
    return;
  }
  const long long hlen = (long long)(info >> 48);
  const unsigned long long sb = (unsigned long long)cell[3];
  copy_piece(out, dst, hpool + (src >> 32), hlen);
  if (threadIdx.x < 6) {
    const unsigned j = threadIdx.x;
    out[dst + hlen + j] = (uint8_t)(sb >> (16 * (j >> 1) + 8 * (j & 1)));
  }
  long long o = dst + hlen + 6;
  for (int s = 0; s < 4; s++) {
    const long long len = (long long)((sb >> (16 * s)) & 0xFFFF);
    copy_piece(out, o, base + (row + s) * stride, len);
    o += len;
  }
}

}  // namespace

extern "C" int splice_cells(void* out, const void* desc, int n_groups, long long n_cells,
                            const void* hpool, void* stream) {
  if (n_cells <= 0) return 0;
  if (n_groups <= 0 || n_groups > 256 || n_cells > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  splice_kernel<<<(unsigned)n_cells, kThreads, 0, (cudaStream_t)stream>>>(
      (uint8_t*)out, (const long long*)desc, n_groups, (const uint8_t*)hpool);
  return (int)cudaGetLastError();
}
