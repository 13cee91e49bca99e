// Per-cell-table Huffman decode of backward HUF bitstreams (tableLog <= 12).
//
// Replaces the Pallas kernels zipnn_tpu/ops/pallas_huf_pc.py
// `_build_kernel` (K1, launched by `_decode_call_cached`) and
// zipnn_tpu/ops/pallas_gather.py `_gather_call_cached` (K3, the DMA row
// gather that fed K1 right-aligned stream rows), and does the d-index ->
// symbol job of `_build_post_kernel` (K4) on the main path.
//
// Design.  One thread decodes one stream.  A TPU lane cannot gather per
// lane, so the Pallas kernel emitted dtable indices from a boundary
// compare chain and mapped them to symbols in a second pass; here each
// thread reads its own cell's (symbol, nb) entries and its own stream
// bytes straight from the uploaded payload at their byte offset, and
// writes symbol bytes.
//
// What bounds it.  The decode of one stream is a serial chain (peek ->
// table -> bits consumed -> next peek), so the kernel is bound by that
// chain's latency, not by bytes: ~4 streams per 64 KB of plane output
// gives only a few thousand threads for a 512 MB container.  The design
// keeps the chain short: the stream's bits sit in a 64-bit register
// container refilled every few symbols, and the table is read through the
// read-only cache.  Output bytes are packed four to a word before they
// are stored.
//
// Semantics (held against zipnn_tpu/ops/jax_entropy.py decode_streams):
// bits_left starts at the sentinel position; each step peeks the tlog
// bits below bits_left, shifting in zeros below the stream's first bit
// (the bytes before a stream in the payload are real data, so they are
// masked, never read), looks up the entry and retreats by its nb.  No
// byte outside [start, start + len) is read, whatever the input.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void huf_pc_decode_kernel(
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
    int n_streams,
    uint8_t* __restrict__ out,
    int32_t* __restrict__ bits_left_out) {
  int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n_streams) return;
  const uint8_t* src = payload + starts[s];
  const int len = lens[s];
  const int n = out_lens[s];
  const int cell = cells[s];
  const int tl = tlogs[cell];
  const uint16_t* tbl = tables + (int64_t)cell * table_stride;
  uint8_t* dst = out + out_offs[s];
  const int64_t dst_addr = (int64_t)(out_offs[s]);

  int bl = bits0[s];
  int cbase = -16;  // container holds stream bytes [cbase, cbase + 8)
  uint64_t cont = 0;
  uint32_t acc = 0;
  for (int k = 0; k < n; ++k) {
    const int lo = bl - tl;
    const int lo2 = lo > 0 ? lo : 0;
    int navail = bl - lo2;
    navail = navail < 0 ? 0 : (navail > 12 ? 12 : navail);
    uint32_t idx = 0;
    if (navail > 0) {
      const int byte0 = lo2 >> 3;
      if (byte0 < cbase || byte0 + 3 > cbase + 8) {
        int nb = byte0 - 5;
        cbase = nb > 0 ? nb : 0;
        cont = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int p = cbase + j;
          if (p < len) cont |= (uint64_t)__ldg(src + p) << (8 * j);
        }
      }
      const uint32_t val =
          (uint32_t)(cont >> (lo2 - 8 * cbase)) & ((1u << navail) - 1u);
      idx = val << (lo2 - lo);
    }
    const uint32_t e = __ldg(tbl + idx);
    bl -= (int)(e >> 8);
    const int64_t pos = dst_addr + k;
    acc |= (e & 0xFFu) << (8 * (int)(pos & 3));
    if ((pos & 3) == 3 || k == n - 1) {
      const int64_t w0 = pos & ~(int64_t)3;
      if (w0 >= dst_addr && (pos & 3) == 3) {
        *reinterpret_cast<uint32_t*>(dst + (w0 - dst_addr)) = acc;
      } else {
        const int64_t first = w0 > dst_addr ? w0 : dst_addr;
        for (int64_t p = first; p <= pos; ++p)
          dst[p - dst_addr] = (uint8_t)(acc >> (8 * (int)(p & 3)));
      }
      acc = 0;
    }
  }
  bits_left_out[s] = bl;
}

}  // namespace

extern "C" int huf_pc_decode(
    const void* payload, const void* starts, const void* lens,
    const void* bits0, const void* out_offs, const void* out_lens,
    const void* cells, const void* tlogs, const void* tables,
    long long table_stride, int n_streams, void* out, void* bits_left,
    void* stream) {
  if (n_streams <= 0) return 0;
  const int threads = 64;
  const int blocks = (n_streams + threads - 1) / threads;
  huf_pc_decode_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)payload, (const int64_t*)starts, (const int32_t*)lens,
      (const int32_t*)bits0, (const int64_t*)out_offs,
      (const int32_t*)out_lens, (const int32_t*)cells,
      (const int32_t*)tlogs, (const uint16_t*)tables, (int64_t)table_stride,
      n_streams, (uint8_t*)out, (int32_t*)bits_left);
  return (int)cudaGetLastError();
}
