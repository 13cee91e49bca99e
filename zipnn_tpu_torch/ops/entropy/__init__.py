"""From-scratch entropy codecs for the ``.znn`` format.

This package reimplements — from the published format, not from vendored
code — the HUF (Huffman) and FSE (tANS) stream formats used by the
reference's entropy layer (include/FiniteStateEntropy, linked per reference
setup.py:24-30), so that streams we produce are decodable by stock
FSE/zstd-family decoders and vice versa:

* ``bitstream``: the backward-read bit container convention shared by HUF
  and FSE (forward LSB-first writes, closing sentinel bit, reads from the
  stream tail).
* ``fse``: table-based asymmetric numeral system codec — normalized-count
  header, state tables, two interleaved states.  Used for Huffman
  weight-table compression, and reusable as a general small-alphabet codec.
* ``huf``: canonical Huffman with package-merge length limiting, the
  FSE-compressed (or raw 4-bit) weight header, and the 4-stream block
  layout with a 6-byte jump table.
"""

from . import bitstream, fse, huf  # noqa: F401
