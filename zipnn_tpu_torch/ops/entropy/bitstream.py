"""Backward bitstream container shared by the HUF and FSE formats.

Convention (matches the FSE-family bitstream):

* The encoder appends values LSB-first into a little-endian stream:
  ``add(v, n)`` places bit ``i`` of ``v`` at absolute bit position
  ``pos + i`` where ``pos`` is the running bit count.
* ``close()`` appends a single ``1`` sentinel bit and pads the final byte
  with zeros; the stream length in bits is recovered from the position of
  the highest set bit of the last byte.
* The decoder reads from the *end*: ``read(n)`` returns the ``n`` bits just
  below the current top, with the highest absolute position as the MSB of
  the returned value.  Therefore the first value read is the last value
  written, and for a matched write/read size ``read(n)`` returns exactly
  the value passed to the corresponding ``add(v, n)``.
"""
from __future__ import annotations


class BitWriter:
    """Forward bit writer with a 64-bit accumulation container (O(1)/add)."""

    __slots__ = ("_acc", "_nbits", "_out")

    def __init__(self) -> None:
        self._acc = 0
        self._nbits = 0
        self._out = bytearray()

    def add(self, value: int, nbits: int) -> None:
        value, nbits = int(value), int(nbits)  # guard against numpy scalars
        if nbits:
            self._acc |= (value & ((1 << nbits) - 1)) << self._nbits
            self._nbits += nbits
            if self._nbits >= 32:
                # flush whole bytes, keep the remainder in the container
                nbytes = self._nbits >> 3
                self._out += (self._acc & ((1 << (nbytes * 8)) - 1)).to_bytes(
                    nbytes, "little"
                )
                self._acc >>= nbytes * 8
                self._nbits &= 7

    @property
    def bit_count(self) -> int:
        return len(self._out) * 8 + self._nbits

    def close(self) -> bytes:
        """Append the sentinel bit and return the finished stream."""
        self.add(1, 1)
        return self.finish()

    def finish(self) -> bytes:
        """Zero-pad to a whole byte and return the stream (no sentinel)."""
        if self._nbits:
            self._out += self._acc.to_bytes((self._nbits + 7) >> 3, "little")
            self._acc = 0
            self._nbits = 0
        return bytes(self._out)


class BitReader:
    """Backward bit reader.

    Reading past the beginning of the stream returns zero-padded low bits
    and sets ``overflowed`` — mirroring the reference decoder's tolerant
    end-of-stream handling, which peeks a full table-log window even when
    fewer real bits remain.
    """

    __slots__ = ("_data", "bits_left", "overflowed")

    def __init__(self, data) -> None:
        data = bytes(data)
        if not data or data[-1] == 0:
            raise ValueError("corrupt bitstream: missing sentinel bit")
        last = data[-1]
        self._data = data
        # position of the sentinel = highest set bit of the last byte
        self.bits_left = 8 * (len(data) - 1) + (last.bit_length() - 1)
        self.overflowed = False

    def peek(self, nbits: int) -> int:
        if nbits == 0:
            return 0
        top = self.bits_left
        lo = top - nbits
        pad = 0
        if lo < 0:
            pad = -lo
            lo = 0
        first_byte = lo >> 3
        last_byte = (top + 7) >> 3
        window = int.from_bytes(self._data[first_byte:last_byte], "little")
        val = (window >> (lo - 8 * first_byte)) & ((1 << (top - lo)) - 1)
        return val << pad

    def read(self, nbits: int) -> int:
        val = self.peek(nbits)
        self.bits_left -= nbits
        if self.bits_left < 0:
            self.overflowed = True
        return val

    @property
    def finished(self) -> bool:
        """True when every payload bit has been consumed exactly."""
        return self.bits_left == 0
