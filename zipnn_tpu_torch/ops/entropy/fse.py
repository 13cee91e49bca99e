"""FSE (tANS) codec — stream-format-compatible from-scratch implementation.

Implements the Finite State Entropy stream format (the entropy coder the
reference links from include/FiniteStateEntropy; format documented in the
zstd RFC 8878 §4.1 and the FSE project docs): a bit-packed normalized-count
header followed by a backward bitstream driven by two interleaved ANS
states.  In the ``.znn`` codec this codes the Huffman weight tables
(``huf.py``), and it doubles as a general small-alphabet entropy coder.

No code is taken from the reference or from zstd; everything here is
re-derived from the published format.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from .bitstream import BitReader, BitWriter

FSE_MIN_TABLELOG = 5
FSE_MAX_TABLELOG = 15
FSE_DEFAULT_TABLELOG = 11
FSE_TABLELOG_ABSOLUTE_MAX = 15


def _highbit(v: int) -> int:
    if v <= 0:
        raise ValueError("highbit of non-positive value")
    return v.bit_length() - 1


def min_table_log(src_size: int, max_symbol_value: int) -> int:
    min_bits_src = _highbit(src_size - 1) + 1 if src_size > 1 else 1
    min_bits_symbols = _highbit(max_symbol_value) + 2 if max_symbol_value else 2
    return min(min_bits_src, min_bits_symbols)


def optimal_table_log(
    max_table_log: int, src_size: int, max_symbol_value: int, minus: int = 2
) -> int:
    table_log = max_table_log or FSE_DEFAULT_TABLELOG
    max_bits_src = _highbit(src_size - 1) - minus if src_size > 1 else 1
    if max_bits_src < table_log:
        table_log = max_bits_src
    mb = min_table_log(src_size, max_symbol_value)
    if mb > table_log:
        table_log = mb
    table_log = max(table_log, FSE_MIN_TABLELOG)
    table_log = min(table_log, FSE_MAX_TABLELOG)
    return table_log


# ---------------------------------------------------------------------------
# Normalization: histogram -> counts summing to exactly 2**table_log,
# where -1 denotes a "less than 1/tableSize" probability symbol.
# ---------------------------------------------------------------------------

_RTB_TABLE = (0, 473195, 504333, 520860, 550000, 700000, 750000, 830000)


def normalize_count(
    count: Sequence[int], table_log: int, total: int, max_symbol_value: int
) -> List[int]:
    if table_log < FSE_MIN_TABLELOG or table_log > FSE_MAX_TABLELOG:
        raise ValueError(f"tableLog {table_log} out of range")
    if table_log < min_table_log(total, max_symbol_value):
        raise ValueError("tableLog too small for this alphabet")

    norm = [0] * (max_symbol_value + 1)
    scale = 62 - table_log
    step = (1 << 62) // total
    v_step = 1 << (scale - 20)
    still_to_distribute = 1 << table_log
    largest = 0
    largest_p = 0
    low_threshold = total >> table_log

    for s in range(max_symbol_value + 1):
        c = count[s]
        if c == total:
            raise ValueError("RLE input should not reach normalize_count")
        if c == 0:
            continue
        if c <= low_threshold:
            norm[s] = -1
            still_to_distribute -= 1
        else:
            proba = (c * step) >> scale
            if proba < 8:
                rest_to_beat = v_step * _RTB_TABLE[proba]
                if c * step - (proba << scale) > rest_to_beat:
                    proba += 1
            if proba > largest_p:
                largest_p = proba
                largest = s
            norm[s] = proba
            still_to_distribute -= proba

    if -still_to_distribute >= (norm[largest] >> 1):
        return _normalize_m2(count, table_log, total, max_symbol_value)
    norm[largest] += still_to_distribute
    return norm


def _normalize_m2(
    count: Sequence[int], table_log: int, total: int, max_symbol_value: int
) -> List[int]:
    """Fallback distribution for corner-case histograms."""
    NOT_YET = None
    norm: List[Optional[int]] = [0] * (max_symbol_value + 1)
    distributed = 0
    low_threshold = total >> table_log
    low_one = (total * 3) >> (table_log + 1)
    remaining_total = total

    for s in range(max_symbol_value + 1):
        c = count[s]
        if c == 0:
            continue
        if c <= low_threshold:
            norm[s] = -1
            distributed += 1
            remaining_total -= c
        elif c <= low_one:
            norm[s] = 1
            distributed += 1
            remaining_total -= c
        else:
            norm[s] = NOT_YET

    to_distribute = (1 << table_log) - distributed
    if to_distribute == 0:
        return [n if n is not None else 0 for n in norm]

    if to_distribute and (remaining_total // to_distribute) > low_one:
        low_one = (remaining_total * 3) // (to_distribute * 2)
        for s in range(max_symbol_value + 1):
            if norm[s] is NOT_YET and count[s] <= low_one:
                norm[s] = 1
                distributed += 1
                remaining_total -= count[s]
        to_distribute = (1 << table_log) - distributed

    if distributed == max_symbol_value + 1:
        # all symbols low probability: give everything left to the largest
        max_v = max(range(max_symbol_value + 1), key=lambda s: count[s])
        norm[max_v] += to_distribute  # type: ignore[operator]
        return [n if n is not None else 0 for n in norm]

    if remaining_total == 0:
        # spread remaining points round-robin over positive symbols
        s = 0
        while to_distribute > 0:
            if norm[s] is not None and norm[s] > 0:  # type: ignore[operator]
                norm[s] += 1  # type: ignore[operator]
                to_distribute -= 1
            s = (s + 1) % (max_symbol_value + 1)
        return [n if n is not None else 0 for n in norm]

    v_step_log = 62 - table_log
    mid = (1 << (v_step_log - 1)) - 1
    r_step = (((1 << v_step_log) * to_distribute) + mid) // remaining_total
    tmp_total = mid
    for s in range(max_symbol_value + 1):
        if norm[s] is NOT_YET:
            end = tmp_total + count[s] * r_step
            s_start = tmp_total >> v_step_log
            s_end = end >> v_step_log
            weight = s_end - s_start
            if weight < 1:
                raise ValueError("normalization failed")
            norm[s] = weight
            tmp_total = end
    return [n if n is not None else 0 for n in norm]


# ---------------------------------------------------------------------------
# Normalized-count header (bit-packed, read forward LSB-first)
# ---------------------------------------------------------------------------

def write_ncount(norm: Sequence[int], max_symbol_value: int, table_log: int) -> bytes:
    w = BitWriter()
    table_size = 1 << table_log
    w.add(table_log - FSE_MIN_TABLELOG, 4)

    remaining = table_size + 1  # +1 for extra accuracy
    threshold = table_size
    nb_bits = table_log + 1
    symbol = 0
    alphabet_size = max_symbol_value + 1
    previous_is_0 = False

    while symbol < alphabet_size and remaining > 1:
        if previous_is_0:
            start = symbol
            while symbol < alphabet_size and not norm[symbol]:
                symbol += 1
            if symbol == alphabet_size:
                raise ValueError("incorrect normalized distribution")
            while symbol >= start + 24:
                start += 24
                w.add(0xFFFF, 16)
            while symbol >= start + 3:
                start += 3
                w.add(3, 2)
            w.add(symbol - start, 2)
        count = norm[symbol]
        symbol += 1
        mx = (2 * threshold - 1) - remaining
        remaining -= -count if count < 0 else count
        count += 1  # +1 for extra accuracy; -1 (low proba) becomes 0
        if count >= threshold:
            count += mx
        w.add(count, nb_bits - (1 if count < mx else 0))
        previous_is_0 = count == 1
        if remaining < 1:
            raise ValueError("incorrect normalized distribution")
        while remaining < threshold:
            nb_bits -= 1
            threshold >>= 1

    if remaining != 1:
        raise ValueError("incorrect normalized distribution")
    # the ncount header is length-delimited by its own field structure:
    # zero-pad to whole bytes, no sentinel bit
    return w.finish()


class _LSBReader:
    """Forward LSB-first bit cursor (for the ncount header only)."""

    __slots__ = ("data", "pos")

    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0

    def peek(self, n: int) -> int:
        first = self.pos >> 3
        last = (self.pos + n + 7) >> 3
        window = int.from_bytes(self.data[first:last], "little")
        return (window >> (self.pos - 8 * first)) & ((1 << n) - 1)

    def read(self, n: int) -> int:
        v = self.peek(n)
        self.pos += n
        return v


def read_ncount(data: bytes, max_symbol_limit: int = 255) -> Tuple[List[int], int, int, int]:
    """Parse a normalized-count header.

    Returns (norm, max_symbol_value, table_log, bytes_consumed).
    """
    rd = _LSBReader(bytes(data) + b"\x00" * 8)
    table_log = rd.read(4) + FSE_MIN_TABLELOG
    if table_log > FSE_TABLELOG_ABSOLUTE_MAX:
        raise ValueError("tableLog too large")
    remaining = (1 << table_log) + 1
    threshold = 1 << table_log
    nb_bits = table_log + 1
    norm: List[int] = []
    previous_0 = False

    while remaining > 1 and len(norm) <= max_symbol_limit:
        if previous_0:
            n0 = 0
            while rd.peek(16) == 0xFFFF:
                rd.read(16)
                n0 += 24
            while rd.peek(2) == 3:
                rd.read(2)
                n0 += 3
            n0 += rd.read(2)
            if len(norm) + n0 > max_symbol_limit:
                raise ValueError("maxSymbolValue too small")
            norm.extend([0] * n0)
        mx = (2 * threshold - 1) - remaining
        if (rd.peek(nb_bits - 1) & (threshold - 1)) < mx:
            count = rd.read(nb_bits - 1) & (threshold - 1)
        else:
            count = rd.read(nb_bits) & (2 * threshold - 1)
            if count >= threshold:
                count -= mx
        count -= 1  # extra accuracy; 0 becomes -1 (low proba)
        remaining -= -count if count < 0 else count
        norm.append(count)
        previous_0 = count == 0
        while remaining < threshold:
            nb_bits -= 1
            threshold >>= 1

    if remaining != 1:
        raise ValueError("corrupt normalized-count header")
    consumed = (rd.pos + 7) >> 3
    if consumed > len(data):
        raise ValueError("normalized-count header overruns input")
    return norm, len(norm) - 1, table_log, consumed


# ---------------------------------------------------------------------------
# Encode / decode tables
# ---------------------------------------------------------------------------

def _table_step(table_size: int) -> int:
    return (table_size >> 1) + (table_size >> 3) + 3


def _spread_symbols(norm: Sequence[int], table_log: int) -> List[int]:
    """Place symbols across the state table (shared by C and D tables)."""
    table_size = 1 << table_log
    table_mask = table_size - 1
    step = _table_step(table_size)
    table_symbol = [0] * table_size
    high_threshold = table_size - 1
    # low-probability symbols occupy the tail slots
    for s, n in enumerate(norm):
        if n == -1:
            table_symbol[high_threshold] = s
            high_threshold -= 1
    position = 0
    for s, n in enumerate(norm):
        for _ in range(max(n, 0)):
            table_symbol[position] = s
            position = (position + step) & table_mask
            while position > high_threshold:
                position = (position + step) & table_mask
    if position != 0:
        raise ValueError("table spread failed: corrupt normalized counts")
    return table_symbol


class CTable:
    """Encode table: next-state array plus per-symbol transforms."""

    __slots__ = ("table_log", "state_table", "delta_nb_bits", "delta_find_state")

    def __init__(self, norm: Sequence[int], table_log: int) -> None:
        self.table_log = table_log
        table_size = 1 << table_log
        table_symbol = _spread_symbols(norm, table_log)

        # cumul: first state slot per symbol (low-proba symbols get 1 slot)
        cumul = [0] * (len(norm) + 1)
        for s, n in enumerate(norm):
            cumul[s + 1] = cumul[s] + (1 if n == -1 else n)

        state_table = [0] * table_size
        next_slot = list(cumul[:-1])
        for u in range(table_size):
            s = table_symbol[u]
            state_table[next_slot[s]] = table_size + u
            next_slot[s] += 1
        self.state_table = state_table

        self.delta_nb_bits = [0] * len(norm)
        self.delta_find_state = [0] * len(norm)
        total = 0
        for s, n in enumerate(norm):
            if n == 0:
                self.delta_nb_bits[s] = ((table_log + 1) << 16) - table_size
            elif n in (-1, 1):
                self.delta_nb_bits[s] = (table_log << 16) - table_size
                self.delta_find_state[s] = total - 1
                total += 1
            else:
                max_bits_out = table_log - _highbit(n - 1)
                min_state_plus = n << max_bits_out
                self.delta_nb_bits[s] = (max_bits_out << 16) - min_state_plus
                self.delta_find_state[s] = total - n
                total += n


def _init_state(ct: CTable, symbol: int) -> int:
    nb_bits_out = (ct.delta_nb_bits[symbol] + (1 << 15)) >> 16
    value = (nb_bits_out << 16) - ct.delta_nb_bits[symbol]
    return ct.state_table[(value >> nb_bits_out) + ct.delta_find_state[symbol]]


def _encode_symbol(w: BitWriter, ct: CTable, state: int, symbol: int) -> int:
    nb_bits_out = (state + ct.delta_nb_bits[symbol]) >> 16
    w.add(state, nb_bits_out)
    return ct.state_table[(state >> nb_bits_out) + ct.delta_find_state[symbol]]


def compress_using_ctable(symbols: Sequence[int], ct: CTable) -> Optional[bytes]:
    """Backward two-state payload (without the ncount header)."""
    n = len(symbols)
    if n <= 2:
        return None
    w = BitWriter()
    if n & 1:
        c1 = _init_state(ct, symbols[n - 1])
        c2 = _init_state(ct, symbols[n - 2])
        c1 = _encode_symbol(w, ct, c1, symbols[n - 3])
        ip = n - 3
    else:
        c2 = _init_state(ct, symbols[n - 1])
        c1 = _init_state(ct, symbols[n - 2])
        ip = n - 2
    while ip > 0:
        c2 = _encode_symbol(w, ct, c2, symbols[ip - 1])
        c1 = _encode_symbol(w, ct, c1, symbols[ip - 2])
        ip -= 2
    w.add(c2, ct.table_log)
    w.add(c1, ct.table_log)
    return w.close()


class DTable:
    """Decode table: per-state (symbol, nb_bits, new_state_base)."""

    __slots__ = ("table_log", "symbol", "nb_bits", "new_state")

    def __init__(self, norm: Sequence[int], table_log: int) -> None:
        self.table_log = table_log
        table_size = 1 << table_log
        table_symbol = _spread_symbols(norm, table_log)
        symbol_next = [1 if n == -1 else n for n in norm]
        self.symbol = [0] * table_size
        self.nb_bits = [0] * table_size
        self.new_state = [0] * table_size
        for u in range(table_size):
            s = table_symbol[u]
            next_state = symbol_next[s]
            symbol_next[s] += 1
            nb = table_log - _highbit(next_state)
            self.symbol[u] = s
            self.nb_bits[u] = nb
            self.new_state[u] = (next_state << nb) - table_size


def decompress_using_dtable(
    payload: bytes, dt: DTable, max_out: int
) -> List[int]:
    """Decode a two-state FSE payload; output length comes from stream end."""
    rd = BitReader(payload)
    states = [rd.read(dt.table_log), rd.read(dt.table_log)]
    if rd.overflowed:
        raise ValueError("FSE payload too short")
    out: List[int] = []
    i = 0
    while True:
        if len(out) > max_out:
            raise ValueError("FSE output exceeds destination capacity")
        st = states[i & 1]
        out.append(dt.symbol[st])
        bits = rd.read(dt.nb_bits[st])
        if rd.overflowed:
            # stream exhausted: the other state holds the final symbol
            out.append(dt.symbol[states[(i + 1) & 1]])
            break
        states[i & 1] = dt.new_state[st] + bits
        i += 1
    return out


# ---------------------------------------------------------------------------
# One-shot helpers
# ---------------------------------------------------------------------------

RLE = "rle"
INCOMPRESSIBLE = "incompressible"


def compress(data: Sequence[int], max_symbol_value: int = 255, max_table_log: int = FSE_DEFAULT_TABLELOG):
    """FSE-compress a symbol sequence.

    Returns compressed bytes, or the markers ``RLE`` (single repeated
    symbol) / ``INCOMPRESSIBLE``.
    """
    n = len(data)
    if n <= 1:
        return INCOMPRESSIBLE
    count = [0] * (max_symbol_value + 1)
    for b in data:
        count[b] += 1
    max_sv = max(s for s, c in enumerate(count) if c) if any(count) else 0
    max_count = max(count)
    if max_count == n:
        return RLE
    if max_count == 1:
        return INCOMPRESSIBLE
    table_log = optimal_table_log(max_table_log, n, max_sv)
    norm = normalize_count(count, table_log, n, max_sv)
    header = write_ncount(norm, max_sv, table_log)
    ct = CTable(norm, table_log)
    payload = compress_using_ctable(data, ct)
    if payload is None:
        return INCOMPRESSIBLE
    return header + payload


def decompress(data: bytes, max_out: int) -> List[int]:
    """Inverse of :func:`compress` for the bytes case (no markers)."""
    norm, max_sv, table_log, consumed = read_ncount(data, max_symbol_limit=255)
    dt = DTable(norm, table_log)
    return decompress_using_dtable(bytes(data)[consumed:], dt, max_out)
