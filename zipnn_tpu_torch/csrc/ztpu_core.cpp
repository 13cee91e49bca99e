// ztpu_core.cpp — native host codec for the .znn container format.
//
// The PyTorch/CUDA port's own copy of the JAX package's csrc/ztpu_core.cpp,
// taken whole (engine "native" is the reference's engine), with the port's
// entries at the end (``ztpu_build_ctables``, ``ztpu_expand_dtables16``,
// ``ztpu_splice_cells``), built only from the static routines above them
// (the table steps of huf_compress_block are one static, huf_build_ctable,
// that ztpu_build_ctables shares).  Bound by zipnn_tpu_torch/native.py.
//
// From-scratch C++ implementation of the same pipeline as the Python golden
// model (zipnn_tpu/codec.py): byte-plane grouping with sign-bit rotation
// (reference semantics: csrc/data_manipulation_dtype16.c/dtype32.c), per-plane
// HUF entropy coding with FSE-compressed weight tables (format per the
// published zstd/FSE spec, RFC 8878 §4.1-4.2), chunk-type + cumulative-size
// tables, and a std::thread pool pulling chunk ids off an atomic counter
// (replacing the reference's pthreads design, zipnn_core.c:294-390).
//
// Exposed as a plain C ABI for ctypes (no CPython dependency).
//
// The encoder is engineered to be byte-identical to the numpy engine: same
// histogram, same heap-Huffman + package-merge length assignment with the
// same tie-breaks, same FSE normalization, same stream framing.  Tests
// cross-validate both directions.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <memory>
#include <mutex>
#include <type_traits>
#if defined(__AVX2__)
#include <immintrin.h>
#endif
#include <cstring>
#include <functional>
#include <queue>
#include <thread>
#include <vector>
#if defined(__GLIBC__) || defined(__linux__)
#include <malloc.h>
#define ZTPU_HAVE_MALLOPT 1
#endif

namespace {

// ---------------------------------------------------------------------------
// small utils
// ---------------------------------------------------------------------------

static inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

static inline void write_le16(uint8_t* p, uint16_t v) { std::memcpy(p, &v, 2); }

static inline uint64_t read_u64_unaligned(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}

static inline void write_u64_unaligned(uint8_t* p, uint64_t v) {
  std::memcpy(p, &v, 8);
}

// ---------------------------------------------------------------------------
// bit io (backward-stream convention; see ops/entropy/bitstream.py)
// ---------------------------------------------------------------------------

struct BitWriter {
  uint64_t acc = 0;
  unsigned nbits = 0;
  std::vector<uint8_t> out;

  inline void add(uint32_t value, unsigned n) {
    acc |= (uint64_t)(value & ((1u << n) - 1)) << nbits;
    nbits += n;
    if (nbits >= 32) {
      unsigned nbytes = nbits >> 3;
      size_t o = out.size();
      out.resize(o + nbytes);
      std::memcpy(&out[o], &acc, nbytes);
      acc >>= nbytes * 8;
      nbits &= 7;
    }
  }
  // close with sentinel bit
  std::vector<uint8_t> close() {
    add(1, 1);
    if (nbits) {
      unsigned nbytes = (nbits + 7) >> 3;
      size_t o = out.size();
      out.resize(o + nbytes);
      std::memcpy(&out[o], &acc, nbytes);
      acc = 0;
      nbits = 0;
    }
    return std::move(out);
  }
  // pad to byte, no sentinel (ncount headers)
  std::vector<uint8_t> finish() {
    if (nbits) {
      unsigned nbytes = (nbits + 7) >> 3;
      size_t o = out.size();
      out.resize(o + nbytes);
      std::memcpy(&out[o], &acc, nbytes);
      acc = 0;
      nbits = 0;
    }
    return std::move(out);
  }
};

// Backward reader: container always holds the 8 bytes at `ptr`; peeks take
// the top bits.  Never reads outside [start, end).
struct BackwardReader {
  uint64_t container = 0;
  unsigned bits_consumed = 0;
  unsigned virtual_pad = 0;  // phantom zero bits below a short (<8 B) stream
  const uint8_t* ptr = nullptr;
  const uint8_t* start = nullptr;
  bool ok = true;

  void init(const uint8_t* src, size_t size) {
    start = src;
    if (size == 0 || src[size - 1] == 0) {
      ok = false;
      return;
    }
    int hb = highbit(src[size - 1]);
    if (size >= 8) {
      ptr = src + size - 8;
      container = read_u64_unaligned(ptr);
      bits_consumed = 8 - hb;
    } else {
      ptr = src;
      container = 0;
      for (size_t i = 0; i < size; i++) container |= (uint64_t)src[i] << (8 * i);
      container <<= (8 - size) * 8;  // last byte at the container MSB
      virtual_pad = (unsigned)((8 - size) * 8);
      bits_consumed = 8 - hb;
    }
  }
  inline uint32_t peek(unsigned n) const {
    unsigned bc = bits_consumed < 63 ? bits_consumed : 63;
    return (uint32_t)((container << bc) >> (64 - n));
  }
  inline void skip(unsigned n) { bits_consumed += n; }
  inline uint32_t read(unsigned n) {
    uint32_t v = n ? peek(n) : 0;
    skip(n);
    return v;
  }
  inline void reload() {
    if (bits_consumed <= 7) return;
    unsigned nb = bits_consumed >> 3;
    size_t avail = (size_t)(ptr - start);
    if (nb > avail) nb = (unsigned)avail;
    if (!nb) return;
    ptr -= nb;
    bits_consumed -= nb * 8;
    container = read_u64_unaligned(ptr);
  }
  inline bool exhausted_exactly() const {
    return ptr == start && bits_consumed == 64 - virtual_pad;
  }
  inline long long bits_left() const {
    return (long long)(ptr - start) * 8 + 64 - (long long)virtual_pad -
           (long long)bits_consumed;
  }
};

// ---------------------------------------------------------------------------
// FSE (for HUF weight tables)
// ---------------------------------------------------------------------------

constexpr int FSE_MIN_TABLELOG = 5;
constexpr int FSE_MAX_TABLELOG = 15;

static int fse_min_table_log(size_t src_size, unsigned max_sv) {
  int a = src_size > 1 ? highbit((uint32_t)(src_size - 1)) + 1 : 1;
  int b = max_sv ? highbit(max_sv) + 2 : 2;
  return a < b ? a : b;
}

static int fse_optimal_table_log(int max_tl, size_t src_size, unsigned max_sv, int minus) {
  int tl = max_tl;
  int max_bits_src = src_size > 1 ? highbit((uint32_t)(src_size - 1)) - minus : 1;
  if (max_bits_src < tl) tl = max_bits_src;
  int mb = fse_min_table_log(src_size, max_sv);
  if (mb > tl) tl = mb;
  if (tl < FSE_MIN_TABLELOG) tl = FSE_MIN_TABLELOG;
  if (tl > FSE_MAX_TABLELOG) tl = FSE_MAX_TABLELOG;
  return tl;
}

static const uint32_t kRtb[8] = {0, 473195, 504333, 520860, 550000, 700000, 750000, 830000};

// returns false on failure
static bool fse_normalize(const uint32_t* count, int table_log, size_t total,
                          unsigned max_sv, int16_t* norm) {
  uint64_t scale = 62 - table_log;
  uint64_t step = ((uint64_t)1 << 62) / total;
  uint64_t v_step = (uint64_t)1 << (scale - 20);
  int64_t still = (int64_t)1 << table_log;
  unsigned largest = 0;
  int16_t largest_p = 0;
  uint32_t low_threshold = (uint32_t)(total >> table_log);
  for (unsigned s = 0; s <= max_sv; s++) norm[s] = 0;
  for (unsigned s = 0; s <= max_sv; s++) {
    uint32_t c = count[s];
    if (c == total) return false;  // rle should not reach here
    if (c == 0) continue;
    if (c <= low_threshold) {
      norm[s] = -1;
      still -= 1;
    } else {
      int16_t proba = (int16_t)(((uint64_t)c * step) >> scale);
      if (proba < 8) {
        uint64_t rest_to_beat = v_step * kRtb[proba];
        if ((uint64_t)c * step - ((uint64_t)proba << scale) > rest_to_beat) proba++;
      }
      if (proba > largest_p) {
        largest_p = proba;
        largest = s;
      }
      norm[s] = proba;
      still -= proba;
    }
  }
  if (-still >= (norm[largest] >> 1)) {
    // fallback distribution (normalizeM2 equivalent)
    const int16_t NOT_YET = -2;
    unsigned distributed = 0;
    size_t rem_total = total;
    uint32_t low_one = (uint32_t)((total * 3) >> (table_log + 1));
    for (unsigned s = 0; s <= max_sv; s++) norm[s] = 0;
    for (unsigned s = 0; s <= max_sv; s++) {
      uint32_t c = count[s];
      if (c == 0) continue;
      if (c <= low_threshold) {
        norm[s] = -1;
        distributed++;
        rem_total -= c;
      } else if (c <= low_one) {
        norm[s] = 1;
        distributed++;
        rem_total -= c;
      } else {
        norm[s] = NOT_YET;
      }
    }
    int64_t to_distribute = ((int64_t)1 << table_log) - distributed;
    if (to_distribute == 0) goto done_m2;
    if (to_distribute && (int64_t)(rem_total / to_distribute) > low_one) {
      low_one = (uint32_t)((rem_total * 3) / (to_distribute * 2));
      for (unsigned s = 0; s <= max_sv; s++) {
        if (norm[s] == NOT_YET && count[s] <= low_one) {
          norm[s] = 1;
          distributed++;
          rem_total -= count[s];
        }
      }
      to_distribute = ((int64_t)1 << table_log) - distributed;
    }
    if (distributed == max_sv + 1) {
      unsigned max_v = 0;
      uint32_t max_c = 0;
      for (unsigned s = 0; s <= max_sv; s++)
        if (count[s] > max_c) {
          max_c = count[s];
          max_v = s;
        }
      norm[max_v] = (int16_t)(norm[max_v] + to_distribute);
      goto done_m2;
    }
    if (rem_total == 0) {
      unsigned s = 0;
      while (to_distribute > 0) {
        if (norm[s] > 0) {
          norm[s]++;
          to_distribute--;
        }
        s = (s + 1) % (max_sv + 1);
      }
      goto done_m2;
    }
    {
      uint64_t v_step_log = 62 - table_log;
      uint64_t mid = ((uint64_t)1 << (v_step_log - 1)) - 1;
      uint64_t r_step = ((((uint64_t)1 << v_step_log) * to_distribute) + mid) / rem_total;
      uint64_t tmp_total = mid;
      for (unsigned s = 0; s <= max_sv; s++) {
        if (norm[s] == NOT_YET) {
          uint64_t end = tmp_total + count[s] * r_step;
          uint32_t s_start = (uint32_t)(tmp_total >> v_step_log);
          uint32_t s_end = (uint32_t)(end >> v_step_log);
          uint32_t weight = s_end - s_start;
          if (weight < 1) return false;
          norm[s] = (int16_t)weight;
          tmp_total = end;
        }
      }
    }
  done_m2:
    for (unsigned s = 0; s <= max_sv; s++)
      if (norm[s] == NOT_YET) return false;
    return true;
  }
  norm[largest] = (int16_t)(norm[largest] + still);
  return true;
}

static bool fse_write_ncount(const int16_t* norm, unsigned max_sv, int table_log,
                             std::vector<uint8_t>& out) {
  BitWriter w;
  int table_size = 1 << table_log;
  w.add(table_log - FSE_MIN_TABLELOG, 4);
  int remaining = table_size + 1;
  int threshold = table_size;
  int nb_bits = table_log + 1;
  unsigned symbol = 0;
  unsigned alphabet = max_sv + 1;
  bool prev0 = false;
  while (symbol < alphabet && remaining > 1) {
    if (prev0) {
      unsigned start = symbol;
      while (symbol < alphabet && !norm[symbol]) symbol++;
      if (symbol == alphabet) return false;
      while (symbol >= start + 24) {
        start += 24;
        w.add(0xFFFF, 16);
      }
      while (symbol >= start + 3) {
        start += 3;
        w.add(3, 2);
      }
      w.add(symbol - start, 2);
    }
    int count = norm[symbol++];
    int mx = (2 * threshold - 1) - remaining;
    remaining -= count < 0 ? -count : count;
    count++;
    if (count >= threshold) count += mx;
    w.add((uint32_t)count, nb_bits - (count < mx ? 1 : 0));
    prev0 = (count == 1);
    if (remaining < 1) return false;
    while (remaining < threshold) {
      nb_bits--;
      threshold >>= 1;
    }
  }
  if (remaining != 1) return false;
  out = w.finish();
  return true;
}

// forward LSB cursor for ncount reading
struct LSBReader {
  const uint8_t* data;
  size_t len;
  size_t pos = 0;  // bit position
  uint32_t peek(unsigned n) const {
    size_t first = pos >> 3;
    uint64_t window = 0;
    size_t last = (pos + n + 7) >> 3;
    for (size_t i = first; i < last && i < len; i++)
      window |= (uint64_t)data[i] << (8 * (i - first));
    return (uint32_t)((window >> (pos - 8 * first)) & (((uint64_t)1 << n) - 1));
  }
  uint32_t read(unsigned n) {
    uint32_t v = peek(n);
    pos += n;
    return v;
  }
};

// returns bytes consumed, or -1 on error
static int fse_read_ncount(const uint8_t* data, size_t len, int16_t* norm,
                           unsigned max_limit, unsigned* max_sv_out, int* table_log_out) {
  LSBReader rd{data, len};
  int table_log = (int)rd.read(4) + FSE_MIN_TABLELOG;
  if (table_log > FSE_MAX_TABLELOG) return -1;
  int remaining = (1 << table_log) + 1;
  int threshold = 1 << table_log;
  int nb_bits = table_log + 1;
  unsigned charnum = 0;
  bool prev0 = false;
  while (remaining > 1 && charnum <= max_limit) {
    if (prev0) {
      unsigned n0 = 0;
      while (rd.peek(16) == 0xFFFF) {
        rd.read(16);
        n0 += 24;
      }
      while (rd.peek(2) == 3) {
        rd.read(2);
        n0 += 3;
      }
      n0 += rd.read(2);
      if (charnum + n0 > max_limit) return -1;
      for (unsigned i = 0; i < n0; i++) norm[charnum++] = 0;
    }
    int mx = (2 * threshold - 1) - remaining;
    int count;
    if ((int)(rd.peek(nb_bits - 1) & (threshold - 1)) < mx) {
      count = (int)(rd.read(nb_bits - 1) & (threshold - 1));
    } else {
      count = (int)(rd.read(nb_bits) & (2 * threshold - 1));
      if (count >= threshold) count -= mx;
    }
    count--;
    remaining -= count < 0 ? -count : count;
    norm[charnum++] = (int16_t)count;
    prev0 = (count == 0);
    while (remaining < threshold) {
      nb_bits--;
      threshold >>= 1;
    }
  }
  if (remaining != 1) return -1;
  int consumed = (int)((rd.pos + 7) >> 3);
  if ((size_t)consumed > len) return -1;
  *max_sv_out = charnum - 1;
  *table_log_out = table_log;
  return consumed;
}

struct FseTables {
  int table_log;
  std::vector<uint16_t> state_table;      // encode: next state
  std::vector<int32_t> delta_nb_bits;     // encode per symbol
  std::vector<int32_t> delta_find_state;  // encode per symbol
  std::vector<uint8_t> d_symbol;          // decode per state
  std::vector<uint8_t> d_nb_bits;
  std::vector<uint16_t> d_new_state;
};

static bool fse_spread(const int16_t* norm, unsigned max_sv, int table_log,
                       std::vector<uint8_t>& table_symbol) {
  int table_size = 1 << table_log;
  int mask = table_size - 1;
  int step = (table_size >> 1) + (table_size >> 3) + 3;
  table_symbol.assign(table_size, 0);
  int high_threshold = table_size - 1;
  for (unsigned s = 0; s <= max_sv; s++)
    if (norm[s] == -1) table_symbol[high_threshold--] = (uint8_t)s;
  int position = 0;
  for (unsigned s = 0; s <= max_sv; s++) {
    for (int i = 0; i < norm[s]; i++) {
      table_symbol[position] = (uint8_t)s;
      position = (position + step) & mask;
      while (position > high_threshold) position = (position + step) & mask;
    }
  }
  return position == 0;
}

static bool fse_build_tables(const int16_t* norm, unsigned max_sv, int table_log,
                             bool want_encode, bool want_decode, FseTables& t) {
  t.table_log = table_log;
  int table_size = 1 << table_log;
  std::vector<uint8_t> table_symbol;
  if (!fse_spread(norm, max_sv, table_log, table_symbol)) return false;

  if (want_encode) {
    std::vector<int32_t> cumul(max_sv + 2, 0);
    for (unsigned s = 0; s <= max_sv; s++)
      cumul[s + 1] = cumul[s] + (norm[s] == -1 ? 1 : norm[s]);
    t.state_table.assign(table_size, 0);
    std::vector<int32_t> next_slot(cumul.begin(), cumul.end() - 1);
    for (int u = 0; u < table_size; u++) {
      uint8_t s = table_symbol[u];
      t.state_table[next_slot[s]++] = (uint16_t)(table_size + u);
    }
    t.delta_nb_bits.assign(max_sv + 1, 0);
    t.delta_find_state.assign(max_sv + 1, 0);
    int total = 0;
    for (unsigned s = 0; s <= max_sv; s++) {
      int n = norm[s];
      if (n == 0) {
        t.delta_nb_bits[s] = ((table_log + 1) << 16) - table_size;
      } else if (n == -1 || n == 1) {
        t.delta_nb_bits[s] = (table_log << 16) - table_size;
        t.delta_find_state[s] = total - 1;
        total += 1;
      } else {
        int max_bits_out = table_log - highbit(n - 1);
        int min_state_plus = n << max_bits_out;
        t.delta_nb_bits[s] = (max_bits_out << 16) - min_state_plus;
        t.delta_find_state[s] = total - n;
        total += n;
      }
    }
  }
  if (want_decode) {
    std::vector<uint16_t> symbol_next(max_sv + 1);
    for (unsigned s = 0; s <= max_sv; s++) symbol_next[s] = norm[s] == -1 ? 1 : norm[s];
    t.d_symbol.assign(table_size, 0);
    t.d_nb_bits.assign(table_size, 0);
    t.d_new_state.assign(table_size, 0);
    for (int u = 0; u < table_size; u++) {
      uint8_t s = table_symbol[u];
      uint16_t next_state = symbol_next[s]++;
      uint8_t nb = (uint8_t)(table_log - highbit(next_state));
      t.d_symbol[u] = s;
      t.d_nb_bits[u] = nb;
      t.d_new_state[u] = (uint16_t)((next_state << nb) - table_size);
    }
  }
  return true;
}

static inline int fse_init_state(const FseTables& t, unsigned symbol) {
  int nb_out = (t.delta_nb_bits[symbol] + (1 << 15)) >> 16;
  int value = (nb_out << 16) - t.delta_nb_bits[symbol];
  return t.state_table[(value >> nb_out) + t.delta_find_state[symbol]];
}

static inline int fse_encode_symbol(BitWriter& w, const FseTables& t, int state,
                                    unsigned symbol) {
  unsigned nb_out = (unsigned)((state + t.delta_nb_bits[symbol]) >> 16);
  w.add((uint32_t)state, nb_out);
  return t.state_table[(state >> nb_out) + t.delta_find_state[symbol]];
}

// FSE-compress `data` (HUF weights).  Returns: 1 = written to out,
// 0 = incompressible/RLE (store raw weights), -1 = error.
static int fse_compress_weights(const uint8_t* data, size_t n, std::vector<uint8_t>& out) {
  if (n <= 1) return 0;
  uint32_t count[16] = {0};
  unsigned max_sv = 0;
  for (size_t i = 0; i < n; i++) {
    if (data[i] > 12) return -1;
    count[data[i]]++;
  }
  for (unsigned s = 0; s <= 12; s++)
    if (count[s]) max_sv = s;
  uint32_t max_count = *std::max_element(count, count + 13);
  if (max_count == n) return 0;  // rle
  if (max_count == 1) return 0;  // all unique
  int table_log = fse_optimal_table_log(6, n, max_sv, 2);
  int16_t norm[16];
  if (!fse_normalize(count, table_log, n, max_sv, norm)) return 0;
  std::vector<uint8_t> header;
  if (!fse_write_ncount(norm, max_sv, table_log, header)) return 0;
  FseTables t;
  if (!fse_build_tables(norm, max_sv, table_log, true, false, t)) return 0;
  if (n <= 2) return 0;
  BitWriter w;
  int c1, c2;
  size_t ip;
  if (n & 1) {
    c1 = fse_init_state(t, data[n - 1]);
    c2 = fse_init_state(t, data[n - 2]);
    c1 = fse_encode_symbol(w, t, c1, data[n - 3]);
    ip = n - 3;
  } else {
    c2 = fse_init_state(t, data[n - 1]);
    c1 = fse_init_state(t, data[n - 2]);
    ip = n - 2;
  }
  while (ip > 0) {
    c2 = fse_encode_symbol(w, t, c2, data[ip - 1]);
    c1 = fse_encode_symbol(w, t, c1, data[ip - 2]);
    ip -= 2;
  }
  w.add((uint32_t)c2, table_log);
  w.add((uint32_t)c1, table_log);
  std::vector<uint8_t> payload = w.close();
  out = std::move(header);
  out.insert(out.end(), payload.begin(), payload.end());
  return 1;
}

// decode FSE weights stream into out (size from stream end); returns count or -1
static int fse_decompress_weights(const uint8_t* data, size_t len, uint8_t* out,
                                  int max_out) {
  int16_t norm[256];
  unsigned max_sv;
  int table_log;
  int consumed = fse_read_ncount(data, len, norm, 255, &max_sv, &table_log);
  if (consumed < 0) return -1;
  FseTables t;
  if (!fse_build_tables(norm, max_sv, table_log, false, true, t)) return -1;
  BackwardReader rd;
  rd.init(data + consumed, len - consumed);
  if (!rd.ok) return -1;
  long long bits_left = rd.bits_left();
  int s1 = (int)rd.read(table_log);
  rd.reload();
  int s2 = (int)rd.read(table_log);
  rd.reload();
  bits_left -= 2 * table_log;
  if (bits_left < 0) return -1;
  int states[2] = {s1, s2};
  int n = 0;
  for (int i = 0;; i ^= 1) {
    if (n > max_out) return -1;
    int st = states[i];
    out[n++] = t.d_symbol[st];
    unsigned nb = t.d_nb_bits[st];
    uint32_t bits = rd.read(nb);
    bits_left -= nb;
    if (bits_left < 0) {
      if (n > max_out) return -1;
      out[n++] = t.d_symbol[states[i ^ 1]];
      break;
    }
    states[i] = t.d_new_state[st] + bits;
    rd.reload();
  }
  return n;
}

// ---------------------------------------------------------------------------
// HUF
// ---------------------------------------------------------------------------

constexpr int HUF_TABLELOG_MAX = 12;
constexpr int HUF_TABLELOG_DEFAULT = 11;
constexpr size_t HUF_BLOCKSIZE_MAX = 128 * 1024;

// heap Huffman (same tie-breaks as the Python model: (freq, id) with
// symbol ids < 256 and internal node ids counting up from 256)
struct HeapNode {
  uint64_t freq;
  int id;
  int left, right;  // -1 for leaves
};

static bool huffman_lengths(const uint32_t* count, uint8_t* lengths /*256*/,
                            int* max_len_out) {
  struct QEnt {
    uint64_t freq;
    int id;
    int node;
  };
  struct Cmp {
    bool operator()(const QEnt& a, const QEnt& b) const {
      if (a.freq != b.freq) return a.freq > b.freq;
      return a.id > b.id;
    }
  };
  std::vector<HeapNode> nodes;
  std::priority_queue<QEnt, std::vector<QEnt>, Cmp> pq;
  for (int s = 0; s < 256; s++) {
    if (count[s]) {
      nodes.push_back({count[s], s, -1, -1});
      pq.push({count[s], s, (int)nodes.size() - 1});
    }
  }
  if (pq.size() < 2) return false;
  int tick = 256;
  while (pq.size() > 1) {
    QEnt a = pq.top();
    pq.pop();
    QEnt b = pq.top();
    pq.pop();
    nodes.push_back({a.freq + b.freq, tick, a.node, b.node});
    pq.push({a.freq + b.freq, tick, (int)nodes.size() - 1});
    tick++;
  }
  // iterative depth walk; mirror python: children pushed (left, d+1) then
  // (right, d+1), popped LIFO — order does not affect depths
  std::memset(lengths, 0, 256);
  int max_len = 0;
  std::vector<std::pair<int, int>> stack;
  stack.push_back({pq.top().node, 0});
  while (!stack.empty()) {
    auto [nd, d] = stack.back();
    stack.pop_back();
    const HeapNode& h = nodes[nd];
    if (h.left < 0) {
      int l = d > 1 ? d : 1;
      lengths[h.id] = (uint8_t)l;
      if (l > max_len) max_len = l;
    } else {
      stack.push_back({h.left, d + 1});
      stack.push_back({h.right, d + 1});
    }
  }
  *max_len_out = max_len;
  return true;
}

// package-merge, boundary form; same ordering as the python model
// (sort key = (freq, symbol sequence) with sequences compared
// lexicographically).  Items are nodes in a pool — a leaf or a pair of
// prior-level nodes — so levels sort ids instead of copying symbol
// vectors; sequence comparison walks the two leaf fringes lazily and
// almost always resolves within a couple of leaves.
struct PMLeafIter {
  // in-order leaf walker over a package tree (depth <= max_len + 1)
  int stack[40];
  int top;
  void init(int node) {
    top = 0;
    stack[top++] = node;
  }
  // returns next leaf's symbol, or -1 when exhausted
  inline int next(const int* left, const int* right, const int* sym) {
    while (top) {
      int nd = stack[--top];
      if (left[nd] < 0) return sym[nd];
      stack[top++] = right[nd];
      stack[top++] = left[nd];
    }
    return -1;
  }
};

static bool package_merge_lengths(const uint32_t* count, int max_len,
                                  uint8_t* lengths /*256*/) {
  // node pool: leaves + up to n/2 packages per level * max_len levels
  static thread_local std::vector<uint64_t> freq;
  static thread_local std::vector<uint64_t> key;
  static thread_local std::vector<int> left, right, sym;
  freq.clear();
  key.clear();
  left.clear();
  right.clear();
  sym.clear();

  auto add_node = [&](uint64_t f, int l, int r, int s) {
    freq.push_back(f);
    left.push_back(l);
    right.push_back(r);
    sym.push_back(s);
    // fast sort key: (freq, first leaf symbol, is_package).  This resolves
    // every ordering except two packages sharing a first symbol (one built
    // over the fresh leaf, one over a prior package carrying it) — those
    // rare ties fall back to the full lazy sequence walk.
    int fs = s;
    int node = l;
    while (fs < 0) {
      fs = sym[node];
      if (fs < 0) node = left[node];
    }
    key.push_back((f << 10) | ((uint64_t)fs << 2) | (s < 0 ? 1 : 0));
    return (int)freq.size() - 1;
  };

  std::vector<int> leaves;
  for (int s = 0; s < 256; s++)
    if (count[s]) leaves.push_back(add_node(count[s], -1, -1, s));
  size_t n = leaves.size();
  if (n < 2 || ((size_t)1 << max_len) < n) return false;

  auto less = [&](int a, int b) {
    if (key[a] != key[b]) return key[a] < key[b];
    PMLeafIter ia, ib;
    ia.init(a);
    ib.init(b);
    const int *L = left.data(), *R = right.data(), *S = sym.data();
    for (;;) {
      int sa = ia.next(L, R, S);
      int sb = ib.next(L, R, S);
      if (sa != sb) {
        if (sa < 0) return true;   // a is a strict prefix -> shorter first
        if (sb < 0) return false;
        return sa < sb;
      }
      if (sa < 0) return false;  // identical sequences (unreachable)
    }
  };

  std::sort(leaves.begin(), leaves.end(), less);
  std::vector<int> prev, packs, cur;
  for (int level = 0; level < max_len; level++) {
    packs.clear();
    for (size_t i = 0; i + 1 < prev.size(); i += 2)
      packs.push_back(add_node(freq[prev[i]] + freq[prev[i + 1]], prev[i],
                               prev[i + 1], -1));
    // Packages inherit sortedness from the sorted prev level: a weight tie
    // between consecutive packages forces all four constituent weights
    // equal, where order reduces to the lexicographic sequence comparison
    // (and a strict-prefix tie is impossible among equal weights, since
    // the extension's leaves would need zero total frequency).  So merging
    // the two sorted runs replaces the full re-sort the profiler showed
    // dominating compress (~100 ms per 64 MB of equal-key heapsort).
    cur.resize(leaves.size() + packs.size());
    std::merge(leaves.begin(), leaves.end(), packs.begin(), packs.end(),
               cur.begin(), less);
    prev = cur;
  }
  std::memset(lengths, 0, 256);
  const int *L = left.data(), *R = right.data(), *S = sym.data();
  for (size_t i = 0; i < 2 * (n - 1) && i < prev.size(); i++) {
    PMLeafIter it;
    it.init(prev[i]);
    for (int s; (s = it.next(L, R, S)) >= 0;) lengths[s]++;
  }
  return true;
}

struct HufCTable {
  uint8_t lengths[256];
  uint16_t vals[256];
  int table_log;
  unsigned max_sv;
  // optional symbol-pair encode table (shared-profile planes, tlog <= 8):
  // pair_vl[(first<<8)|second] = combined_value | combined_len<<20.
  // Output bytes are identical to the single-symbol rounds — canonical
  // values are < 2^len so the OR-composition is exact.
  const uint32_t* pair_vl = nullptr;
};

// Build the 64K-entry pair table (once per plane; ~64K stores, amortized
// over the plane's millions of symbols).  Requires tlog <= 8 so any pair
// fits 16 bits.
static void build_pair_vl(const HufCTable& ct, uint32_t* out /*65536*/) {
  for (int first = 0; first < 256; first++) {
    uint32_t v1 = ct.vals[first];
    uint32_t l1 = ct.lengths[first];
    uint32_t* row = out + ((size_t)first << 8);
    for (int second = 0; second < 256; second++) {
      uint32_t v = v1 | ((uint32_t)ct.vals[second] << l1);
      uint32_t l = l1 + ct.lengths[second];
      row[second] = v | (l << 20);
    }
  }
}

static void canonical_values(HufCTable& ct) {
  int nb_per_rank[HUF_TABLELOG_MAX + 2] = {0};
  for (int s = 0; s < 256; s++) nb_per_rank[ct.lengths[s]]++;
  int val_per_rank[HUF_TABLELOG_MAX + 2] = {0};
  int mn = 0;
  for (int l = ct.table_log; l > 0; l--) {
    val_per_rank[l] = mn;
    mn += nb_per_rank[l];
    mn >>= 1;
  }
  int nxt[HUF_TABLELOG_MAX + 2];
  std::memcpy(nxt, val_per_rank, sizeof(nxt));
  for (int s = 0; s < 256; s++) {
    int l = ct.lengths[s];
    ct.vals[s] = l ? (uint16_t)nxt[l]++ : 0;
  }
}

// weight header: FSE-compressed or raw 4-bit; false => store chunk raw
static bool huf_write_ctable(const HufCTable& ct, std::vector<uint8_t>& out) {
  unsigned max_sv = ct.max_sv;
  std::vector<uint8_t> weights(max_sv);
  for (unsigned s = 0; s < max_sv; s++)
    weights[s] = ct.lengths[s] ? (uint8_t)(ct.table_log + 1 - ct.lengths[s]) : 0;
  if (max_sv > 1) {
    std::vector<uint8_t> comp;
    int r = fse_compress_weights(weights.data(), weights.size(), comp);
    if (r == 1 && comp.size() > 1 && comp.size() < max_sv / 2.0 && comp.size() < 128) {
      out.clear();
      out.push_back((uint8_t)comp.size());
      out.insert(out.end(), comp.begin(), comp.end());
      return true;
    }
  }
  if (max_sv > 128) return false;
  out.clear();
  out.push_back((uint8_t)(127 + max_sv));
  weights.push_back(0);
  for (unsigned i = 0; i < max_sv; i += 2) out.push_back((uint8_t)((weights[i] << 4) | weights[i + 1]));
  return true;
}

struct HufDTable {
  uint8_t sym[1 << HUF_TABLELOG_MAX];
  uint8_t nb[1 << HUF_TABLELOG_MAX];
  uint16_t ent[1 << HUF_TABLELOG_MAX];  // sym | nb<<8: one load per symbol
  int table_log;
};

// Parse a HUF weight header into per-symbol weights (weights[s] = 0 for
// absent symbols; all 256 entries written) plus rank_stats and the
// tableLog, without expanding a decode table.  Returns bytes consumed
// or -1 on a corrupt header.
static int huf_read_weights(const uint8_t* data, size_t len, uint8_t* weights,
                            uint32_t* rank_stats, int* table_log_out,
                            int* n_symbols_out) {
  if (len == 0) return -1;
  unsigned i_size = data[0];
  int o_size;
  int consumed;
  if (i_size >= 128) {
    o_size = (int)i_size - 127;
    int packed = (o_size + 1) / 2;
    if ((size_t)(1 + packed) > len) return -1;
    for (int i = 0; i < o_size; i++) {
      uint8_t b = data[1 + (i >> 1)];
      weights[i] = (i & 1) == 0 ? (b >> 4) : (b & 15);
    }
    consumed = 1 + packed;
  } else {
    if ((size_t)(1 + i_size) > len) return -1;
    o_size = fse_decompress_weights(data + 1, i_size, weights, 255);
    if (o_size < 0) return -1;
    consumed = 1 + (int)i_size;
  }
  for (int w = 0; w <= HUF_TABLELOG_MAX; w++) rank_stats[w] = 0;
  uint64_t weight_total = 0;
  for (int i = 0; i < o_size; i++) {
    if (weights[i] > HUF_TABLELOG_MAX) return -1;
    rank_stats[weights[i]]++;
    weight_total += ((uint64_t)1 << weights[i]) >> 1;
  }
  if (weight_total == 0) return -1;
  int table_log = highbit((uint32_t)weight_total) + 1;
  if (table_log > HUF_TABLELOG_MAX) return -1;
  uint64_t rest = ((uint64_t)1 << table_log) - weight_total;
  int last_weight = highbit((uint32_t)rest) + 1;
  if (rest != ((uint64_t)1 << (last_weight - 1))) return -1;
  if (o_size >= 256) return -1;
  weights[o_size] = (uint8_t)last_weight;
  rank_stats[last_weight]++;
  if (rank_stats[1] < 2 || (rank_stats[1] & 1)) return -1;
  for (int i = o_size + 1; i < 256; i++) weights[i] = 0;
  *table_log_out = table_log;
  *n_symbols_out = o_size + 1;
  return consumed;
}

// returns bytes consumed or -1
static int huf_read_dtable(const uint8_t* data, size_t len, HufDTable& dt) {
  uint8_t weights[256];
  uint32_t rank_stats[HUF_TABLELOG_MAX + 1];
  int table_log, n_symbols;
  int consumed =
      huf_read_weights(data, len, weights, rank_stats, &table_log, &n_symbols);
  if (consumed < 0) return -1;

  // fill decode table
  uint32_t rank_val[HUF_TABLELOG_MAX + 2] = {0};
  uint32_t next_start = 0;
  for (int nn = 1; nn <= table_log; nn++) {
    uint32_t cur = next_start;
    next_start += rank_stats[nn] << (nn - 1);
    rank_val[nn] = cur;
  }
  dt.table_log = table_log;
  for (int s = 0; s < n_symbols; s++) {
    int w = weights[s];
    if (!w) continue;
    uint32_t length = (1u << w) >> 1;
    uint32_t start = rank_val[w];
    std::memset(dt.sym + start, s, length);
    std::memset(dt.nb + start, table_log + 1 - w, length);
    rank_val[w] += length;
  }
  for (int t = 0; t < (1 << dt.table_log); t++)
    dt.ent[t] = (uint16_t)(dt.sym[t] | (dt.nb[t] << 8));
  return consumed;
}

// encode one stream: symbols in descending index order + sentinel.
// Raw-pointer bump writer, one flush per two symbols: canonical values are
// < 2^length so no masking is needed, and two appends fit the 64-bit
// accumulator (nbits < 32 after a flush, + 2x12 = 55 max).  Byte output is
// identical to the BitWriter path (LSB-first continuous bitstream).
static void huf_encode_stream(const uint8_t* part, size_t n, const HufCTable& ct,
                              std::vector<uint8_t>& out) {
  out.resize(n + (n >> 1) + 16);  // 12 bits/symbol worst case + store slack
  uint8_t* op = out.data();
  uint64_t acc = 0;
  unsigned nbits = 0;
  size_t i = n;
  while (i >= 2) {
    uint8_t s1 = part[--i];
    acc |= (uint64_t)ct.vals[s1] << nbits;
    nbits += ct.lengths[s1];
    uint8_t s2 = part[--i];
    acc |= (uint64_t)ct.vals[s2] << nbits;
    nbits += ct.lengths[s2];
    if (nbits >= 32) {
      write_u64_unaligned(op, acc);
      op += 4;
      acc >>= 32;
      nbits -= 32;
    }
  }
  if (i) {
    uint8_t s = part[0];
    acc |= (uint64_t)ct.vals[s] << nbits;
    nbits += ct.lengths[s];
  }
  acc |= (uint64_t)1 << nbits;  // sentinel
  nbits += 1;
  write_u64_unaligned(op, acc);
  op += (nbits + 7) >> 3;
  out.resize((size_t)(op - out.data()));
}

// encode all four segments in lockstep: four independent accumulator
// chains give ~4x ILP over the serial single-stream writer (mirrors the
// interleaved 4-stream decode loop below).  Stream k is written at
// scratch + k*stride (stride must be >= sizes[k]*1.5 + 16); sizes land in
// ssize[4].  Output bytes are identical to four huf_encode_stream calls;
// raw-pointer staging avoids the per-call vector zero-fill + copy that
// used to cost ~1/3 of the encode wall time.
static void huf_encode_4streams(const uint8_t* data, const size_t sizes[4],
                                const HufCTable& ct, uint8_t* scratch,
                                size_t stride, size_t ssize[4]) {
  const uint16_t* vals = ct.vals;
  const uint8_t* lens = ct.lengths;
  // merged (value, length) table: one load per symbol instead of two
  uint32_t vl[256];
  for (int s = 0; s < 256; s++)
    vl[s] = (uint32_t)vals[s] | ((uint32_t)lens[s] << 16);
  uint64_t acc[4] = {0, 0, 0, 0};
  unsigned nb[4] = {0, 0, 0, 0};
  uint8_t* op[4];
  uint8_t* ob[4];
  const uint8_t* sp[4];
  size_t rem[4];
  {
    const uint8_t* p = data;
    for (int k = 0; k < 4; k++) {
      ob[k] = op[k] = scratch + (size_t)k * stride;
      sp[k] = p + sizes[k];  // backward writer: encode from the segment end
      rem[k] = sizes[k];
      p += sizes[k];
    }
  }
  // R symbols per stream per round with one spill: needs 7 + R*tlog <= 63
  // in the 64-bit accumulator.  Every live profile has tlog <= 11 (the
  // per-chunk default caps at HUF_TABLELOG_DEFAULT=11; shared tables cap
  // at 8), so R=5 is always safe and R=7 when tlog <= 8.
  auto run_rounds = [&](auto rconst) {
    constexpr int R = decltype(rconst)::value;
    size_t rounds = (sizes[3] < sizes[0] ? sizes[3] : sizes[0]) / R;
    for (size_t r = 0; r < rounds; r++) {
      for (int k = 0; k < 4; k++) {
        const uint8_t* s = sp[k];
        uint64_t a = acc[k];
        unsigned n = nb[k];
        for (int j = 1; j <= R; j++) {
          uint32_t e = vl[s[-j]];
          a |= (uint64_t)(uint16_t)e << n;
          n += e >> 16;
        }
        sp[k] = s - R;
        acc[k] = a;
        nb[k] = n;
      }
      for (int k = 0; k < 4; k++) {
        write_u64_unaligned(op[k], acc[k]);
        unsigned adv = nb[k] >> 3;
        op[k] += adv;
        acc[k] >>= adv * 8;
        nb[k] &= 7;
      }
    }
    for (int k = 0; k < 4; k++) rem[k] -= R * rounds;
  };
  // Symbol-pair rounds (tlog <= 8 shared tables): vl2[(s1<<8)|s2] packs the
  // combined canonical value (<= 16 bits) + length, so one unaligned u16
  // load + one table load appends TWO symbols — roughly half the encode
  // ops of the single-symbol rounds.  P pairs per round: 7 + 16P <= 63.
  auto run_rounds_pair = [&](const uint32_t* vl2) {
    constexpr int P = 3;
    size_t rounds = (sizes[3] < sizes[0] ? sizes[3] : sizes[0]) / (2 * P);
    for (size_t r = 0; r < rounds; r++) {
      for (int k = 0; k < 4; k++) {
        const uint8_t* s = sp[k];
        uint64_t a = acc[k];
        unsigned n = nb[k];
        for (int j = 1; j <= P; j++) {
          uint16_t pr;  // LE: low byte = s[-2j] (second), high = s[-2j+1]
          std::memcpy(&pr, s - 2 * j, 2);
          uint32_t e = vl2[pr];
          a |= (uint64_t)(e & 0xFFFFFu) << n;
          n += e >> 20;
        }
        sp[k] = s - 2 * P;
        acc[k] = a;
        nb[k] = n;
      }
      for (int k = 0; k < 4; k++) {
        write_u64_unaligned(op[k], acc[k]);
        unsigned adv = nb[k] >> 3;
        op[k] += adv;
        acc[k] >>= adv * 8;
        nb[k] &= 7;
      }
    }
    for (int k = 0; k < 4; k++) rem[k] -= 2 * P * rounds;
  };
  if (ct.pair_vl)
    run_rounds_pair(ct.pair_vl);
  else if (ct.table_log <= 8)
    run_rounds(std::integral_constant<int, 7>{});
  else
    run_rounds(std::integral_constant<int, 5>{});
  for (int k = 0; k < 4; k++) {
    while (rem[k]) {  // tails: at most 3 symbols (segment size skew)
      uint8_t s = *--sp[k];
      acc[k] |= (uint64_t)vals[s] << nb[k];
      nb[k] += lens[s];
      rem[k]--;
      if (nb[k] >= 32) {
        write_u64_unaligned(op[k], acc[k]);
        op[k] += 4;
        acc[k] >>= 32;
        nb[k] -= 32;
      }
    }
    acc[k] |= (uint64_t)1 << nb[k];  // sentinel
    nb[k] += 1;
    write_u64_unaligned(op[k], acc[k]);
    op[k] += (nb[k] + 7) >> 3;
    ssize[k] = (size_t)(op[k] - ob[k]);
  }
}

// per-thread staging for the 4 encode streams (grow-only, uninitialized)
static thread_local std::unique_ptr<uint8_t[]> t_enc_buf;
static thread_local size_t t_enc_cap = 0;
static inline uint8_t* enc_scratch(size_t need) {
  if (need > t_enc_cap) {
    t_enc_buf.reset(new uint8_t[need]);
    t_enc_cap = need;
  }
  return t_enc_buf.get();
}

// decode one stream of exactly out_len symbols; returns false on corruption
static bool huf_decode_stream(const uint8_t* stream, size_t stream_len,
                              const HufDTable& dt, uint8_t* out, size_t out_len) {
  BackwardReader rd;
  rd.init(stream, stream_len);
  if (!rd.ok) return false;
  const int tlog = dt.table_log;
  size_t i = 0;
  // fast path: 4 symbols per reload (4*12 bits fits the 56-bit refill budget)
  while (i + 4 <= out_len && rd.ptr > rd.start) {
    for (int k = 0; k < 4; k++) {
      uint32_t idx = rd.peek(tlog);
      out[i++] = dt.sym[idx];
      rd.skip(dt.nb[idx]);
    }
    rd.reload();
  }
  while (i < out_len) {
    uint32_t idx = rd.peek(tlog);
    out[i++] = dt.sym[idx];
    rd.skip(dt.nb[idx]);
    rd.reload();
  }
  return rd.exhausted_exactly();
}

// full-block byte histogram.  8 sub-histograms: consecutive equal symbols
// would otherwise serialize on store-to-load forwarding of the same
// counter slot (concentrated weight planes hit this hard); fed 16 bytes
// per iteration via two u64 loads to take pressure off the load ports.
static void hist_block(const uint8_t* data, size_t n, uint32_t* count,
                       unsigned* max_sv_out, uint32_t* largest_out) {
  uint32_t cnt8[8][256] = {{0}};
  size_t i = 0;
  for (; i + 16 <= n; i += 16) {
    uint64_t v, w;
    std::memcpy(&v, data + i, 8);
    std::memcpy(&w, data + i + 8, 8);
    cnt8[0][v & 0xFF]++;
    cnt8[1][(v >> 8) & 0xFF]++;
    cnt8[2][(v >> 16) & 0xFF]++;
    cnt8[3][(v >> 24) & 0xFF]++;
    cnt8[4][(v >> 32) & 0xFF]++;
    cnt8[5][(v >> 40) & 0xFF]++;
    cnt8[6][(v >> 48) & 0xFF]++;
    cnt8[7][v >> 56]++;
    cnt8[0][w & 0xFF]++;
    cnt8[1][(w >> 8) & 0xFF]++;
    cnt8[2][(w >> 16) & 0xFF]++;
    cnt8[3][(w >> 24) & 0xFF]++;
    cnt8[4][(w >> 32) & 0xFF]++;
    cnt8[5][(w >> 40) & 0xFF]++;
    cnt8[6][(w >> 48) & 0xFF]++;
    cnt8[7][w >> 56]++;
  }
  for (; i < n; i++) cnt8[0][data[i]]++;
  unsigned max_sv = 0;
  uint32_t largest = 0;
  for (int s = 0; s < 256; s++) {
    uint32_t t = cnt8[0][s];
    for (int k = 1; k < 8; k++) t += cnt8[k][s];
    count[s] = t;
    if (t) max_sv = s;
    if (t > largest) largest = t;
  }
  *max_sv_out = max_sv;
  *largest_out = largest;
}

// The table steps of a block that passed the cheap checks (RLE,
// (n >> 7) + 4, n < 12): tableLog, heap Huffman, package-merge past the
// tableLog, the weight header (and its size check), canonical values.
// false => store raw.
static bool huf_build_ctable(const uint32_t* count, size_t n, unsigned max_sv,
                             HufCTable& ct, std::vector<uint8_t>& header) {
  int table_log = fse_optimal_table_log(HUF_TABLELOG_DEFAULT, n, max_sv, 1);
  int max_len;
  if (!huffman_lengths(count, ct.lengths, &max_len)) return false;
  if (max_len > table_log) {
    if (!package_merge_lengths(count, table_log, ct.lengths)) return false;
    max_len = 0;
    for (int s = 0; s < 256; s++)
      if (ct.lengths[s] > max_len) max_len = ct.lengths[s];
  }
  ct.table_log = max_len;
  ct.max_sv = max_sv;
  if (!huf_write_ctable(ct, header)) return false;
  if (header.size() + 12 >= n) return false;
  canonical_values(ct);
  return true;
}

// HUF-compress a block directly into dst (dst_cap >= n is sufficient:
// anything larger than n-2 is rejected).  Result codes: >0 compressed
// size written at dst; 0 => store raw (dst untouched); -1 => 1-byte RLE
// (dst[0] set).
static long long huf_compress_block(const uint8_t* data, size_t n,
                                    uint8_t* dst, size_t dst_cap) {
  if (n == 0 || n > HUF_BLOCKSIZE_MAX) return 0;
  uint32_t count[256];
  unsigned max_sv;
  uint32_t largest;
  hist_block(data, n, count, &max_sv, &largest);
  if (largest == n) {
    if (dst_cap < 1) return 0;
    dst[0] = data[0];
    return -1;
  }
  if (largest <= (n >> 7) + 4) return 0;
  if (n < 12) return 0;

  HufCTable ct;
  std::vector<uint8_t> header;
  if (!huf_build_ctable(count, n, max_sv, ct, header)) return 0;

  size_t seg = (n + 3) / 4;
  size_t sizes[4] = {seg, seg, seg, n - 3 * seg};
  size_t stride = seg + (seg >> 1) + 16;
  size_t ssize[4];
  huf_encode_4streams(data, sizes, ct, enc_scratch(4 * stride), stride, ssize);
  for (int k = 0; k < 4; k++) {
    if (ssize[k] == 0 || ssize[k] > 65535) return 0;
  }
  size_t total = header.size() + 6 + ssize[0] + ssize[1] + ssize[2] + ssize[3];
  if (total >= n - 1 || total > dst_cap) return 0;
  uint8_t* op = dst;
  std::memcpy(op, header.data(), header.size());
  op += header.size();
  write_le16(op + 0, (uint16_t)ssize[0]);
  write_le16(op + 2, (uint16_t)ssize[1]);
  write_le16(op + 4, (uint16_t)ssize[2]);
  op += 6;
  const uint8_t* sbase = t_enc_buf.get();
  for (int k = 0; k < 4; k++) {
    std::memcpy(op, sbase + (size_t)k * stride, ssize[k]);
    op += ssize[k];
  }
  return (long long)total;
}

// decompress one block (with raw/RLE conventions); returns false on error
static bool huf_decompress_block(const uint8_t* data, size_t c_size, uint8_t* out,
                                 size_t dst_size) {
  if (dst_size == 0 || c_size > dst_size) return false;
  if (c_size == dst_size) {
    std::memcpy(out, data, dst_size);
    return true;
  }
  if (c_size == 1) {
    std::memset(out, data[0], dst_size);
    return true;
  }
  HufDTable dt;
  int consumed = huf_read_dtable(data, c_size, dt);
  if (consumed < 0) return false;
  const uint8_t* rest = data + consumed;
  size_t rest_len = c_size - consumed;
  if (rest_len < 6) return false;
  size_t l[4];
  l[0] = rest[0] | (rest[1] << 8);
  l[1] = rest[2] | (rest[3] << 8);
  l[2] = rest[4] | (rest[5] << 8);
  if (6 + l[0] + l[1] + l[2] > rest_len) return false;
  l[3] = rest_len - 6 - l[0] - l[1] - l[2];
  size_t seg = (dst_size + 3) / 4;
  size_t sizes[4] = {seg, seg, seg, dst_size - 3 * seg};
  const uint8_t* sp = rest + 6;
  // interleave the four streams: each has an independent serial dependency
  // chain (~6 cycles/symbol), so round-robin decoding gives ~4x ILP — the
  // same structure the reference's vendored HUF_decompress4X uses.
  BackwardReader rd[4];
  uint8_t* op[4];
  {
    const uint8_t* s = sp;
    uint8_t* o = out;
    for (int k = 0; k < 4; k++) {
      rd[k].init(s, l[k]);
      if (!rd[k].ok) return false;
      op[k] = o;
      s += l[k];
      o += sizes[k];
    }
  }
  const int tlog = dt.table_log;
  const unsigned shift_base = 64 - (unsigned)tlog;
  // Double-symbol table (zstd X2 idea): entry = sym0 | sym1<<8 |
  // total_bits<<16 | n_syms<<24.  A lookup resolves 2 symbols whenever the
  // second code is fully determined by the remaining peek bits — for the
  // ~4-5 bit/symbol exponent-plane tables that's most lookups, nearly
  // halving the serial per-symbol cost.  Validity of the pair requires the
  // whole aliased index range to share one dtable block (first==last
  // check; canonical blocks are contiguous per symbol).
  static thread_local uint32_t x2[1 << HUF_TABLELOG_MAX];
  {
    uint32_t size = 1u << tlog;
    for (uint32_t d = 0; d < size; d++) {
      uint32_t nb0 = dt.nb[d];
      uint32_t e = dt.sym[d] | (nb0 << 16) | (1u << 24);
      if (nb0 >= 1 && nb0 <= (uint32_t)tlog) {
        uint32_t rem = (uint32_t)tlog - nb0;
        uint32_t d2 = (d << nb0) & (size - 1);
        uint32_t d2e = d2 + (nb0 ? (1u << nb0) - 1 : 0);
        uint32_t nb1 = dt.nb[d2];
        if (nb1 != 0 && nb1 <= rem && dt.nb[d2e] == nb1 &&
            dt.sym[d2e] == dt.sym[d2]) {
          e = dt.sym[d] | ((uint32_t)dt.sym[d2] << 8) | ((nb0 + nb1) << 16) |
              (2u << 24);
        }
      }
      x2[d] = e;
    }
  }
  uint8_t* oend[4];
  for (int k = 0; k < 4; k++) oend[k] = op[k] + sizes[k];
  // burst state lives in locals so the 4 independent ~6-cycle dependency
  // chains register-allocate (the rd[] struct members defeated that: the
  // compiler kept spilling per symbol)
  uint64_t c[4];
  unsigned bc[4];
  const uint8_t* pp[4];
  for (int k = 0; k < 4; k++) {
    c[k] = rd[k].container;
    bc[k] = rd[k].bits_consumed;
    pp[k] = rd[k].ptr;
  }
  for (;;) {
    // hoist the bounds: each round is 4 lookups per stream (<= 4*tlog
    // bits, so the pointer moves back at most 6 bytes) and advances each
    // output by at most 8 symbols plus a 1-byte speculative write
    size_t hdroom = (size_t)-1, orem = (size_t)-1;
    for (int k = 0; k < 4; k++) {
      size_t a = (size_t)(pp[k] - rd[k].start);
      if (a < hdroom) hdroom = a;
      size_t o = (size_t)(oend[k] - op[k]);
      if (o < orem) orem = o;
    }
    size_t rounds = hdroom / 6;
    size_t orounds = orem > 9 ? (orem - 9) / 8 : 0;
    if (orounds < rounds) rounds = orounds;
    if (rounds == 0) break;
    for (size_t r = 0; r < rounds; r++) {
      for (int rep = 0; rep < 4; rep++) {
        for (int k = 0; k < 4; k++) {
          uint32_t e = x2[(uint32_t)((c[k] << bc[k]) >> shift_base)];
          op[k][0] = (uint8_t)e;
          op[k][1] = (uint8_t)(e >> 8);
          op[k] += e >> 24;
          bc[k] += (e >> 16) & 0xFFu;
        }
      }
      for (int k = 0; k < 4; k++) {
        unsigned nb = bc[k] >> 3;
        pp[k] -= nb;
        bc[k] &= 7;
        c[k] = read_u64_unaligned(pp[k]);
      }
    }
  }
  for (int k = 0; k < 4; k++) {
    rd[k].container = c[k];
    rd[k].bits_consumed = bc[k];
    rd[k].ptr = pp[k];
  }
  // tails, one stream at a time (single-symbol, bounds-checked reader)
  for (int k = 0; k < 4; k++) {
    uint8_t* o = op[k];
    while (o < oend[k]) {
      uint32_t idx = rd[k].peek(tlog);
      *o++ = dt.sym[idx];
      rd[k].skip(dt.nb[idx]);
      rd[k].reload();
    }
    if (!rd[k].exhausted_exactly()) return false;
  }
  return true;
}

// ---------------------------------------------------------------------------
// byte-plane transforms (reference semantics, dtype16.c / dtype32.c)
// ---------------------------------------------------------------------------

// ---- fused bit-reorder + 2-plane (de)interleave, AVX2 when available ----
// The reference quirk (data_manipulation_dtype16.c:10-29): the sign
// rotation operates on whole uint32 words, so the final len%4 bytes are
// never reordered — only pairs with index < (len/4)*2 transform.

static void split2(const uint8_t* src, size_t len, int bit_reorder,
                   uint8_t* d0, uint8_t* d1) {
  size_t half = len / 2;
  size_t reo_pairs = bit_reorder ? (len / 4) * 2 : 0;
  size_t vlim = bit_reorder ? reo_pairs : half;
  size_t i = 0;
#if defined(__AVX2__)
  const __m256i m_ff00 = _mm256_set1_epi16((short)0xFF00);
  const __m256i m_0080 = _mm256_set1_epi16(0x0080);
  const __m256i m_007f = _mm256_set1_epi16(0x007F);
  const __m256i m_00ff = _mm256_set1_epi16(0x00FF);
  for (; i + 32 <= vlim; i += 32) {
    __m256i a = _mm256_loadu_si256((const __m256i*)(src + 2 * i));
    __m256i b = _mm256_loadu_si256((const __m256i*)(src + 2 * i + 32));
    if (bit_reorder) {
      a = _mm256_or_si256(
          _mm256_or_si256(_mm256_and_si256(_mm256_slli_epi16(a, 1), m_ff00),
                          _mm256_and_si256(_mm256_srli_epi16(a, 8), m_0080)),
          _mm256_and_si256(a, m_007f));
      b = _mm256_or_si256(
          _mm256_or_si256(_mm256_and_si256(_mm256_slli_epi16(b, 1), m_ff00),
                          _mm256_and_si256(_mm256_srli_epi16(b, 8), m_0080)),
          _mm256_and_si256(b, m_007f));
    }
    __m256i lo = _mm256_packus_epi16(_mm256_and_si256(a, m_00ff),
                                     _mm256_and_si256(b, m_00ff));
    __m256i hi = _mm256_packus_epi16(_mm256_srli_epi16(a, 8),
                                     _mm256_srli_epi16(b, 8));
    lo = _mm256_permute4x64_epi64(lo, 0xD8);
    hi = _mm256_permute4x64_epi64(hi, 0xD8);
    _mm256_storeu_si256((__m256i*)(d0 + i), lo);
    _mm256_storeu_si256((__m256i*)(d1 + i), hi);
  }
#endif
  for (; i < half; i++) {
    uint16_t x = (uint16_t)(src[2 * i] | (src[2 * i + 1] << 8));
    if (i < reo_pairs)
      x = (uint16_t)(((x << 1) & 0xFF00) | ((x >> 8) & 0x0080) | (x & 0x007F));
    d0[i] = (uint8_t)x;
    d1[i] = (uint8_t)(x >> 8);
  }
  if (len & 1) d0[half] = src[len - 1];
}

static void combine2(const uint8_t* s0, const uint8_t* s1, uint8_t* out,
                     size_t len, int bit_reorder) {
  size_t half = len / 2;
  size_t reo_pairs = bit_reorder ? (len / 4) * 2 : 0;
  size_t vlim = bit_reorder ? reo_pairs : half;
  size_t i = 0;
#if defined(__AVX2__)
  const __m256i m_8000 = _mm256_set1_epi16((short)0x8000);
  const __m256i m_7f80 = _mm256_set1_epi16(0x7F80);
  const __m256i m_007f = _mm256_set1_epi16(0x007F);
  for (; i + 32 <= vlim; i += 32) {
    __m256i lo = _mm256_loadu_si256((const __m256i*)(s0 + i));
    __m256i hi = _mm256_loadu_si256((const __m256i*)(s1 + i));
    __m256i t0 = _mm256_unpacklo_epi8(lo, hi);
    __m256i t1 = _mm256_unpackhi_epi8(lo, hi);
    __m256i a = _mm256_permute2x128_si256(t0, t1, 0x20);
    __m256i b = _mm256_permute2x128_si256(t0, t1, 0x31);
    if (bit_reorder) {
      a = _mm256_or_si256(
          _mm256_or_si256(_mm256_and_si256(_mm256_slli_epi16(a, 8), m_8000),
                          _mm256_and_si256(_mm256_srli_epi16(a, 1), m_7f80)),
          _mm256_and_si256(a, m_007f));
      b = _mm256_or_si256(
          _mm256_or_si256(_mm256_and_si256(_mm256_slli_epi16(b, 8), m_8000),
                          _mm256_and_si256(_mm256_srli_epi16(b, 1), m_7f80)),
          _mm256_and_si256(b, m_007f));
    }
    _mm256_storeu_si256((__m256i*)(out + 2 * i), a);
    _mm256_storeu_si256((__m256i*)(out + 2 * i + 32), b);
  }
#endif
  for (; i < half; i++) {
    uint16_t x = (uint16_t)(s0[i] | (s1[i] << 8));
    if (i < reo_pairs)
      x = (uint16_t)(((x << 8) & 0x8000) | ((x >> 1) & 0x7F80) | (x & 0x007F));
    out[2 * i] = (uint8_t)x;
    out[2 * i + 1] = (uint8_t)(x >> 8);
  }
  if (len & 1) out[len - 1] = s0[half];
}

// ---- fused fp32 bit-reorder + 4-plane (de)interleave (SSSE3) ------------
// Same quirk discipline as the 16-bit pair: the rotation operates on whole
// uint32 words; the final len%4 bytes pass through unreordered.

#if defined(__SSSE3__)
static inline __m128i reorder32_vec(__m128i v) {
  return _mm_or_si128(
      _mm_or_si128(
          _mm_and_si128(_mm_slli_epi32(v, 1), _mm_set1_epi32((int)0xFF000000)),
          _mm_and_si128(_mm_srli_epi32(v, 8), _mm_set1_epi32(0x00800000))),
      _mm_and_si128(v, _mm_set1_epi32(0x007FFFFF)));
}

static inline __m128i revert32_vec(__m128i v) {
  return _mm_or_si128(
      _mm_or_si128(
          _mm_and_si128(_mm_slli_epi32(v, 8), _mm_set1_epi32((int)0x80000000)),
          _mm_and_si128(_mm_srli_epi32(v, 1), _mm_set1_epi32(0x7F800000))),
      _mm_and_si128(v, _mm_set1_epi32(0x007FFFFF)));
}
#endif

static void split4(const uint8_t* src, size_t len, int bit_reorder,
                   uint8_t* const* dp) {
  size_t q = len / 4;
  size_t i = 0;
#if defined(__SSSE3__)
  const __m128i sh =
      _mm_setr_epi8(0, 4, 8, 12, 1, 5, 9, 13, 2, 6, 10, 14, 3, 7, 11, 15);
  for (; i + 16 <= q; i += 16) {
    __m128i v0 = _mm_loadu_si128((const __m128i*)(src + 4 * i));
    __m128i v1 = _mm_loadu_si128((const __m128i*)(src + 4 * i + 16));
    __m128i v2 = _mm_loadu_si128((const __m128i*)(src + 4 * i + 32));
    __m128i v3 = _mm_loadu_si128((const __m128i*)(src + 4 * i + 48));
    if (bit_reorder) {
      v0 = reorder32_vec(v0);
      v1 = reorder32_vec(v1);
      v2 = reorder32_vec(v2);
      v3 = reorder32_vec(v3);
    }
    v0 = _mm_shuffle_epi8(v0, sh);
    v1 = _mm_shuffle_epi8(v1, sh);
    v2 = _mm_shuffle_epi8(v2, sh);
    v3 = _mm_shuffle_epi8(v3, sh);
    __m128i t0 = _mm_unpacklo_epi32(v0, v1);
    __m128i t1 = _mm_unpackhi_epi32(v0, v1);
    __m128i t2 = _mm_unpacklo_epi32(v2, v3);
    __m128i t3 = _mm_unpackhi_epi32(v2, v3);
    _mm_storeu_si128((__m128i*)(dp[0] + i), _mm_unpacklo_epi64(t0, t2));
    _mm_storeu_si128((__m128i*)(dp[1] + i), _mm_unpackhi_epi64(t0, t2));
    _mm_storeu_si128((__m128i*)(dp[2] + i), _mm_unpacklo_epi64(t1, t3));
    _mm_storeu_si128((__m128i*)(dp[3] + i), _mm_unpackhi_epi64(t1, t3));
  }
#endif
  for (; i < q; i++) {
    uint32_t u;
    std::memcpy(&u, src + 4 * i, 4);
    if (bit_reorder)
      u = ((u << 1) & 0xFF000000u) | ((u >> 8) & 0x800000u) | (u & 0x7FFFFFu);
    dp[0][i] = (uint8_t)u;
    dp[1][i] = (uint8_t)(u >> 8);
    dp[2][i] = (uint8_t)(u >> 16);
    dp[3][i] = (uint8_t)(u >> 24);
  }
  size_t r = len % 4;
  for (size_t b = 0; b < r; b++) dp[b][q] = src[4 * q + b];
}

static void combine4(const uint8_t* const* sp, uint8_t* out, size_t len,
                     int bit_reorder) {
  size_t q = len / 4;
  size_t i = 0;
#if defined(__SSSE3__)
  for (; i + 16 <= q; i += 16) {
    __m128i v0 = _mm_loadu_si128((const __m128i*)(sp[0] + i));
    __m128i v1 = _mm_loadu_si128((const __m128i*)(sp[1] + i));
    __m128i v2 = _mm_loadu_si128((const __m128i*)(sp[2] + i));
    __m128i v3 = _mm_loadu_si128((const __m128i*)(sp[3] + i));
    __m128i a0 = _mm_unpacklo_epi8(v0, v1);
    __m128i a1 = _mm_unpackhi_epi8(v0, v1);
    __m128i b0 = _mm_unpacklo_epi8(v2, v3);
    __m128i b1 = _mm_unpackhi_epi8(v2, v3);
    __m128i o0 = _mm_unpacklo_epi16(a0, b0);
    __m128i o1 = _mm_unpackhi_epi16(a0, b0);
    __m128i o2 = _mm_unpacklo_epi16(a1, b1);
    __m128i o3 = _mm_unpackhi_epi16(a1, b1);
    if (bit_reorder) {
      o0 = revert32_vec(o0);
      o1 = revert32_vec(o1);
      o2 = revert32_vec(o2);
      o3 = revert32_vec(o3);
    }
    _mm_storeu_si128((__m128i*)(out + 4 * i), o0);
    _mm_storeu_si128((__m128i*)(out + 4 * i + 16), o1);
    _mm_storeu_si128((__m128i*)(out + 4 * i + 32), o2);
    _mm_storeu_si128((__m128i*)(out + 4 * i + 48), o3);
  }
#endif
  for (; i < q; i++) {
    uint32_t u = (uint32_t)sp[0][i] | ((uint32_t)sp[1][i] << 8) |
                 ((uint32_t)sp[2][i] << 16) | ((uint32_t)sp[3][i] << 24);
    if (bit_reorder)
      u = ((u << 8) & 0x80000000u) | ((u >> 1) & 0x7F800000u) | (u & 0x7FFFFFu);
    std::memcpy(out + 4 * i, &u, 4);
  }
  size_t r = len % 4;
  for (size_t b = 0; b < r; b++) out[4 * q + b] = sp[b][q];
}

static void plane_lengths(size_t total, unsigned num_buf, size_t* lens) {
  size_t q = total / num_buf, r = total % num_buf;
  for (unsigned b = 0; b < num_buf; b++) lens[b] = q + (b < r ? 1 : 0);
}

// split chunk into planes (planes buffer must hold `len` bytes contiguously,
// partitioned per plane_lengths)
static void split_planes(const uint8_t* chunk, size_t len, unsigned num_buf,
                         int bit_reorder, uint8_t* scratch_reordered,
                         uint8_t** plane_ptrs, size_t* plane_lens) {
  (void)scratch_reordered;  // both fused paths need no scratch now
  plane_lengths(len, num_buf, plane_lens);
  if (num_buf == 2) {
    // fused reorder + deinterleave: one pass, no scratch copy
    split2(chunk, len, bit_reorder, plane_ptrs[0], plane_ptrs[1]);
    return;
  }
  if (num_buf == 1) {
    std::memcpy(plane_ptrs[0], chunk, len);
    return;
  }
  split4(chunk, len, bit_reorder, plane_ptrs);
}

static void combine_planes(uint8_t* const* plane_ptrs, const size_t* plane_lens,
                           uint8_t* out, size_t len, unsigned num_buf,
                           int bit_reorder) {
  if (num_buf == 1) {
    std::memcpy(out, plane_ptrs[0], len);
    return;
  }
  if (num_buf == 2) {
    // fused interleave + sign-rotation revert: one pass over the output
    combine2(plane_ptrs[0], plane_ptrs[1], out, len, bit_reorder);
    return;
  }
  const uint8_t* sp[4] = {plane_ptrs[0], plane_ptrs[1], plane_ptrs[2],
                          plane_ptrs[3]};
  combine4(sp, out, len, bit_reorder);
}

// ---------------------------------------------------------------------------
// chunk pipeline
// ---------------------------------------------------------------------------

struct ChunkResult {
  // blob[b]/planes point into the call's arena (see arena_acquire below):
  // raw planes keep their bytes in the plane region (no per-plane copy,
  // assembly reads planes + poff[b]); compressed blobs live in the blob
  // region.  Pointer-based results mean zero per-chunk allocations.
  const uint8_t* blob[4] = {nullptr, nullptr, nullptr, nullptr};
  const uint8_t* planes = nullptr;
  size_t poff[4] = {0, 0, 0, 0};
  uint8_t type[4];
  uint64_t size[4];
};

// ---------------------------------------------------------------------------
// compress arena: planes + blobs for a whole call in ONE reusable buffer.
// Per-chunk new[] would fresh-fault ~2x the input size on every call —
// ~2 GB/s on slow-page-fault hosts (nested virtualization pays ~2-14 us a
// page) vs ~17 GB/s for warm writes.  The most recently released arena is
// cached process-wide so steady-state compress calls run entirely on warm
// pages; buffers above ZTPU_ARENA_KEEP_MAX bytes (default 768 MB) are not
// retained.
// ---------------------------------------------------------------------------

struct ArenaLease {
  std::unique_ptr<uint8_t[]> buf;  // uninitialized storage (new[])
  size_t cap = 0;
};
static std::mutex g_arena_mu;
static ArenaLease g_arena;

static size_t arena_keep_max() {
  static size_t v = [] {
    const char* e = std::getenv("ZTPU_ARENA_KEEP_MAX");
    return e ? (size_t)std::strtoull(e, nullptr, 10) : (size_t)(768ull << 20);
  }();
  return v;
}

static ArenaLease arena_acquire(size_t need) {
  ArenaLease a;
  {
    std::lock_guard<std::mutex> lk(g_arena_mu);
    if (g_arena.buf && g_arena.cap >= need) {
      a.buf = std::move(g_arena.buf);
      a.cap = g_arena.cap;
      g_arena.cap = 0;
    }
  }
  if (!a.buf || a.cap < need) {
    a.buf.reset(new uint8_t[need]);
    a.cap = need;
  }
  return a;
}

static void arena_release(ArenaLease a) {
  if (a.cap > arena_keep_max()) return;
  std::lock_guard<std::mutex> lk(g_arena_mu);
  if (!g_arena.buf || a.cap > g_arena.cap) {
    g_arena.buf = std::move(a.buf);
    g_arena.cap = a.cap;
  }
}

// The caller's input/output buffers (np.empty in the ctypes layer) are
// tens of MB: above glibc's default mmap threshold every call gets fresh
// mmap'd pages and pays the page-fault + kernel-zeroing tax on every
// output byte (~2 GB/s on nested-virt hosts vs ~17 GB/s warm — it was
// ~35% of compress wall time).  Raising the thresholds makes glibc reuse
// freed heap warm across calls — the same policy the arena applies to
// internal scratch.  Applied once, on the first native codec call, so
// merely importing the library changes nothing; opt out with
// ZTPU_NO_MALLOPT=1.
static void tune_malloc_once() {
#if defined(ZTPU_HAVE_MALLOPT)
  static std::once_flag f;
  std::call_once(f, [] {
    if (std::getenv("ZTPU_NO_MALLOPT")) return;
    mallopt(M_MMAP_THRESHOLD, 256 << 20);
    mallopt(M_TRIM_THRESHOLD, 512 << 20);
  });
#endif
}

// per-thread fp32 bit-reorder scratch (grow-only, uninitialized)
static thread_local std::unique_ptr<uint8_t[]> t_reorder_buf;
static thread_local size_t t_reorder_cap = 0;
static inline uint8_t* reorder_scratch(size_t need) {
  if (need > t_reorder_cap) {
    t_reorder_buf.reset(new uint8_t[need]);
    t_reorder_cap = need;
  }
  return t_reorder_buf.get();
}

static void run_pool(unsigned threads, size_t n_items,
                     const std::function<void(size_t)>& fn) {
  if (threads <= 1 || n_items <= 1) {
    for (size_t i = 0; i < n_items; i++) fn(i);
    return;
  }
  std::atomic<size_t> next{0};
  unsigned n_threads = std::min<size_t>(threads, n_items);
  std::vector<std::thread> pool;
  pool.reserve(n_threads);
  for (unsigned t = 0; t < n_threads; t++) {
    pool.emplace_back([&]() {
      for (;;) {
        size_t i = next.fetch_add(1, std::memory_order_relaxed);
        if (i >= n_items) return;
        fn(i);
      }
    });
  }
  for (auto& th : pool) th.join();
}
// Shared-table sampling policy — MUST equal codec.SHARED_SAMPLE_MIN_CHUNKS
// / SHARED_SAMPLE_STRIDE; native.py asserts equality at load via
// ztpu_sample_policy so a tune on either side fails loudly instead of
// silently breaking cross-engine byte-identity.
static const size_t kSharedSampleMinChunks = 512;
static const size_t kSharedSampleStride = 8;
}  // namespace

extern "C" {

void ztpu_sample_policy(unsigned* min_chunks, unsigned* stride) {
  *min_chunks = (unsigned)kSharedSampleMinChunks;
  *stride = (unsigned)kSharedSampleStride;
}

// Per-plane byte histograms of the SAMPLED chunks (global chunk index
// 0 mod stride; ``global_chunk0`` is the global index of data's first
// chunk).  out = int64 [num_buf * 256].  The multihost shared profile
// uses this for its table all-reduce (codec.sampled_plane_counts).
long long ztpu_sampled_counts(const uint8_t* data, size_t len,
                              unsigned num_buf, int bit_reorder,
                              int byte_reorder, size_t chunk_size,
                              size_t global_chunk0, size_t stride,
                              long long* out) {
  (void)byte_reorder;
  if (num_buf != 1 && num_buf != 2 && num_buf != 4) return -1;
  if (!stride) return -1;
  size_t n_chunks = chunk_size ? (len + chunk_size - 1) / chunk_size : 0;
  for (size_t i = 0; i < (size_t)num_buf * 256; i++) out[i] = 0;
  std::vector<uint8_t> planes(chunk_size);
  size_t first = (stride - global_chunk0 % stride) % stride;
  for (size_t c = first; c < n_chunks; c += stride) {
    size_t off = c * chunk_size;
    size_t clen = std::min(chunk_size, len - off);
    size_t plens[4];
    uint8_t* pptrs[4] = {nullptr, nullptr, nullptr, nullptr};
    plane_lengths(clen, num_buf, plens);
    size_t acc = 0;
    for (unsigned b = 0; b < num_buf; b++) {
      pptrs[b] = planes.data() + acc;
      acc += plens[b];
    }
    uint8_t* reordered =
        bit_reorder && num_buf == 4 ? reorder_scratch(clen) : nullptr;
    split_planes(data + off, clen, num_buf, bit_reorder, reordered, pptrs,
                 plens);
    for (unsigned b = 0; b < num_buf; b++) {
      uint32_t h[256];
      unsigned msv;
      uint32_t lg;
      hist_block(pptrs[b], plens[b], h, &msv, &lg);
      long long* o = out + (size_t)b * 256;
      for (int s = 0; s < 256; s++) o[s] += h[s];
    }
  }
  return 0;
}

// Batch-parse HUF weight headers into decode tables for the TPU per-cell
// fast path's host prep (a Python-loop parse of a Llama-scale container's
// ~65k distinct per-chunk tables costs tens of seconds; this is ~100 ms).
// For cell i the header starts at payload+offsets[i] with at most sizes[i]
// bytes.  Writes sym/nb (4096 entries per cell; entries beyond 1<<tlog are
// zero) and the tableLog.  Returns 0, or -(i+1) for the first bad header.
long long ztpu_parse_dtables(const uint8_t* payload, const long long* offsets,
                             const long long* sizes, long long n,
                             uint8_t* sym_out, uint8_t* nb_out,
                             int* tlog_out, int threads) {
  std::atomic<long long> bad{0};
  run_pool((unsigned)threads, (size_t)n, [&](size_t i) {
    if (bad.load(std::memory_order_relaxed)) return;
    HufDTable dt;
    int consumed =
        huf_read_dtable(payload + offsets[i], (size_t)sizes[i], dt);
    if (consumed < 0) {
      long long want = 0;
      bad.compare_exchange_strong(want, (long long)i + 1);
      return;
    }
    size_t tsize = (size_t)1 << dt.table_log;
    std::memcpy(sym_out + (size_t)i * 4096, dt.sym, tsize);
    std::memset(sym_out + (size_t)i * 4096 + tsize, 0, 4096 - tsize);
    std::memcpy(nb_out + (size_t)i * 4096, dt.nb, tsize);
    std::memset(nb_out + (size_t)i * 4096 + tsize, 0, 4096 - tsize);
    tlog_out[i] = dt.table_log;
  });
  return -bad.load();
}

// Phase 1 of the TPU per-cell decode plan: batch-parse weight headers into
// per-symbol weights (u8[n][256], zeros for absent symbols) + tableLogs.
// Cheaper than ztpu_parse_dtables: no 4096-entry table expansion per cell.
// Returns 0, or -(i+1) for the first corrupt header.
long long ztpu_parse_dweights(const uint8_t* payload, const long long* offsets,
                              const long long* sizes, long long n,
                              uint8_t* weights_out, int* tlog_out,
                              int threads) {
  std::atomic<long long> bad{0};
  run_pool((unsigned)threads, (size_t)n, [&](size_t i) {
    if (bad.load(std::memory_order_relaxed)) return;
    uint32_t rank_stats[HUF_TABLELOG_MAX + 1];
    int table_log, n_symbols;
    int consumed = huf_read_weights(payload + offsets[i], (size_t)sizes[i],
                                    weights_out + (size_t)i * 256, rank_stats,
                                    &table_log, &n_symbols);
    if (consumed < 0) {
      long long want = 0;
      bad.compare_exchange_strong(want, (long long)i + 1);
      return;
    }
    tlog_out[i] = table_log;
  });
  return -bad.load();
}

// Phase 2: expand per-cell weights into the per-cell decode kernel's host
// inputs — the boundary registers (closed form over rank_stats: bound_m =
// #d-entries with nb > m, i.e. entries whose weight <= tableLog - m,
// scaled into the common tlog_k-bit domain) and the packed symbol pages
// (the canonical dtable fill, longest codes first, written straight into
// the little-endian u32 page words).  Matches ops/pallas_huf_pc.py
// _expand_cell / ops/entropy/huf.py build_dtable byte for byte.
long long ztpu_expand_cells(const uint8_t* weights, const int* tlogs,
                            long long n, int tlog_k, int* bounds_out,
                            uint32_t* pages_out, int threads) {
  if (tlog_k < 1 || tlog_k > HUF_TABLELOG_MAX) return -1;
  size_t page_words = ((size_t)1 << tlog_k) / 4;
  run_pool((unsigned)threads, (size_t)n, [&](size_t i) {
    const uint8_t* w = weights + (size_t)i * 256;
    int tlog = tlogs[i];
    int scale = tlog_k - tlog;
    uint32_t rank_stats[HUF_TABLELOG_MAX + 2] = {0};
    for (int s = 0; s < 256; s++) rank_stats[w[s]]++;
    int* bo = bounds_out + (size_t)i * (tlog_k - 1);
    uint64_t cum_by_w[HUF_TABLELOG_MAX + 2] = {0};
    uint64_t cum = 0;
    for (int wq = 1; wq <= tlog; wq++) {
      cum += (uint64_t)rank_stats[wq] * (((uint64_t)1 << wq) >> 1);
      cum_by_w[wq] = cum;
    }
    for (int m = 1; m < tlog_k; m++) {
      int wmax = tlog - m;  // weights 1..wmax have nb > m
      uint64_t b = wmax >= 1 ? cum_by_w[wmax] : 0;
      bo[m - 1] = (int)(b << scale);
    }
    uint8_t* sym12 = (uint8_t*)(pages_out + (size_t)i * page_words);
    uint32_t rank_val[HUF_TABLELOG_MAX + 2] = {0};
    uint32_t next_start = 0;
    for (int nn = 1; nn <= tlog; nn++) {
      uint32_t cur = next_start;
      next_start += rank_stats[nn] << (nn - 1);
      rank_val[nn] = cur;
    }
    for (int s = 0; s < 256; s++) {
      int ww = w[s];
      if (!ww) continue;
      uint32_t length = ((1u << ww) >> 1) << scale;
      uint32_t start = rank_val[ww] << scale;
      std::memset(sym12 + start, s, length);
      rank_val[ww] += (1u << ww) >> 1;
    }
  });
  return 0;
}

// Splice one plane's cell region of a shared-profile container payload
// from the encode kernel's padded row output plus the gathered raw-cell
// bytes (the host side of the fused TPU encode; replaces a per-cell
// Python loop).  For chunk c the cell starts at out+starts[c]:
//   kinds[c]==0: raw    -> plane_bytes from raw_rows[raw_idx[c]]
//   kinds[c]==1: rle    -> 1 byte rle_vals[c]
//   kinds[c]==2: huf    -> header | 6-byte jump (sbytes LE) | 4 streams,
//     stream k copied from rows[(4c+k)*row_stride] when row_ok[4c+k],
//     else left zeroed for the caller to patch (exact host re-encode).
// Reference equivalent: prepare_python_return_buffer + the interleaved
// copy (zipnn_core.c:56-153).
long long ztpu_splice_plane(uint8_t* out, const long long* starts,
                            const uint8_t* kinds, const uint8_t* rle_vals,
                            const int* raw_idx, const uint8_t* raw_rows,
                            long long raw_stride, const uint8_t* header,
                            long long hlen, const uint16_t* sbytes,
                            const uint8_t* rows, long long row_stride,
                            const uint8_t* row_ok, long long full,
                            long long plane_bytes, int threads) {
  tune_malloc_once();
  std::atomic<bool> failed{false};
  run_pool((unsigned)threads, (size_t)full, [&](size_t c) {
    uint8_t* o = out + starts[c];
    switch (kinds[c]) {
      case 0: {
        int ri = raw_idx ? raw_idx[c] : -1;
        if (ri < 0 || !raw_rows) {
          failed.store(true);
          return;
        }
        std::memcpy(o, raw_rows + (size_t)ri * raw_stride, (size_t)plane_bytes);
        break;
      }
      case 1:
        o[0] = rle_vals[c];
        break;
      default: {
        std::memcpy(o, header, (size_t)hlen);
        o += hlen;
        const uint16_t* sb = sbytes + 4 * c;
        o[0] = (uint8_t)(sb[0] & 0xFF);
        o[1] = (uint8_t)(sb[0] >> 8);
        o[2] = (uint8_t)(sb[1] & 0xFF);
        o[3] = (uint8_t)(sb[1] >> 8);
        o[4] = (uint8_t)(sb[2] & 0xFF);
        o[5] = (uint8_t)(sb[2] >> 8);
        o += 6;
        for (int k = 0; k < 4; k++) {
          size_t n = sb[k];
          if (rows && (!row_ok || row_ok[4 * c + k]))
            std::memcpy(o, rows + (size_t)(4 * c + k) * row_stride, n);
          o += n;
        }
        break;
      }
    }
  });
  return failed.load() ? -1 : 0;
}

// Assemble chunk results into the payload: type table, cumulative sizes,
// plane-major data regions (parallel interleave copy).
static long long assemble_payload(std::vector<ChunkResult>& results,
                                  size_t n_chunks, unsigned num_buf,
                                  int threads, uint8_t* out, size_t out_cap) {
  size_t tables = n_chunks * num_buf * 9;
  size_t total = tables;
  for (size_t c = 0; c < n_chunks; c++)
    for (unsigned b = 0; b < num_buf; b++) total += results[c].size[b];
  if (total > out_cap) return -1;

  uint8_t* tp = out;
  for (unsigned b = 0; b < num_buf; b++)
    for (size_t c = 0; c < n_chunks; c++) *tp++ = results[c].type[b];
  uint8_t* sp = tp;  // cumulative-size table (unaligned-safe writes)
  std::vector<std::vector<uint64_t>> cum_start(num_buf);
  std::vector<uint64_t> plane_totals(num_buf, 0);
  for (unsigned b = 0; b < num_buf; b++) {
    cum_start[b].resize(n_chunks + 1, 0);
    uint64_t cum = 0;
    for (size_t c = 0; c < n_chunks; c++) {
      cum_start[b][c] = cum;
      cum += results[c].size[b];
      write_u64_unaligned(sp + 8 * (b * n_chunks + c), cum);
    }
    plane_totals[b] = cum;
  }
  std::vector<uint64_t> plane_base(num_buf, 0);
  for (unsigned b = 1; b < num_buf; b++)
    plane_base[b] = plane_base[b - 1] + plane_totals[b - 1];
  uint8_t* dbase = out + tables;
  run_pool((unsigned)threads, n_chunks, [&](size_t c) {
    const ChunkResult& r = results[c];
    for (unsigned b = 0; b < num_buf; b++) {
      const uint8_t* s = r.type[b] ? r.blob[b] : r.planes + r.poff[b];
      std::memcpy(dbase + plane_base[b] + cum_start[b][c], s, r.size[b]);
    }
  });
  return (long long)total;
}

// Compress `data` into the table+planes payload.  Returns payload size, or
// -1 on error / insufficient capacity.
//
// check_th_after_percent: the bounded threshold check (the reference's
// intended-but-dead checkCompTh semantics, zipnn_core.c:423-424, 554-558;
// spec codec.check_abandon_index): after coding chunks [0, K] with
// K = ceil(n_chunks/percent), a plane whose cumulative stored size exceeds
// threshold x its uncompressed size is abandoned — chunks (K, n) of it are
// stored raw with NO Huffman attempt.  0 disables.  raw_planes_mask: bit b
// forces plane b raw from chunk 0 (the distributed form of the same check,
// where the decision arrives via a collective — parallel/multihost.py).
long long ztpu_compress(const uint8_t* data, size_t len, unsigned num_buf,
                        int bit_reorder, int byte_reorder, size_t chunk_size,
                        double threshold, int threads,
                        int check_th_after_percent, unsigned raw_planes_mask,
                        uint8_t* out, size_t out_cap) {
  tune_malloc_once();
  (void)byte_reorder;  // plane count fully determines the live split modes
  if (num_buf != 1 && num_buf != 2 && num_buf != 4) return -1;
  size_t n_chunks = chunk_size ? (len + chunk_size - 1) / chunk_size : 0;
  std::vector<ChunkResult> results(n_chunks);
  std::atomic<bool> failed{false};

  // one arena for every chunk's planes + blobs (see arena_acquire)
  ArenaLease arena = arena_acquire(2 * n_chunks * chunk_size + 1);
  uint8_t* planes_region = arena.buf.get();
  uint8_t* blob_region = planes_region + n_chunks * chunk_size;

  unsigned skip_mask = raw_planes_mask;
  auto do_chunk = [&](size_t c, unsigned skip) {
    if (failed.load(std::memory_order_relaxed)) return;
    size_t off = c * chunk_size;
    size_t clen = std::min(chunk_size, len - off);
    uint8_t* planes = planes_region + c * chunk_size;
    uint8_t* blobd = blob_region + c * chunk_size;
    size_t plens[4];
    uint8_t* pptrs[4] = {nullptr, nullptr, nullptr, nullptr};
    plane_lengths(clen, num_buf, plens);
    size_t acc = 0;
    for (unsigned b = 0; b < num_buf; b++) {
      pptrs[b] = planes + acc;
      acc += plens[b];
    }
    // scratch only for the fp32 reorder path; the 2-plane split is fused
    uint8_t* reordered =
        bit_reorder && num_buf == 4 ? reorder_scratch(clen) : nullptr;
    split_planes(data + off, clen, num_buf, bit_reorder, reordered, pptrs,
                 plens);
    ChunkResult& r = results[c];
    r.planes = planes;
    size_t acc2 = 0, bcur = 0;
    for (unsigned b = 0; b < num_buf; b++) {
      r.poff[b] = acc2;
      acc2 += plens[b];
      if (skip & (1u << b)) {  // abandoned plane: raw, no attempt
        r.type[b] = 0;
        r.size[b] = plens[b];
        continue;
      }
      long long cs =
          huf_compress_block(pptrs[b], plens[b], blobd + bcur, clen - bcur);
      size_t csize = cs == -1 ? 1 : (cs > 0 ? (size_t)cs : 0);
      if (csize && (double)csize < (double)plens[b] * threshold) {
        r.type[b] = 1;
        r.size[b] = csize;
        r.blob[b] = blobd + bcur;
        bcur += csize;
      } else {
        r.type[b] = 0;
        r.size[b] = plens[b];
      }
    }
  };

  size_t check_idx = n_chunks;  // disabled sentinel
  if (check_th_after_percent > 0 && n_chunks > 1) {
    size_t k =
        (n_chunks + (size_t)check_th_after_percent - 1) /
        (size_t)check_th_after_percent;
    if (k < n_chunks - 1) check_idx = k;
  }
  if (check_idx < n_chunks) {
    // phase 1: the prefix [0, K]; then the per-plane abandonment decision
    run_pool((unsigned)threads, check_idx + 1,
             [&](size_t c) { do_chunk(c, skip_mask); });
    if (failed.load()) return -1;
    size_t plens[4];
    plane_lengths(chunk_size, num_buf, plens);  // prefix chunks are full
    for (unsigned b = 0; b < num_buf; b++) {
      uint64_t stored = 0;
      for (size_t c = 0; c <= check_idx; c++) stored += results[c].size[b];
      uint64_t uncomp = (uint64_t)(check_idx + 1) * plens[b];
      // identical IEEE-double expression to codec.check_abandon_planes
      if ((double)stored > (double)uncomp * threshold)
        skip_mask |= (1u << b);
    }
    // phase 2: the remaining chunks with the abandonment applied
    run_pool((unsigned)threads, n_chunks - (check_idx + 1),
             [&](size_t i) { do_chunk(check_idx + 1 + i, skip_mask); });
  } else {
    run_pool((unsigned)threads, n_chunks,
             [&](size_t c) { do_chunk(c, skip_mask); });
  }
  if (failed.load()) return -1;
  long long ret =
      assemble_payload(results, n_chunks, num_buf, threads, out, out_cap);
  arena_release(std::move(arena));
  return ret;
}

// Shared-table profile compress (the TPU-optimal encode profile): one
// <=8-bit Huffman table per byte plane built from the plane-global
// histogram, identical weight headers repeated per block.  Byte-identical
// to codec.compress_payload_numpy(shared_tables=True), the profile's
// specification.  Returns payload size, -1 on error, or -2 when a plane
// histogram overflows uint32 (caller falls back to the numpy engine).
//
// preset_lengths (nullable): num_buf x 256 externally built code lengths
// (all-zero row = no table for that plane) with preset_live[num_buf]
// hopeless flags — the multihost shared profile passes the global-
// histogram table so every process emits identical bytes
// (codec.shared_tables_from_counts).
long long ztpu_compress_shared(const uint8_t* data, size_t len,
                               unsigned num_buf, int bit_reorder,
                               int byte_reorder, size_t chunk_size,
                               double threshold, int threads,
                               const uint8_t* preset_lengths,
                               const uint8_t* preset_live, uint8_t* out,
                               size_t out_cap) {
  tune_malloc_once();
  (void)byte_reorder;
  if (num_buf != 1 && num_buf != 2 && num_buf != 4) return -1;
  size_t n_chunks = chunk_size ? (len + chunk_size - 1) / chunk_size : 0;

  // one arena for planes + blobs; planes written by pass 1 are REUSED by
  // pass 2 (the old per-pass new[] + re-split paid a second full split
  // pass plus fresh page faults both times)
  ArenaLease arena = arena_acquire(2 * n_chunks * chunk_size + 1);
  uint8_t* planes_region = arena.buf.get();
  uint8_t* blob_region = planes_region + n_chunks * chunk_size;

  // pass 1: split into the arena + per-(chunk, plane) histograms
  std::vector<uint32_t> hists((size_t)n_chunks * num_buf * 256, 0);
  run_pool((unsigned)threads, n_chunks, [&](size_t c) {
    size_t off = c * chunk_size;
    size_t clen = std::min(chunk_size, len - off);
    uint8_t* planes = planes_region + c * chunk_size;
    size_t plens[4];
    uint8_t* pptrs[4] = {nullptr, nullptr, nullptr, nullptr};
    plane_lengths(clen, num_buf, plens);
    size_t acc = 0;
    for (unsigned b = 0; b < num_buf; b++) {
      pptrs[b] = planes + acc;
      acc += plens[b];
    }
    uint8_t* reordered =
        bit_reorder && num_buf == 4 ? reorder_scratch(clen) : nullptr;
    split_planes(data + off, clen, num_buf, bit_reorder, reordered, pptrs,
                 plens);
    for (unsigned b = 0; b < num_buf; b++) {
      uint32_t* h = hists.data() + (c * num_buf + b) * 256;
      unsigned msv;
      uint32_t lg;
      hist_block(pptrs[b], plens[b], h, &msv, &lg);
    }
  });

  // shared table per plane.  Format policy (codec.shared_sample_stride):
  // above the gate the table is built from every stride-th chunk's
  // histogram only, and a plane whose sampled expected code length
  // cannot beat the threshold is "hopeless" — every cell raw (RLE still
  // applies).  The constants are asserted against the Python spec's at
  // library load (native.py reads ztpu_sample_policy).
  const size_t sample_stride =
      n_chunks >= kSharedSampleMinChunks ? kSharedSampleStride : 1;
  struct SharedT {
    HufCTable ct;
    std::vector<uint8_t> header;
    bool ok = false;
    bool live = true;
  };
  SharedT sh[4];
  for (unsigned b = 0; b < num_buf; b++) {
    if (preset_lengths) {
      HufCTable& ct = sh[b].ct;
      const uint8_t* pl = preset_lengths + (size_t)b * 256;
      int max_len = 0;
      unsigned max_sv = 0, n_present = 0;
      for (int s = 0; s < 256; s++) {
        ct.lengths[s] = pl[s];
        if (pl[s]) {
          n_present++;
          max_sv = s;
          if (pl[s] > max_len) max_len = pl[s];
        }
      }
      sh[b].live = preset_live && preset_live[b];
      if (n_present == 0) continue;     // no table for this plane
      if (n_present < 2 || max_len > 8) return -1;  // invalid preset
      ct.table_log = max_len;
      ct.max_sv = max_sv;
      if (!huf_write_ctable(ct, sh[b].header)) return -1;
      canonical_values(ct);
      sh[b].ok = true;
      continue;
    }
    uint64_t count64[256] = {0};
    for (size_t c = 0; c < n_chunks; c += sample_stride) {
      const uint32_t* h = hists.data() + (c * num_buf + b) * 256;
      for (int s = 0; s < 256; s++) count64[s] += h[s];
    }
    uint64_t total = 0;
    uint32_t count[256];
    unsigned n_present = 0, max_sv = 0;
    for (int s = 0; s < 256; s++) {
      if (count64[s] > 0xFFFFFFFFull) return -2;
      count[s] = (uint32_t)count64[s];
      total += count64[s];
      if (count[s]) {
        n_present++;
        max_sv = s;
      }
    }
    sh[b].live = sample_stride == 1;  // hopeless rule only when sampling
    if (total == 0 || n_present < 2) continue;  // no table (build returns None)
    HufCTable& ct = sh[b].ct;
    int max_len;
    if (!huffman_lengths(count, ct.lengths, &max_len)) continue;
    if (max_len > 8) {
      if (!package_merge_lengths(count, 8, ct.lengths)) continue;
      max_len = 0;
      for (int s = 0; s < 256; s++)
        if (ct.lengths[s] > max_len) max_len = ct.lengths[s];
    }
    ct.table_log = max_len;
    ct.max_sv = max_sv;
    if (!huf_write_ctable(ct, sh[b].header)) continue;
    canonical_values(ct);
    sh[b].ok = true;
    if (sample_stride > 1) {
      // identical IEEE-double expression as codec.shared_plane_hopeless
      uint64_t sbits = 0;
      for (int s = 0; s < 256; s++)
        sbits += count64[s] * (uint64_t)ct.lengths[s];
      sh[b].live = !((double)sbits >= threshold * 8.0 * (double)total);
    }
  }

  // pair-encode tables for the live planes (tlog <= 8 by construction of
  // the shared profile): ~100us build per plane, ~2x fewer encode ops
  std::vector<std::unique_ptr<uint32_t[]>> pair_tbls(num_buf);
  for (unsigned b = 0; b < num_buf; b++) {
    if (sh[b].ok && sh[b].live) {
      pair_tbls[b].reset(new uint32_t[65536]);
      build_pair_vl(sh[b].ct, pair_tbls[b].get());
      sh[b].ct.pair_vl = pair_tbls[b].get();
    }
  }

  // pass 2: encode every cell (planes already split in the arena) with
  // its plane's shared table
  std::vector<ChunkResult> results(n_chunks);
  run_pool((unsigned)threads, n_chunks, [&](size_t c) {
    size_t off = c * chunk_size;
    size_t clen = std::min(chunk_size, len - off);
    uint8_t* planes = planes_region + c * chunk_size;
    uint8_t* blobd = blob_region + c * chunk_size;
    size_t plens[4];
    uint8_t* pptrs[4] = {nullptr, nullptr, nullptr, nullptr};
    plane_lengths(clen, num_buf, plens);
    size_t acc = 0;
    for (unsigned b = 0; b < num_buf; b++) {
      pptrs[b] = planes + acc;
      acc += plens[b];
    }
    ChunkResult& r = results[c];
    r.planes = planes;
    size_t acc2 = 0, bcur = 0;
    for (unsigned b = 0; b < num_buf; b++) {
      r.poff[b] = acc2;
      acc2 += plens[b];
      size_t n = plens[b];
      const uint32_t* h = hists.data() + (c * num_buf + b) * 256;
      uint32_t largest = 0;
      for (int s = 0; s < 256; s++)
        if (h[s] > largest) largest = h[s];
      size_t csize = 0;  // 0 = no candidate blob
      if (n > 0 && largest == n) {
        blobd[bcur] = pptrs[b][0];  // 1-byte RLE cell
        csize = 1;
      } else if (n >= 12 && n <= HUF_BLOCKSIZE_MAX && sh[b].ok && sh[b].live) {
        // sound lower bound from the cell histogram: the encoded cell is
        // at least header + jump + total_code_bits/8 bytes, so a cell
        // whose lower bound already fails the size/threshold guards is
        // raw without running the encoder (mantissa planes skip ~all
        // their encode work; decisions stay byte-exact because the true
        // size can only be larger).  A sampled table (stride > 1) may
        // have no code for a byte the sample never saw — such a cell
        // stores raw (codec.compress_cell_shared's guard).
        uint64_t bits = 0;
        bool uncodeable = false;
        for (int s2 = 0; s2 < 256; s2++) {
          if (h[s2] && !sh[b].ct.lengths[s2]) uncodeable = true;
          bits += (uint64_t)h[s2] * sh[b].ct.lengths[s2];
        }
        uint64_t lower = sh[b].header.size() + 6 + bits / 8;
        if (uncodeable || (double)lower >= (double)n * threshold ||
            lower >= n - 1) {
          r.type[b] = 0;
          r.size[b] = n;
          continue;
        }
        // compress_with_table: 4-stream encode with the fixed table
        size_t seg = (n + 3) / 4;
        size_t sizes[4] = {seg, seg, seg, n - 3 * seg};
        size_t stride = seg + (seg >> 1) + 16;
        size_t ssize[4];
        huf_encode_4streams(pptrs[b], sizes, sh[b].ct,
                            enc_scratch(4 * stride), stride, ssize);
        bool ok = true;
        for (int k = 0; k < 4; k++)
          if (ssize[k] == 0 || ssize[k] > 65535) ok = false;
        size_t total =
            sh[b].header.size() + 6 + ssize[0] + ssize[1] + ssize[2] + ssize[3];
        // compress_with_table size guard + blob-region capacity
        if (ok && total < n - 1 && total <= clen - bcur) {
          uint8_t* op = blobd + bcur;
          std::memcpy(op, sh[b].header.data(), sh[b].header.size());
          op += sh[b].header.size();
          write_le16(op + 0, (uint16_t)ssize[0]);
          write_le16(op + 2, (uint16_t)ssize[1]);
          write_le16(op + 4, (uint16_t)ssize[2]);
          op += 6;
          const uint8_t* sbase = t_enc_buf.get();
          for (int k = 0; k < 4; k++) {
            std::memcpy(op, sbase + (size_t)k * stride, ssize[k]);
            op += ssize[k];
          }
          csize = total;
        }
      }
      if (csize && (double)csize < (double)n * threshold) {
        r.type[b] = 1;
        r.size[b] = csize;
        r.blob[b] = blobd + bcur;
        bcur += csize;
      } else {
        r.type[b] = 0;
        r.size[b] = n;
      }
    }
  });
  long long ret =
      assemble_payload(results, n_chunks, num_buf, threads, out, out_cap);
  arena_release(std::move(arena));
  return ret;
}

// Decompress the table+planes payload into `out` (orig_size bytes).
// Returns 0 on success, negative on error.
long long ztpu_decompress(const uint8_t* payload, size_t payload_len,
                          unsigned num_buf, int bit_reorder, int byte_reorder,
                          size_t chunk_size, size_t orig_size, int threads,
                          uint8_t* out) {
  tune_malloc_once();
  (void)byte_reorder;
  if (num_buf != 1 && num_buf != 2 && num_buf != 4) return -1;
  size_t n_chunks = chunk_size ? (orig_size + chunk_size - 1) / chunk_size : 0;
  if (n_chunks == 0) return 0;
  size_t tables = n_chunks * num_buf * 9;
  if (payload_len < tables) return -2;
  const uint8_t* types = payload;
  const uint8_t* cum_raw = payload + n_chunks * num_buf;
  auto cum = [&](unsigned b, size_t c) -> uint64_t {
    return read_u64_unaligned(cum_raw + 8 * (b * n_chunks + c));
  };
  const uint8_t* dbase = payload + tables;
  size_t data_len = payload_len - tables;

  std::vector<uint64_t> plane_base(num_buf, 0);
  for (unsigned b = 1; b < num_buf; b++)
    plane_base[b] = plane_base[b - 1] + cum(b - 1, n_chunks - 1);
  uint64_t total_data = plane_base[num_buf - 1] + cum(num_buf - 1, n_chunks - 1);
  if (total_data > data_len) return -3;

  std::atomic<long long> status{0};
  run_pool((unsigned)threads, n_chunks, [&](size_t c) {
    if (status.load(std::memory_order_relaxed) != 0) return;
    size_t off = c * chunk_size;
    size_t clen = std::min(chunk_size, orig_size - off);
    size_t plens[4];
    plane_lengths(clen, num_buf, plens);
    // decode each plane (raw planes point into the payload, zero copy)
    std::vector<uint8_t> scratch;
    uint8_t* pptrs[4];
    size_t scratch_need = 0;
    for (unsigned b = 0; b < num_buf; b++)
      if (types[b * n_chunks + c] == 1) scratch_need += plens[b];
    scratch.resize(scratch_need);
    size_t sacc = 0;
    for (unsigned b = 0; b < num_buf; b++) {
      uint64_t start = (c == 0) ? 0 : cum(b, c - 1);
      uint64_t end = cum(b, c);
      const uint8_t* blob = dbase + plane_base[b] + start;
      size_t blen = (size_t)(end - start);
      uint8_t t = types[b * n_chunks + c];
      if (t == 0) {
        if (blen != plens[b]) {
          status.store(-4);
          return;
        }
        pptrs[b] = const_cast<uint8_t*>(blob);
      } else if (t == 1) {
        uint8_t* dst = scratch.data() + sacc;
        sacc += plens[b];
        if (!huf_decompress_block(blob, blen, dst, plens[b])) {
          status.store(-5);
          return;
        }
        pptrs[b] = dst;
      } else {
        status.store(-6);
        return;
      }
    }
    combine_planes(pptrs, plens, out + off, clen, num_buf, bit_reorder);
  });
  return status.load();
}

// single-block entry points (for cross-validation tests)
long long ztpu_huf_compress(const uint8_t* data, size_t n, uint8_t* out,
                            size_t out_cap) {
  long long r = huf_compress_block(data, n, out, out_cap);
  if (r == 0) return 0;
  if (r == -1) return out_cap < 1 ? -1 : 1;  // 1-byte RLE already in out[0]
  return r;
}

long long ztpu_huf_decompress(const uint8_t* data, size_t c_size, uint8_t* out,
                              size_t dst_size) {
  return huf_decompress_block(data, c_size, out, dst_size) ? (long long)dst_size : -1;
}


// ---------------------------------------------------------------------------
// entries of the PyTorch/CUDA port
// ---------------------------------------------------------------------------

// Per-cell Huffman tables of the per-chunk encode, a batch of m count rows
// (u32 [m][256]) of cells of n bytes each: the table steps that
// huf_compress_block takes once a cell has passed its cheap checks (RLE,
// (n >> 7) + 4, n < 12; the caller takes those vectorised), that is
// huf_build_ctable.  Per row: status 1 (Huffman) or 0
// (raw: no code lengths, no header, or a header too long for the cell),
// lengths u8 [256], canonical values u16 [256], the header at
// headers + i * hdr_stride (hdr_stride >= 128) and its length.  Rows of a
// raw status are all zero.  Returns 0, or -1 for a bad argument.
long long ztpu_build_ctables(const uint32_t* counts, long long m, long long n,
                             uint8_t* status, uint8_t* lengths, uint16_t* vals,
                             uint8_t* headers, long long hdr_stride,
                             int* hlens, int threads) {
  if (m < 0 || n <= 0 || hdr_stride < 128) return -1;
  run_pool((unsigned)threads, (size_t)m, [&](size_t i) {
    const uint32_t* count = counts + i * 256;
    uint8_t* lo = lengths + i * 256;
    uint16_t* vo = vals + i * 256;
    status[i] = 0;
    hlens[i] = 0;
    std::memset(lo, 0, 256);
    std::memset(vo, 0, 256 * sizeof(uint16_t));
    unsigned max_sv = 0;
    for (int s = 0; s < 256; s++)
      if (count[s]) max_sv = (unsigned)s;
    HufCTable ct;
    std::vector<uint8_t> header;
    if (!huf_build_ctable(count, (size_t)n, max_sv, ct, header)) return;
    std::memcpy(lo, ct.lengths, 256);
    std::memcpy(vo, ct.vals, 256 * sizeof(uint16_t));
    std::memcpy(headers + i * hdr_stride, header.data(), header.size());
    hlens[i] = (int)header.size();
    status[i] = 1;
  });
  return 0;
}

// Decode tables of the port's per-cell decode kernel from parsed weights
// (ztpu_parse_dweights): for cell i a row of 2^tlog_k int16 entries
// ``symbol | nb_bits << 8``, the canonical fill of huf_read_dtable over
// the first 2^tlogs[i] entries, zeros past them.  Returns 0, or -1 for a
// tableLog outside [1, tlog_k].
long long ztpu_expand_dtables16(const uint8_t* weights, const int* tlogs,
                                long long n, int tlog_k, int16_t* out,
                                int threads) {
  if (tlog_k < 1 || tlog_k > HUF_TABLELOG_MAX) return -1;
  size_t row = (size_t)1 << tlog_k;
  std::atomic<bool> bad{false};
  run_pool((unsigned)threads, (size_t)n, [&](size_t i) {
    const uint8_t* w = weights + i * 256;
    int tlog = tlogs[i];
    int16_t* o = out + i * row;
    std::memset(o, 0, row * sizeof(int16_t));
    if (tlog < 1 || tlog > tlog_k) {
      bad.store(true);
      return;
    }
    uint32_t rank_stats[HUF_TABLELOG_MAX + 2] = {0};
    for (int s = 0; s < 256; s++) rank_stats[w[s]]++;
    uint32_t rank_val[HUF_TABLELOG_MAX + 2] = {0};
    uint32_t next_start = 0;
    for (int nn = 1; nn <= tlog; nn++) {
      rank_val[nn] = next_start;
      next_start += rank_stats[nn] << (nn - 1);
    }
    for (int s = 0; s < 256; s++) {
      int ww = w[s];
      if (!ww) continue;
      uint32_t length = (1u << ww) >> 1;
      uint32_t start = rank_val[ww];
      int16_t ent = (int16_t)(s | ((tlog + 1 - ww) << 8));
      for (uint32_t t = start; t < start + length && t < row; t++) o[t] = ent;
      rank_val[ww] += length;
    }
  });
  return bad.load() ? -1 : 0;
}

// Splice cells of a container payload, each at its absolute start in out
// (the caller's header prefix and chunk tables in front).  Cell c of kind
//   0: copies sizes[c] bytes from blob + boffs[c] (a raw cell, or a block
//      the caller coded whole);
//   1: writes the RLE byte rle_vals[c];
//   2: writes header h = hids[c] of the pool (hpool + hoffs[h], hlens[h]
//      bytes, inside the pool's pool_len bytes),
//      the 6-byte jump table (jumps[3c .. 3c + 2], little-endian) and
//      sizes[c] - hlen - 6 stream bytes from blob + boffs[c].
// Threaded over ranges of cells.  Returns 0, or -(c + 1) for a cell that
// reads outside the blob or the pool (nothing is written past its start).
long long ztpu_splice_cells(uint8_t* out, long long n_cells, const long long* starts,
                            const uint8_t* kinds, const long long* sizes,
                            const uint8_t* rle_vals, const long long* hids,
                            const uint8_t* hpool, long long pool_len,
                            const long long* hoffs, const long long* hlens,
                            long long n_headers,
                            const uint16_t* jumps, const long long* boffs,
                            const uint8_t* blob, long long blob_len, int threads) {
  tune_malloc_once();
  // ranges of cells, 8 a thread: the copies (and the first touch of the
  // output's pages) spread over every thread even for a few thousand cells
  size_t parts = 8 * (size_t)std::max(threads, 1);
  size_t block = std::max<size_t>(1, ((size_t)n_cells + parts - 1) / parts);
  size_t n_blocks = ((size_t)n_cells + block - 1) / block;
  std::atomic<long long> bad{0};
  run_pool((unsigned)threads, n_blocks, [&](size_t j) {
    size_t end = std::min((size_t)n_cells, (j + 1) * block);
    for (size_t c = j * block; c < end; c++) {
      uint8_t* o = out + starts[c];
      long long len = sizes[c];
      switch (kinds[c]) {
        case 1:
          o[0] = rle_vals[c];
          break;
        case 2: {
          long long h = hids[c];
          if (h < 0 || h >= n_headers) goto fail;
          long long hl = hlens[h];
          if (hl < 0 || hoffs[h] < 0 || hoffs[h] + hl > pool_len) goto fail;
          len -= hl + 6;
          if (len < 0 || boffs[c] < 0 || boffs[c] + len > blob_len) goto fail;
          std::memcpy(o, hpool + hoffs[h], (size_t)hl);
          o += hl;
          for (int k = 0; k < 3; k++) write_le16(o + 2 * k, jumps[3 * c + k]);
          std::memcpy(o + 6, blob + boffs[c], (size_t)len);
          break;
        }
        default:
          if (len < 0 || boffs[c] < 0 || boffs[c] + len > blob_len) goto fail;
          std::memcpy(o, blob + boffs[c], (size_t)len);
          break;
      }
      continue;
    fail:
      long long want = 0;
      bad.compare_exchange_strong(want, (long long)c + 1);
      return;
    }
  });
  return -bad.load();
}

}  // extern "C"
