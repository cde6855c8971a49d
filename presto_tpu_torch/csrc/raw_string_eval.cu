// K17 raw_string_eval: raw (non-dictionary) VARCHAR values, one mode a
// launch over a zero-padded (n, W) uint8 matrix of UTF-8 bytes.
//
// Replaces: presto_tpu/ops/rawstring.py (compare :65, substr :80,
// substr_chars :91, change_case :111, concat :131, lengths :50,
// hash_bytes :147, pack_lanes :157, unpack_lanes :177), the device
// halves of presto_tpu/expr/compile.py's raw branches (_compile_raw_cmp
// :2763, IN over raw :2956, the row selects of nullif :1253, greatest /
// least :2548, CASE and coalesce) and, where the reference runs them on
// the host through jax.pure_callback, LIKE (_like_to_regex :893),
// starts_with, ends_with (_compile_raw_bool :2842), length, strpos and
// codepoint (_compile_raw_int_fn :2870).
//
// Bound on the H100: memory.  Each mode reads each row's bytes once
// (and the second matrix or the literal) and writes one result a row:
// LIKE over TPC-H's o_comment (varchar(79)) reads 79 B and writes 1 B a
// row, 8.4M rows in ~0.2 ms at 3.35 TB/s.
//
// Design: one thread a row (grid-stride), the row walked byte by byte
// from device memory.  That leaves the coalescing on the table: a warp
// reads 32 rows 25 to 79 bytes apart, one byte a thread at a time, so
// a load instruction touches up to 32 sectors for 32 useful bytes; a
// later version can stage a warp's rows in shared memory with 16-byte
// loads (the rows are contiguous) and walk them there.  The modes that
// read characters decode UTF-8 as the reference's host path does
// (bytes.rstrip(b"\0").decode("utf-8", errors="replace")): a character
// starts at each byte that is not a continuation byte (0b10xxxxxx), up
// to the last nonzero byte, and spans the continuation bytes after it;
// a sequence with fewer continuation bytes than its lead announces (one
// cut at the width) is U+FFFD.  LIKE's pattern arrives as code points
// with -1 for `_` and -2 for `%`, matched by the greedy matcher that
// keeps one backtrack point, the last `%` (exact for these two
// wildcards).  The kernel takes widths up to K17_MAX_WIDTH and patterns
// or needles up to K17_MAX_TOKENS code points; the wrapper raises past
// them, and so does this entry point.

#include "common.cuh"

#define K17_MAX_WIDTH 1024
#define K17_MAX_TOKENS 256
#define K17_MAX_IN 64
#define K17_THREADS 256

enum { M_CMP = 0, M_IN = 1, M_SUBSTR = 2, M_CASE_MAP = 3, M_CONCAT = 4, M_LEN = 5,
       M_STRPOS = 6, M_CODEPOINT = 7, M_LIKE = 8, M_PREFIX = 9, M_SUFFIX = 10, M_PACK = 11,
       M_UNPACK = 12, M_HASH = 13, M_SELECT = 14, M_LAST = M_SELECT };
enum { OP_EQ = 0, OP_NE = 1, OP_LT = 2, OP_LE = 3, OP_GT = 4, OP_GE = 5, OP_SIGN = 6 };
#define ANY_ONE (-1)
#define ANY_RUN (-2)
#define REPLACEMENT 0xFFFD
#define FLAG_CHARS 1
#define FLAG_HAS_LEN 2

struct K17Args {
  int mode, p0, p1, flags;
  i64 n;
  const uint8_t* a;
  int wa;
  i64 a_rows;  // 1: one row for every output row
  const uint8_t* b;
  int wb;
  i64 b_rows;  // CMP, CONCAT, SELECT: 1 or n; IN: the literals
  const int* tok;
  int ntok;
  const uint8_t* sel;
  void* out;
  int wo;
};

__device__ __forceinline__ const uint8_t* row_of(const uint8_t* m, int w, i64 rows, i64 r) {
  return m + (rows == 1 ? 0 : r) * (i64)w;
}

// bytes before the trailing zero padding
__device__ __forceinline__ int row_len(const uint8_t* r, int w) {
  int l = w;
  while (l > 0 && r[l - 1] == 0) --l;
  return l;
}

__device__ __forceinline__ bool is_cont(int b) { return (b & 0xC0) == 0x80; }

// the first character's byte (continuation bytes before it are skipped)
__device__ __forceinline__ int first_unit(const uint8_t* r, int len) {
  int i = 0;
  while (i < len && is_cont(r[i])) ++i;
  return i;
}

// the character at byte i (a character's first byte): its code point
// and its bytes, the lead and every continuation byte after it
__device__ __forceinline__ int decode(const uint8_t* r, int len, int i, int* cp) {
  const int b0 = r[i];
  const int need = b0 < 0x80 ? 0 : b0 >= 0xF8 ? -1 : b0 >= 0xF0 ? 3 : b0 >= 0xE0 ? 2
                   : b0 >= 0xC0 ? 1 : 0;
  int v = need == 0 ? b0 : need == 1 ? (b0 & 0x1F) : need == 2 ? (b0 & 0x0F) : (b0 & 0x07);
  int k = 1;
  while (i + k < len && is_cont(r[i + k])) {
    if (k <= need) v = (v << 6) | (r[i + k] & 0x3F);
    ++k;
  }
  *cp = k - 1 == need ? v : REPLACEMENT;
  return k;
}

// -1, 0 or 1: the first differing byte, zero padding to the wider width
__device__ __forceinline__ int cmp_rows(const uint8_t* x, int wx, const uint8_t* y, int wy) {
  const int w = wx > wy ? wx : wy;
  for (int j = 0; j < w; ++j) {
    const int bx = j < wx ? x[j] : 0, by = j < wy ? y[j] : 0;
    if (bx != by) return bx < by ? -1 : 1;
  }
  return 0;
}

__device__ __forceinline__ bool op_of_sign(int s, int op) {
  switch (op) {
    case OP_EQ: return s == 0;
    case OP_NE: return s != 0;
    case OP_LT: return s < 0;
    case OP_LE: return s <= 0;
    case OP_GT: return s > 0;
    default: return s >= 0;
  }
}

// the characters of a row: their count
__device__ int count_units(const uint8_t* r, int len) {
  int c = 0, cp;
  for (int i = first_unit(r, len); i < len; i += decode(r, len, i, &cp)) ++c;
  return c;
}

// whether the needle's code points start at byte i
__device__ __forceinline__ bool match_at(const uint8_t* r, int len, int i, const int* tok,
                                         int m) {
  int cp;
  for (int t = 0; t < m; ++t) {
    if (i >= len) return false;
    i += decode(r, len, i, &cp);
    if (cp != tok[t]) return false;
  }
  return true;
}

__device__ bool like_row(const uint8_t* r, int len, const int* tok, int ntok) {
  int i = first_unit(r, len), p = 0, star = -1, star_i = 0, cp;
  while (i < len) {
    if (p < ntok && tok[p] == ANY_RUN) {  // remember the run's start, match it empty first
      star = ++p;
      star_i = i;
      continue;
    }
    if (p < ntok) {
      const int k = decode(r, len, i, &cp);
      if (tok[p] == ANY_ONE || tok[p] == cp) {
        i += k;
        ++p;
        continue;
      }
    }
    if (star < 0) return false;
    star_i += decode(r, len, star_i, &cp);  // the last `%` takes one character more
    i = star_i;
    p = star;
  }
  while (p < ntok && tok[p] == ANY_RUN) ++p;
  return p == ntok;
}

static __global__ void k17_eval(K17Args g) {
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 r = (i64)blockIdx.x * blockDim.x + threadIdx.x; r < g.n; r += stride) {
    const uint8_t* x = row_of(g.a, g.wa, g.a_rows, r);
    switch (g.mode) {
      case M_CMP: {
        const int s = cmp_rows(x, g.wa, row_of(g.b, g.wb, g.b_rows, r), g.wb);
        if (g.p0 == OP_SIGN) ((signed char*)g.out)[r] = (signed char)s;
        else ((uint8_t*)g.out)[r] = op_of_sign(s, g.p0);
        break;
      }
      case M_IN: {
        bool hit = false;
        for (i64 k = 0; k < g.b_rows && !hit; ++k)
          hit = cmp_rows(x, g.wa, g.b + k * g.wb, g.wb) == 0;
        ((uint8_t*)g.out)[r] = hit;
        break;
      }
      case M_SUBSTR: {
        uint8_t* o = (uint8_t*)g.out + r * (i64)g.wo;
        const int s = g.p0 - 1 > 0 ? g.p0 - 1 : 0;
        const bool has_len = (g.flags & FLAG_HAS_LEN) != 0;
        int c = 0;
        if (g.flags & FLAG_CHARS) {  // substr_chars: characters by their non-continuation bytes
          int ci = -1;
          for (int j = 0; j < g.wa; ++j) {
            const int b = x[j];
            if (b == 0) continue;
            if (!is_cont(b)) ++ci;
            if (ci >= s && (!has_len || ci < s + g.p1)) o[c++] = (uint8_t)b;
          }
        } else {  // the byte slice
          int end = has_len ? (s + g.p1 < g.wa ? s + g.p1 : g.wa) : g.wa;
          for (int j = s; j < end; ++j) o[c++] = x[j];
        }
        for (; c < g.wo; ++c) o[c] = 0;
        break;
      }
      case M_CASE_MAP: {
        uint8_t* o = (uint8_t*)g.out + r * (i64)g.wo;
        const bool up = (g.flags & FLAG_CHARS) != 0;
        int prev = 0;
        for (int j = 0; j < g.wa; ++j) {
          const int b = x[j];
          int v = b;
          if (up) {
            if ((b >= 'a' && b <= 'z') || (prev == 0xC3 && b >= 0xA0 && b <= 0xBE && b != 0xB7))
              v = b - 32;
          } else if ((b >= 'A' && b <= 'Z') ||
                     (prev == 0xC3 && b >= 0x80 && b <= 0x9E && b != 0x97)) {
            v = b + 32;
          }
          o[j] = (uint8_t)v;
          prev = b;
        }
        break;
      }
      case M_CONCAT: {
        uint8_t* o = (uint8_t*)g.out + r * (i64)g.wo;
        const uint8_t* y = row_of(g.b, g.wb, g.b_rows, r);
        int la = 0, lb = 0;
        for (int j = 0; j < g.wa; ++j) la += x[j] != 0;
        for (int j = 0; j < g.wb; ++j) lb += y[j] != 0;
        for (int j = 0; j < g.wo; ++j)
          o[j] = j < la ? (j < g.wa ? x[j] : 0) : (j - la < lb ? y[j - la] : 0);
        break;
      }
      case M_LEN: {
        i64 v = 0;
        if (g.flags & FLAG_CHARS) v = count_units(x, row_len(x, g.wa));
        else
          for (int j = 0; j < g.wa; ++j) v += x[j] != 0;
        ((i64*)g.out)[r] = v;
        break;
      }
      case M_STRPOS: {
        const int len = row_len(x, g.wa);
        i64 pos = 0;
        int ci = 0, cp;
        if (g.ntok == 0) pos = 1;
        for (int i = first_unit(x, len); pos == 0 && i < len; i += decode(x, len, i, &cp)) {
          if (match_at(x, len, i, g.tok, g.ntok)) pos = ci + 1;
          ++ci;
        }
        ((i64*)g.out)[r] = pos;
        break;
      }
      case M_CODEPOINT: {
        const int len = row_len(x, g.wa);
        const int i = first_unit(x, len);
        int cp = 0;
        if (i < len) decode(x, len, i, &cp);
        ((i64*)g.out)[r] = cp;
        break;
      }
      case M_LIKE:
        ((uint8_t*)g.out)[r] = like_row(x, row_len(x, g.wa), g.tok, g.ntok);
        break;
      case M_PREFIX: {
        const int len = row_len(x, g.wa);
        ((uint8_t*)g.out)[r] = match_at(x, len, first_unit(x, len), g.tok, g.ntok);
        break;
      }
      case M_SUFFIX: {
        const int len = row_len(x, g.wa);
        const int units = count_units(x, len);
        bool ok = units >= g.ntok;
        if (ok) {
          int i = first_unit(x, len), cp;
          for (int skip = units - g.ntok; skip > 0; --skip) i += decode(x, len, i, &cp);
          ok = match_at(x, len, i, g.tok, g.ntok);
        }
        ((uint8_t*)g.out)[r] = ok;
        break;
      }
      case M_PACK: {
        const int k = (g.wa + 7) / 8;
        i64* o = (i64*)g.out + r * k;
        for (int c = 0; c < k; ++c) {
          u64 lane = 0;
          for (int j = 0; j < 8; ++j) {
            const int t = 8 * c + j;
            lane = (lane << 8) | (u64)(t < g.wa ? x[t] : 0);
          }
          o[c] = (i64)(lane ^ 0x8000000000000000ull);  // unsigned order -> signed
        }
        break;
      }
      case M_UNPACK: {
        const i64* lanes = (const i64*)x;
        uint8_t* o = (uint8_t*)g.out + r * (i64)g.wo;
        for (int t = 0; t < g.wo; ++t) {
          const u64 u = (u64)lanes[t >> 3] ^ 0x8000000000000000ull;
          o[t] = (uint8_t)((u >> (8 * (7 - (t & 7)))) & 0xFF);
        }
        break;
      }
      case M_HASH: {
        u64 h = 0xCBF29CE484222325ull;
        for (int j = 0; j < g.wa; ++j) h = (h ^ (u64)x[j]) * 0x100000001B3ull;
        ((i64*)g.out)[r] = (i64)(h & 0x7FFFFFFFFFFFFFFFull);
        break;
      }
      default: {  // M_SELECT
        const bool take_a = g.sel[r] != 0;
        const uint8_t* y = take_a ? x : row_of(g.b, g.wb, g.b_rows, r);
        const int wy = take_a ? g.wa : g.wb;
        uint8_t* o = (uint8_t*)g.out + r * (i64)g.wo;
        for (int j = 0; j < g.wo; ++j) o[j] = j < wy ? y[j] : 0;
        break;
      }
    }
  }
}

// One mode over n rows (see kernels/raw_string_eval.py for the
// arguments of each).  Returns cudaGetLastError() after the launch.
extern "C" int k17_raw_string_eval(int mode, int p0, int p1, int flags, i64 n, const void* a,
                                   int wa, i64 a_rows, const void* b, int wb, i64 b_rows,
                                   const void* tok, int ntok, const void* sel, void* out,
                                   int wo, void* stream) {
  if (mode < 0 || mode > M_LAST || n < 0 || wa < 1 || wa > 8 * K17_MAX_WIDTH ||
      wb > K17_MAX_WIDTH || wo > K17_MAX_WIDTH + K17_MAX_WIDTH || ntok < 0 ||
      ntok > K17_MAX_TOKENS || (mode == M_IN && (b_rows < 1 || b_rows > K17_MAX_IN)) ||
      (mode != M_UNPACK && wa > K17_MAX_WIDTH) || (ntok > 0 && tok == nullptr) ||
      ((mode == M_CMP || mode == M_CONCAT || mode == M_SELECT || mode == M_IN) && b == nullptr) ||
      (mode == M_SELECT && sel == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  K17Args g;
  g.mode = mode;
  g.p0 = p0;
  g.p1 = p1;
  g.flags = flags;
  g.n = n;
  g.a = (const uint8_t*)a;
  g.wa = wa;
  g.a_rows = a_rows;
  g.b = (const uint8_t*)b;
  g.wb = wb;
  g.b_rows = b_rows;
  g.tok = (const int*)tok;
  g.ntok = ntok;
  g.sel = (const uint8_t*)sel;
  g.out = out;
  g.wo = wo;
  i64 blocks = (n + K17_THREADS - 1) / K17_THREADS;
  if (blocks > 132 * 64) blocks = 132 * 64;
  k17_eval<<<(int)blocks, K17_THREADS, 0, (cudaStream_t)stream>>>(g);
  return (int)cudaGetLastError();
}
