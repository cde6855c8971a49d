// K1 expr_eval: an interpreter of lowered scalar expressions.
//
// Replaces: presto_tpu/expr/compile.py ExprCompiler.compile (the
// arithmetic, comparison, BETWEEN and AND/OR/NOT subset, with
// _rescale_guard and the _ovf_add/_ovf_sub/_ovf_mul rules; LIKE and
// varchar comparisons against a literal through a dictionary table,
// _compile_like/_compile_string_cmp; IN over literals, _compile_in;
// CASE/IF, _compile_case; double
// arithmetic over decimals with decimal128.mul_long_short and
// to_double, _compile_arith; the date parts year/month/day/quarter of
// _compile_datepart with _civil_from_days; a short decimal to double,
// _to_double; comparisons with a long-decimal operand, run_lcmp of
// _compile_cmp with decimal128.rescale and compare; is_null and
// not_null; double columns, literals, + - * / negation and abs, and
// comparisons in double space, _align_pair's double branch; integer
// negation and abs with _ovf_neg) and presto_tpu/ops/filter_project.py
// filter_page/project_page, which XLA fused into one program per chain.
//
// Bound on the H100: memory.  Each row reads its input columns' data
// and validity (and the row mask for a filter) once and writes one
// output; there are a few integer operations per byte, far below the
// card's operations-per-byte balance.  TPC-H Q6's predicate reads
// 24 B/row, ~60 us per 2^23-row split at 3.35 TB/s.
//
// Design: the host lowers the tree to a postfix program (literal
// sub-trees already folded) that travels by value in the kernel's
// parameter space, so every thread reads the same instruction from
// the constant bank.  One thread per row, grid-stride loop, a
// fixed-depth per-thread stack of (int64 value, valid) pairs.  One
// build serves every query; no per-expression code generation.  A
// filter skips rows that are already dead and writes only the new row
// mask.  A string predicate (LIKE, a comparison or IN against
// literals) is one LUT opcode: the row's dictionary code indexes a
// host-built boolean table; CANON maps a code to its value's
// representative code through an int32 table (key columns whose
// dictionary repeats a value).  IN over numbers compares the raw
// value with each literal of a run in the constant pool (no scale
// alignment, as the reference).  The interpreter is
// instantiated twice: the narrow one (every TPC-H filter and argument)
// keeps the int64 stack; the wide one, picked only for programs with a
// long-decimal or double lane, adds a second limb per stack slot, so
// the narrow programs pay nothing for it.  Double arithmetic uses the
// _rn intrinsics, so the card rounds as the plain twin does, bit for
// bit (S2D divides by 10^scale; it never multiplies by a reciprocal).
// DATEPART runs the civil-calendar walk with floor division (fdiv), as
// jnp's // does, so days before 1970 come out right; C++'s / would
// truncate toward zero.  A long comparison brings both sides to two
// limbs at the common scale (S2L, LSCALE in steps of at most 10^9 that
// wrap as the reference's rescale does) and compares the high limb,
// then the low one.  Simple first: the stack lives in local memory and
// loads are not vectorised.
//
// Added for TPC-DS: COAL keeps the first valid of two operands
// (coalesce, left to right, after each operand is coerced to the
// output type); a string CASE / IF / coalesce remaps each branch's
// codes into the merged dictionary with CANON's int32 table, and a
// comparison of two string columns maps both sides to shared value
// ids with two such tables, then compares integers.  SFLOOR is a
// scaled-int floor division by 10^k (a ceiling adds 10^k - 1 first;
// also a decimal down-scale), SROUND rounds a decimal half away from
// zero over 10^drop, DFLOOR floors or ceils a double, DROUND rounds a
// double half away from zero at 10^digits (floor(x + 0.5) / ceil(x -
// 0.5), then / 10^digits), D2S is cast_decimal from a double,
// round(d * 10^scale) half to even by __double2ll_rn (jnp.round's
// rule, never round()'s), D2L the same split into limbs through
// floor(scaled / 10^18), and LADD adds or subtracts two long decimals
// (decimal128.add/sub).

#include "common.cuh"

#define K1_MAX_INS 128
#define K1_MAX_CONSTS 64
#define K1_MAX_COLS 16
#define K1_MAX_STACK 16
#define K1_MAX_LUTS 16
#define K1_IN_COUNT_SHIFT 8

// opcodes: keep in step with kernels/expr_eval.py
enum {
  OP_LOAD, OP_LIT, OP_NULL, OP_ADD, OP_SUB, OP_MUL, OP_SCALE_CHK, OP_SCALE,
  OP_EQ, OP_NE, OP_LT, OP_LE, OP_GT, OP_GE, OP_BETWEEN, OP_AND, OP_OR, OP_NOT,
  OP_LUT, OP_SEL, OP_LOAD_LONG, OP_MUL_LS, OP_L2D, OP_DDIV, OP_IN, OP_CANON,
  OP_DATEPART, OP_S2D, OP_S2L, OP_LSCALE, OP_LCMP, OP_NOTNULL, OP_LOAD_F64, OP_DLIT,
  OP_DADD, OP_DSUB, OP_DMUL, OP_DNEG, OP_DABS, OP_DCMP, OP_NEG, OP_ABS, OP_COAL,
  OP_SFLOOR, OP_SROUND, OP_DFLOOR, OP_DROUND, OP_D2S, OP_D2L, OP_LADD
};
enum { KIND_BOOL = 0, KIND_I32 = 1, KIND_I64 = 2, KIND_F64 = 3, KIND_D128 = 4 };

struct K1Prog {
  int n_ins;
  int op[K1_MAX_INS];
  int arg[K1_MAX_INS];
  i64 consts[K1_MAX_CONSTS];
  const void* col_data[K1_MAX_COLS];
  const uint8_t* col_valid[K1_MAX_COLS];
  int col_kind[K1_MAX_COLS];
  const void* lut[K1_MAX_LUTS];  // uint8 (LUT) or int32 (CANON) entries
  i64 lut_len[K1_MAX_LUTS];
};

// decimal128 limbs (ops/decimal128.py): value = hi * 10^18 + lo,
// 0 <= lo < 10^18.  Every step wraps as the reference's int64 lanes do.
__device__ __forceinline__ void d128_normalize(i64 hi, i64 lo, i64* oh, i64* ol) {
  const i64 carry = fdiv(lo, B18);
  *ol = wsub(lo, wmul(carry, B18));
  *oh = wadd(hi, carry);
}

// decimal128.mul_int64: schoolbook over base-10^9 halves
__device__ __forceinline__ void d128_mul_int64(i64 a, i64 b, i64* oh, i64* ol) {
  const i64 a1 = fdiv(a, B9), a0 = fmod_(a, B9);
  const i64 b1 = fdiv(b, B9), b0 = fmod_(b, B9);
  const i64 cross = wadd(wmul(a1, b0), wmul(a0, b1));
  const i64 c_hi = fdiv(cross, B9);
  const i64 c_lo = wsub(cross, wmul(c_hi, B9));
  d128_normalize(wadd(wmul(a1, b1), c_hi), wadd(wmul(c_lo, B9), wmul(a0, b0)), oh, ol);
}

// decimal128.mul_long_short: (hi*B + lo)*k = (hi*k)*B + lo*k
__device__ __forceinline__ void d128_mul_long_short(i64 ah, i64 al, i64 k, i64* oh,
                                                    i64* ol) {
  i64 lh, ll;
  d128_mul_int64(al, k, &lh, &ll);
  d128_normalize(wadd(wmul(ah, k), lh), ll, oh, ol);
}

// decimal128.mul_small: lo in base-10^9 halves, every product wraps
__device__ __forceinline__ void d128_mul_small(i64 ah, i64 al, i64 k, i64* oh, i64* ol) {
  const i64 l1 = fdiv(al, B9), l0 = fmod_(al, B9);
  const i64 p0 = wmul(l0, k), p1 = wmul(l1, k);
  const i64 c1 = fdiv(p1, B9);
  d128_normalize(wadd(wmul(ah, k), c1), wadd(wmul(wsub(p1, wmul(c1, B9)), B9), p0), oh, ol);
}

// _civil_from_days: epoch days -> year, month, day (floor division)
__device__ __forceinline__ void civil_from_days(i64 z, i64* y, i64* m, i64* d) {
  z += 719468;
  const i64 era = fdiv(z >= 0 ? z : z - 146096, 146097);
  const i64 doe = z - era * 146097;
  const i64 yoe = fdiv(doe - fdiv(doe, 1460) + fdiv(doe, 36524) - fdiv(doe, 146096), 365);
  const i64 doy = doe - (365 * yoe + fdiv(yoe, 4) - fdiv(yoe, 100));
  const i64 mp = fdiv(5 * doy + 2, 153);
  *d = doy - fdiv(153 * mp + 2, 5) + 1;
  *m = mp < 10 ? mp + 3 : mp - 9;
  *y = yoe + era * 400 + (*m <= 2 ? 1 : 0);
}

__device__ __forceinline__ double pow10d(int k) {
  double p = 1.0;
  for (int i = 0; i < k; ++i) p = __dmul_rn(p, 10.0);  // exact up to 10^22
  return p;
}

__device__ __forceinline__ i64 d2bits(double x) { return __double_as_longlong(x); }
__device__ __forceinline__ double bits2d(i64 x) { return __longlong_as_double(x); }

__device__ __forceinline__ void logic3(bool is_and, i64 ad, bool av, i64 bd, bool bv,
                                       i64* d, bool* v) {
  bool a = ad != 0, b = bd != 0;
  if (is_and) {
    bool definite_false = (av && !a) || (bv && !b);
    *d = (!definite_false && a && b) ? 1 : 0;
    *v = (av && bv) || definite_false;
  } else {
    bool definite_true = (av && a) || (bv && b);
    *d = (definite_true || a || b) ? 1 : 0;
    *v = (av && bv) || definite_true;
  }
}

// WIDE adds the second limb (sl) of a long-decimal lane; a double
// lane keeps its bits in sd.
template <bool WIDE>
__device__ __forceinline__ void run_program(const K1Prog& p, i64 row, i64* out_d, i64* out_l,
                                            bool* out_v) {
  i64 sd[K1_MAX_STACK];
  i64 sl[WIDE ? K1_MAX_STACK : 1];
  bool sv[K1_MAX_STACK];
  int sp = 0;
  for (int pc = 0; pc < p.n_ins; ++pc) {
    const int op = p.op[pc];
    const int arg = p.arg[pc];
    switch (op) {
      case OP_LOAD: {
        i64 d;
        const int k = p.col_kind[arg];
        if (k == KIND_I64) d = ((const i64*)p.col_data[arg])[row];
        else if (k == KIND_I32) d = ((const int*)p.col_data[arg])[row];
        else d = ((const uint8_t*)p.col_data[arg])[row] != 0;
        sd[sp] = d;
        sv[sp] = p.col_valid[arg][row] != 0;
        ++sp;
        break;
      }
      case OP_LIT: sd[sp] = p.consts[arg]; sv[sp] = true; ++sp; break;
      case OP_NULL: sd[sp] = 0; sv[sp] = false; ++sp; break;
      case OP_SCALE_CHK: {
        const i64 f = p.consts[arg];
        const i64 lim = I64_MAX / f;
        const i64 d = sd[sp - 1];
        sv[sp - 1] = sv[sp - 1] && !(d > lim || d < -lim);
        sd[sp - 1] = wmul(d, f);
        break;
      }
      case OP_SCALE: sd[sp - 1] = wmul(sd[sp - 1], p.consts[arg]); break;
      case OP_NOT: sd[sp - 1] = sd[sp - 1] == 0; break;
      case OP_LUT:
      case OP_CANON: {
        i64 c = sd[sp - 1];
        c = c < 0 ? 0 : (c >= p.lut_len[arg] ? p.lut_len[arg] - 1 : c);
        if (op == OP_LUT) sd[sp - 1] = ((const uint8_t*)p.lut[arg])[c] != 0;
        else sd[sp - 1] = ((const int*)p.lut[arg])[c];
        break;
      }
      case OP_DATEPART: {  // arg: 0 year, 1 month, 2 day, 3 quarter
        i64 y, m, d;
        civil_from_days(sd[sp - 1], &y, &m, &d);
        sd[sp - 1] = arg == 0 ? y : arg == 1 ? m : arg == 2 ? d : fdiv(m - 1, 3) + 1;
        break;
      }
      case OP_NEG:
      case OP_ABS: {  // arg 1: an int32 lane, whose least value has no negation
        const i64 x = sd[sp - 1];
        sv[sp - 1] = sv[sp - 1] && x != (arg ? -2147483648LL : I64_MIN);
        sd[sp - 1] = op == OP_NEG || x < 0 ? wneg(x) : x;
        break;
      }
      case OP_SFLOOR: {  // arg: divisor's constant index * 2 + (1 for a ceiling)
        const i64 c = p.consts[arg >> 1];
        const i64 x = (arg & 1) ? wadd(sd[sp - 1], c - 1) : sd[sp - 1];
        sd[sp - 1] = fdiv(x, c);
        break;
      }
      case OP_SROUND: {  // half away from zero over 10^drop (wrapping as jnp)
        const i64 q = p.consts[arg], half = q / 2;
        const i64 x = sd[sp - 1];
        sd[sp - 1] = x >= 0 ? fdiv(wadd(x, half), q) : wneg(fdiv(wadd(wneg(x), half), q));
        break;
      }
      case OP_DFLOOR:  // arg: 0 floor, 1 ceil
        if constexpr (WIDE) {
          const double x = bits2d(sd[sp - 1]);
          sd[sp - 1] = d2bits(arg ? ceil(x) : floor(x));
        }
        break;
      case OP_DROUND:  // half away from zero at 10^digits (the constant's bits)
        if constexpr (WIDE) {
          const double m = bits2d(p.consts[arg]);
          const double x = __dmul_rn(bits2d(sd[sp - 1]), m);
          const double r = x >= 0 ? floor(__dadd_rn(x, 0.5)) : ceil(__dsub_rn(x, 0.5));
          sd[sp - 1] = d2bits(__ddiv_rn(r, m));
        }
        break;
      case OP_D2S:  // round(d * 10^scale) half to even, to int64
        if constexpr (WIDE)
          sd[sp - 1] = __double2ll_rn(__dmul_rn(bits2d(sd[sp - 1]), bits2d(p.consts[arg])));
        break;
      case OP_D2L:  // the same scaled value, split into two limbs
        if constexpr (WIDE) {
          const double scaled = rint(__dmul_rn(bits2d(sd[sp - 1]), bits2d(p.consts[arg])));
          const double hi = floor(__ddiv_rn(scaled, 1e18));
          const double lo = __dsub_rn(scaled, __dmul_rn(hi, 1e18));
          d128_normalize(__double2ll_rz(hi), __double2ll_rz(lo), &sd[sp - 1], &sl[sp - 1]);
        }
        break;
      case OP_NOTNULL:  // arg: 0 not_null, 1 is_null; never NULL itself
        sd[sp - 1] = arg ? !sv[sp - 1] : sv[sp - 1];
        sv[sp - 1] = true;
        break;
      case OP_IN: {
        const int first = arg & ((1 << K1_IN_COUNT_SHIFT) - 1);
        const int count = arg >> K1_IN_COUNT_SHIFT;
        const i64 x = sd[sp - 1];
        bool hit = false;
        for (int j = 0; j < count; ++j) hit = hit || x == p.consts[first + j];
        sd[sp - 1] = hit;
        break;
      }
      case OP_SEL: {  // cond then else -> cond ? then : else
        const bool take = sd[sp - 3] != 0 && sv[sp - 3];
        const int src = take ? sp - 2 : sp - 1;
        sd[sp - 3] = sd[src];
        sv[sp - 3] = sv[src];
        if constexpr (WIDE) sl[sp - 3] = sl[src];
        sp -= 2;
        break;
      }
      case OP_BETWEEN: {
        const i64 hd = sd[sp - 1], ld = sd[sp - 2], xd = sd[sp - 3];
        const bool hv = sv[sp - 1], lv = sv[sp - 2], xv = sv[sp - 3];
        sp -= 2;
        logic3(true, xd >= ld, xv && lv, xd <= hd, xv && hv, &sd[sp - 1], &sv[sp - 1]);
        break;
      }
      case OP_S2D:
        if constexpr (WIDE)
          sd[sp - 1] = d2bits(__ddiv_rn(__ll2double_rn(sd[sp - 1]), pow10d(arg)));
        break;
      case OP_S2L:  // decimal128.from_int64
        if constexpr (WIDE) d128_normalize(0, sd[sp - 1], &sd[sp - 1], &sl[sp - 1]);
        break;
      case OP_LSCALE:  // decimal128.rescale up by 10^arg, steps of <= 10^9
        if constexpr (WIDE) {
          for (int k = arg; k > 0; k -= 9) {
            i64 f = 1;
            for (int j = 0; j < (k < 9 ? k : 9); ++j) f *= 10;
            d128_mul_small(sd[sp - 1], sl[sp - 1], f, &sd[sp - 1], &sl[sp - 1]);
          }
        }
        break;
      case OP_LCMP:  // arg: 0 eq, 1 ne, 2 lt, 3 le, 4 gt, 5 ge
        if constexpr (WIDE) {
          const i64 ah = sd[sp - 2], al = sl[sp - 2], bh = sd[sp - 1], bl = sl[sp - 1];
          const bool lt = ah < bh || (ah == bh && al < bl);
          const bool eq = ah == bh && al == bl;
          const bool r[6] = {eq, !eq, lt, lt || eq, !(lt || eq), !lt};
          sv[sp - 2] = sv[sp - 2] && sv[sp - 1];
          sd[sp - 2] = r[arg];
          --sp;
        }
        break;
      case OP_LOAD_F64:  // a double column's bits
      case OP_DLIT:      // a double constant's bits
        if constexpr (WIDE) {
          sd[sp] = op == OP_DLIT ? p.consts[arg] : ((const i64*)p.col_data[arg])[row];
          sv[sp] = op == OP_DLIT || p.col_valid[arg][row] != 0;
          ++sp;
        }
        break;
      case OP_DNEG:  // the sign bit flips, as -x does
        if constexpr (WIDE) sd[sp - 1] = d2bits(-bits2d(sd[sp - 1]));
        break;
      case OP_DABS:
        if constexpr (WIDE) sd[sp - 1] = d2bits(fabs(bits2d(sd[sp - 1])));
        break;
      case OP_LOAD_LONG:
      case OP_L2D:
        if constexpr (WIDE) {
          if (op == OP_LOAD_LONG) {
            const i64* d = (const i64*)p.col_data[arg];
            sd[sp] = d[2 * row];
            sl[sp] = d[2 * row + 1];
            sv[sp] = p.col_valid[arg][row] != 0;
            ++sp;
          } else {  // decimal128.to_double
            const double x = __dadd_rn(__dmul_rn(__ll2double_rn(sd[sp - 1]), 1e18),
                                       __ll2double_rn(sl[sp - 1]));
            sd[sp - 1] = d2bits(arg ? __ddiv_rn(x, pow10d(arg)) : x);
          }
        }
        break;
      default: {
        const i64 b = sd[sp - 1], a = sd[sp - 2];
        const bool bv = sv[sp - 1], av = sv[sp - 2];
        --sp;
        i64 d;
        bool v = av && bv;
        switch (op) {
          case OP_AND: case OP_OR:
            logic3(op == OP_AND, a, av, b, bv, &d, &v);
            break;
          case OP_COAL: {  // the first valid operand
            const bool take = !av && bv;
            d = take ? b : a;
            v = av || bv;
            if constexpr (WIDE) sl[sp - 1] = take ? sl[sp] : sl[sp - 1];
            break;
          }
          case OP_LADD:  // arg 0: a + b, 1: a - b, two long decimals
            if constexpr (WIDE) {
              i64 h, l;
              if (arg) d128_normalize(wsub(a, b), wsub(sl[sp - 1], sl[sp]), &h, &l);
              else d128_normalize(wadd(a, b), wadd(sl[sp - 1], sl[sp]), &h, &l);
              d = h;
              sl[sp - 1] = l;
            } else {
              d = 0;
            }
            break;
          case OP_ADD: d = wadd(a, b); v = v && !(((a ^ d) & (b ^ d)) < 0); break;
          case OP_SUB: d = wsub(a, b); v = v && !(((a ^ b) & (a ^ d)) < 0); break;
          case OP_MUL: {
            const __int128 wide = (__int128)a * (__int128)b;
            d = wmul(a, b);
            v = v && !(wide > (__int128)I64_MAX || wide < (__int128)I64_MIN);
            break;
          }
          case OP_DADD:
          case OP_DSUB:
          case OP_DMUL:
          case OP_DCMP:
            if constexpr (WIDE) {
              const double x = bits2d(a), y = bits2d(b);
              if (op == OP_DCMP) {  // arg: 0 eq, 1 ne, 2 lt, 3 le, 4 gt, 5 ge
                const bool r[6] = {x == y, x != y, x < y, x <= y, x > y, x >= y};
                d = r[arg];
              } else {
                d = d2bits(op == OP_DADD ? __dadd_rn(x, y)
                           : op == OP_DSUB ? __dsub_rn(x, y) : __dmul_rn(x, y));
              }
            } else {
              d = 0;
            }
            break;
          case OP_MUL_LS:
          case OP_DDIV:
            if constexpr (WIDE) {
              if (op == OP_MUL_LS) {  // arg 0: a is long, b short; 1: the reverse
                i64 h, l;
                if (arg == 0) d128_mul_long_short(a, sl[sp - 1], b, &h, &l);
                else d128_mul_long_short(b, sl[sp], a, &h, &l);
                d = h;
                sl[sp - 1] = l;
              } else {  // a zero divisor gives NULL
                const double x = bits2d(a), y = bits2d(b);
                d = d2bits(__ddiv_rn(x, y == 0.0 ? 1.0 : y));
                v = v && y != 0.0;
              }
            } else {
              d = 0;
            }
            break;
          case OP_EQ: d = a == b; break;
          case OP_NE: d = a != b; break;
          case OP_LT: d = a < b; break;
          case OP_LE: d = a <= b; break;
          case OP_GT: d = a > b; break;
          default: d = a >= b; break;  // OP_GE
        }
        sd[sp - 1] = d;
        sv[sp - 1] = v;
      }
    }
  }
  *out_d = sd[0];
  if constexpr (WIDE) *out_l = sl[0];
  *out_v = sv[0];
}

template <bool WIDE>
__global__ void k1_kernel(const K1Prog p, i64 n, const uint8_t* __restrict__ row_mask,
                          void* __restrict__ out_data, int out_kind,
                          uint8_t* __restrict__ out_valid, uint8_t* __restrict__ out_mask) {
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    if (out_mask != nullptr && !row_mask[i]) {
      out_mask[i] = 0;  // a dead row stays dead: no need to evaluate
      continue;
    }
    i64 d, l = 0;
    bool v;
    run_program<WIDE>(p, i, &d, &l, &v);
    if (out_mask != nullptr) {
      out_mask[i] = (d != 0) && v;
      continue;
    }
    if (out_kind == KIND_D128) {  // a long decimal's two limbs
      ((i64*)out_data)[2 * i] = d;
      ((i64*)out_data)[2 * i + 1] = l;
    } else if (out_kind == KIND_I64 || out_kind == KIND_F64) ((i64*)out_data)[i] = d;
    else if (out_kind == KIND_I32) ((int*)out_data)[i] = (int)d;
    else ((uint8_t*)out_data)[i] = d != 0;
    out_valid[i] = v;
  }
}

// Evaluates the program over n rows.  With out_mask set (a filter),
// writes out_mask = row_mask & data & valid; else out_data/out_valid.
// Returns cudaGetLastError() after the launch.
extern "C" int k1_expr_eval(const int* ops, const int* args, int n_ins,
                            const i64* consts, int n_consts,
                            const i64* col_data, const i64* col_valid, const int* col_kind,
                            int n_cols, const i64* luts, const i64* lut_len, int n_luts,
                            int wide, i64 n, const void* row_mask,
                            void* out_data, int out_kind, void* out_valid, void* out_mask,
                            void* stream) {
  if (n_ins > K1_MAX_INS || n_consts > K1_MAX_CONSTS || n_cols > K1_MAX_COLS ||
      n_luts > K1_MAX_LUTS)
    return (int)cudaErrorInvalidValue;
  K1Prog p;
  p.n_ins = n_ins;
  for (int i = 0; i < n_ins; ++i) { p.op[i] = ops[i]; p.arg[i] = args[i]; }
  for (int i = 0; i < n_consts; ++i) p.consts[i] = consts[i];
  for (int i = 0; i < n_cols; ++i) {
    p.col_data[i] = (const void*)col_data[i];
    p.col_valid[i] = (const uint8_t*)col_valid[i];
    p.col_kind[i] = col_kind[i];
  }
  for (int i = 0; i < n_luts; ++i) {
    p.lut[i] = (const void*)luts[i];
    p.lut_len[i] = lut_len[i];
  }
  if (n > 0) {
    const int threads = 256;
    const int grid = grid_for(n, threads, 8);
    if (wide)
      k1_kernel<true><<<grid, threads, 0, (cudaStream_t)stream>>>(
          p, n, (const uint8_t*)row_mask, out_data, out_kind, (uint8_t*)out_valid,
          (uint8_t*)out_mask);
    else
      k1_kernel<false><<<grid, threads, 0, (cudaStream_t)stream>>>(
          p, n, (const uint8_t*)row_mask, out_data, out_kind, (uint8_t*)out_valid,
          (uint8_t*)out_mask);
  }
  return (int)cudaGetLastError();
}
