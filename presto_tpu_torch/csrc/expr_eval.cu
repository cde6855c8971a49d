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
//
// The function surface (the rest of _compile_math :2356 with
// width_bucket :2395, _compile_bitwise :2480, greatest/least :2528,
// nullif :1249, cast_bigint :1090, _compile_hll :1583 with
// _hll_from_hash :758 and _mix_u64 :776, the double mod of
// _compile_arith :3013 and _trunc_mod/_trunc_div :886, and the date
// parts of _compile_datepart :3102): a handful of family opcodes whose
// argument picks the function, so the switch grows by nine cases, not
// by thirty.  DUN computes a function of one double (libdevice's for
// the transcendental ones; sqrt, degrees and radians by _rn
// intrinsics, so they stay exact), DBIN power, atan2 or jnp.mod's
// floored fmod; BITW works on the low `bits` bits as an unsigned
// field and shifts by the count & 63 (C++ leaves a shift of 64 or more
// undefined); GL keeps NaN and orders -0.0 below 0.0 through an int64
// order key, as jnp.maximum does; CASTBI converts as XLA does (toward
// zero, saturating, NaN to 0); HLL mixes the lane's 64 bits by
// splitmix64 and takes the top P bits or __clzll of the rest plus one;
// the date parts keep floor division (fdiv, fmod_) for days before
// 1970.  An opcode past the table is refused at launch.
//
// Timestamps and the dictionary tables (_compile_datepart :3102's
// timestamp branch, _compile_datetime :3158 with _datetime_trunc :3231,
// _datetime_add :3267, _datetime_diff :3297 and _add_months :3530,
// _compile_date_format :1556, _compile_string_lut_fn :1279,
// _compile_string_number_cast :1418 and _compile_binary_hash :1496):
// a timestamp is an int64 lane of epoch microseconds.  VLUT reads an
// int64 value table over the row's clipped dictionary code (length,
// strpos, codepoint, levenshtein_distance, date_parse, crc32, CAST of a
// varchar column to bigint, ...; the tables are built on the host once
// per dictionary), DVLUT a double table (CAST to double), each with an
// optional not-null table whose entry clears the valid bit.  TSPART
// takes a date part or the time of day of microseconds, DTRUNC
// truncates, DTADD adds a fixed span (wrapping) or calendar months
// (the day of the month clamped to the new month's length), DTDIFF
// counts spans (truncating toward zero) or calendar-field months,
// CASTTS moves between days and microseconds, UNIXT converts to or
// from epoch seconds in double (a true division, __ddiv_rn), DFMT
// takes a date's code in the date_format dictionary (NULL outside its
// span).  All of them divide by floor division (fdiv), as the
// reference's jnp // does, so 1969 comes out right; date_diff's spans
// truncate as its _trunc_div does.  HLL with P = 0 pushes the whole
// splitmix64 hash (checksum's per-row hash).
//
// The narrow types (cast_real, cast_smallint and cast_tinyint :1111,
// _compile_arith's REAL branch :3005, _align_pair's REAL branch,
// _compile_in :2952 over a double): a SMALLINT or TINYINT column loads
// sign-extended into the int64 lane and a REAL widens exactly into the
// double lane; each stores back narrowed.  A REAL is never computed in
// float32: each REAL operation runs in double and F32R rounds its result
// once to float32 (__double2float_rn) and widens it back.  For + - * /
// and the floored mod of two float32 values the double result rounded
// once is the correctly rounded float32 result (53 >= 2 * 24 + 2), so
// the lane holds the reference's float32 bits.  F32R of the int64 lane
// converts straight to float32 (__ll2float_rn, cast_real of an
// integer).  CASTN NULLs an int64 lane outside a narrower signed range
// (the narrowing casts' NULL, and the int16/int32 arithmetic's
// overflow).  DIN compares a double lane with each double literal of a
// run in the constant pool (==: NaN matches nothing, -0.0 equals 0.0).
//
// The wide decimals (presto_tpu/ops/decimal128.py's five-limb layout for
// decimal(37..38), and the compiler's branches over it: _to_long_limbs
// :802 with limbs=5, _compile_arith :3030-:3051, run_lcmp :2654, neg
// :1007, abs/sign :2361, greatest/least :2541, cast_bigint :1096,
// cast_decimal :1219, _coerce :3464 with _narrow_to_int64 :3493): a
// third instantiation of the interpreter whose stack slots hold five
// int64 limbs, picked only for a program that holds a D38 opcode, so
// narrow and two-limb programs keep their smaller stacks.  Its slots
// are 5 x 16 x 8 = 640 B of local memory a thread.  LOAD_D38 and
// LIT_D38 push five limbs, LIT_LONG a two-limb literal (also in the
// two-limb instance); S2D38 and L2D38 widen an int64 lane or two limbs;
// D38UP shifts the magnitude up by at most 8 digits a step, dropping
// limb 0's carry-out (past the limbs' 45 digits the value wraps), D38DOWN
// floor-divides by at most 10^9 a step; D38ADD and D38NEG carry by
// floor division (_norm_wide); D38MUL multiplies the magnitude by an
// int64 split at 10^9 (mul_wide_small); D38CMP compares limb 0 first;
// D382D is Horner's rule in _rn operations, then one division by the
// correctly rounded 10^scale; D38NARROW collapses to an int64 lane or
// two limbs, wrapping.  No __int128: every step is the twin's int64
// arithmetic, so the card's limbs equal the twin's bit for bit, the
// wrap cases included.  Bound: memory, as the other instances (a wide
// column is 40 B a row).

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
  OP_SFLOOR, OP_SROUND, OP_DFLOOR, OP_DROUND, OP_D2S, OP_D2L, OP_LADD,
  OP_DUN, OP_DBIN, OP_BITW, OP_GL, OP_NULLIF, OP_CASTBI, OP_HLL, OP_WBUCKET, OP_IMOD,
  OP_VLUT, OP_DVLUT, OP_TSPART, OP_DTRUNC, OP_DTADD, OP_DTDIFF, OP_CASTTS, OP_UNIXT, OP_DFMT,
  OP_F32R, OP_CASTN, OP_DIN, OP_LOAD_D38, OP_LIT_LONG, OP_LIT_D38, OP_S2D38, OP_L2D38,
  OP_D38UP, OP_D38DOWN, OP_D38ADD, OP_D38NEG, OP_D38MUL, OP_D38CMP, OP_D382D, OP_D38NARROW,
  OP_D38SIGN, OP_COUNT
};
// DUN's functions (kernels/expr_eval.py DUN_FNS), DBIN's (DBIN_FNS),
// BITW's operations (BITW_OPS), GL's lanes and CASTBI's sources
enum { DUN_SQRT, DUN_CBRT, DUN_EXP, DUN_LN, DUN_LOG2, DUN_LOG10, DUN_SIN, DUN_COS, DUN_TAN,
       DUN_ASIN, DUN_ACOS, DUN_ATAN, DUN_SINH, DUN_COSH, DUN_TANH, DUN_DEGREES, DUN_RADIANS,
       DUN_TRUNCATE, DUN_SIGN, DUN_IS_NAN, DUN_IS_FINITE, DUN_IS_INFINITE };
enum { DBIN_POWER, DBIN_ATAN2, DBIN_MOD };
enum { BW_AND, BW_OR, BW_XOR, BW_SHL, BW_SHR, BW_COUNT };
enum { GL_INT, GL_DOUBLE, GL_LONG, GL_D38 };
enum { CAST_FROM_DOUBLE, CAST_FROM_SHORT, CAST_FROM_LONG };
enum { KIND_BOOL = 0, KIND_I32 = 1, KIND_I64 = 2, KIND_F64 = 3, KIND_D128 = 4, KIND_I16 = 5,
       KIND_I8 = 6, KIND_F32 = 7, KIND_D38 = 8 };
enum { F32R_DOUBLE, F32R_INT };
// DT_UNITS (kernels/expr_eval.py): the first seven are fixed spans
enum { U_MICRO, U_MILLI, U_SECOND, U_MINUTE, U_HOUR, U_DAY, U_WEEK, U_MONTH, U_QUARTER,
       U_YEAR };
enum { UNIXT_TS, UNIXT_DATE, UNIXT_FROM };
#define MICROS_PER_DAY 86400000000LL
#define DATE_FMT_BASE (-25567LL)
#define DATE_FMT_SPAN 73049LL
#define DT_TS 16
#define DT_A_DATE 16
#define DT_B_DATE 32

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

// _days_from_civil: (year, month, day) -> epoch days (floor division)
__device__ __forceinline__ i64 days_from_civil(i64 y, i64 m, i64 d) {
  y -= m <= 2 ? 1 : 0;
  const i64 era = fdiv(y >= 0 ? y : y - 399, 400);
  const i64 yoe = y - era * 400;
  const i64 mp = m > 2 ? m - 3 : m + 9;
  const i64 doy = fdiv(153 * mp + 2, 5) + d - 1;
  const i64 doe = yoe * 365 + fdiv(yoe, 4) - fdiv(yoe, 100) + doy;
  return era * 146097 + doe - 719468;
}

// DATEPART: year, month, day, quarter, ISO day_of_week, day_of_year,
// ISO week and year_of_week (the Thursday's year), last_day_of_month
__device__ __forceinline__ i64 date_part(i64 days, int part) {
  i64 y, m, d;
  civil_from_days(days, &y, &m, &d);
  switch (part) {
    case 0: return y;
    case 1: return m;
    case 2: return d;
    case 3: return fdiv(m - 1, 3) + 1;
    case 4: return fmod_(days + 3, 7) + 1;
    case 5: return days - days_from_civil(y, 1, 1) + 1;
    case 6:
    case 7: {
      const i64 th = days - fmod_(days + 3, 7) + 3;
      i64 yt, mt, dt;
      civil_from_days(th, &yt, &mt, &dt);
      return part == 7 ? yt : fdiv(th - days_from_civil(yt, 1, 1), 7) + 1;
    }
    case 8: return days_from_civil(m == 12 ? y + 1 : y, m == 12 ? 1 : m + 1, 1) - 1;
    default: return 0;  // the time of day of a date
  }
}

__device__ __forceinline__ i64 unit_micros(int u) {
  switch (u) {
    case U_MICRO: return 1;
    case U_MILLI: return 1000;
    case U_SECOND: return 1000000;
    case U_MINUTE: return 60000000LL;
    case U_HOUR: return 3600000000LL;
    case U_DAY: return MICROS_PER_DAY;
    default: return 7 * MICROS_PER_DAY;
  }
}

__device__ __forceinline__ i64 narrow32(i64 x) { return (i64)(int)x; }

// IMOD's widths: code 0 64 bits, 1 32, 2 16, 3 8
__device__ __forceinline__ int imod_bits(int code) { return 64 >> code; }
__device__ __forceinline__ i64 least_at(int bits) {
  return bits == 64 ? I64_MIN : -(1LL << (bits - 1));
}
// abs at a signed width: its least value stays itself
__device__ __forceinline__ i64 abs_at(i64 x, int bits) {
  return x == least_at(bits) || x >= 0 ? x : wneg(x);
}
// an int64 lane wrapped to a narrower signed width
__device__ __forceinline__ i64 wrap_at(i64 x, int bits) {
  return bits == 64 ? x : bits == 32 ? (i64)(int)x : bits == 16 ? (i64)(short)x
                                                              : (i64)(signed char)x;
}

// TSPART: a date part (DATEPART's 0..8) or the time of day (9 hour,
// 10 minute, 11 second, 12 millisecond) of epoch microseconds
__device__ __forceinline__ i64 ts_part(i64 micros, int part) {
  const i64 days = fdiv(micros, MICROS_PER_DAY);
  const i64 tod = micros - days * MICROS_PER_DAY;
  switch (part) {
    case 9: return fdiv(tod, 3600000000LL);
    case 10: return fmod_(fdiv(tod, 60000000LL), 60);
    case 11: return fmod_(fdiv(tod, 1000000), 60);
    case 12: return fmod_(fdiv(tod, 1000), 1000);
    default: return date_part(days, part);
  }
}

// _add_months: days shifted by n calendar months, the day clamped
__device__ __forceinline__ i64 add_months(i64 days, i64 n) {
  i64 y, m, d;
  civil_from_days(days, &y, &m, &d);
  const i64 months = wadd(wadd(wmul(y, 12), m - 1), n);
  const i64 y2 = fdiv(months, 12);
  const i64 m2 = months - y2 * 12 + 1;
  const bool leap = fmod_(y2, 4) == 0 && (fmod_(y2, 100) != 0 || fmod_(y2, 400) == 0);
  const int len[12] = {31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31};
  const i64 mlen = len[m2 - 1] + (m2 == 2 && leap ? 1 : 0);
  return days_from_civil(y2, m2, d < mlen ? d : mlen);
}

__device__ __forceinline__ i64 unit_months(int u, i64 n) {
  return wmul(n, u == U_YEAR ? 12 : u == U_QUARTER ? 3 : 1);
}

// DTRUNC: arg = unit | DT_TS for a timestamp
__device__ __forceinline__ i64 dt_trunc(i64 x, int arg) {
  const int u = arg & 15;
  const bool ts = arg & DT_TS;
  if (u <= U_DAY) {
    if (!ts) return x;
    const i64 step = unit_micros(u);
    return wmul(fdiv(x, step), step);
  }
  const i64 days = ts ? fdiv(x, MICROS_PER_DAY) : x;
  i64 y, m, d;
  civil_from_days(days, &y, &m, &d);
  i64 out;
  if (u == U_WEEK) out = days - fmod_(days + 3, 7);
  else if (u == U_MONTH) out = days_from_civil(y, m, 1);
  else if (u == U_QUARTER) out = days_from_civil(y, fdiv(m - 1, 3) * 3 + 1, 1);
  else out = days_from_civil(y, 1, 1);
  return ts ? wmul(out, MICROS_PER_DAY) : narrow32(out);
}

// DTADD: x plus n units (arg = unit | DT_TS for a timestamp)
__device__ __forceinline__ i64 dt_add(i64 x, i64 n, int arg) {
  const int u = arg & 15;
  if (arg & DT_TS) {
    if (u <= U_WEEK) return wadd(x, wmul(n, unit_micros(u)));
    const i64 days = fdiv(x, MICROS_PER_DAY);
    const i64 tod = x - days * MICROS_PER_DAY;
    return wadd(wmul(add_months(days, unit_months(u, n)), MICROS_PER_DAY), tod);
  }
  if (u == U_DAY) return narrow32(wadd(x, n));
  if (u == U_WEEK) return narrow32(wadd(x, wmul(7, n)));
  return narrow32(add_months(x, unit_months(u, n)));
}

// SQL's division toward zero by a positive constant (_trunc_div)
__device__ __forceinline__ i64 trunc_div(i64 a, i64 b) {
  const i64 q = fdiv(a < 0 ? wneg(a) : a, b);
  return a < 0 ? wneg(q) : q;
}

// DTDIFF: b - a in units (arg = unit | DT_A_DATE | DT_B_DATE)
__device__ __forceinline__ i64 dt_diff(i64 a, i64 b, int arg) {
  const int u = arg & 15;
  const i64 m1 = (arg & DT_A_DATE) ? wmul(a, MICROS_PER_DAY) : a;
  const i64 m2 = (arg & DT_B_DATE) ? wmul(b, MICROS_PER_DAY) : b;
  if (u <= U_WEEK) return trunc_div(wsub(m2, m1), unit_micros(u));
  i64 y1, mo1, d1, y2, mo2, d2;
  civil_from_days(fdiv(m1, MICROS_PER_DAY), &y1, &mo1, &d1);
  civil_from_days(fdiv(m2, MICROS_PER_DAY), &y2, &mo2, &d2);
  const i64 months = wsub(wadd(wmul(y2, 12), mo2), wadd(wmul(y1, 12), mo1));
  if (u == U_MONTH) return months;
  if (u == U_QUARTER) return trunc_div(months, 3);
  return wsub(y2, y1);
}

// XLA's double -> int64: toward zero, saturating, NaN to 0
__device__ __forceinline__ i64 double_to_i64(double x) {
  if (isnan(x)) return 0;
  if (x >= 9223372036854775808.0) return I64_MAX;
  if (x < -9223372036854775808.0) return I64_MIN;
  return __double2ll_rz(x);
}

// splitmix64's finalizer (the reference's _mix_u64)
__device__ __forceinline__ u64 mix_u64(u64 x) {
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

__device__ __forceinline__ double pow10d(int k) {
  double p = 1.0;
  for (int i = 0; i < k; ++i) p = __dmul_rn(p, 10.0);  // exact up to 10^22
  return p;
}

__device__ __forceinline__ i64 d2bits(double x) { return __double_as_longlong(x); }
__device__ __forceinline__ double bits2d(i64 x) { return __longlong_as_double(x); }

// decimal128.from_int64(x, limbs=5)
__device__ __forceinline__ void w_from_i64(i64 x, i64* w) {
  w[0] = w[1] = w[2] = w[3] = 0;
  w[4] = x;
  w_norm(w);
}

// decimal128.widen: two base-10^18 limbs to five base-10^9 ones
__device__ __forceinline__ void w_widen(i64 hi, i64 lo, i64* w) {
  w[0] = 0;
  w[1] = fdiv(hi, B9);
  w[2] = fmod_(hi, B9);
  w[3] = fdiv(lo, B9);
  w[4] = fmod_(lo, B9);
  w_norm(w);
}

// decimal128._shift_digits_wide: times 10^k (1 <= k <= 8) on the
// magnitude, each limb's part above 10^(9-k) carried one limb up; limb
// 0's carry-out drops (the magnitude wraps modulo 10^45)
__device__ __forceinline__ void w_shift(i64* w, int k) {
  const bool neg = w[0] < 0;
  if (neg) w_neg(w);
  i64 m = 1, mul = 1;
  for (int j = 0; j < 9 - k; ++j) m *= 10;
  for (int j = 0; j < k; ++j) mul *= 10;
  i64 high[D38_LIMBS];
  for (int i = 0; i < D38_LIMBS; ++i) {
    high[i] = fdiv(w[i], m);
    w[i] = wmul(wsub(w[i], wmul(high[i], m)), mul);
  }
  for (int i = 0; i < D38_LIMBS - 1; ++i) w[i] = wadd(w[i], high[i + 1]);
  w_norm(w);
  if (neg) w_neg(w);
}

// decimal128._downscale_wide: floor division by 10^k (1 <= k <= 9), a
// remainder chain from limb 0 (r < 10^k, so r * 10^9 + limb < 10^18)
__device__ __forceinline__ void w_down(i64* w, int k) {
  i64 d = 1;
  for (int j = 0; j < k; ++j) d *= 10;
  i64 r = 0;
  for (int i = 0; i < D38_LIMBS; ++i) {
    const i64 cur = wadd(wmul(r, B9), w[i]);
    const i64 q = fdiv(cur, d);
    r = wsub(cur, wmul(q, d));
    w[i] = q;
  }
  w_norm(w);
}

// decimal128.mul_wide_small: w times an int64 (|k| < 10^18) on
// magnitudes, k split at 10^9 so every limb product stays below 10^18;
// the high half's product moves up one limb, its limb 0 dropping
__device__ __forceinline__ void w_mul_small(i64* w, i64 k) {
  const bool neg_a = w[0] < 0, neg_k = k < 0;
  if (neg_a) w_neg(w);
  const i64 k_abs = neg_k ? wneg(k) : k;
  const i64 k1 = fdiv(k_abs, B9);
  const i64 k0 = wsub(k_abs, wmul(k1, B9));
  i64 lo[D38_LIMBS], hi[D38_LIMBS];
  for (int i = 0; i < D38_LIMBS; ++i) {
    lo[i] = wmul(w[i], k0);
    hi[i] = wmul(w[i], k1);
  }
  w_norm(lo);
  w_norm(hi);
  for (int i = 0; i < D38_LIMBS; ++i) w[i] = wadd(i + 1 < D38_LIMBS ? hi[i + 1] : 0, lo[i]);
  w_norm(w);
  if (neg_a != neg_k) w_neg(w);
}

// 10^k as the correctly rounded double (k <= 38), as the twin's 10.0 ** k
__device__ __forceinline__ double pow10_rn(int k) {
  const double p[39] = {1e0, 1e1, 1e2, 1e3, 1e4, 1e5, 1e6, 1e7, 1e8, 1e9, 1e10, 1e11, 1e12,
                        1e13, 1e14, 1e15, 1e16, 1e17, 1e18, 1e19, 1e20, 1e21, 1e22, 1e23,
                        1e24, 1e25, 1e26, 1e27, 1e28, 1e29, 1e30, 1e31, 1e32, 1e33, 1e34,
                        1e35, 1e36, 1e37, 1e38};
  return p[k < 0 ? 0 : k > 38 ? 38 : k];
}

// decimal128.to_double: Horner's rule from limb 0, then one division
__device__ __forceinline__ double w_to_double(const i64* w, int scale) {
  double acc = __ll2double_rn(w[0]);
  for (int i = 1; i < D38_LIMBS; ++i)
    acc = __dadd_rn(__dmul_rn(acc, 1e9), __ll2double_rn(w[i]));
  return __ddiv_rn(acc, pow10_rn(scale));
}

// decimal128.to_int64 (the reference's _narrow_to_int64, wrapping)
__device__ __forceinline__ i64 w_to_i64(const i64* w) {
  i64 acc = w[0];
  for (int i = 1; i < D38_LIMBS; ++i) acc = wadd(wmul(acc, B9), w[i]);
  return acc;
}

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

// A stack slot holds LIMBS int64 lanes: the narrow instance (1) an
// int64 lane; the wide one (2) adds the second limb (sl) of a
// long-decimal lane, a double keeping its bits in sd; the D38 one (5)
// holds a wide decimal's five limbs (st[0..4]), and runs every opcode of
// the other two as well.
template <int LIMBS>
__device__ __forceinline__ void run_program(const K1Prog& p, i64 row, i64* out, bool* out_v) {
  constexpr bool WIDE = LIMBS > 1;
  constexpr bool D38 = LIMBS == D38_LIMBS;
  i64 st[LIMBS][K1_MAX_STACK];
  i64 (&sd)[K1_MAX_STACK] = st[0];
  i64 (&sl)[K1_MAX_STACK] = st[WIDE ? 1 : 0];  // read only in the wide instances
  bool sv[K1_MAX_STACK];
  int sp = 0;
  // a wide decimal's limbs at slot s, and back
  auto get = [&](int s, i64* w) {
    for (int j = 0; j < LIMBS && j < D38_LIMBS; ++j) w[j] = st[j][s];
  };
  auto put = [&](int s, const i64* w) {
    for (int j = 0; j < LIMBS && j < D38_LIMBS; ++j) st[j][s] = w[j];
  };
  for (int pc = 0; pc < p.n_ins; ++pc) {
    const int op = p.op[pc];
    const int arg = p.arg[pc];
    switch (op) {
      case OP_LOAD: {
        i64 d;
        const int k = p.col_kind[arg];
        if (k == KIND_I64) d = ((const i64*)p.col_data[arg])[row];
        else if (k == KIND_I32) d = ((const int*)p.col_data[arg])[row];
        else if (k == KIND_I16) d = ((const short*)p.col_data[arg])[row];
        else if (k == KIND_I8) d = ((const signed char*)p.col_data[arg])[row];
        else d = ((const uint8_t*)p.col_data[arg])[row] != 0;
        sd[sp] = d;
        sv[sp] = p.col_valid[arg][row] != 0;
        ++sp;
        break;
      }
      case OP_LIT: sd[sp] = p.consts[arg]; sv[sp] = true; ++sp; break;
      case OP_NULL:  // every limb zeroed, as the twin's
        for (int j = 0; j < LIMBS; ++j) st[j][sp] = 0;
        sv[sp] = false;
        ++sp;
        break;
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
      case OP_DATEPART:  // arg: the part (date_part)
        sd[sp - 1] = date_part(sd[sp - 1], arg);
        break;
      case OP_VLUT:
      case OP_DVLUT: {  // arg: value table | (not-null table + 1) << 8; 8-byte entries
        const int t = arg & 255, nn = arg >> 8;
        i64 c = sd[sp - 1];
        c = c < 0 ? 0 : (c >= p.lut_len[t] ? p.lut_len[t] - 1 : c);
        if (nn) sv[sp - 1] = sv[sp - 1] && ((const uint8_t*)p.lut[nn - 1])[c] != 0;
        sd[sp - 1] = ((const i64*)p.lut[t])[c];
        break;
      }
      case OP_TSPART: sd[sp - 1] = ts_part(sd[sp - 1], arg); break;
      case OP_DTRUNC: sd[sp - 1] = dt_trunc(sd[sp - 1], arg); break;
      case OP_CASTTS:  // arg 0: days to microseconds, 1: microseconds to days
        sd[sp - 1] = arg ? narrow32(fdiv(sd[sp - 1], MICROS_PER_DAY))
                         : wmul(sd[sp - 1], MICROS_PER_DAY);
        break;
      case OP_UNIXT:  // to_unixtime of micros or days, or from_unixtime of a double
        if constexpr (WIDE) {
          if (arg == UNIXT_FROM) {
            sd[sp - 1] = double_to_i64(__dmul_rn(bits2d(sd[sp - 1]), 1e6));
          } else {
            double x = __ll2double_rn(sd[sp - 1]);
            if (arg == UNIXT_DATE) x = __dmul_rn(x, (double)MICROS_PER_DAY);
            sd[sp - 1] = d2bits(__ddiv_rn(x, 1e6));
          }
        }
        break;
      case OP_DFMT: {  // arg 1: a timestamp; the day's code, NULL outside the span
        const i64 days = arg ? fdiv(sd[sp - 1], MICROS_PER_DAY) : sd[sp - 1];
        const i64 code = days - DATE_FMT_BASE;
        sv[sp - 1] = sv[sp - 1] && code >= 0 && code < DATE_FMT_SPAN;
        sd[sp - 1] = code < 0 ? 0 : (code >= DATE_FMT_SPAN ? DATE_FMT_SPAN - 1 : code);
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
      case OP_DUN:  // a function of one double (DUN_*); sign and the tests give ints
        if constexpr (WIDE) {
          const double x = bits2d(sd[sp - 1]);
          double r = 0.0;
          switch (arg) {
            case DUN_SQRT: r = __dsqrt_rn(x); break;
            case DUN_CBRT: r = cbrt(x); break;
            case DUN_EXP: r = exp(x); break;
            case DUN_LN: r = log(x); break;
            case DUN_LOG2: r = log2(x); break;
            case DUN_LOG10: r = log10(x); break;
            case DUN_SIN: r = sin(x); break;
            case DUN_COS: r = cos(x); break;
            case DUN_TAN: r = tan(x); break;
            case DUN_ASIN: r = asin(x); break;
            case DUN_ACOS: r = acos(x); break;
            case DUN_ATAN: r = atan(x); break;
            case DUN_SINH: r = sinh(x); break;
            case DUN_COSH: r = cosh(x); break;
            case DUN_TANH: r = tanh(x); break;
            case DUN_DEGREES: r = __dmul_rn(x, 180.0 / 3.141592653589793); break;
            case DUN_RADIANS: r = __dmul_rn(x, 3.141592653589793 / 180.0); break;
            case DUN_TRUNCATE: r = trunc(x); break;
            default: break;
          }
          if (arg >= DUN_SIGN) {
            sd[sp - 1] = arg == DUN_SIGN ? (x > 0.0) - (x < 0.0)
                : arg == DUN_IS_NAN ? (i64)isnan(x)
                : arg == DUN_IS_FINITE ? (i64)isfinite(x) : (i64)isinf(x);
          } else {
            sd[sp - 1] = d2bits(r);
          }
        }
        break;
      case OP_CASTBI: {  // arg: source (CAST_FROM_*) | decimal scale << 2
        const int scale = arg >> 2;
        i64 p10 = 1;
        for (int j = 0; j < scale; ++j) p10 *= 10;
        if ((arg & 3) == CAST_FROM_DOUBLE) {
          if constexpr (WIDE) sd[sp - 1] = double_to_i64(bits2d(sd[sp - 1]));
        } else if ((arg & 3) == CAST_FROM_LONG) {  // floor at the scale, narrowed (wraps)
          if constexpr (WIDE) sd[sp - 1] = wadd(wmul(sd[sp - 1], B18 / p10), fdiv(sl[sp - 1], p10));
        } else if (scale > 0) {  // HALF_UP: the floor plus the remainder's vote
          const i64 x = sd[sp - 1], q = fdiv(x, p10), r = x - q * p10;
          sd[sp - 1] = q + (x >= 0 ? 2 * r >= p10 : 2 * r > p10);
        }
        break;
      }
      case OP_HLL: {  // arg: 0 bucket, 1 rho | P << 1, over the lane's 64 bits; P 0: the
                      // hash, arg 1: splitmix64 (the golden-ratio increment first: mix64)
        const int P = arg >> 1;
        const u64 h = mix_u64((u64)sd[sp - 1] + (arg == 1 ? 0x9E3779B97F4A7C15ull : 0ull));
        sd[sp - 1] = P == 0 ? (i64)h
            : (arg & 1) ? (i64)__clzll((long long)((h << P) | (1ull << (P - 1)))) + 1
                        : (i64)(h >> (64 - P));
        break;
      }
      case OP_WBUCKET:  // x lo hi n -> the reference's width_bucket
        if constexpr (WIDE) {
          const double x = bits2d(sd[sp - 4]), lo = bits2d(sd[sp - 3]), hi = bits2d(sd[sp - 2]);
          const i64 nb = sd[sp - 1];
          const double frac = __ddiv_rn(__dsub_rn(x, lo), hi == lo ? 1.0 : __dsub_rn(hi, lo));
          i64 b = wadd(double_to_i64(floor(__dmul_rn(frac, __ll2double_rn(nb)))), 1);
          b = b < 0 ? 0 : b;
          b = b > wadd(nb, 1) ? wadd(nb, 1) : b;
          sv[sp - 4] = sv[sp - 4] && sv[sp - 3] && sv[sp - 2] && sv[sp - 1];
          sd[sp - 4] = b;
          sp -= 3;
        }
        break;
      case OP_F32R:  // arg: F32R_DOUBLE rounds the double lane, F32R_INT the int64 lane
        if constexpr (WIDE)
          sd[sp - 1] = d2bits((double)(arg == F32R_INT ? __ll2float_rn(sd[sp - 1])
                                                       : __double2float_rn(bits2d(sd[sp - 1]))));
        break;
      case OP_CASTN: {  // arg: 8, 16 or 32 bits; NULL outside that signed range
        const i64 half = 1LL << (arg - 1), x = sd[sp - 1];
        sv[sp - 1] = sv[sp - 1] && x >= -half && x < half;
        break;
      }
      case OP_DIN:  // == against each double literal of the run (bits)
        if constexpr (WIDE) {
          const int first = arg & ((1 << K1_IN_COUNT_SHIFT) - 1);
          const int count = arg >> K1_IN_COUNT_SHIFT;
          const double x = bits2d(sd[sp - 1]);
          bool hit = false;
          for (int j = 0; j < count; ++j) hit = hit || x == bits2d(p.consts[first + j]);
          sd[sp - 1] = hit;
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
        for (int j = 0; j < LIMBS; ++j) st[j][sp - 3] = st[j][src];
        sv[sp - 3] = sv[src];
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
          sd[sp] = op == OP_DLIT ? p.consts[arg]
                   : p.col_kind[arg] == KIND_F32  // a REAL widens exactly
                   ? d2bits((double)((const float*)p.col_data[arg])[row])
                   : ((const i64*)p.col_data[arg])[row];
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
      case OP_LIT_LONG:  // a long literal: two constants from arg
        if constexpr (WIDE) {
          sd[sp] = p.consts[arg];
          sl[sp] = p.consts[arg + 1];
          sv[sp] = true;
          ++sp;
        }
        break;
      case OP_LOAD_D38:  // a wide column's five limbs
      case OP_LIT_D38:   // a wide literal: five constants from arg
        if constexpr (D38) {
          const i64* src = op == OP_LIT_D38 ? p.consts + arg
                                            : (const i64*)p.col_data[arg] + D38_LIMBS * row;
          put(sp, src);
          sv[sp] = op == OP_LIT_D38 || p.col_valid[arg][row] != 0;
          ++sp;
        }
        break;
      case OP_S2D38:      // an int64 lane to five limbs (from_int64)
      case OP_L2D38:      // two limbs to five (widen)
      case OP_D38UP:      // arg digits up, steps of <= 8, the top carry dropped
      case OP_D38DOWN:    // arg digits down by floor division, steps of <= 9
      case OP_D38NEG:
      case OP_D382D:      // to double at scale arg
      case OP_D38NARROW:  // arg 0: to an int64 lane (wrapping), 1: to two limbs
      case OP_D38SIGN:    // arg 0: abs, 1: sign as an int64 lane
        if constexpr (D38) {
          i64 w[D38_LIMBS];
          if (op == OP_S2D38) w_from_i64(sd[sp - 1], w);
          else if (op == OP_L2D38) w_widen(sd[sp - 1], sl[sp - 1], w);
          else get(sp - 1, w);
          if (op == OP_D38UP) {
            for (int k = arg; k > 0; k -= 8) w_shift(w, k < 8 ? k : 8);
          } else if (op == OP_D38DOWN) {
            for (int k = arg; k > 0; k -= 9) w_down(w, k < 9 ? k : 9);
          } else if (op == OP_D38NEG || (op == OP_D38SIGN && arg == 0 && w[0] < 0)) {
            w_neg(w);
          }
          if (op == OP_D382D) {
            sd[sp - 1] = d2bits(w_to_double(w, arg));
          } else if (op == OP_D38NARROW && arg == 0) {
            sd[sp - 1] = w_to_i64(w);
          } else if (op == OP_D38NARROW) {  // hi = l0 * 10^18 + l1 * 10^9 + l2
            sd[sp - 1] = wadd(wmul(wadd(wmul(w[0], B9), w[1]), B9), w[2]);
            sl[sp - 1] = wadd(wmul(w[3], B9), w[4]);
          } else if (op == OP_D38SIGN && arg == 1) {
            sd[sp - 1] = w[0] < 0 ? -1
                : (w[0] | w[1] | w[2] | w[3] | w[4]) != 0 ? 1 : 0;
          } else {
            put(sp - 1, w);
          }
        }
        break;
      case OP_D38ADD:  // arg 0: a + b, 1: a - b (_norm_wide's carries)
      case OP_D38MUL:  // arg 0: a wide, b an int64 lane; 1: the reverse
      case OP_D38CMP:  // arg: 0 eq, 1 ne, 2 lt, 3 le, 4 gt, 5 ge
        if constexpr (D38) {
          i64 wa[D38_LIMBS], wb[D38_LIMBS];
          const bool v = sv[sp - 2] && sv[sp - 1];
          if (op == OP_D38MUL) {
            get(arg == 0 ? sp - 2 : sp - 1, wa);
            w_mul_small(wa, sd[arg == 0 ? sp - 1 : sp - 2]);
            put(sp - 2, wa);
          } else {
            get(sp - 2, wa);
            get(sp - 1, wb);
            if (op == OP_D38CMP) {
              const int c = w_cmp(wa, wb);
              const bool r[6] = {c == 0, c != 0, c < 0, c <= 0, c > 0, c >= 0};
              sd[sp - 2] = r[arg];
            } else {
              for (int j = 0; j < D38_LIMBS; ++j)
                wa[j] = arg ? wsub(wa[j], wb[j]) : wadd(wa[j], wb[j]);
              w_norm(wa);
              put(sp - 2, wa);
            }
          }
          sv[sp - 2] = v;
          --sp;
        }
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
          case OP_NULLIF:  // b: a = b; a, NULL where that is true
            d = a;
            v = av && !(b != 0 && bv);
            break;
          case OP_COAL: {  // the first valid operand
            const bool take = !av && bv;
            d = take ? b : a;
            v = av || bv;
            for (int j = 1; j < LIMBS; ++j) st[j][sp - 1] = take ? st[j][sp] : st[j][sp - 1];
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
          case OP_DBIN:  // arg: power, atan2, or jnp.mod's floored remainder
            if constexpr (WIDE) {
              const double x = bits2d(a), y = bits2d(b);
              double r;
              if (arg == DBIN_POWER) r = pow(x, y);
              else if (arg == DBIN_ATAN2) r = atan2(x, y);
              else {
                const double ys = y == 0.0 ? 1.0 : y;
                r = fmod(x, ys);
                if (r != 0.0 && ((r < 0.0) != (ys < 0.0))) r = __dadd_rn(r, ys);
                v = v && y != 0.0;
              }
              d = d2bits(r);
            } else {
              d = 0;
            }
            break;
          case OP_BITW: {  // arg: op | bits << 4; shifts by b & 63 on the low bits
            const int bits = arg >> 4;
            const u64 mask = bits >= 64 ? ~0ull : (1ull << bits) - 1;
            const u64 ua = (u64)a & mask;
            const int sh = (int)(b & 63);
            switch (arg & 15) {
              case BW_AND: d = a & b; break;
              case BW_OR: d = a | b; break;
              case BW_XOR: d = a ^ b; break;
              case BW_SHL: d = (i64)((ua << sh) & mask); break;
              case BW_SHR: d = (i64)((ua >> sh) & mask); break;
              default: d = __popcll((long long)ua); break;
            }
            break;
          }
          case OP_GL: {  // arg: 1 greatest / 0 least | lane << 1; NULL if either is
            const bool gt = arg & 1;
            const int lane = arg >> 1;
            if (lane == GL_INT) {
              d = gt ? (a > b ? a : b) : (a < b ? a : b);
            } else if constexpr (WIDE) {
              if (lane == GL_DOUBLE) {  // NaN wins; -0.0 below 0.0 (jnp.maximum's order)
                const double x = bits2d(a), y = bits2d(b);
                const i64 ka = double_order_key(a), kb = double_order_key(b);
                d = isnan(x) || isnan(y) ? CANONICAL_NAN
                    : (gt ? ka >= kb : ka <= kb) ? a : b;
              } else if (lane == GL_LONG) {  // limb by limb, high limb first
                const i64 al = sl[sp - 1], bl = sl[sp];
                const bool a_less = a < b || (a == b && al < bl);
                const bool take_a = a_less != gt;
                d = take_a ? a : b;
                sl[sp - 1] = take_a ? al : bl;
              } else {  // GL_D38: five limbs, limb 0 first
                d = a;
                if constexpr (D38) {
                  i64 wa[D38_LIMBS], wb[D38_LIMBS];
                  get(sp - 1, wa);
                  get(sp, wb);
                  if ((w_cmp(wa, wb) < 0) == gt) {  // take b
                    put(sp - 1, wb);
                    d = wb[0];
                  }
                }
              }
            } else {
              d = 0;
            }
            break;
          }
          case OP_IMOD: {  // arg: 0 mod, 1 div | a's, b's width codes << 1, << 3
            // truncating, NULL on a zero divisor; each abs at its operand's
            // width (its least value wraps to itself) and the result
            // wrapped at the wider one, as the reference's jnp computes
            const int wa = imod_bits(arg >> 1 & 3), wb = imod_bits(arg >> 3 & 3);
            const int wr = wa > wb ? wa : wb;
            const i64 bs = b == 0 ? 1 : b;
            const i64 aa = abs_at(a, wa), ab = abs_at(bs, wb);
            if (arg & 1) {
              const i64 q = fdiv(aa, ab);
              d = wrap_at((a < 0) != (bs < 0) ? wneg(q) : q, wr);
              v = v && b != 0 && !(a == least_at(wr) && b == -1);
            } else {
              const i64 r = fmod_(aa, ab);
              d = wrap_at(a < 0 ? wneg(r) : r, wr);
              v = v && b != 0;
            }
            break;
          }
          case OP_DTADD: d = dt_add(a, b, arg); break;  // a: the date or timestamp, b: n
          case OP_DTDIFF: d = dt_diff(a, b, arg); break;
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
  for (int j = 0; j < LIMBS; ++j) out[j] = st[j][0];
  *out_v = sv[0];
}

template <int LIMBS>
__global__ void k1_kernel(const K1Prog p, i64 n, const uint8_t* __restrict__ row_mask,
                          void* __restrict__ out_data, int out_kind,
                          uint8_t* __restrict__ out_valid, uint8_t* __restrict__ out_mask) {
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    if (out_mask != nullptr && !row_mask[i]) {
      out_mask[i] = 0;  // a dead row stays dead: no need to evaluate
      continue;
    }
    i64 w[LIMBS];
    bool v;
    run_program<LIMBS>(p, i, w, &v);
    const i64 d = w[0];
    if (out_mask != nullptr) {
      out_mask[i] = (d != 0) && v;
      continue;
    }
    if (out_kind == KIND_D128 || out_kind == KIND_D38) {  // a long or wide decimal's limbs
      const int k = out_kind == KIND_D128 ? 2 : D38_LIMBS;
      for (int j = 0; j < k && j < LIMBS; ++j) ((i64*)out_data)[k * i + j] = w[j];
    } else if (out_kind == KIND_I64 || out_kind == KIND_F64) ((i64*)out_data)[i] = d;
    else if (out_kind == KIND_I32) ((int*)out_data)[i] = (int)d;
    else if (out_kind == KIND_I16) ((short*)out_data)[i] = (short)d;
    else if (out_kind == KIND_I8) ((signed char*)out_data)[i] = (signed char)d;
    else if (out_kind == KIND_F32) ((float*)out_data)[i] = __double2float_rn(bits2d(d));
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
                            int limbs, i64 n, const void* row_mask,
                            void* out_data, int out_kind, void* out_valid, void* out_mask,
                            void* stream) {
  if (n_ins > K1_MAX_INS || n_consts > K1_MAX_CONSTS || n_cols > K1_MAX_COLS ||
      n_luts > K1_MAX_LUTS || (limbs != 1 && limbs != 2 && limbs != D38_LIMBS) ||
      (out_kind == KIND_D38 && limbs != D38_LIMBS) || (out_kind == KIND_D128 && limbs < 2))
    return (int)cudaErrorInvalidValue;
  K1Prog p;
  p.n_ins = n_ins;
  for (int i = 0; i < n_ins; ++i) {
    if (ops[i] < 0 || ops[i] >= OP_COUNT) return (int)cudaErrorInvalidValue;
    p.op[i] = ops[i];
    p.arg[i] = args[i];
  }
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
    if (limbs == D38_LIMBS)
      k1_kernel<D38_LIMBS><<<grid, threads, 0, (cudaStream_t)stream>>>(
          p, n, (const uint8_t*)row_mask, out_data, out_kind, (uint8_t*)out_valid,
          (uint8_t*)out_mask);
    else if (limbs == 2)
      k1_kernel<2><<<grid, threads, 0, (cudaStream_t)stream>>>(
          p, n, (const uint8_t*)row_mask, out_data, out_kind, (uint8_t*)out_valid,
          (uint8_t*)out_mask);
    else
      k1_kernel<1><<<grid, threads, 0, (cudaStream_t)stream>>>(
          p, n, (const uint8_t*)row_mask, out_data, out_kind, (uint8_t*)out_valid,
          (uint8_t*)out_mask);
  }
  return (int)cudaGetLastError();
}
