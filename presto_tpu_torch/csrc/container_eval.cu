// K12 container_eval: the per-row slot functions of ARRAY, MAP and ROW
// values (cardinality, element_at / subscript, contains,
// array_position, array_min/max/sum/average, array_sort,
// array_distinct, slice, the slot coercions, ||, map_keys /
// map_values, the ARRAY / MAP / ROW constructors and field access, the
// set functions, map_concat, sequence, repeat, split's table gather,
// and the lambda functions' assembly from their body's lanes).
//
// Replaces: presto_tpu/ops/container.py (construct_row :169, row_field
// :179, construct_array :235, subscript :252, map_get :268, cardinality
// :279, contains :283, array_position :290, array_reduce :299,
// array_sort :320, array_distinct :352, slice_array :391, coerce_slots
// :411, concat_arrays :435, map_keys_array / map_values_array :459,
// construct_map :533, _row_compact :555, _membership :575 and the set
// functions after it, map_concat :645, compact_entry_pairs :670) and
// the container branches of presto_tpu/expr/compile.py
// (_compile_container :1806, _compile_split :1476, the lambdas
// :2116-:2355), which XLA fused as masked reductions, gathers and
// argsorts over the trailing slot axis.
//
// Bound on the H100: memory.  Every opcode reads each input slot once
// and writes each output slot once (sort, distinct and the set
// functions compare slots of one row with each other, in registers and
// the L1-cached row); an (n, 65) int64 matrix of 15M rows is 7.8 GB,
// ~2.3 ms at 3.35 TB/s.
//
// Design: one thread per row, grid-stride, one opcode per launch (the
// host lowers each SQL function to an opcode and its parameters).  A
// thread walks its row's slots in order, so every order-sensitive rule
// of the reference holds by construction: a double sum adds in slot
// order from 0.0, compactions keep slot order, sorts are insertion
// sorts (stable; a row holds at most a few dozen slots), NULL
// elements and pads are told apart by position against the row's
// counts, never by value.  The storage dtype (int32, int64, float64)
// is a template parameter; inputs of another kind (the scalar lanes,
// the comparison copies of the set functions) load through one
// converting accessor.  Simple first: rows are read with strided
// per-thread accesses, not staged through shared memory.

#include <math.h>

#include <type_traits>

#include "common.cuh"

enum { K12_BOOL = 0, K12_I32 = 1, K12_I64 = 2, K12_F64 = 3 };
enum {
  OP_CARD, OP_SUBSCRIPT, OP_MAP_GET, OP_CONTAINS, OP_POSITION, OP_REDUCE, OP_SORT,
  OP_DISTINCT, OP_SLICE, OP_COERCE, OP_CONCAT, OP_MAP_HALF, OP_CONSTRUCT, OP_CONSTRUCT_MAP,
  OP_ROW_FIELD, OP_COMPACT, OP_COMPACT_PAIRS, OP_SETOP, OP_OVERLAP, OP_REMOVE, OP_MAP_CONCAT,
  OP_TKEYS, OP_SEQUENCE, OP_REPEAT, OP_ASSEMBLE, OP_MATCH, OP_SLOT, OP_TABLE, OP_COUNT
};
enum { R_MIN, R_MAX, R_SUM, R_AVG };
enum { M_ANY, M_NONE, M_ALL };
enum { C_CAST, C_DEC2DBL, C_DBL2DEC, C_UP, C_DOWN, C_ASTYPE };

struct K12 {
  int op;
  i64 n;
  const void* a;
  const uint8_t* av;
  const void* b;
  const uint8_t* bv;
  const void* c;
  const void* x;
  const uint8_t* xv;
  const void* y;
  const uint8_t* yv;
  const i64* off;
  void* out;
  uint8_t* ov;
  uint8_t* o2;
  int t_kind, a_w, b_k, b_w, c_k, c_w, x_k, y_k, y_w, o_k, o_w, out_m;
  i64 a_rows;
  i64 p[6];
};

// -- element rules -----------------------------------------------------------

__device__ __forceinline__ bool is_null_v(int v) { return v == (int)0x80000000; }
__device__ __forceinline__ bool is_null_v(i64 v) { return v == I64_MIN; }
__device__ __forceinline__ bool is_null_v(double v) { return isnan(v); }

template <typename T> __device__ __forceinline__ T sent_v();
template <> __device__ __forceinline__ int sent_v<int>() { return (int)0x80000000; }
template <> __device__ __forceinline__ i64 sent_v<i64>() { return I64_MIN; }
template <> __device__ __forceinline__ double sent_v<double>() {
  return __longlong_as_double(0x7ff8000000000000LL);
}

template <typename T> __device__ __forceinline__ i64 len_of(T l0) {
  const i64 l = (i64)l0;
  return l < 0 ? 0 : l;
}
template <> __device__ __forceinline__ i64 len_of<double>(double l0) {
  if (isnan(l0)) return 0;
  const i64 l = (i64)l0;
  return l < 0 ? 0 : l;
}

// One element of any kind, with its NULL flag (a bool never is NULL).
struct Val {
  i64 i;
  double d;
  bool f;
  bool null;
};

__device__ __forceinline__ Val load_val(const void* p, int kind, i64 idx) {
  Val v;
  v.f = false;
  v.d = 0.0;
  switch (kind) {
    case K12_BOOL: v.i = ((const uint8_t*)p)[idx] != 0; v.null = false; break;
    case K12_I32: {
      const int x = ((const int*)p)[idx];
      v.i = x;
      v.null = is_null_v(x);
      break;
    }
    case K12_I64: v.i = ((const i64*)p)[idx]; v.null = is_null_v(v.i); break;
    default:
      v.d = ((const double*)p)[idx];
      v.f = true;
      v.null = isnan(v.d);
      v.i = v.null ? 0 : (i64)v.d;
  }
  return v;
}

// a value in T, NULL as T's sentinel, a double into an integer truncated
template <typename T> __device__ __forceinline__ T store_as(const Val& v);
template <> __device__ __forceinline__ int store_as<int>(const Val& v) {
  return v.null ? sent_v<int>() : (int)v.i;
}
template <> __device__ __forceinline__ i64 store_as<i64>(const Val& v) {
  return v.null ? sent_v<i64>() : v.i;
}
template <> __device__ __forceinline__ double store_as<double>(const Val& v) {
  return v.null ? sent_v<double>() : (v.f ? v.d : (double)v.i);
}

// numpy's astype, as the reference's host runs it: no NULL rule (an
// integer sentinel into a double is its value), a NaN into an integer
// that type's least value
template <typename T> __device__ __forceinline__ T astype(const Val& v);
template <> __device__ __forceinline__ int astype<int>(const Val& v) {
  return v.f ? (isnan(v.d) ? (int)0x80000000 : (int)(i64)v.d) : (int)v.i;
}
template <> __device__ __forceinline__ i64 astype<i64>(const Val& v) {
  return v.f ? (isnan(v.d) ? I64_MIN : (i64)v.d) : v.i;
}
template <> __device__ __forceinline__ double astype<double>(const Val& v) {
  return v.f ? v.d : (double)v.i;
}

template <typename T> __device__ __forceinline__ T from_double(double x) { return (T)x; }
template <typename T> __device__ __forceinline__ T from_i64(i64 x) { return (T)x; }

// coerce_slots: one slot converted by mode
template <typename TD>
__device__ __forceinline__ TD conv(const Val& v, int mode, i64 fac) {
  if (mode == C_ASTYPE) return astype<TD>(v);
  if (v.null) return sent_v<TD>();
  const double x = v.f ? v.d : (double)v.i;
  switch (mode) {
    case C_CAST: return store_as<TD>(v);
    case C_DEC2DBL: return from_double<TD>(x / __longlong_as_double(fac));
    case C_DBL2DEC: {
      const double r = rint(x * __longlong_as_double(fac));
      return from_i64<TD>(isfinite(r) ? (i64)r : 0);
    }
    case C_UP: return from_i64<TD>(wmul(v.i, fac));
    default: return from_i64<TD>(fdiv(v.i, fac));
  }
}

template <typename T> __device__ __forceinline__ void put(void* p, i64 idx, T v) {
  ((T*)p)[idx] = v;
}

// -- the flattened body of a lambda ----------------------------------------------

// element j of row r of the body: its value (kind y_k) and whether it
// is valid and in the row's range
__device__ __forceinline__ Val body_at(const K12& g, i64 r, i64 j, bool* ok) {
  const i64 o = g.off[r];
  if (j >= g.off[r + 1] - o) {
    *ok = false;
    Val v;
    v.i = 0; v.d = 0.0; v.f = false; v.null = true;
    return v;
  }
  *ok = g.yv[o + j] != 0;
  return load_val(g.y, g.y_k, o + j);
}

// -- the opcodes -----------------------------------------------------------------

template <typename T>
__device__ void insertion_sort(T* s, i64 k) {
  for (i64 q = 1; q < k; ++q) {
    const T v = s[q];
    i64 w = q - 1;
    while (w >= 0 && v < s[w]) {
      s[w + 1] = s[w];
      --w;
    }
    s[w + 1] = v;
  }
}

// Kept slots of a row, in order, into out[1..cap]; returns how many.
template <typename T>
__device__ __forceinline__ i64 keep_slot(T* o, i64 k, i64 cap, T v) {
  if (k < cap) o[1 + k] = v;
  return k + 1;
}

template <typename T>
__device__ void k12_row(const K12& g, i64 r) {
  const i64 p0 = g.p[0], p1 = g.p[1];
  const int op = g.op;
  if (op == OP_SEQUENCE) {
    i64* o = (i64*)g.out + r * g.o_w;
    o[0] = g.out_m;
    for (i64 j = 0; j < g.out_m; ++j) o[1 + j] = wadd(p0, wmul(p1, j));
    return;
  }
  if (op == OP_REPEAT) {
    T* o = (T*)g.out + r * g.o_w;
    const T v = g.xv[r] ? store_as<T>(load_val(g.x, g.x_k, r)) : sent_v<T>();
    o[0] = (T)p0;
    for (i64 j = 0; j < g.out_m; ++j) o[1 + j] = v;
    return;
  }
  if (op == OP_CONSTRUCT) {
    T* o = (T*)g.out + r * g.o_w;
    const T* e = (const T*)g.y + r * g.y_w;
    const uint8_t* ev = g.yv + r * g.y_w;
    T* s = o;
    if (p0) {
      o[0] = (T)g.y_w;
      s = o + 1;
    }
    for (i64 j = 0; j < g.out_m; ++j) s[j] = (j < g.y_w && ev[j]) ? e[j] : sent_v<T>();
    return;
  }
  if (op == OP_ASSEMBLE) {
    T* o = (T*)g.out + r * g.o_w;
    const i64 cnt = g.off[r + 1] - g.off[r];
    const i64 m = g.out_m;
    o[0] = (T)cnt;
    T* vals = o + 1;
    if (p0) {  // transform_values: the map's keys (storage kind p1), then the new values
      for (i64 j = 0; j < m; ++j) o[1 + j] = astype<T>(load_val(g.a, (int)p1, r * g.a_w + 1 + j));
      vals = o + 1 + m;
    }
    for (i64 j = 0; j < m; ++j) {
      bool ok;
      const Val v = body_at(g, r, j, &ok);
      vals[j] = ok ? store_as<T>(v) : sent_v<T>();
    }
    return;
  }
  if (op == OP_MATCH) {
    const i64 cnt = g.off[r + 1] - g.off[r];
    bool any = false, all = true;
    for (i64 j = 0; j < cnt; ++j) {
      bool ok;
      const Val v = body_at(g, r, j, &ok);
      const bool hit = ok && v.i != 0;
      any |= hit;
      all &= hit;
    }
    ((uint8_t*)g.out)[r] = p0 == M_ANY ? any : p0 == M_NONE ? !any : all;
    g.ov[r] = g.av[r];
    return;
  }
  if (op == OP_TABLE) {
    const Val c = load_val(g.x, g.x_k, r);
    i64 code = c.i;
    code = code < 0 ? 0 : (code >= g.a_rows ? g.a_rows - 1 : code);
    const T* src = (const T*)g.a + code * g.a_w;
    T* o = (T*)g.out + r * g.o_w;
    for (int j = 0; j < g.a_w; ++j) o[j] = src[j];
    g.ov[r] = g.xv[r];
    return;
  }
  const T* A = (const T*)g.a + r * g.a_w;
  const bool av = g.av != nullptr ? g.av[r] != 0 : true;
  const i64 L = len_of<T>(A[0]);
  if (op == OP_CARD) {
    ((i64*)g.out)[r] = L;
    g.ov[r] = av;
    return;
  }
  if (op == OP_ROW_FIELD) {
    const T v = A[p0];
    put<T>(g.out, r, v);
    g.ov[r] = av && !is_null_v(v);
    return;
  }
  const bool mapped = op == OP_MAP_GET || op == OP_COMPACT_PAIRS || op == OP_TKEYS ||
                      op == OP_MAP_HALF || op == OP_MAP_CONCAT || op == OP_COERCE;
  const i64 m = mapped ? g.p[5] : (i64)g.a_w - 1;
  const T* S = A + 1;
  const i64 live_n = L < m ? L : m;
  switch (op) {
    case OP_SUBSCRIPT: {
      const i64 i0 = load_val(g.x, g.x_k, r).i - 1;
      const bool ok = g.xv[r] && i0 >= 0 && i0 < L && m > 0;
      const T v = m > 0 ? S[i0 < 0 ? 0 : (i0 >= m ? m - 1 : i0)] : sent_v<T>();
      put<T>(g.out, r, v);
      g.ov[r] = av && ok && !is_null_v(v);
      return;
    }
    case OP_MAP_GET: {
      const T key = store_as<T>(load_val(g.x, g.x_k, r));
      i64 hit = -1;
      if (g.xv[r])
        for (i64 j = 0; j < live_n && hit < 0; ++j)
          if (S[j] == key) hit = j;
      const T v = m > 0 ? S[m + (hit < 0 ? 0 : hit)] : sent_v<T>();
      put<T>(g.out, r, v);
      g.ov[r] = av && hit >= 0 && !is_null_v(v);
      return;
    }
    case OP_CONTAINS:
    case OP_POSITION: {
      const T key = store_as<T>(load_val(g.x, g.x_k, r));
      i64 hit = -1;
      for (i64 j = 0; j < live_n && hit < 0; ++j)
        if (!is_null_v(S[j]) && S[j] == key) hit = j;
      if (op == OP_CONTAINS) ((uint8_t*)g.out)[r] = hit >= 0;
      else ((i64*)g.out)[r] = hit + 1;
      g.ov[r] = av && g.xv[r];
      return;
    }
    case OP_REDUCE: {
      i64 cnt = 0;
      if (p0 == R_MIN || p0 == R_MAX) {
        T acc;
        if constexpr (std::is_floating_point<T>::value) {
          acc = p0 == R_MIN ? (T)INFINITY : (T)-INFINITY;
        } else if constexpr (sizeof(T) == 8) {
          acc = p0 == R_MIN ? (T)I64_MAX : (T)(I64_MIN + 1);
        } else {
          acc = p0 == R_MIN ? (T)0x7fffffff : (T)((int)0x80000000 + 1);
        }
        for (i64 j = 0; j < live_n; ++j) {
          const T v = S[j];
          if (is_null_v(v)) continue;
          ++cnt;
          if (p0 == R_MIN ? v < acc : v > acc) acc = v;
        }
        put<T>(g.out, r, acc);
      } else {
        T acc = 0;
        for (i64 j = 0; j < m; ++j) {
          const T v = S[j];
          const bool ok = j < live_n && !is_null_v(v);
          cnt += ok;
          if constexpr (std::is_floating_point<T>::value) {
            acc = acc + (ok ? v : (T)0);
          } else {
            acc = (T)(i64)((u64)(i64)acc + (u64)(i64)(ok ? v : (T)0));
          }
        }
        if (p0 == R_AVG)
          put<double>(g.out, r, (double)acc / (double)(cnt > 1 ? cnt : 1));
        else
          put<T>(g.out, r, acc);
      }
      g.ov[r] = av && cnt > 0;
      return;
    }
    case OP_SORT:
    case OP_DISTINCT: {
      T* o = (T*)g.out + r * g.o_w;
      i64 nn = 0;
      bool had_null = false;
      for (i64 j = 0; j < live_n; ++j) {
        if (is_null_v(S[j])) had_null = true;
        else o[1 + nn++] = S[j];
      }
      if constexpr (!std::is_floating_point<T>::value) {
        // the reference's integer sort key puts a NULL element at max - 1,
        // among the values' extremes: sort the NULLs in with that key and
        // keep the first nn keys (a real max beside a NULL comes out as
        // max - 1, the reference's fault, followed)
        if (op == OP_SORT && had_null) {
          const T near_max = (T)(sizeof(T) == 8 ? I64_MAX - 1 : 0x7ffffffe);
          i64 k = nn;
          for (i64 j = 0; j < live_n; ++j)
            if (is_null_v(S[j])) o[1 + k++] = near_max;
          insertion_sort<T>(o + 1, k);
        } else {
          insertion_sort<T>(o + 1, nn);
        }
      } else {
        insertion_sort<T>(o + 1, nn);
      }
      i64 k = nn;
      if (op == OP_DISTINCT) {
        k = 0;
        T prev = sent_v<T>();
        for (i64 j = 0; j < nn; ++j) {
          const T v = o[1 + j];
          if (j == 0 || v != prev) o[1 + k++] = v;
          prev = v;
        }
        o[0] = (T)(k + (had_null ? 1 : 0));
      } else {
        o[0] = A[0];
      }
      for (i64 j = k; j < m; ++j) o[1 + j] = sent_v<T>();
      return;
    }
    case OP_SLICE: {
      T* o = (T*)g.out + r * g.o_w;
      i64 base = p0 > 0 ? p0 - 1 : L + p0;
      if (base < 0) base = 0;
      i64 avail = L - base < p1 ? L - base : p1;
      if (avail < 0) avail = 0;
      o[0] = (T)avail;
      for (i64 j = 0; j < m; ++j) {
        i64 s = j + base;
        s = s < 0 ? 0 : (s >= m ? m - 1 : s);
        o[1 + j] = j < avail ? S[s] : sent_v<T>();
      }
      return;
    }
    case OP_CONCAT: {
      T* o = (T*)g.out + r * g.o_w;
      const T* B = (const T*)g.b + r * g.b_w;
      const i64 lb = len_of<T>(B[0]);
      const i64 wb = g.b_w - 1, total = L + lb;
      o[0] = (T)total;
      for (i64 j = 0; j < g.out_m; ++j) {
        T v;
        if (j < L) v = j < m ? S[j] : sent_v<T>();
        else if (wb > 0) {
          i64 bj = j - L;
          bj = bj >= wb ? wb - 1 : bj;
          v = B[1 + bj];
        } else v = sent_v<T>();
        o[1 + j] = j < total ? v : sent_v<T>();
      }
      return;
    }
    case OP_CONSTRUCT_MAP: {
      T* o = (T*)g.out + r * g.o_w;
      const T* B = (const T*)g.b + r * g.b_w;
      const i64 lb = len_of<T>(B[0]);
      const i64 k = L < lb ? L : lb;
      const i64 mo = g.out_m;
      o[0] = (T)k;
      for (i64 j = 0; j < mo; ++j) {
        const bool live = j < k;
        o[1 + j] = live && j < m ? S[j] : sent_v<T>();
        o[1 + mo + j] = live && j < g.b_w - 1 ? B[1 + j] : sent_v<T>();
      }
      return;
    }
    case OP_COMPACT: {
      T* o = (T*)g.out + r * g.o_w;
      const i64 cap = g.out_m;
      i64 k = 0;
      for (i64 j = 0; j < m; ++j) {
        bool ok;
        const Val v = body_at(g, r, j, &ok);
        if (ok && v.i != 0) k = keep_slot<T>(o, k, cap, S[j]);
      }
      k = k < cap ? k : cap;
      o[0] = (T)k;
      for (i64 j = k; j < cap; ++j) o[1 + j] = sent_v<T>();
      return;
    }
    case OP_REMOVE: {
      T* o = (T*)g.out + r * g.o_w;
      const T key = store_as<T>(load_val(g.x, g.x_k, r));
      i64 k = 0;
      for (i64 j = 0; j < live_n; ++j)
        if (is_null_v(S[j]) || S[j] != key) k = keep_slot<T>(o, k, m, S[j]);
      o[0] = (T)k;
      for (i64 j = k; j < m; ++j) o[1 + j] = sent_v<T>();
      g.ov[r] = av && g.xv[r];
      return;
    }
    case OP_SETOP:
    case OP_OVERLAP: {
      // b: the second array and c: this one, both in the comparison type
      const i64 mb = g.b_w - 1;
      const i64 rowb = r * g.b_w, rowc = r * g.c_w;
      const Val lb0 = load_val(g.b, g.b_k, rowb);
      const i64 lb = lb0.null ? 0 : (lb0.i < 0 ? 0 : lb0.i);
      const i64 lbn = lb < mb ? lb : mb;
      bool b_null = false;
      for (i64 q = 0; q < lbn; ++q) b_null |= load_val(g.b, g.b_k, rowb + 1 + q).null;
      T* o = (T*)g.out + r * g.o_w;
      const i64 cap = g.out_m;
      bool match = false, a_null = false;
      i64 k = 0;
      for (i64 j = 0; j < live_n; ++j) {
        const bool na = is_null_v(S[j]);
        bool member = false;
        if (!na) {
          const Val ac = load_val(g.c, g.c_k, rowc + 1 + j);
          for (i64 q = 0; q < lbn && !member; ++q) {
            const Val bc = load_val(g.b, g.b_k, rowb + 1 + q);
            if (bc.null || ac.null) continue;
            member = (ac.f || bc.f) ? (ac.f ? ac.d : (double)ac.i) == (bc.f ? bc.d : (double)bc.i)
                                    : ac.i == bc.i;
          }
        }
        a_null |= na;
        match |= !na && member;
        if (op == OP_SETOP) {
          const bool keep = p0 == 0 ? ((!na && member) || (na && b_null))
                                    : ((!na && !member) || (na && !b_null));
          if (keep) k = keep_slot<T>(o, k, cap, S[j]);
        }
      }
      if (op == OP_OVERLAP) {
        ((uint8_t*)g.out)[r] = match;
        g.ov[r] = av && g.bv[r] && (match || !(a_null || b_null));
        return;
      }
      k = k < cap ? k : cap;
      o[0] = (T)k;
      for (i64 j = k; j < cap; ++j) o[1 + j] = sent_v<T>();
      return;
    }
    case OP_COMPACT_PAIRS:
    case OP_TKEYS:
    case OP_MAP_CONCAT: {
      T* o = (T*)g.out + r * g.o_w;
      const i64 cap = g.out_m;
      i64 k = 0;
      if (op == OP_MAP_CONCAT) {
        const T* B = (const T*)g.b + r * g.b_w;
        const i64 m2 = g.p[4];
        const i64 l2 = len_of<T>(B[0]);
        const i64 l2n = l2 < m2 ? l2 : m2;
        for (i64 j = 0; j < live_n; ++j) {
          bool shadowed = false;
          for (i64 q = 0; q < l2n && !shadowed; ++q) shadowed = S[j] == B[1 + q];
          if (!shadowed) {
            if (k < cap) {
              o[1 + k] = S[j];
              o[1 + cap + k] = S[m + j];
            }
            ++k;
          }
        }
        for (i64 q = 0; q < l2n; ++q) {
          if (k < cap) {
            o[1 + k] = B[1 + q];
            o[1 + cap + k] = B[1 + m2 + q];
          }
          ++k;
        }
      } else {
        for (i64 j = 0; j < m; ++j) {
          bool ok;
          const Val v = body_at(g, r, j, &ok);
          bool keep;
          T key = S[j];
          if (op == OP_COMPACT_PAIRS) {
            keep = ok && v.i != 0;
          } else {
            key = store_as<T>(v);
            keep = ok;
            for (i64 q = 0; q < j && keep; ++q) {
              bool okq;
              const Val w = body_at(g, r, q, &okq);
              if (okq && store_as<T>(w) == key) keep = false;
            }
          }
          if (keep) {
            if (k < cap) {
              o[1 + k] = key;
              o[1 + cap + k] = S[m + j];
            }
            ++k;
          }
        }
      }
      k = k < cap ? k : cap;
      o[0] = (T)k;
      for (i64 j = k; j < cap; ++j) {
        o[1 + j] = sent_v<T>();
        o[1 + cap + j] = sent_v<T>();
      }
      return;
    }
    case OP_SLOT: {
      const i64 i = p0;
      const T v = i < m ? S[i] : sent_v<T>();
      put<T>(g.out, r, v);
      g.ov[r] = i < L && !is_null_v(v);
      g.o2[r] = i < L;
      return;
    }
    default:
      return;
  }
}

// COERCE and MAP_HALF: T the source storage, TD the output's
template <typename T, typename TD>
__device__ void k12_convert_row(const K12& g, i64 r) {
  const T* A = (const T*)g.a + r * g.a_w;
  TD* o = (TD*)g.out + r * g.o_w;
  const i64 m = g.p[5];
  const int tk = g.t_kind;
  if (g.op == OP_MAP_HALF) {
    o[0] = (TD)len_of<T>(A[0]);
    const i64 base = 1 + g.p[0] * m;
    for (i64 j = 0; j < m; ++j) o[1 + j] = astype<TD>(load_val(g.a, tk, r * g.a_w + base + j));
    return;
  }
  o[0] = astype<TD>(load_val(g.a, tk, r * g.a_w));
  for (i64 j = 0; j < m; ++j)
    o[1 + j] = conv<TD>(load_val(g.a, tk, r * g.a_w + 1 + j), (int)g.p[0], g.p[1]);
  if (g.p[4])
    for (i64 j = 0; j < m; ++j)
      o[1 + m + j] = conv<TD>(load_val(g.a, tk, r * g.a_w + 1 + m + j), (int)g.p[2], g.p[3]);
}

template <typename T>
static __global__ void k12_kernel(K12 g) {
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 r = (i64)blockIdx.x * blockDim.x + threadIdx.x; r < g.n; r += stride) {
    if (g.op == OP_COERCE || g.op == OP_MAP_HALF) {
      switch (g.o_k) {
        case K12_I32: k12_convert_row<T, int>(g, r); break;
        case K12_I64: k12_convert_row<T, i64>(g, r); break;
        default: k12_convert_row<T, double>(g, r);
      }
    } else {
      k12_row<T>(g, r);
    }
  }
}

// ptrs: a, av, b, bv, c, x, xv, y, yv, off, out, out_valid, out2
// ints: t_kind, a_w, b_k, b_w, c_k, c_w, x_k, y_k, y_w, o_k, o_w, out_m,
//       a_rows, p[0..5]
extern "C" int k12_container_eval(int op, i64 n, const i64* ptrs, const i64* ints,
                                  void* stream) {
  if (op < 0 || op >= OP_COUNT) return (int)cudaErrorInvalidValue;
  K12 g;
  g.op = op;
  g.n = n;
  g.a = (const void*)ptrs[0];
  g.av = (const uint8_t*)ptrs[1];
  g.b = (const void*)ptrs[2];
  g.bv = (const uint8_t*)ptrs[3];
  g.c = (const void*)ptrs[4];
  g.x = (const void*)ptrs[5];
  g.xv = (const uint8_t*)ptrs[6];
  g.y = (const void*)ptrs[7];
  g.yv = (const uint8_t*)ptrs[8];
  g.off = (const i64*)ptrs[9];
  g.out = (void*)ptrs[10];
  g.ov = (uint8_t*)ptrs[11];
  g.o2 = (uint8_t*)ptrs[12];
  g.t_kind = (int)ints[0];
  g.a_w = (int)ints[1];
  g.b_k = (int)ints[2];
  g.b_w = (int)ints[3];
  g.c_k = (int)ints[4];
  g.c_w = (int)ints[5];
  g.x_k = (int)ints[6];
  g.y_k = (int)ints[7];
  g.y_w = (int)ints[8];
  g.o_k = (int)ints[9];
  g.o_w = (int)ints[10];
  g.out_m = (int)ints[11];
  g.a_rows = ints[12];
  for (int i = 0; i < 6; ++i) g.p[i] = ints[13 + i];
  if (g.t_kind < K12_I32 || g.t_kind > K12_F64) return (int)cudaErrorInvalidValue;
  if ((op == OP_COERCE || op == OP_MAP_HALF) && (g.o_k < K12_I32 || g.o_k > K12_F64))
    return (int)cudaErrorInvalidValue;
  if (g.out_m < 0 || g.out_m > (1 << 20) || g.a_w > (1 << 20) + 1)
    return (int)cudaErrorInvalidValue;
  if (op == OP_SEQUENCE && g.t_kind != K12_I64) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const int grid = grid_for(n, 256, 8);
  switch (g.t_kind) {
    case K12_I32: k12_kernel<int><<<grid, 256, 0, s>>>(g); break;
    case K12_I64: k12_kernel<i64><<<grid, 256, 0, s>>>(g); break;
    default: k12_kernel<double><<<grid, 256, 0, s>>>(g);
  }
  return (int)cudaGetLastError();
}
