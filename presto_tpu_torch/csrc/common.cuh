// Shared helpers of the presto_tpu_torch kernels.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

typedef long long i64;
typedef unsigned long long u64;

// Two's-complement wrapping arithmetic (signed overflow is undefined
// in C++, so it runs in unsigned and reinterprets).
__device__ __forceinline__ i64 wadd(i64 a, i64 b) { return (i64)((u64)a + (u64)b); }
__device__ __forceinline__ i64 wsub(i64 a, i64 b) { return (i64)((u64)a - (u64)b); }
__device__ __forceinline__ i64 wmul(i64 a, i64 b) { return (i64)((u64)a * (u64)b); }
__device__ __forceinline__ i64 wneg(i64 a) { return (i64)(0ull - (u64)a); }

// Floor division and the matching non-negative remainder (b > 0), as
// jnp.floor_divide / jnp.remainder compute them.
__device__ __forceinline__ i64 fdiv(i64 a, i64 b) {
  i64 q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}
__device__ __forceinline__ i64 fmod_(i64 a, i64 b) { return a - fdiv(a, b) * b; }

#define I64_MAX 0x7fffffffffffffffLL
#define I64_MIN (-I64_MAX - 1)
#define B18 1000000000000000000LL
#define B9 1000000000LL

// How a raw accumulator slot combines values: summed (from 0), or the
// least or greatest value (from the int64 extreme that no value
// passes), by 64-bit atomics in shared or device memory.
enum { SLOT_ADD = 0, SLOT_MIN = 1, SLOT_MAX = 2 };

__device__ __forceinline__ i64 slot_identity(int kind) {
  return kind == SLOT_MIN ? I64_MAX : kind == SLOT_MAX ? I64_MIN : 0;
}

__device__ __forceinline__ void slot_combine(u64* p, i64 v, int kind) {
  if (kind == SLOT_MIN) atomicMin((long long*)p, (long long)v);
  else if (kind == SLOT_MAX) atomicMax((long long*)p, (long long)v);
  else if (v != 0) atomicAdd(p, (u64)v);  // adding zero changes nothing
}

// An int64 extreme stored into an int32 state: the int32 identity.
__device__ __forceinline__ int narrow_extreme(i64 v) {
  return v == I64_MAX ? 0x7fffffff : v == I64_MIN ? (int)0x80000000 : (int)v;
}

// Grid size for a grid-stride loop over n items: enough blocks to
// fill every SM several times, never more than the items need.
static inline int grid_for(i64 n, int threads, int per_sm) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  i64 need = (n + threads - 1) / threads;
  i64 cap = (i64)sms * per_sm;
  i64 g = need < cap ? need : cap;
  return g < 1 ? 1 : (int)g;
}
