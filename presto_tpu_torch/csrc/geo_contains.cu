// K18 geo_contains: ST_Contains(geometry, point) per row.
//
// Replaces: presto_tpu/geo.py points_in_geometry (:137) and bbox_mask
// (:166), as presto_tpu/expr/compile.py _compile_geo (:1679) calls them:
// one broadcast (rows x vertices) compare-and-count per ring that XLA
// fused, for a WKT literal over every row, and for a dictionary
// geometry column once per distinct geometry over every row, selected
// by code (run_contains_col).
//
// Bound on the H100: arithmetic in float64 where points fall inside
// their geometry's bbox, else memory.  A row reads x, y (and its
// geometry code) once and writes two flags; a row inside the bbox
// tests every edge of its geometry: a compare (whether the edge's
// y-span holds the row's y), and only where it does seven more (two
// subtracts, a divide, a subtract, a multiply, an add, the compare with
// x).  A literal polygon of 1024 vertices over 16.8M points of which a
// third fall in its bbox is ~5.7G edge tests, a few of them spanning
// each row's y: ~6G float64 instructions, ~0.35 ms at the card's 17G
// a millisecond (its 34 TFLOP/s counts a fused multiply-add as two).
//
// Design: one thread per row, grid-stride.  A literal's geometry (the
// only one, code 0) stages its vertices in shared memory when they fit
// (K18_SMEM_VERTS); a column's geometries are read through the
// read-only path (__ldg), each row its own geometry's rings.  The bbox
// test runs first and ends the row when it fails (the result is the
// bbox mask AND the ring test, so the ring test of such a row is never
// needed).  The ring test is the reference's even-odd rule bit for
// bit: for every edge (v[i], v[(i + 1) % nv]) of every ring, the
// closing vertex kept as parsed and the wrap edge added as jnp.roll
// does, an edge with (vy > y) != (vy2 > y) gives t = (y - vy) /
// (vy2 - vy) and xint = vx + t * (vx2 - vx), and counts a crossing
// where xint > x; the parities of all rings XOR (holes and every part
// of a MULTIPOLYGON alike).  Every double operation is an _rn
// intrinsic, so nvcc contracts nothing into a fused multiply-add: the
// reference rounds each step, and a point on an edge flips with one
// ulp.  A POINT geometry is the equality test; a value that did not
// parse (kind -1) or a code out of range gives ok = 0 (a NULL row).

#include "common.cuh"

#define K18_SMEM_VERTS 2048

struct K18 {
  i64 n;
  const double* x;
  const double* y;
  const void* code;  // nullptr: geometry 0 for every row
  int code_kind;     // 1 int32, 2 int64
  i64 n_geoms;
  const int* gkind;
  const double* bbox;
  const i64* ring_lo;
  const i64* vert_lo;
  const double* vx;
  const double* vy;
  uint8_t* hit;
  uint8_t* ok;
};

template <bool SMEM>
static __global__ void k18_contains(K18 g) {
  extern __shared__ double sv[];  // SMEM: geometry 0's vx, then its vy
  const double* VX = g.vx;
  const double* VY = g.vy;
  if (SMEM) {
    const i64 nv = g.vert_lo[g.ring_lo[1]];
    for (i64 i = threadIdx.x; i < nv; i += blockDim.x) {
      sv[i] = g.vx[i];
      sv[nv + i] = g.vy[i];
    }
    __syncthreads();
    VX = sv;
    VY = sv + nv;
  }
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 r = (i64)blockIdx.x * blockDim.x + threadIdx.x; r < g.n; r += stride) {
    i64 gi = 0;
    if (g.code != nullptr)
      gi = g.code_kind == 1 ? (i64)((const int*)g.code)[r] : ((const i64*)g.code)[r];
    const bool okg = gi >= 0 && gi < g.n_geoms && __ldg(g.gkind + gi) >= 0;
    g.ok[r] = okg;
    if (!okg) {
      g.hit[r] = 0;
      continue;
    }
    const double px = g.x[r], py = g.y[r];
    const double* bb = g.bbox + 4 * gi;
    if (!(px >= __ldg(bb) && px <= __ldg(bb + 2) && py >= __ldg(bb + 1) &&
          py <= __ldg(bb + 3))) {
      g.hit[r] = 0;
      continue;
    }
    const i64 r0 = __ldg(g.ring_lo + gi), r1 = __ldg(g.ring_lo + gi + 1);
    if (__ldg(g.gkind + gi) == 0) {  // a POINT: the equality test
      const i64 v = __ldg(g.vert_lo + r0);
      g.hit[r] = px == (SMEM ? VX[v] : __ldg(VX + v)) && py == (SMEM ? VY[v] : __ldg(VY + v));
      continue;
    }
    unsigned inside = 0;
    for (i64 ring = r0; ring < r1; ++ring) {
      const i64 lo = __ldg(g.vert_lo + ring), hi = __ldg(g.vert_lo + ring + 1);
      if (hi <= lo) continue;
      double ax = SMEM ? VX[lo] : __ldg(VX + lo), ay = SMEM ? VY[lo] : __ldg(VY + lo);
      const double fx = ax, fy = ay;
      for (i64 i = lo; i < hi; ++i) {
        double bx, by;
        if (i + 1 < hi) {
          bx = SMEM ? VX[i + 1] : __ldg(VX + i + 1);
          by = SMEM ? VY[i + 1] : __ldg(VY + i + 1);
        } else {  // the wrap edge back to the first vertex
          bx = fx;
          by = fy;
        }
        if ((ay > py) != (by > py)) {
          const double denom = __dsub_rn(by, ay);
          const double t = __ddiv_rn(__dsub_rn(py, ay), denom == 0.0 ? 1.0 : denom);
          const double xint = __dadd_rn(ax, __dmul_rn(t, __dsub_rn(bx, ax)));
          inside ^= xint > px ? 1u : 0u;
        }
        ax = bx;
        ay = by;
      }
    }
    g.hit[r] = (uint8_t)inside;
  }
}

// code: nullptr for a literal (geometry 0); code_kind 1 int32, 2 int64.
extern "C" int k18_geo_contains(i64 n, const double* x, const double* y, const void* code,
                                int code_kind, i64 n_geoms, const int* gkind,
                                const double* bbox, const i64* ring_lo, const i64* vert_lo,
                                const double* vx, const double* vy, i64 smem_verts,
                                uint8_t* hit, uint8_t* ok, void* stream) {
  if (n_geoms < 1 || (code != nullptr && code_kind != 1 && code_kind != 2))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  K18 g;
  g.n = n;
  g.x = x;
  g.y = y;
  g.code = code;
  g.code_kind = code_kind;
  g.n_geoms = n_geoms;
  g.gkind = gkind;
  g.bbox = bbox;
  g.ring_lo = ring_lo;
  g.vert_lo = vert_lo;
  g.vx = vx;
  g.vy = vy;
  g.hit = hit;
  g.ok = ok;
  cudaStream_t s = (cudaStream_t)stream;
  const int grid = grid_for(n, 256, 8);
  if (code == nullptr && smem_verts > 0 && smem_verts <= K18_SMEM_VERTS)
    k18_contains<true><<<grid, 256, 2 * smem_verts * sizeof(double), s>>>(g);
  else
    k18_contains<false><<<grid, 256, 0, s>>>(g);
  return (int)cudaGetLastError();
}
