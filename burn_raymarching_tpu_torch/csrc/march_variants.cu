// K5: the march micro-variant kernel: K1's dense detached march + reattach
// point + 6-tap normals with three arithmetic switches, for the variant
// sweep of tools/exp_march_variants.py.
//
// Replaces the TPU kernel scripts/exp_march_variants.py (variant_march ->
// _kernel, soft-min _soft_min_rows). Per ray: num_steps iterations
// t <- min(t + softmin_k(ro + rd t), 1e4) from t0, one more soft-min giving
// p_final = ro + rd (t + d), then 6-tap central-difference normals at
// eps = 1e-4 with +1e-6 inside the length's sqrt; per (point, slot) pair
// val = sqrt(q) (-k) + k r.
//
// The TPU script's ``base`` is the shipped march kernel, so here ``base`` is
// K1's march: the whole kernel is common.cuh's dense_march, as K1's is, with
// K1's fold, the SFU forms of sqrt and exp, MS_RAYS = 2 rays a lane group,
// pick_lanes' lane count, and only the columns up to the last live slot
// visited. On the same table (K1's pack: centers, |c|^2 = c_sq, r) ``base``
// gives K1's t and normals bit for bit. The switches are the core's template
// flags (all eight combinations instantiated for every lane count; see
// softmin_points for what each computes):
//   COORD  (p - c)^2 by coordinates from the staged -2c;
//   CLAMP  exp(min(val, 80)) and no max: the function the TPU kernel
//          computes, wrong on far rays (their sum underflows to the 1e-8
//          floor), kept as it is;
//   EXP2   the TPU's base-2 transcendentals. Under the SFU forms ``base``
//          already issues ex2.approx(x log2 e), so a variant that changed
//          only the final log to log2 would time nothing. This one folds
//          log2 e into the staged scale instead (k log2 e, and r k log2 e
//          in the table): the per-pair exp loses its multiply, the per-
//          evaluation exp and log become exp2f and log2f. Its t and normals
//          differ from ``base`` by the rounding of the folded scale (the
//          tool's table 2).
//
// The table: prim [4, M] rows (cx, cy, cz, r) and c_sq [1, M] are staged
// into the core's layout, float4 (-2cx, -2cy, -2cz, c_sq) + r k. A slot is
// masked when c_sq >= 1e29 (the wrappers write 1e30), under COORD when its
// center's |c|^2 is (the script's masked centers sit at 1e15: COORD reads no
// c_sq, so the mask must come from the centers); the march stops at the
// last live column. Up to MS_CHUNK = 1,024 live columns are staged once per
// block, more chunk by chunk, so there is no slot cap.
//
// The launch shape is K1's, not the TPU tile's: 8 warps a block, a grid over
// all rays. The TPU's tile_n is a step of its sequential grid; here the
// wrapper only checks that it divides the rays (the TPU grid n // tile_n
// drops a remainder) and a ray's arithmetic does not depend on it, so every
// tile_n gives the same bits and the same time.
//
// What bounds it: K1's bound (common.cuh): not bytes, but rays x live slots
// x (num_steps + 7) pairs, one SFU sqrt and one SFU exp each, with the
// issue slots of the FP32 work around them binding first.
#include "common.cuh"

// K5's table: the global [4, m] rows (cx, cy, cz, r) and [m] c_sq, and the
// scale k (k log2 e under EXP2) that the staged r is multiplied by.
template <bool COORD>
struct VariantTable : StagedColumns {
  const float* __restrict__ prim;
  const float* __restrict__ c_sq;
  int m;
  float k;

  __device__ __forceinline__ bool live(int j) const {
    return (COORD ? sq_norm3(prim[j], prim[m + j], prim[2 * m + j])
                  : c_sq[j]) < MARCH_MASKED_CSQ;
  }

  // MarchTable::stage for K5's layout: bitwise the same staged values as
  // K1's table gives (-2c is exact, r k one rounding as in K1's pack).
  __device__ __forceinline__ void stage(int c0, int len) const {
    __syncthreads();
    for (int i = threadIdx.x; i < len; i += blockDim.x) {
      const int j = c0 + i;
      cq[i] = make_float4(-2.0f * prim[j], -2.0f * prim[m + j],
                          -2.0f * prim[2 * m + j], c_sq[j]);
      rr[i] = prim[3 * m + j] * k;
    }
    __syncthreads();
  }
};

template <int L, bool CLAMP, bool EXP2, bool COORD>
__global__ void __launch_bounds__(MS_WARPS * 32)
march_variants_kernel(const float* __restrict__ ro,
                      const float* __restrict__ rd,
                      const float* __restrict__ t0,
                      const float* __restrict__ prim,
                      const float* __restrict__ c_sq,
                      const float* __restrict__ kp, int n, int m,
                      int num_steps, float eps, float* __restrict__ t_out,
                      float* __restrict__ n_out) {
  const float k = EXP2 ? __ldg(kp) * MARCH_LOG2E : __ldg(kp);
  VariantTable<COORD> tab;
  tab.prim = prim;
  tab.c_sq = c_sq;
  tab.m = m;
  tab.k = k;
  dense_march<L, CLAMP, EXP2, COORD>(tab, m, ro, rd, t0, n, k, num_steps,
                                     eps, t_out, n_out);
}

template <bool CLAMP, bool EXP2, bool COORD>
static int launch_variant(const float* ro, const float* rd, const float* t0,
                          const float* prim, const float* c_sq,
                          const float* k, int n, int m, int num_steps,
                          float eps, float* t_out, float* n_out,
                          cudaStream_t stream) {
#define MV_CASE(L)                                                          \
  case L:                                                                   \
    march_variants_kernel<L, CLAMP, EXP2, COORD>                            \
        <<<dense_blocks(n, L), MS_WARPS * 32, 0, stream>>>(                 \
            ro, rd, t0, prim, c_sq, k, n, m, num_steps, eps, t_out, n_out); \
    break
  switch (pick_lanes(n, m)) {
    MV_CASE(1);
    MV_CASE(2);
    MV_CASE(4);
    MV_CASE(8);
    MV_CASE(16);
    MV_CASE(32);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef MV_CASE
  return (int)cudaGetLastError();
}

// ro, rd [n,3]; t0 [n]; prim [4,m] rows (cx, cy, cz, r); c_sq [m]; k [1] the
// soft-min sharpness in device memory, read when the kernel runs. Writes
// t_out [n], n_out [n,3]. Returns a CUDA error code.
extern "C" int march_variants_launch(const float* ro, const float* rd,
                                     const float* t0, const float* prim,
                                     const float* c_sq, const float* k, int n,
                                     int m, int num_steps, float eps,
                                     int clamp, int exp2, int coord,
                                     float* t_out, float* n_out,
                                     void* stream) {
  if (n < 1 || m < 1 || num_steps < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
#define MV_FLAGS(C, E, X)                                                    \
  case (C) * 4 + (E) * 2 + (X):                                              \
    return launch_variant<C, E, X>(ro, rd, t0, prim, c_sq, k, n, m,          \
                                   num_steps, eps, t_out, n_out, s)
  switch ((clamp != 0) * 4 + (exp2 != 0) * 2 + (coord != 0)) {
    MV_FLAGS(false, false, false);
    MV_FLAGS(false, false, true);
    MV_FLAGS(false, true, false);
    MV_FLAGS(false, true, true);
    MV_FLAGS(true, false, false);
    MV_FLAGS(true, false, true);
    MV_FLAGS(true, true, false);
    MV_FLAGS(true, true, true);
  }
#undef MV_FLAGS
  return (int)cudaErrorInvalidValue;
}
