// K1: fused detached march + reattach point + 6-tap normals.
//
// Replaces the TPU kernel burn_raymarching_tpu/ops/pallas/march_shade_kernel.py
// (march_shade_pallas -> _march_shade_kernel, soft-min _soft_min_rows).
// Per ray: num_steps sphere-tracing iterations t <- min(t + softmin_k(ro+rd t),
// 1e4) (from 0, or from t_init), one more soft-min giving
// p_final = ro + rd (t + d), then 6-tap central-difference normals with
// +1e-6 inside the sqrt. Outputs t [N] and normal [N,3]; nothing here carries
// a gradient.
//
// What bounds it: not bytes. It reads 6 floats and writes 4 per ray, and the
// table is a few KB. Each of the 47 serial soft-min evaluations per ray does
// one sqrtf and one expf per primitive on the SFU, plus a max and a sum
// reduction, and evaluation i+1 needs t from evaluation i. So the design
// (a) spreads one ray's M primitives over the 32 lanes of a warp, so each
// serial evaluation costs ceil(M/32) slots per lane and two 5-step shuffle
// reductions instead of M serial slots; (b) keeps the [5, M] table
// (cx, cy, cz, r, |c|^2) in shared memory, staged once per block when
// M <= MS_CHUNK and chunk by chunk otherwise, so there is no M cap: the TPU
// kernel's M <= 32768 cap was a VMEM limit and does not apply here;
// (c) subtracts the row max exactly as _soft_min_rows does (two passes per
// evaluation), because dropping it underflows far rays.
// Like _soft_min_rows it folds k*r: val = sqrt(q)*(-k) + r*k.
// The per-tile early exit of the TPU kernel is not implemented.
#include "common.cuh"

#define MS_WARPS 8
#define MS_CHUNK 1024
#define MS_T_MAX 1e4f

// Logit of column j for K1: the k*r fold of _soft_min_rows.
struct FoldVal {
  float px, py, pz, psq, k;
  __device__ __forceinline__ float operator()(const float* tab, int cap,
                                              int j) const {
    const float q = fmaxf(expanded_q(px, py, pz, psq, tab[j], tab[cap + j],
                                     tab[2 * cap + j], tab[4 * cap + j]),
                          1e-6f);
    return sqrtf(q) * (-k) + tab[3 * cap + j] * k;
  }
};

// Soft-min of one point per warp against the whole table. Block-uniform
// control flow: every thread of the block calls it the same number of times.
__device__ float softmin_point(float px, float py, float pz,
                               const float* __restrict__ prim, int m, float k,
                               float* tab, bool resident, int lane) {
  const FoldVal val{px, py, pz, sq_norm3(px, py, pz), k};
  return softmin_two_pass(val, prim, m, tab, MS_CHUNK, resident, lane, k);
}

__global__ void __launch_bounds__(MS_WARPS * 32)
march_shade_kernel(const float* __restrict__ ro, const float* __restrict__ rd,
                   const float* __restrict__ t0,
                   const float* __restrict__ prim, int n, int m, float k,
                   int num_steps, float normal_eps, float* __restrict__ t_out,
                   float* __restrict__ n_out) {
  __shared__ float tab[5 * MS_CHUNK];
  const int lane = threadIdx.x & 31;
  const int ray = blockIdx.x * MS_WARPS + (threadIdx.x >> 5);
  // Tail warps march a copy of the last ray so block barriers stay uniform;
  // they store nothing.
  const int r = min(ray, n - 1);
  const bool resident = m <= MS_CHUNK;
  if (resident) stage_table(prim, m, 0, m, tab, MS_CHUNK);

  const float ox = ro[3 * r], oy = ro[3 * r + 1], oz = ro[3 * r + 2];
  const float dx = rd[3 * r], dy = rd[3 * r + 1], dz = rd[3 * r + 2];
  float t = t0 != nullptr ? t0[r] : 0.0f;
  for (int i = 0; i < num_steps; ++i) {
    const float sm = softmin_point(ox + dx * t, oy + dy * t, oz + dz * t,
                                   prim, m, k, tab, resident, lane);
    t = fminf(t + sm, MS_T_MAX);
  }

  // Detached reattach point -> p_final.
  const float dl = softmin_point(ox + dx * t, oy + dy * t, oz + dz * t, prim,
                                 m, k, tab, resident, lane);
  const float tf = t + dl;
  const float px = ox + dx * tf, py = oy + dy * tf, pz = oz + dz * tf;

  const float e = normal_eps;
  const float nx = softmin_point(px + e, py, pz, prim, m, k, tab, resident, lane)
                 - softmin_point(px - e, py, pz, prim, m, k, tab, resident, lane);
  const float ny = softmin_point(px, py + e, pz, prim, m, k, tab, resident, lane)
                 - softmin_point(px, py - e, pz, prim, m, k, tab, resident, lane);
  const float nz = softmin_point(px, py, pz + e, prim, m, k, tab, resident, lane)
                 - softmin_point(px, py, pz - e, prim, m, k, tab, resident, lane);
  const float len = sqrtf(sq_norm3(nx, ny, nz) + 1e-6f);
  if (lane == 0 && ray < n) {
    t_out[ray] = t;
    n_out[3 * ray] = nx / len;
    n_out[3 * ray + 1] = ny / len;
    n_out[3 * ray + 2] = nz / len;
  }
}

// ro, rd [n,3]; t0 [n] or null; prim [5,m] rows cx, cy, cz, r, |c|^2 (1e30
// in masked slots). Writes t_out [n], n_out [n,3]. Returns cudaGetLastError().
extern "C" int march_shade_launch(const float* ro, const float* rd,
                                  const float* t0, const float* prim, int n,
                                  int m, float k, int num_steps,
                                  float normal_eps, float* t_out, float* n_out,
                                  void* stream) {
  const dim3 grid((n + MS_WARPS - 1) / MS_WARPS);
  march_shade_kernel<<<grid, MS_WARPS * 32, 0, (cudaStream_t)stream>>>(
      ro, rd, t0, prim, n, m, k, num_steps, normal_eps, t_out, n_out);
  return (int)cudaGetLastError();
}
