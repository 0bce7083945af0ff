// K1: fused detached march + reattach point + 6-tap normals, and the small
// kernel that packs its primitive table.
//
// Replaces the TPU kernel burn_raymarching_tpu/ops/pallas/march_shade_kernel.py
// (march_shade_pallas -> _march_shade_kernel, soft-min _soft_min_rows).
// Per ray: num_steps sphere-tracing iterations t <- min(t + softmin_k(ro+rd t),
// 1e4) (from 0, or from t_init), one more soft-min giving
// p_final = ro + rd (t + d), then 6-tap central-difference normals with
// +1e-6 inside the sqrt. Outputs t [N] and normal [N,3]; nothing here carries
// a gradient. Like _soft_min_rows it folds k*r: val = sqrt(q)*(-k) + r*k.
//
// What bounds it: not bytes. It reads 6 floats and writes 4 per ray, and the
// table is a few KB. The work is rays x live slots x (num_steps + 7) pairs,
// one sqrt and one exp each on the SFU (common.cuh): 16,384 rays x 128 slots
// x 47 are 0.099 G pairs, >= 0.05 ms. At config 1's widths (8 to 128 slots)
// the time is the serial chain of 47 evaluations per ray, each ending in
// shuffle reductions, more than throughput. Design, on common.cuh's march
// core:
// (a) L lanes per ray, chosen by the launcher from M and N (pick_lanes):
//     32/L rays per warp, log2(L)-step butterflies, none at L = 1. At M = 8
//     no lane idles; at M = 128 a lane walks 16 columns between butterflies
//     instead of 4, and the grid still fills the 132 SMs;
// (b) MS_RAYS rays per lane group in registers share each column load, and
//     their serial chains overlap;
// (c) one pass per evaluation (online soft-min): one sqrt and one exp per
//     pair, with the running max subtracted before every exp;
// (d) the [M, 5] table is staged once per block as float4 + float when its
//     live columns fit MS_CHUNK, and chunk by chunk otherwise, so there is
//     no M cap: the TPU kernel's M <= 32768 cap was a VMEM limit.
// (e) the TPU kernel's optional early exit (its while_loop over a 1,024-ray
//     tile) is the EXIT template flag of the march core: the voting set is
//     the warp, or the block for a chunked table. Converged rays stop up to
//     num_steps * 1e-5 short of where the fixed-count march leaves them.
#include "common.cuh"

#define MS_WARPS 8
#define MS_RAYS 2
#define MS_CHUNK 1024
// pick_lanes: columns a lane should walk between butterflies, and the warps
// wanted in flight (about 2 per scheduler of 132 SMs) before lanes per ray
// stop growing.
#define MS_COLUMNS_PER_LANE 16
#define MS_TARGET_WARPS 1024

template <int L, bool EXIT>
__global__ void __launch_bounds__(MS_WARPS * 32)
march_shade_kernel(const float* __restrict__ ro, const float* __restrict__ rd,
                   const float* __restrict__ t0,
                   const float* __restrict__ prim, int n, int m,
                   const float* __restrict__ kp, int num_steps,
                   float normal_eps, float* __restrict__ t_out,
                   float* __restrict__ n_out) {
  const float k = __ldg(kp);
  __shared__ float4 cq[MS_CHUNK];
  __shared__ float rr[MS_CHUNK];
  __shared__ int n_live;
  MarchTable tab;
  tab.g = prim;
  tab.cap = MS_CHUNK;
  tab.cq = cq;
  tab.rr = rr;
  tab.n = live_columns(prim, m, &n_live);
  tab.resident = tab.n <= MS_CHUNK;
  if (tab.resident) stage_columns(tab, 0, tab.n);

  constexpr int GROUPS = 32 / L;
  const int lane = threadIdx.x & 31;
  const long long group =
      ((long long)blockIdx.x * MS_WARPS + (threadIdx.x >> 5)) * GROUPS +
      lane / L;
  size_t ray[MS_RAYS];
  bool store[MS_RAYS];
#pragma unroll
  for (int i = 0; i < MS_RAYS; ++i) {
    // Groups past the last ray march a copy of it and store nothing, so
    // block barriers and warp shuffles stay uniform.
    const long long r = group * MS_RAYS + i;
    store[i] = r < n;
    ray[i] = (size_t)(r < n ? r : n - 1);
  }
  march_rays<L, MS_RAYS, true, EXIT>(tab, lane % L, ro, rd, t0, ray, store, k,
                                     num_steps, normal_eps, t_out, n_out);
}

// Lanes per ray, a power of two: enough that a lane walks about
// MS_COLUMNS_PER_LANE columns per evaluation, more while fewer than
// MS_TARGET_WARPS warps would be in flight, never more than the slot count
// rounded up, or 32. Fewer lanes mean shorter butterflies and no idle lanes
// at small M; more lanes mean more warps when N is small. Measured at
// 16,384 rays on an H100 with each lane count forced in turn: 4 lanes are
// fastest at M = 8 and 32, 8 at M = 128, which is what this rule picks.
static int pick_lanes(int n, int m) {
  int cap = 1;
  while (cap < m && cap < 32) cap <<= 1;
  int lanes = 1;
  while (lanes < cap && lanes * MS_COLUMNS_PER_LANE < m) lanes <<= 1;
  while (lanes < cap &&
         (long long)n * lanes / (32 * MS_RAYS) < MS_TARGET_WARPS)
    lanes <<= 1;
  return lanes;
}

template <int L, bool EXIT>
static int launch_lanes(const float* ro, const float* rd, const float* t0,
                        const float* prim, int n, int m, const float* k,
                        int num_steps, float normal_eps, float* t_out,
                        float* n_out, cudaStream_t stream) {
  const long long per_block = (long long)MS_WARPS * (32 / L) * MS_RAYS;
  const dim3 grid((unsigned)((n + per_block - 1) / per_block));
  march_shade_kernel<L, EXIT><<<grid, MS_WARPS * 32, 0, stream>>>(
      ro, rd, t0, prim, n, m, k, num_steps, normal_eps, t_out, n_out);
  return (int)cudaGetLastError();
}

// ro, rd [n,3]; t0 [n] or null; prim [m,5] rows (cx, cy, cz, |c|^2, r*k) with
// 1e30 in the |c|^2 of masked slots (march_pack_launch writes it); k [1] the
// soft-min sharpness in device memory, read when the kernel runs (the TPU
// kernel's SMEM operand), so a captured launch follows its value. Writes
// t_out [n], n_out [n,3]. ``early_exit`` != 0 picks the EXIT instantiation.
// Returns a CUDA error code.
extern "C" int march_shade_launch(const float* ro, const float* rd,
                                  const float* t0, const float* prim, int n,
                                  int m, const float* k, int num_steps,
                                  float normal_eps, int early_exit,
                                  float* t_out, float* n_out, void* stream) {
  if (n < 1 || m < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
#define MS_CASE(L)                                                          \
  case L:                                                                   \
    return early_exit                                                       \
               ? launch_lanes<L, true>(ro, rd, t0, prim, n, m, k, num_steps, \
                                       normal_eps, t_out, n_out, s)         \
               : launch_lanes<L, false>(ro, rd, t0, prim, n, m, k,          \
                                        num_steps, normal_eps, t_out, n_out, \
                                        s)
  switch (pick_lanes(n, m)) {
    MS_CASE(1);
    MS_CASE(2);
    MS_CASE(4);
    MS_CASE(8);
    MS_CASE(16);
    MS_CASE(32);
  }
#undef MS_CASE
  return (int)cudaErrorInvalidValue;
}

// Packs K1's table in one launch: out [m,5] = (cx, cy, cz, |c|^2, r*k), with
// |c|^2 = (x*x + y*y) + z*z rounded after every operation (no FMA
// contraction, so it is bitwise the plain version's, march_table) and 1e30
// where ``mask`` (bytes, may be null) is 0; k [1] in device memory.
__global__ void march_pack_kernel(const float* __restrict__ centers,
                                  const float* __restrict__ radii,
                                  const unsigned char* __restrict__ mask,
                                  int m, const float* __restrict__ kp,
                                  float* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m) return;
  const float k = __ldg(kp);
  const float x = centers[3 * j], y = centers[3 * j + 1],
              z = centers[3 * j + 2];
  const float csq = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                              __fmul_rn(z, z));
  out[5 * j] = x;
  out[5 * j + 1] = y;
  out[5 * j + 2] = z;
  out[5 * j + 3] = (mask == nullptr || mask[j]) ? csq : 1e30f;
  out[5 * j + 4] = __fmul_rn(radii[j], k);
}

extern "C" int march_pack_launch(const float* centers, const float* radii,
                                 const unsigned char* mask, int m,
                                 const float* k, float* out, void* stream) {
  if (m < 1) return (int)cudaErrorInvalidValue;
  march_pack_kernel<<<(m + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      centers, radii, mask, m, k, out);
  return (int)cudaGetLastError();
}
