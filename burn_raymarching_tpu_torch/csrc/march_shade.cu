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

// The block shape, the lane rule (pick_lanes) and the kernel body
// (dense_march) are common.cuh's, shared with K5.
template <int L, bool EXIT>
__global__ void __launch_bounds__(MS_WARPS * 32)
march_shade_kernel(const float* __restrict__ ro, const float* __restrict__ rd,
                   const float* __restrict__ t0,
                   const float* __restrict__ prim, int n, int m,
                   const float* __restrict__ kp, int num_steps,
                   float normal_eps, float* __restrict__ t_out,
                   float* __restrict__ n_out) {
  MarchTable tab;
  tab.g = prim;
  dense_march<L, EXIT>(tab, m, ro, rd, t0, n, __ldg(kp), num_steps,
                       normal_eps, t_out, n_out);
}

template <int L, bool EXIT>
static int launch_lanes(const float* ro, const float* rd, const float* t0,
                        const float* prim, int n, int m, const float* k,
                        int num_steps, float normal_eps, float* t_out,
                        float* n_out, cudaStream_t stream) {
  march_shade_kernel<L, EXIT><<<dense_blocks(n, L), MS_WARPS * 32, 0,
                                stream>>>(ro, rd, t0, prim, n, m, k,
                                          num_steps, normal_eps, t_out,
                                          n_out);
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
