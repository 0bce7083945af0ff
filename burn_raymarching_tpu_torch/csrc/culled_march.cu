// K3: per-tile detached culled march + reattach point + 6-tap normals.
//
// Replaces the TPU kernel burn_raymarching_tpu/ops/pallas/culled_march_kernel.py
// (culled_march_normals_pallas -> _culled_march_kernel, soft-min
// _soft_min_rows). Ray tile b of T rays marches against its own top-K table
// prim[b] = [5, K] rows cx, cy, cz, r, |c|^2 (1e30 in invalid slots, whose
// distances are ~1e15 and whose exp terms are exactly 0). Per ray:
// num_steps iterations t <- min(t + softmin_k(ro + rd t), 1e4) from 0 or
// from t_init, one more soft-min giving p_final = ro + rd (t + d), then
// central-difference normals with +1e-6 inside the sqrt. The op order is
// render/culled._tile_dists + _tile_soft_min's, not K1's k*r fold:
// d = sqrt(max(|p|^2 + |c|^2 - 2 p.c, 1e-6)) - r, then val = d * (-k).
//
// What bounds it: as in K1, the SFU and the serial chain of 47 (cold) or 23
// (warm) soft-min evaluations per ray, each two passes over K; the rays are
// 6-7 floats each and a tile's table 20 K bytes. Design: (a) one warp per
// ray, lanes striding over K, xor-butterfly reductions (common.cuh's
// softmin_two_pass, shared with K1). A block holds 8 rays of one tile, so
// config 4's 32 tiles x 512 rays make 2,048 blocks over the 132 SMs instead
// of 32; (b) each block stages its tile's [5, K] table in shared memory once
// (K = 2,048: 40 KB; up to CM_CHUNK = 4,096 columns, 80 KB, opted in past
// 48 KB) and marches its rays against it; above CM_CHUNK the table is
// staged chunk by chunk per evaluation, so there is no K cap.
#include "common.cuh"

#define CM_WARPS 8
#define CM_CHUNK 4096
#define CM_T_MAX 1e4f

// Logit of column j for K3: distance first, then times -k.
struct DistVal {
  float px, py, pz, psq, k;
  __device__ __forceinline__ float operator()(const float* tab, int cap,
                                              int j) const {
    const float q = fmaxf(expanded_q(px, py, pz, psq, tab[j], tab[cap + j],
                                     tab[2 * cap + j], tab[4 * cap + j]),
                          1e-6f);
    return (sqrtf(q) - tab[3 * cap + j]) * (-k);
  }
};

__device__ float tile_softmin(float px, float py, float pz,
                              const float* __restrict__ prim, int kk, float k,
                              float* tab, int cap, bool resident, int lane) {
  const DistVal val{px, py, pz, sq_norm3(px, py, pz), k};
  return softmin_two_pass(val, prim, kk, tab, cap, resident, lane, k);
}

__global__ void __launch_bounds__(CM_WARPS * 32)
culled_march_kernel(const float* __restrict__ ro, const float* __restrict__ rd,
                    const float* __restrict__ t0,
                    const float* __restrict__ prim, int t_dim, int kk,
                    float k, int num_steps, float normal_eps,
                    float* __restrict__ t_out, float* __restrict__ n_out) {
  extern __shared__ float tab[];  // [5, cap]
  const int cap = min(kk, CM_CHUNK);
  const bool resident = kk <= CM_CHUNK;
  const float* tp = prim + (size_t)blockIdx.y * 5 * kk;
  const int lane = threadIdx.x & 31;
  const int ray = blockIdx.x * CM_WARPS + (threadIdx.x >> 5);
  // Tail warps march a copy of the tile's last ray so block barriers stay
  // uniform; they store nothing.
  const size_t r = (size_t)blockIdx.y * t_dim + min(ray, t_dim - 1);
  if (resident) stage_table(tp, kk, 0, kk, tab, cap);

  const float ox = ro[3 * r], oy = ro[3 * r + 1], oz = ro[3 * r + 2];
  const float dx = rd[3 * r], dy = rd[3 * r + 1], dz = rd[3 * r + 2];
  float t = t0 != nullptr ? t0[r] : 0.0f;
  for (int i = 0; i < num_steps; ++i) {
    const float sm = tile_softmin(ox + dx * t, oy + dy * t, oz + dz * t, tp,
                                  kk, k, tab, cap, resident, lane);
    t = fminf(t + sm, CM_T_MAX);
  }

  // Detached reattach point -> p_final.
  const float dl = tile_softmin(ox + dx * t, oy + dy * t, oz + dz * t, tp, kk,
                                k, tab, cap, resident, lane);
  const float tf = t + dl;
  const float px = ox + dx * tf, py = oy + dy * tf, pz = oz + dz * tf;

  const float e = normal_eps;
  const float nx =
      tile_softmin(px + e, py, pz, tp, kk, k, tab, cap, resident, lane) -
      tile_softmin(px - e, py, pz, tp, kk, k, tab, cap, resident, lane);
  const float ny =
      tile_softmin(px, py + e, pz, tp, kk, k, tab, cap, resident, lane) -
      tile_softmin(px, py - e, pz, tp, kk, k, tab, cap, resident, lane);
  const float nz =
      tile_softmin(px, py, pz + e, tp, kk, k, tab, cap, resident, lane) -
      tile_softmin(px, py, pz - e, tp, kk, k, tab, cap, resident, lane);
  const float len = sqrtf(sq_norm3(nx, ny, nz) + 1e-6f);
  if (lane == 0 && ray < t_dim) {
    t_out[r] = t;
    n_out[3 * r] = nx / len;
    n_out[3 * r + 1] = ny / len;
    n_out[3 * r + 2] = nz / len;
  }
}

// ro, rd [b, t_dim, 3]; t0 [b, t_dim] or null; prim [b, 5, kk]. Writes
// t_out [b, t_dim] and n_out [b, t_dim, 3]. Returns a CUDA error code.
extern "C" int culled_march_launch(const float* ro, const float* rd,
                                   const float* t0, const float* prim, int b,
                                   int t_dim, int kk, float k, int num_steps,
                                   float normal_eps, float* t_out,
                                   float* n_out, void* stream) {
  if (b < 1 || t_dim < 1 || kk < 1 || b > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)5 * min(kk, CM_CHUNK) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        culled_march_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((t_dim + CM_WARPS - 1) / CM_WARPS, b);
  culled_march_kernel<<<grid, CM_WARPS * 32, smem, (cudaStream_t)stream>>>(
      ro, rd, t0, prim, t_dim, kk, k, num_steps, normal_eps, t_out, n_out);
  return (int)cudaGetLastError();
}
