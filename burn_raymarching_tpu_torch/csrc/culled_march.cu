// K3: per-tile detached culled march + reattach point + 6-tap normals.
//
// Replaces the TPU kernel burn_raymarching_tpu/ops/pallas/culled_march_kernel.py
// (culled_march_normals_pallas -> _culled_march_kernel, soft-min
// _soft_min_rows). Ray tile b of T rays marches against its own top-K table
// prim[b] = [K, 5] rows (cx, cy, cz, |c|^2, r), 1e30 in the |c|^2 of invalid
// slots (their distances are ~1e15 and their exp terms exactly 0). Per ray:
// num_steps iterations t <- min(t + softmin_k(ro + rd t), 1e4) from 0 or
// from t_init, one more soft-min giving p_final = ro + rd (t + d), then
// central-difference normals with +1e-6 inside the sqrt. The op order is
// render/culled._tile_dists + _tile_soft_min's, not K1's k*r fold:
// d = sqrt(max(|p|^2 + |c|^2 - 2 p.c, 1e-6)) - r, then val = d * (-k).
//
// What bounds it: the SFU and the issue rate, not bytes (common.cuh). A
// launch does rays x live columns x (num_steps + 7) pairs, one sqrt and one
// exp each: config 4's 16,384 rays x 2,048 slots x 23 (warm) are 0.77 G
// pairs, >= 0.37 ms on the SFU if every slot were live. Design, all in
// common.cuh's march core:
// (a) a warp marches CM_RAYS rays of one tile at once, held in registers:
//     each lane loads a column once (one 128-bit + one 32-bit shared load)
//     and applies it to all of them, so shared-memory traffic per pair
//     falls by CM_RAYS and the rays' serial chains overlap. Measured on
//     an H100 with CM_RAYS set to each value: 2 rays per warp at 58
//     registers beat 1, 3 and 4 (80 registers) by 4-8%, and 8 (128
//     registers) is 1.6x slower, so occupancy counts for more than the
//     shared-memory traffic saved;
// (b) one pass per evaluation (online soft-min): one sqrt and one exp per
//     pair, where two passes took two sqrt;
// (c) only the leading columns up to the last valid slot are staged and
//     visited (march_columns): selection puts a tile's valid slots first
//     and most tiles fill a fraction of the budget. A tile with no valid
//     slot (~45% of config 4's tiles in the prefill, and of the step's
//     uniformly drawn ones) visits its first column alone, which gives the
//     bits of all K masked columns: t reaches MARCH_T_MAX on the first
//     step, and the six normal evaluations read one value (normal 0);
// (d) a block holds CM_WARPS x CM_RAYS = 16 rays of one tile, so config 4's
//     32 tiles x 512 rays make 1,024 blocks over the 132 SMs; it stages its
//     tile's table once (K = 2,048: 40 KB; up to CM_CHUNK = 4,096 columns,
//     80 KB, opted in past 48 KB); above CM_CHUNK live columns the table is
//     staged chunk by chunk per evaluation, so there is no K cap.
#include "common.cuh"

#define CM_WARPS 8
#define CM_RAYS 2
#define CM_CHUNK 4096

// The soft-min sharpness of the launch, copied here from device memory on
// the launch's stream (culled_march_launch), so that the kernel reads it as
// it read a launch parameter: from the constant bank. Read through a
// pointer into a register it cost K3 4-5% on an H100 (bench_kernels, K3
// warm 0.195 -> 0.204 ms at config 4's shape), the copy less than the noise.
// The symbol is shared by every launch of the process: launches that
// overlap on two streams must carry the same k (the port launches on one).
__constant__ float c_k;

__global__ void __launch_bounds__(CM_WARPS * 32)
culled_march_kernel(const float* __restrict__ ro, const float* __restrict__ rd,
                    const float* __restrict__ t0,
                    const float* __restrict__ prim, int t_dim, int kk,
                    int num_steps, float normal_eps,
                    float* __restrict__ t_out, float* __restrict__ n_out) {
  const float k = c_k;
  extern __shared__ float4 smem[];  // float4 cq[cap], then float rr[cap]
  __shared__ int n_live;
  MarchTable tab;
  tab.g = prim + (size_t)blockIdx.y * 5 * kk;
  tab.cap = min(kk, CM_CHUNK);
  tab.cq = smem;
  tab.rr = reinterpret_cast<float*>(smem + tab.cap);
  tab.n = march_columns(tab, kk, &n_live);
  tab.resident = tab.n <= tab.cap;
  if (tab.resident) tab.stage(0, tab.n);

  const int lane = threadIdx.x & 31;
  const int first = (blockIdx.x * CM_WARPS + (threadIdx.x >> 5)) * CM_RAYS;
  size_t ray[CM_RAYS];
  bool store[CM_RAYS];
#pragma unroll
  for (int i = 0; i < CM_RAYS; ++i) {
    // Rays past the tile's end march a copy of its last ray and store
    // nothing, so block barriers stay uniform.
    store[i] = first + i < t_dim;
    ray[i] = (size_t)blockIdx.y * t_dim + min(first + i, t_dim - 1);
  }
  march_rays<32, CM_RAYS, false>(tab, lane, ro, rd, t0, ray, store, k,
                                 num_steps, normal_eps, t_out, n_out);
}

// ro, rd [b, t_dim, 3]; t0 [b, t_dim] or null; prim [b, kk, 5]; k [1] the
// soft-min sharpness in device memory, copied to c_k on the stream before
// the kernel runs (the TPU kernel's SMEM operand; a captured launch copies
// it again at every replay). Writes t_out [b, t_dim] and n_out
// [b, t_dim, 3]. Returns a CUDA error code.
extern "C" int culled_march_launch(const float* ro, const float* rd,
                                   const float* t0, const float* prim, int b,
                                   int t_dim, int kk, const float* k,
                                   int num_steps, float normal_eps, float* t_out,
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
  const cudaError_t err =
      cudaMemcpyToSymbolAsync(c_k, k, sizeof(float), 0,
                              cudaMemcpyDeviceToDevice, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  const int per_block = CM_WARPS * CM_RAYS;
  const dim3 grid((t_dim + per_block - 1) / per_block, b);
  culled_march_kernel<<<grid, CM_WARPS * 32, smem, (cudaStream_t)stream>>>(
      ro, rd, t0, prim, t_dim, kk, num_steps, normal_eps, t_out, n_out);
  return (int)cudaGetLastError();
}
