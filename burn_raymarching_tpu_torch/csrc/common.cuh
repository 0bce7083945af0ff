// Shared device helpers for the hand-written Hopper kernels.
//
// Numerics follow the JAX package (burn_raymarching_tpu/ops/sdf.py): fp32
// throughout, the expanded distance form max(|p|^2 + |c|^2 - 2 p.c, 1e-6)
// with the K=3 dot product written as FMAs (no tensor cores: TF32 would
// corrupt the distance field), full-precision sqrtf/expf/logf (the build
// passes no --use_fast_math), and 1e30 in the |c|^2 slot of masked
// primitives so their distances are ~1e15 and their exp terms exactly 0.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define FULL_MASK 0xffffffffu

__device__ __forceinline__ float warp_max(float v) {
  // xor butterfly: every lane ends with the same value (max is exact).
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL_MASK, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  // xor butterfly: both partners add the same pair (fp add commutes), so
  // every lane ends with the bitwise-same sum in a fixed order.
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
  return v;
}

// |p|^2 summed in the JAX reduction order ((x^2 + y^2) + z^2).
__device__ __forceinline__ float sq_norm3(float x, float y, float z) {
  return (x * x + y * y) + z * z;
}

// Squared point-center distance via the expanded form; returns the raw q
// (before the 1e-6 clamp) so backward passes can test q > 1e-6.
__device__ __forceinline__ float expanded_q(float px, float py, float pz,
                                            float psq, float cx, float cy,
                                            float cz, float csq) {
  const float pdc = fmaf(px, cx, fmaf(py, cy, pz * cz));
  return (psq + csq) - 2.0f * pdc;
}

// Copies columns [c0, c0 + len) of a row-major [5, m] table (rows cx, cy, cz,
// r, |c|^2) into a [5, cap] shared-memory array. Every thread of the block
// must call it: it synchronises before and after the copy.
__device__ __forceinline__ void stage_table(const float* __restrict__ prim,
                                            int m, int c0, int len,
                                            float* tab, int cap) {
  __syncthreads();
  for (int i = threadIdx.x; i < 5 * len; i += blockDim.x) {
    const int row = i / len;
    const int col = i - row * len;
    tab[row * cap + col] = prim[row * m + c0 + col];
  }
  __syncthreads();
}

// Soft-min of one point per warp against a [5, m] table:
// (log(max(sum exp(val - mx), 1e-8)) + mx) / (-k), with mx the exact row max
// (first pass) and the sum in a second pass, because dropping the max
// underflows far rays. ``val(tab, cap, j)`` gives the logit of column j of
// the staged [5, cap] shared table. The lanes stride over the columns and
// both reductions are xor butterflies, so every lane returns the same value.
// With ``resident`` the whole table is already staged; otherwise it is staged
// chunk by chunk, so every thread of the block must make the same calls.
template <class Val>
__device__ __forceinline__ float softmin_two_pass(const Val& val,
                                                  const float* __restrict__ prim,
                                                  int m, float* tab, int cap,
                                                  bool resident, int lane,
                                                  float k) {
  float mx = -INFINITY;
  for (int c0 = 0; c0 < m; c0 += cap) {
    const int len = min(cap, m - c0);
    if (!resident) stage_table(prim, m, c0, len, tab, cap);
    for (int j = lane; j < len; j += 32) mx = fmaxf(mx, val(tab, cap, j));
  }
  mx = warp_max(mx);
  float s = 0.0f;
  for (int c0 = 0; c0 < m; c0 += cap) {
    const int len = min(cap, m - c0);
    if (!resident) stage_table(prim, m, c0, len, tab, cap);
    for (int j = lane; j < len; j += 32) s += expf(val(tab, cap, j) - mx);
  }
  s = warp_sum(s);
  return (logf(fmaxf(s, 1e-8f)) + mx) / (-k);
}
