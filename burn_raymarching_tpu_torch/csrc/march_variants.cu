// K5: the march micro-variant kernel: a dense detached march + reattach point
// + 6-tap normals with three arithmetic switches, for the variant sweep of
// tools/exp_march_variants.py.
//
// Replaces the TPU kernel scripts/exp_march_variants.py (variant_march ->
// _kernel, soft-min _soft_min_rows). Per ray: num_steps iterations
// t <- min(t + softmin_k(ro + rd t), 1e4) from t0, one more soft-min giving
// p_final = ro + rd (t + d), then 6-tap central-difference normals at
// eps = 1e-4 with +1e-6 inside the length's sqrt. Per (point, slot) pair
// val = sqrt(q) (-k) + k r, with the switches (template flags, all eight
// combinations instantiated):
//   COORD  q = max((dx^2 + dy^2) + dz^2, 1e-6) from the centers (masked slots
//          carry far centers); otherwise the expanded
//          q = max((|p|^2 + c_sq) - 2 p.c, 1e-6) with the K = 3 dot as FMAs
//          (masked slots carry c_sq = 1e30);
//   CLAMP  val = min(val, 80) and no max: s = sum exp(val), out = log(max(s,
//          1e-8)) / (-k). A ray far from every slot underflows s to 0 and
//          steps by the floor's log(1e-8) / (-k): that is the function the
//          TPU kernel computes, and it is kept;
//          otherwise out = (log(max(sum exp(val - mx), 1e-8)) + mx) / (-k),
//          mx the row max, taken here in one pass (online soft-min, as
//          common.cuh's march core): a running max and a sum relative to it,
//          merged over the ray's lanes by butterflies. It differs from the
//          two-pass form by float32 rounding only;
//   EXP2   exp2f(x log2 e) and log2f(x) ln 2 in place of expf(x) and logf(x).
// Every transcendental is the full-precision library function (sqrtf, expf,
// exp2f, logf, log2f), not the SFU's approximate forms of common.cuh's
// pair_exp / pair_sqrt: how much those forms gain is what the sweep reads
// against K1.
//
// Block shape: a block marches tile_n consecutive rays (the TPU kernel's
// grid step; the TPU grid n // tile_n drops a remainder, the wrapper raises
// on one). MV_LANES = 8 lanes per ray (K1's lane count at M = 128) stride
// over the slots; a block holds min(tile_n, 128) lane groups (at most 1,024
// threads, rounded up to whole warps), and a group marches rays group,
// group + groups, ... of the tile in turn, so tile_n = 64 is 512 threads
// marching one ray a group, 128 is 1,024 threads, 1,024 is 1,024 threads
// marching 8 rays a group one after another. Groups past the tile's last
// ray march a copy of it and store nothing (warp shuffles stay uniform).
// The [4, M] table and c_sq are staged once per block into shared memory
// as float4 (cx, cy, cz, c_sq) plus k r (20 bytes a slot, M <= 2,457).
//
// What bounds it: not bytes (a ray is 7 floats in and 4 out, the table a few
// KB). The work is rays x slots x (num_steps + 7) pairs, each a sqrt and an
// exp with ~12-20 FP32 operations around them; the full-precision sqrtf and
// expf are several instructions each, so the FP32 issue rate binds before
// the SFU. Tiles of 1,024 rays and more leave most of the 132 SMs idle at
// 16,384 rays (16 blocks or fewer): the sweep shows what that costs.
#include "common.cuh"

#define MV_LANES 8
#define MV_MAX_THREADS 1024
#define MV_MAX_SMEM 49152
#define MV_LOG2E 1.4426950408889634f
#define MV_LN2 0.6931471805599453f

template <bool EXP2>
__device__ __forceinline__ float mv_exp(float x) {
  return EXP2 ? exp2f(x * MV_LOG2E) : expf(x);
}

template <bool EXP2>
__device__ __forceinline__ float mv_log(float x) {
  return EXP2 ? log2f(x) * MV_LN2 : logf(x);
}

// Soft-min of one point against the staged table, by the MV_LANES lanes of
// a group (lane g takes slots g, g + MV_LANES, ...); every lane of the
// group returns the same value.
template <bool CLAMP, bool EXP2, bool COORD>
__device__ __forceinline__ float mv_softmin(const float4* __restrict__ cq,
                                            const float* __restrict__ kr,
                                            int m, int g, float px, float py,
                                            float pz, float k) {
  const float psq = sq_norm3(px, py, pz);
  float mx = -INFINITY, s = 0.0f;
  for (int j = g; j < m; j += MV_LANES) {
    const float4 c = cq[j];
    float q;
    if (COORD) {
      const float dx = px - c.x, dy = py - c.y, dz = pz - c.z;
      q = fmaxf((dx * dx + dy * dy) + dz * dz, 1e-6f);
    } else {
      q = fmaxf((psq + c.w) - 2.0f * fmaf(px, c.x, fmaf(py, c.y, pz * c.z)),
                1e-6f);
    }
    const float v = sqrtf(q) * (-k) + kr[j];
    if (CLAMP) {
      s += mv_exp<EXP2>(fminf(v, 80.0f));
    } else {
      // Running max mx and s = sum exp(v_i - mx): a slot that raises the
      // max rescales s by exp(mx_old - v) and adds 1.
      const float d = v - mx;
      const float e = mv_exp<EXP2>(-fabsf(d));
      s = d > 0.0f ? fmaf(s, e, 1.0f) : s + e;
      mx = fmaxf(mx, v);
    }
  }
  if (CLAMP) {
    const float sum = group_sum<MV_LANES>(s);
    return mv_log<EXP2>(fmaxf(sum, 1e-8f)) / (-k);
  }
  const float gmx = group_max<MV_LANES>(mx);
  // A lane that saw no slot holds (-inf, 0) and adds 0 * exp(-inf) = 0.
  const float sum = group_sum<MV_LANES>(s * mv_exp<EXP2>(mx - gmx));
  return (mv_log<EXP2>(fmaxf(sum, 1e-8f)) + gmx) / (-k);
}

template <bool CLAMP, bool EXP2, bool COORD>
__global__ void __launch_bounds__(MV_MAX_THREADS)
march_variants_kernel(const float* __restrict__ ro,
                      const float* __restrict__ rd,
                      const float* __restrict__ t0,
                      const float* __restrict__ prim,
                      const float* __restrict__ c_sq,
                      const float* __restrict__ kp, int m, int tile_n,
                      int num_steps, float eps, float* __restrict__ t_out,
                      float* __restrict__ n_out) {
  extern __shared__ float4 smem[];
  float4* cq = smem;
  float* kr = reinterpret_cast<float*>(smem + m);
  const float k = __ldg(kp);
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    cq[j] = make_float4(prim[j], prim[m + j], prim[2 * m + j], c_sq[j]);
    kr[j] = prim[3 * m + j] * k;
  }
  __syncthreads();

  const int groups = blockDim.x / MV_LANES;
  const int group = threadIdx.x / MV_LANES;
  const int g = threadIdx.x % MV_LANES;
  const size_t first = (size_t)blockIdx.x * tile_n;
  for (int r0 = 0; r0 < tile_n; r0 += groups) {
    const int r = r0 + group;
    const bool store = r < tile_n;
    const size_t ray = first + (size_t)(store ? r : tile_n - 1);
    const float ox = ro[3 * ray], oy = ro[3 * ray + 1], oz = ro[3 * ray + 2];
    const float dx = rd[3 * ray], dy = rd[3 * ray + 1], dz = rd[3 * ray + 2];
    float t = t0[ray];
    for (int it = 0; it < num_steps; ++it) {
      const float d = mv_softmin<CLAMP, EXP2, COORD>(
          cq, kr, m, g, ox + dx * t, oy + dy * t, oz + dz * t, k);
      t = fminf(t + d, MARCH_T_MAX);
    }
    const float d_last = mv_softmin<CLAMP, EXP2, COORD>(
        cq, kr, m, g, ox + dx * t, oy + dy * t, oz + dz * t, k);
    const float tf = t + d_last;
    const float fx = ox + dx * tf, fy = oy + dy * tf, fz = oz + dz * tf;
    float nrm[3];
#pragma unroll
    for (int axis = 0; axis < 3; ++axis) {
      float tap[2];
#pragma unroll
      for (int sign = 0; sign < 2; ++sign) {
        const float h = sign == 0 ? eps : -eps;
        tap[sign] = mv_softmin<CLAMP, EXP2, COORD>(
            cq, kr, m, g, axis == 0 ? fx + h : fx, axis == 1 ? fy + h : fy,
            axis == 2 ? fz + h : fz, k);
      }
      nrm[axis] = tap[0] - tap[1];
    }
    if (store && g == 0) {
      const float len = sqrtf(sq_norm3(nrm[0], nrm[1], nrm[2]) + 1e-6f);
      t_out[ray] = t;
      n_out[3 * ray] = nrm[0] / len;
      n_out[3 * ray + 1] = nrm[1] / len;
      n_out[3 * ray + 2] = nrm[2] / len;
    }
  }
}

template <bool CLAMP, bool EXP2, bool COORD>
static int launch_variant(const float* ro, const float* rd, const float* t0,
                          const float* prim, const float* c_sq,
                          const float* k, int n, int m, int tile_n,
                          int num_steps, float eps, float* t_out,
                          float* n_out, cudaStream_t stream) {
  const int groups = tile_n < MV_MAX_THREADS / MV_LANES
                         ? tile_n
                         : MV_MAX_THREADS / MV_LANES;
  const int threads = (groups * MV_LANES + 31) / 32 * 32;
  const size_t smem = (size_t)m * (sizeof(float4) + sizeof(float));
  march_variants_kernel<CLAMP, EXP2, COORD>
      <<<n / tile_n, threads, smem, stream>>>(ro, rd, t0, prim, c_sq, k, m,
                                              tile_n, num_steps, eps, t_out,
                                              n_out);
  return (int)cudaGetLastError();
}

// ro, rd [n,3]; t0 [n]; prim [4,m] rows (cx, cy, cz, r); c_sq [m]; k [1] the
// soft-min sharpness in device memory, read when the kernel runs. tile_n
// must divide n. Writes t_out [n], n_out [n,3]. Returns a CUDA error code.
extern "C" int march_variants_launch(const float* ro, const float* rd,
                                     const float* t0, const float* prim,
                                     const float* c_sq, const float* k, int n,
                                     int m, int tile_n, int num_steps,
                                     float eps, int clamp, int exp2,
                                     int coord, float* t_out, float* n_out,
                                     void* stream) {
  if (n < 1 || m < 1 || tile_n < 1 || n % tile_n != 0 || num_steps < 0 ||
      (size_t)m * (sizeof(float4) + sizeof(float)) > MV_MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
#define MV_CASE(C, E, X)                                                     \
  case (C) * 4 + (E) * 2 + (X):                                              \
    return launch_variant<C, E, X>(ro, rd, t0, prim, c_sq, k, n, m, tile_n,  \
                                   num_steps, eps, t_out, n_out, s)
  switch ((clamp != 0) * 4 + (exp2 != 0) * 2 + (coord != 0)) {
    MV_CASE(false, false, false);
    MV_CASE(false, false, true);
    MV_CASE(false, true, false);
    MV_CASE(false, true, true);
    MV_CASE(true, false, false);
    MV_CASE(true, false, true);
    MV_CASE(true, true, false);
    MV_CASE(true, true, true);
  }
#undef MV_CASE
  return (int)cudaErrorInvalidValue;
}
