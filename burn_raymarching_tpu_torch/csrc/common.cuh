// Shared device helpers for the hand-written Hopper kernels.
//
// Numerics follow the JAX package (burn_raymarching_tpu/ops/sdf.py): fp32
// throughout, the expanded distance form max(|p|^2 + |c|^2 - 2 p.c, 1e-6)
// with the K=3 dot product written as FMAs (no tensor cores: TF32 would
// corrupt the distance field), no --use_fast_math, and 1e30 in the |c|^2
// slot of masked primitives so their distances are ~1e15 and their exp terms
// exactly 0.
//
// The second half of this file is the core that the two march kernels share
// (K1 march_shade.cu, K3 culled_march.cu): a primitive table staged in shared
// memory as float4 (-2cx, -2cy, -2cz, |c|^2) plus one float (r, or r*k for
// K1), a one-pass (online) soft-min of R points per lane group against it,
// and the march + reattach + 6-tap normals of R rays per lane group.
//
// What bounds that core: not bytes (a ray is 6-7 floats in and 4 out, a
// table a few KB to 40 KB, staged once per block). Per (point, primitive)
// pair the work needs one sqrt and one exp on the SFU, 16 lanes per clock
// per SM: 132 SMs at ~1.98 GHz give ~4.2e12 per second, so a pair costs at
// least 2 / 4.2e12 s. Around them stand ~20 FP32 operations per pair, one
// issue slot each (1 per clock per scheduler), which puts the issue rate at
// about twice that time; measured, the kernels reach ~40% of the SFU bound.
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

// ---------------------------------------------------------------------------
// The march core (K1 and K3).
//
// The per-pair sqrt and exp are the SFU's own sqrt and 2^x (sqrt.approx.ftz,
// ex2.approx.ftz of x log2(e)): ~2 ulp each, below the float32 noise the
// expanded form already carries near a surface (ulp(|p|^2) ~ 1e-7 against
// q ~ 1e-3), and judged by the float64 march in chip_smoke.py; sqrtf/expf
// measured 1.6x slower on an H100 with the same gap to float64. The
// per-evaluation log, the lane rescale and the normal's sqrt are full
// precision.
#define MARCH_T_MAX 1e4f
// |c|^2 at or above this marks a masked slot (the wrappers write 1e30).
#define MARCH_MASKED_CSQ 1e29f

__device__ __forceinline__ float pair_sqrt(float q) {
  float r;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(q));  // q >= 1e-6
  return r;
}

// exp(x) for x <= 0. A denormal result is flushed to 0, which the sums
// cannot tell from it: they hold a term >= 1, and anything under 2^-24 of
// that is rounded away.
__device__ __forceinline__ float pair_exp(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x * 1.4426950408889634f));
  return r;
}

// 1 / x for x > 0 on the SFU.
__device__ __forceinline__ float pair_rcp(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// xor butterflies over the L lanes of a group (L a power of two <= 32, the
// groups aligned in the warp): every lane of the group ends with the same
// value, bitwise, in a fixed order.
template <int L>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL_MASK, v, o));
  return v;
}

template <int L>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
  return v;
}

template <int L>
__device__ __forceinline__ float group_min(float v) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(FULL_MASK, v, o));
  return v;
}

// ---------------------------------------------------------------------------
// Sums over blocks inside one launch (K2 and K4 backward, K4 forward).
//
// Blocks run in any order, so a sum over blocks is taken by whichever block
// finishes last, in an order that does not depend on which one that is:
// every block writes its part to global memory and takes an integer ticket;
// the block that draws the last ticket reads all parts back and adds them
// in index order. No float atomics, so the result is bitwise repeatable.

// Takes a ticket for the calling block after its global writes; true for
// the block that draws the last of ``count``. The counter is left at 0 for
// the next launch. Every thread of the block must call it; ``flag`` is one
// shared int.
__device__ __forceinline__ bool last_ticket(int* counter, int count,
                                            int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int last = atomicAdd(counter, 1) == count - 1;
    if (last) *counter = 0;
    *flag = last;
  }
  __syncthreads();
  const bool last = *flag != 0;
  if (last) __threadfence();
  return last;
}

// Rows added per node of sum_tree. 16 loads of 16 bytes are in flight per
// thread and level.
#define SUM_TREE_FAN 16

// dst[0, pitch) = the sum of ``cnt`` <= SUM_TREE_FAN rows of ``pitch``
// floats at src, in row order, by the calling block. A thread starts all
// its loads before its first addition.
__device__ __forceinline__ void sum_rows(const float* src, int cnt, int pitch,
                                         float* dst) {
  for (int c = threadIdx.x; c < pitch / 4; c += blockDim.x) {
    float4 v[SUM_TREE_FAN];
#pragma unroll
    for (int r = 0; r < SUM_TREE_FAN; ++r)
      if (r < cnt)
        v[r] = __ldcg(reinterpret_cast<const float4*>(src + (size_t)r * pitch) +
                      c);
    float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int r = 0; r < SUM_TREE_FAN; ++r)
      if (r < cnt) s.x += v[r].x, s.y += v[r].y, s.z += v[r].z, s.w += v[r].w;
    reinterpret_cast<float4*>(dst)[c] = s;
  }
}

// The sum of ``rows`` rows of ``pitch`` floats (a multiple of 4, the rows 16
// bytes aligned) that ``rows`` blocks wrote, one each, into ``part``, as a
// fixed tree with SUM_TREE_FAN rows per node: the block that draws the last
// ticket of a node adds the node's rows in row order into a row of the next
// level (in ``scratch``, which holds one row per node of every level), and
// goes on to that level; the root's sum goes to out [pitch]. ``row`` is the
// calling block's row. tickets: one int per node, 0 on entry and exit. Every
// thread of the block must call it; true for the one block that wrote
// ``out``.
__device__ __forceinline__ bool sum_tree(const float* part, int rows, int row,
                                         int pitch, float* scratch,
                                         int* tickets, float* out, int* flag) {
  const float* src = part;
  do {
    const int node = row / SUM_TREE_FAN, first = node * SUM_TREE_FAN;
    const int cnt = min(SUM_TREE_FAN, rows - first);
    const int nodes = (rows + SUM_TREE_FAN - 1) / SUM_TREE_FAN;
    if (!last_ticket(tickets + node, cnt, flag)) return false;
    sum_rows(src + (size_t)first * pitch, cnt, pitch,
             nodes == 1 ? out : scratch + (size_t)node * pitch);
    src = scratch;
    scratch += (size_t)nodes * pitch;
    tickets += nodes;
    row = node;
    rows = nodes;
  } while (rows > 1);
  return true;
}

// One block's primitive table. ``g`` is the global [m, 5] array with rows
// (cx, cy, cz, |c|^2, rr); ``n`` the columns to visit (see live_columns);
// cq/rr the shared-memory copy of up to ``cap`` columns.
struct MarchTable {
  const float* __restrict__ g;
  int n;
  float4* cq;
  float* rr;
  int cap;
  bool resident;  // columns [0, n) are staged once and stay
};

// Number of leading columns that hold every unmasked slot: 1 + the last
// column with |c|^2 < MARCH_MASKED_CSQ, or m when every slot is masked (the
// soft-min of an all-masked table is the masked distance itself). The
// trailing columns are all masked; each adds exactly 0 to a sum whose max
// comes from an unmasked column, so the march never visits them. Every
// thread of the block must call it (``scratch`` is one shared int).
__device__ __forceinline__ int live_columns(const float* __restrict__ g, int m,
                                            int* scratch) {
  if (threadIdx.x == 0) *scratch = 0;
  __syncthreads();
  int last = 0;
  for (int j = threadIdx.x; j < m; j += blockDim.x)
    if (g[5 * j + 3] < MARCH_MASKED_CSQ) last = j + 1;
  if (last > 0) atomicMax(scratch, last);  // integer max: order-free
  __syncthreads();
  const int n = *scratch;
  return n > 0 ? n : m;
}

// Stages columns [c0, c0 + len) of the global table into shared memory,
// scaling the center by -2 (exact), so that per pair
//   q = (|p|^2 + |c|^2) + fma(px, cx', fma(py, cy', pz cz'))
// is bitwise (|p|^2 + |c|^2) - 2 p.c and costs one 128-bit and one 32-bit
// shared load per column. Global reads are coalesced over the 5 len floats.
// Every thread of the block must call it: it synchronises before and after.
__device__ __forceinline__ void stage_columns(const MarchTable& tab, int c0,
                                              int len) {
  __syncthreads();
  const float* src = tab.g + (size_t)5 * c0;
  float* cq = reinterpret_cast<float*>(tab.cq);
  for (int i = threadIdx.x; i < 5 * len; i += blockDim.x) {
    const int col = i / 5;
    const int f = i - 5 * col;
    const float v = src[i];
    if (f < 3) cq[4 * col + f] = -2.0f * v;
    else if (f == 3) cq[4 * col + 3] = v;
    else tab.rr[col] = v;
  }
  __syncthreads();
}

// Soft-min of R points per lane group against the table, in one pass:
//   out = (log(max(sum_j exp(v_j - mx), 1e-8)) + mx) / (-k),  mx = max_j v_j,
// with v_j = (sqrt(q_j) - r_j) (-k) (K3's order), or with FOLD
// v_j = sqrt(q_j) (-k) + r_j k (K1's k r fold; the table holds r k).
// Each lane keeps a running max m and a sum s relative to it: a column with
// d = v - m adds e = exp(-|d|) as s + e, or as s e + 1 when it raises the
// max: one sqrt and one exp per pair, and a max is subtracted before every
// exp (dropping it underflows far rays). The L lanes of a group stride over
// the columns, each column is loaded once for the group's R points, and the
// lanes' (m, s) are merged by xor butterflies, so every lane of a group
// returns the same values. It differs from the two-pass form by float32
// rounding only. A far column's term is exactly 0 after the exp (s >= 1
// swallows anything under 2^-24), so a test that skips its exp changes no
// bit, but it was measured slower than the exp it saves (a warp skips only
// when all its pairs of a column step are far) and is not made. Unless the
// table is resident it is staged chunk by chunk,
// so every thread of the block must make the same calls.
template <int L, int R, bool FOLD>
__device__ __forceinline__ void softmin_points(const MarchTable& tab, int g,
                                               const float (&px)[R],
                                               const float (&py)[R],
                                               const float (&pz)[R], float k,
                                               float (&out)[R]) {
  float psq[R], m[R], s[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    psq[i] = sq_norm3(px[i], py[i], pz[i]);
    m[i] = -INFINITY;
    s[i] = 0.0f;
  }
  for (int c0 = 0; c0 < tab.n; c0 += tab.cap) {
    const int len = min(tab.cap, tab.n - c0);
    if (!tab.resident) stage_columns(tab, c0, len);
    for (int j = g; j < len; j += L) {
      const float4 c = tab.cq[j];
      const float rr = tab.rr[j];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float q = fmaxf(
            (psq[i] + c.w) + fmaf(px[i], c.x, fmaf(py[i], c.y, pz[i] * c.z)),
            1e-6f);
        const float v = FOLD ? fmaf(pair_sqrt(q), -k, rr)
                             : (pair_sqrt(q) - rr) * (-k);
        const float d = v - m[i];
        const float e = pair_exp(-fabsf(d));
        s[i] = d > 0.0f ? fmaf(s[i], e, 1.0f) : s[i] + e;
        m[i] = fmaxf(m[i], v);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const float mx = group_max<L>(m[i]);
    // A lane that saw no column holds (m, s) = (-inf, 0): 0 * exp(-inf) = 0.
    const float sum = group_sum<L>(L > 1 ? s[i] * expf(m[i] - mx) : s[i]);
    out[i] = (logf(fmaxf(sum, 1e-8f)) + mx) / (-k);
  }
}

// The whole per-ray work of K1 and K3 for the R rays of one lane group:
// num_steps iterations t <- min(t + softmin(ro + rd t), 1e4) from t0 (or 0),
// one more soft-min giving p_final = ro + rd (t + d), then 6-tap
// central-difference normals with +1e-6 inside the sqrt. ``ray[i]`` indexes
// ro/rd/t0/t_out/n_out; rays with ``store[i]`` false are marched (block
// barriers stay uniform) and not written. Lane ``g`` == 0 writes.
template <int L, int R, bool FOLD>
__device__ __forceinline__ void march_rays(
    const MarchTable& tab, int g, const float* __restrict__ ro,
    const float* __restrict__ rd, const float* __restrict__ t0,
    const size_t (&ray)[R], const bool (&store)[R], float k, int num_steps,
    float eps, float* __restrict__ t_out, float* __restrict__ n_out) {
  float ox[R], oy[R], oz[R], dx[R], dy[R], dz[R], t[R];
  float px[R], py[R], pz[R], sm[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    ox[i] = ro[3 * ray[i]], oy[i] = ro[3 * ray[i] + 1], oz[i] = ro[3 * ray[i] + 2];
    dx[i] = rd[3 * ray[i]], dy[i] = rd[3 * ray[i] + 1], dz[i] = rd[3 * ray[i] + 2];
    t[i] = t0 != nullptr ? t0[ray[i]] : 0.0f;
  }
  // One more pass than num_steps: the last gives the reattach distance.
  for (int it = 0; it <= num_steps; ++it) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      px[i] = ox[i] + dx[i] * t[i];
      py[i] = oy[i] + dy[i] * t[i];
      pz[i] = oz[i] + dz[i] * t[i];
    }
    softmin_points<L, R, FOLD>(tab, g, px, py, pz, k, sm);
    if (it < num_steps) {
#pragma unroll
      for (int i = 0; i < R; ++i) t[i] = fminf(t[i] + sm[i], MARCH_T_MAX);
    }
  }
  // Detached reattach point -> p_final, kept in (ox, oy, oz).
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const float tf = t[i] + sm[i];
    ox[i] += dx[i] * tf, oy[i] += dy[i] * tf, oz[i] += dz[i] * tf;
  }
  float nrm[3][R], lo[R];
#pragma unroll
  for (int axis = 0; axis < 3; ++axis) {
#pragma unroll
    for (int sign = 0; sign < 2; ++sign) {
      const float h = sign == 0 ? eps : -eps;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        px[i] = axis == 0 ? ox[i] + h : ox[i];
        py[i] = axis == 1 ? oy[i] + h : oy[i];
        pz[i] = axis == 2 ? oz[i] + h : oz[i];
      }
      softmin_points<L, R, FOLD>(tab, g, px, py, pz, k,
                                 sign == 0 ? nrm[axis] : lo);
    }
#pragma unroll
    for (int i = 0; i < R; ++i) nrm[axis][i] -= lo[i];
  }
  if (g != 0) return;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (!store[i]) continue;
    const float len =
        sqrtf(sq_norm3(nrm[0][i], nrm[1][i], nrm[2][i]) + 1e-6f);
    t_out[ray[i]] = t[i];
    n_out[3 * ray[i]] = nrm[0][i] / len;
    n_out[3 * ray[i] + 1] = nrm[1][i] / len;
    n_out[3 * ray[i] + 2] = nrm[2][i] / len;
  }
}
