// Shared device helpers for the hand-written Hopper kernels.
//
// Numerics follow the JAX package (burn_raymarching_tpu/ops/sdf.py): fp32
// throughout, the expanded distance form max(|p|^2 + |c|^2 - 2 p.c, 1e-6)
// with the K=3 dot product written as FMAs (no tensor cores: TF32 would
// corrupt the distance field), no --use_fast_math, and 1e30 in the |c|^2
// slot of masked primitives so their distances are ~1e15 and their exp terms
// exactly 0.
//
// The second half of this file is the core that the three march kernels
// share (K1 march_shade.cu, K3 culled_march.cu, K5 march_variants.cu): a
// primitive table staged in shared memory as float4 (-2cx, -2cy, -2cz, |c|^2)
// plus one float (r, or r*k for K1 and K5), a one-pass (online) soft-min of
// R points per lane group against it, and the march + reattach + 6-tap
// normals of R rays per lane group. K1 and K5 also share the dense launch
// shape (dense_march, pick_lanes). K5's three arithmetic switches (CLAMP,
// EXP2, COORD) are template flags of the core; K1 and K3 instantiate their
// defaults, which compile to the code the core had without them.
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
// q ~ 1e-3), and judged by the float64 march in the kernel tests; sqrtf/expf
// measured 1.6x slower on an H100 with the same gap to float64. The
// per-evaluation log, the lane rescale and the normal's sqrt are full
// precision.
#define MARCH_T_MAX 1e4f
// |c|^2 at or above this marks a masked slot (the wrappers write 1e30).
#define MARCH_MASKED_CSQ 1e29f
#define MARCH_LOG2E 1.4426950408889634f
// CLAMP's ceiling on a pair's value (the TPU variant's min(val, 80)).
#define MARCH_CLAMP_VAL 80.0f

__device__ __forceinline__ float pair_sqrt(float q) {
  float r;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(q));  // q >= 1e-6
  return r;
}

// 2^x on the SFU. The online soft-min calls it with x <= 0; CLAMP's sum
// with x <= 80 log2(e) ~ 115.4, where ex2.approx is defined as well (its
// input range is the whole float range; 2^115.4 is finite). A denormal
// result is flushed to 0, which no sum can tell from it: the online sums
// hold a term >= 1, and anything under 2^-24 of that is rounded away;
// CLAMP's sum matters only above its 1e-8 floor, far above the 2^-126 that
// a flushed term lies under.
__device__ __forceinline__ float pair_exp2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// exp(x) as 2^(x log2(e)) (see pair_exp2 for the range and the flush).
__device__ __forceinline__ float pair_exp(float x) {
  return pair_exp2(x * MARCH_LOG2E);
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

// The shared-memory side of one block's primitive table: ``n`` the columns
// to visit (live_columns, march_columns); cq/rr the staged copy of up to
// ``cap`` columns. A table type of the core adds its global arrays and two
// members, live(j) and stage(c0, len), as MarchTable does (K5's is
// march_variants.cu's VariantTable).
struct StagedColumns {
  int n;
  float4* cq;
  float* rr;
  int cap;
  bool resident;  // columns [0, n) are staged once and stay
};

// One block's primitive table (K1, K3): ``g`` is the global [m, 5] array
// with rows (cx, cy, cz, |c|^2, rr).
struct MarchTable : StagedColumns {
  const float* __restrict__ g;

  // Whether slot j holds a primitive (its |c|^2 is below the mask value).
  __device__ __forceinline__ bool live(int j) const {
    return g[5 * j + 3] < MARCH_MASKED_CSQ;
  }

  // Stages columns [c0, c0 + len) into shared memory, scaling the center by
  // -2 (exact), so that per pair
  //   q = (|p|^2 + |c|^2) + fma(px, cx', fma(py, cy', pz cz'))
  // is bitwise (|p|^2 + |c|^2) - 2 p.c and costs one 128-bit and one 32-bit
  // shared load per column. Global reads are coalesced over the 5 len
  // floats. Every thread of the block must call it: it synchronises before
  // and after.
  __device__ __forceinline__ void stage(int c0, int len) const {
    __syncthreads();
    const float* src = g + (size_t)5 * c0;
    float* q = reinterpret_cast<float*>(cq);
    for (int i = threadIdx.x; i < 5 * len; i += blockDim.x) {
      const int col = i / 5;
      const int f = i - 5 * col;
      const float v = src[i];
      if (f < 3) q[4 * col + f] = -2.0f * v;
      else if (f == 3) q[4 * col + 3] = v;
      else rr[col] = v;
    }
    __syncthreads();
  }
};

// Number of leading columns that hold every live slot (Tab::live): 1 + the
// last live column, 0 when no slot is live. The trailing columns are all
// masked; each adds exactly 0 to a sum whose max comes from a live column,
// so the kernels skip them. Every thread of the block must call it
// (``scratch`` is one shared int).
template <class Tab>
__device__ __forceinline__ int live_columns(const Tab& tab, int m,
                                            int* scratch) {
  if (threadIdx.x == 0) *scratch = 0;
  __syncthreads();
  int last = 0;
  for (int j = threadIdx.x; j < m; j += blockDim.x)
    if (tab.live(j)) last = j + 1;
  if (last > 0) atomicMax(scratch, last);  // integer max: order-free
  __syncthreads();
  return *scratch;
}

// The columns a march visits (K1, K3, K5): live_columns, or the first
// column alone when no slot is live. An all-masked table gives the same
// bits from its first column as from all m: every masked column has
// |c|^2 = 1e30, so the columns' q (>= 1e30) differ only by -2 p.c and
// their soft-min terms v (~ -1e15 k) only by r k, each far below an ulp,
// and with m equal terms the soft-min is v itself (log(m) is below an ulp
// of v too). So the first step takes t to MARCH_T_MAX, the reattach point
// lies ~1e15 out, where +-eps moves q by far less than an ulp, the six
// normal evaluations read one value and the normal is exactly 0, whatever
// m is. (Under K5's COORD the mask is a far center instead: an all-masked
// table then reads its first column's distance.)
template <class Tab>
__device__ __forceinline__ int march_columns(const Tab& tab, int m,
                                             int* scratch) {
  return max(live_columns(tab, m, scratch), 1);
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
//
// K5's switches (K1 and K3 take the defaults):
//   COORD  q = (dx^2 + dy^2) + dz^2 with d = p - c by coordinates, where
//          fma(0.5, -2c, p) is bitwise p - c (the staged -2c halves
//          exactly); masked slots need far centers;
//   CLAMP  s = sum of exp(min(v, 80)) and no max: out = log(max(s, 1e-8))
//          / (-k), wrong on a ray far from every slot (its s underflows to
//          0 and it steps by the floor's log(1e-8) / (-k));
//   EXP2   the caller has folded log2(e) into the scale (k and the staged r
//          k carry it), so v is in base 2: the per-pair exp is 2^x with no
//          multiply, CLAMP's ceiling is 80 log2(e), and the per-evaluation
//          exp and log are exp2f and log2f: out = (log2(s) + mx) / (-k).
template <int L, int R, bool FOLD, bool CLAMP = false, bool EXP2 = false,
          bool COORD = false, class Tab>
__device__ __forceinline__ void softmin_points(const Tab& tab, int g,
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
    if (!tab.resident) tab.stage(c0, len);
    for (int j = g; j < len; j += L) {
      const float4 c = tab.cq[j];
      const float rr = tab.rr[j];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        float q;
        if (COORD) {
          const float dx = fmaf(0.5f, c.x, px[i]);
          const float dy = fmaf(0.5f, c.y, py[i]);
          const float dz = fmaf(0.5f, c.z, pz[i]);
          q = fmaxf((dx * dx + dy * dy) + dz * dz, 1e-6f);
        } else {
          q = fmaxf((psq[i] + c.w) +
                        fmaf(px[i], c.x, fmaf(py[i], c.y, pz[i] * c.z)),
                    1e-6f);
        }
        const float v = FOLD ? fmaf(pair_sqrt(q), -k, rr)
                             : (pair_sqrt(q) - rr) * (-k);
        if (CLAMP) {
          s[i] += EXP2 ? pair_exp2(fminf(v, MARCH_CLAMP_VAL * MARCH_LOG2E))
                       : pair_exp(fminf(v, MARCH_CLAMP_VAL));
        } else {
          const float d = v - m[i];
          const float e = EXP2 ? pair_exp2(-fabsf(d)) : pair_exp(-fabsf(d));
          s[i] = d > 0.0f ? fmaf(s[i], e, 1.0f) : s[i] + e;
          m[i] = fmaxf(m[i], v);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (CLAMP) {
      const float sum = fmaxf(group_sum<L>(s[i]), 1e-8f);
      out[i] = (EXP2 ? log2f(sum) : logf(sum)) / (-k);
    } else {
      const float mx = group_max<L>(m[i]);
      // A lane that saw no column holds (m, s) = (-inf, 0): 0 * exp(-inf) = 0.
      const float sum = fmaxf(
          group_sum<L>(L > 1 ? s[i] * (EXP2 ? exp2f(m[i] - mx)
                                            : expf(m[i] - mx))
                             : s[i]),
          1e-8f);
      out[i] = ((EXP2 ? log2f(sum) : logf(sum)) + mx) / (-k);
    }
  }
}

// The whole per-ray work of K1, K3 and K5 for the R rays of one lane group:
// num_steps iterations t <- min(t + softmin(ro + rd t), 1e4) from t0 (or 0),
// one more soft-min giving p_final = ro + rd (t + d), then 6-tap
// central-difference normals with +1e-6 inside the sqrt. ``ray[i]`` indexes
// ro/rd/t0/t_out/n_out; rays with ``store[i]`` false are marched (block
// barriers stay uniform) and not written. Lane ``g`` == 0 writes.
// CLAMP, EXP2, COORD: softmin_points' switches.
template <int L, int R, bool FOLD, bool CLAMP = false, bool EXP2 = false,
          bool COORD = false, class Tab>
__device__ __forceinline__ void march_rays(
    const Tab& tab, int g, const float* __restrict__ ro,
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
    softmin_points<L, R, FOLD, CLAMP, EXP2, COORD>(tab, g, px, py, pz, k, sm);
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
      softmin_points<L, R, FOLD, CLAMP, EXP2, COORD>(
          tab, g, px, py, pz, k, sign == 0 ? nrm[axis] : lo);
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

// ---------------------------------------------------------------------------
// The dense march (K1 and K5): every ray against one table of m slots.
//
// MS_WARPS warps a block, 32 / L lane groups a warp, MS_RAYS rays a group in
// registers (each column load serves MS_RAYS points and their serial chains
// overlap); lane group G of the grid marches rays G MS_RAYS + i of all n, so
// a ray's arithmetic depends on L alone, never on the block it falls in.
// The table's live columns are staged once per block when they fit
// MS_CHUNK, and chunk by chunk otherwise, so there is no slot cap.
#define MS_WARPS 8
#define MS_RAYS 2
#define MS_CHUNK 1024
// pick_lanes: columns a lane should walk between butterflies, and the warps
// wanted in flight (about 2 per scheduler of 132 SMs) before lanes per ray
// stop growing.
#define MS_COLUMNS_PER_LANE 16
#define MS_TARGET_WARPS 1024

// Lanes per ray, a power of two: enough that a lane walks about
// MS_COLUMNS_PER_LANE columns per evaluation, more while fewer than
// MS_TARGET_WARPS warps would be in flight, never more than the slot count
// rounded up, or 32. Fewer lanes mean shorter butterflies and no idle lanes
// at small M; more lanes mean more warps when N is small. Measured at
// 16,384 rays on an H100 with each lane count forced in turn: 4 lanes are
// fastest at M = 8 and 32, 8 at M = 128, which is what this rule picks.
static inline int pick_lanes(int n, int m) {
  int cap = 1;
  while (cap < m && cap < 32) cap <<= 1;
  int lanes = 1;
  while (lanes < cap && lanes * MS_COLUMNS_PER_LANE < m) lanes <<= 1;
  while (lanes < cap &&
         (long long)n * lanes / (32 * MS_RAYS) < MS_TARGET_WARPS)
    lanes <<= 1;
  return lanes;
}

// Blocks of MS_WARPS * 32 threads that dense_march needs for n rays at L
// lanes a ray.
static inline unsigned dense_blocks(int n, int lanes) {
  const long long per_block = (long long)MS_WARPS * (32 / lanes) * MS_RAYS;
  return (unsigned)((n + per_block - 1) / per_block);
}

// The body of a dense march kernel: sets ``tab``'s staging fields (its
// global table set by the caller), then marches this thread's lane group's
// rays. Groups past the last ray march a copy of it and store nothing, so
// block barriers and warp shuffles stay uniform.
template <int L, bool CLAMP = false, bool EXP2 = false, bool COORD = false,
          class Tab>
__device__ __forceinline__ void dense_march(
    Tab& tab, int m, const float* __restrict__ ro,
    const float* __restrict__ rd, const float* __restrict__ t0, int n,
    float k, int num_steps, float normal_eps, float* __restrict__ t_out,
    float* __restrict__ n_out) {
  __shared__ float4 cq[MS_CHUNK];
  __shared__ float rr[MS_CHUNK];
  __shared__ int n_live;
  tab.cap = MS_CHUNK;
  tab.cq = cq;
  tab.rr = rr;
  tab.n = march_columns(tab, m, &n_live);
  tab.resident = tab.n <= MS_CHUNK;
  if (tab.resident) tab.stage(0, tab.n);

  constexpr int GROUPS = 32 / L;
  const int lane = threadIdx.x & 31;
  const long long group =
      ((long long)blockIdx.x * MS_WARPS + (threadIdx.x >> 5)) * GROUPS +
      lane / L;
  size_t ray[MS_RAYS];
  bool store[MS_RAYS];
#pragma unroll
  for (int i = 0; i < MS_RAYS; ++i) {
    const long long r = group * MS_RAYS + i;
    store[i] = r < n;
    ray[i] = (size_t)(r < n ? r : n - 1);
  }
  march_rays<L, MS_RAYS, true, CLAMP, EXP2, COORD>(
      tab, lane % L, ro, rd, t0, ray, store, k, num_steps, normal_eps, t_out,
      n_out);
}
