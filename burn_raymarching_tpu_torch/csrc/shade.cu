// K2: fused shade/composite forward and its hand-derived backward, and the
// small kernel that packs their table.
//
// Replaces the TPU kernel burn_raymarching_tpu/ops/pallas/shade_kernel.py
// (shade_fused -> _shade_call custom VJP: _shade_fwd_kernel,
// _shade_bwd_kernel, shared math in _forward_core, and the table build of
// the shade_fused wrapper). Per ray, with t and the normal from the detached
// march (K1):
//   dist_last = softmin_k(D(p0)),  p0 = ro + rd t          (reattachment)
//   p         = ro + rd (t + dist_last)
//   lighting  = amb + max(n.l^, 0) (1 - amb)
//   D         = D(p)  -- one [M] row shared by
//   mix       = softmax(-10 D) . colors  and  cov = sigmoid(-15 softmin_k(D))
//   out       = mix lighting cov
// The backward recomputes all of that per ray and applies the gradient in
// the TPU kernel's docstring (shade_kernel.py:27-38).
//
// What bounds it: the SFU, not bytes. A ray is 13 floats in and 3 out, the
// table 32 bytes a slot (4 KB at 128 slots, read through L1); per (ray, live
// slot) pair the forward needs 2 sqrt and 3 exp. At config 1's sizes
// (16,384 rays x 10 to 100 live slots) that is a few microseconds, so what
// the step pays is launches and start-up more than throughput. Design:
// (a) shade_pack_kernel builds the table in one launch from the parameter
//     tensors: float4 (cx, cy, cz, |c|^2 or 1e30) and float4 (r, colR, colG,
//     colB) per slot, then the normalised light, the ambient term, |l| and
//     the number of leading columns that hold every live slot;
// (b) L lanes per ray (a power of two chosen from M and N, pick_lanes), 32/L
//     rays per warp, row reductions by xor butterflies inside the L lanes;
// (c) one pass per evaluation point with online accumulators. Both soft-min
//     and softmax weigh a column by exp(-c (d - dmin)), so one running
//     minimum distance serves both: a column at delta = d - dmin adds
//     e = exp(-c |delta|) as s + e, or as s e + 1 when it lowers the
//     minimum, and the colour sums are rescaled with s10. A minimum is
//     subtracted before every exp (far rays would underflow without it);
// (d) only columns below the live count are visited: masked slots inside it
//     carry |c|^2 = 1e30 and add exactly 0;
// (e) the backward needs no pass for wsum = sum_j w_j (dmix . col_j): it is
//     dmix . mix. It makes four distance evaluations per pair (the two
//     forward passes, pass B at p, pass C at p0);
// (f) the TPU backward grid ran in order and carried dprim in its output
//     block. Here a fixed grid of at most 2 blocks per SM walks fixed,
//     contiguous shares of the rays; every lane group accumulates its
//     columns' gradients in its own shared-memory row, the block sums its
//     rows in a fixed order into one row of a [blocks, 7M+4] partial array,
//     and the sum over blocks happens in the same launch as a fixed tree
//     (sum_tree in common.cuh): the block that takes the last integer
//     ticket of a node adds the node's 16 rows in row order, and the block
//     that takes the root's last ticket also projects d_l^ onto d_light.
//     Which block comes last varies; the order of every sum does not. No
//     float atomics: the gradients are bitwise repeatable.
// The per-pair sqrt, exp and reciprocal are the SFU's approximate forms
// (common.cuh); the per-ray log, exp and divides are full precision.
#include "common.cuh"

#define SK_WARPS 8
// pick_lanes: columns a lane should walk per pass (forward, backward), and
// the warps wanted in flight before lanes per ray stop growing. Measured at
// 16,384 rays on an H100 with each lane count forced in turn: 4 lanes are
// fastest at 8, 16 and 32 slots, forward and backward; at 128 slots 8
// forward and 16 backward (two blocks' accumulators then fit an SM).
#define SF_COLUMNS_PER_LANE 16
#define SB_COLUMNS_PER_LANE 8
#define SK_TARGET_WARPS 2048
#define SMEM_MAX 232448

// The packed table: cq[j] = (cx, cy, cz, |c|^2), rc[j] = (r, colR, colG,
// colB) for j < m, then (l^x, l^y, l^z, ambient) and (|l|, live columns, 0,
// 0).
struct ShadeTable {
  const float4* __restrict__ cq;
  const float4* __restrict__ rc;
  int n;  // columns to visit
  float lx, ly, lz, amb, l_norm;
};

__device__ __forceinline__ ShadeTable read_table(const float4* __restrict__ tab,
                                                 int m) {
  ShadeTable tb;
  tb.cq = tab;
  tb.rc = tab + m;
  const float4 h0 = __ldg(tab + 2 * m), h1 = __ldg(tab + 2 * m + 1);
  tb.lx = h0.x, tb.ly = h0.y, tb.lz = h0.z, tb.amb = h0.w;
  tb.l_norm = h1.x;
  tb.n = (int)h1.y;
  return tb;
}

// One block. |c|^2 = (x*x + y*y) + z*z and l^ = l / sqrt((lx*lx + ly*ly) +
// lz*lz), rounded after every operation (no FMA contraction), so the table
// is bitwise the plain version's (shade_table).
__global__ void shade_pack_kernel(const float* __restrict__ centers,
                                  const float* __restrict__ radii,
                                  const float* __restrict__ colors,
                                  const unsigned char* __restrict__ mask,
                                  const float* __restrict__ light,
                                  const float* __restrict__ ambient, int m,
                                  float4* __restrict__ out) {
  __shared__ int n_live;
  if (threadIdx.x == 0) n_live = 0;
  __syncthreads();
  int last = 0;
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    const float x = centers[3 * j], y = centers[3 * j + 1],
                z = centers[3 * j + 2];
    const bool live = mask == nullptr || mask[j];
    const float csq = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                                __fmul_rn(z, z));
    out[j] = make_float4(x, y, z, live ? csq : 1e30f);
    out[m + j] = make_float4(radii[j], colors[3 * j], colors[3 * j + 1],
                             colors[3 * j + 2]);
    if (live) last = j + 1;
  }
  if (last > 0) atomicMax(&n_live, last);  // integer max: order-free
  __syncthreads();
  if (threadIdx.x == 0) {
    const float lx = light[0], ly = light[1], lz = light[2];
    const float l_norm = __fsqrt_rn(__fadd_rn(
        __fadd_rn(__fmul_rn(lx, lx), __fmul_rn(ly, ly)), __fmul_rn(lz, lz)));
    out[2 * m] = make_float4(__fdiv_rn(lx, l_norm), __fdiv_rn(ly, l_norm),
                             __fdiv_rn(lz, l_norm), ambient[0]);
    // With every slot masked all columns are visited, as the plain version
    // does.
    out[2 * m + 1] =
        make_float4(l_norm, (float)(n_live > 0 ? n_live : m), 0.0f, 0.0f);
  }
}

// One ray's forward, held by every lane of its group.
struct RayFwd {
  float p0x, p0y, p0z, p0sq;
  float dmin0, s0;  // at p0: least distance, clamped sum of exp(-k delta)
  float px, py, pz, psq;
  float dmin;       // at p
  float s10, sk;    // sums of exp(-10 delta) and (clamped) exp(-k delta)
  float mix[3];
  float cov, lighting, diff, dot;
};

// Surface distance sqrt(max(q, 1e-6)) - r by the expanded form; *q gets the
// unclamped q and *sq the root.
__device__ __forceinline__ float pair_dist(const float4 c, float r, float px,
                                           float py, float pz, float psq,
                                           float* q, float* sq) {
  *q = expanded_q(px, py, pz, psq, c.x, c.y, c.z, c.w);
  *sq = pair_sqrt(fmaxf(*q, 1e-6f));
  return *sq - r;
}

// Forward of one ray by the L lanes of its group (lane g of the group);
// every lane returns the same values.
template <int L>
__device__ __forceinline__ RayFwd shade_forward(const ShadeTable& tb, int g,
                                                float ox, float oy, float oz,
                                                float dx, float dy, float dz,
                                                float t, float nx, float ny,
                                                float nz, float k) {
  RayFwd f;
  float q, sq;
  f.p0x = ox + dx * t;
  f.p0y = oy + dy * t;
  f.p0z = oz + dz * t;
  f.p0sq = sq_norm3(f.p0x, f.p0y, f.p0z);

  // Pass 1: soft-min at p0.
  float dm = INFINITY, s = 0.0f;
  for (int j = g; j < tb.n; j += L) {
    const float d = pair_dist(__ldg(tb.cq + j), __ldg(tb.rc + j).x, f.p0x,
                              f.p0y, f.p0z, f.p0sq, &q, &sq);
    const float delta = d - dm;
    const float e = pair_exp(-k * fabsf(delta));
    s = delta < 0.0f ? fmaf(s, e, 1.0f) : s + e;
    dm = fminf(dm, d);
  }
  f.dmin0 = group_min<L>(dm);
  // A lane that saw no column holds (inf, 0): 0 * exp(-inf) = 0.
  f.s0 = fmaxf(group_sum<L>(L > 1 ? s * expf(-k * (dm - f.dmin0)) : s), 1e-8f);
  const float dist_last = (logf(f.s0) + f.dmin0 * (-k)) / (-k);
  const float t1 = t + dist_last;
  f.px = ox + dx * t1;
  f.py = oy + dy * t1;
  f.pz = oz + dz * t1;
  f.psq = sq_norm3(f.px, f.py, f.pz);

  f.dot = (nx * tb.lx + ny * tb.ly) + nz * tb.lz;
  f.diff = fmaxf(f.dot, 0.0f);
  f.lighting = tb.amb + f.diff * (1.0f - tb.amb);

  // Pass 2 at p: softmax(-10 D) . colors and soft-min_k(D) together.
  dm = INFINITY;
  float s10 = 0.0f, sk = 0.0f, c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;
  for (int j = g; j < tb.n; j += L) {
    const float4 rc = __ldg(tb.rc + j);
    const float d = pair_dist(__ldg(tb.cq + j), rc.x, f.px, f.py, f.pz, f.psq,
                              &q, &sq);
    const float delta = d - dm;
    const float e10 = pair_exp(-10.0f * fabsf(delta));
    const float ek = pair_exp(-k * fabsf(delta));
    const bool lower = delta < 0.0f;
    // Old sums times a, the new column times b.
    const float a10 = lower ? e10 : 1.0f, b10 = lower ? 1.0f : e10;
    s10 = fmaf(s10, a10, b10);
    c0 = fmaf(c0, a10, b10 * rc.y);
    c1 = fmaf(c1, a10, b10 * rc.z);
    c2 = fmaf(c2, a10, b10 * rc.w);
    sk = lower ? fmaf(sk, ek, 1.0f) : sk + ek;
    dm = fminf(dm, d);
  }
  f.dmin = group_min<L>(dm);
  if (L > 1) {
    const float r10 = expf(-10.0f * (dm - f.dmin));
    s10 *= r10, c0 *= r10, c1 *= r10, c2 *= r10;
    sk *= expf(-k * (dm - f.dmin));
  }
  f.s10 = group_sum<L>(s10);
  f.sk = fmaxf(group_sum<L>(sk), 1e-8f);
  f.mix[0] = group_sum<L>(c0) / f.s10;
  f.mix[1] = group_sum<L>(c1) / f.s10;
  f.mix[2] = group_sum<L>(c2) / f.s10;
  const float dist_scene = (logf(f.sk) + f.dmin * (-k)) / (-k);
  f.cov = 1.0f / (1.0f + expf(dist_scene * 15.0f));
  return f;
}

template <int L>
__global__ void __launch_bounds__(SK_WARPS * 32)
shade_fwd_kernel(const float* __restrict__ ro, const float* __restrict__ rd,
                 const float* __restrict__ t, const float* __restrict__ nrm,
                 const float4* __restrict__ tab, int n, int m,
                 const float* __restrict__ kp, float* __restrict__ out) {
  const float k = __ldg(kp);
  constexpr int G = 32 / L;
  const int lane = threadIdx.x & 31;
  const long long r =
      ((long long)blockIdx.x * SK_WARPS + (threadIdx.x >> 5)) * G + lane / L;
  // Groups past the last ray shade a copy of it and store nothing, so the
  // warp's shuffles stay uniform.
  const size_t ray = (size_t)(r < n ? r : n - 1);
  const ShadeTable tb = read_table(tab, m);
  const RayFwd f = shade_forward<L>(
      tb, lane % L, ro[3 * ray], ro[3 * ray + 1], ro[3 * ray + 2],
      rd[3 * ray], rd[3 * ray + 1], rd[3 * ray + 2], t[ray], nrm[3 * ray],
      nrm[3 * ray + 1], nrm[3 * ray + 2], k);
  if (lane % L == 0 && r < n) {
#pragma unroll
    for (int c = 0; c < 3; ++c)
      out[3 * ray + c] = f.mix[c] * f.lighting * f.cov;
  }
}

// Shared-memory row stride of one lane group's accumulators: 7m + 4 floats
// rounded up to 32, plus L, so that the 32/L groups of a warp, whose lanes
// touch columns j .. j + L - 1 of their own rows, fall on distinct banks.
static __host__ __device__ __forceinline__ int acc_stride(int m, int lanes) {
  return ((7 * m + 4 + 31) / 32) * 32 + (lanes < 32 ? lanes : 0);
}

// Floats per row of the partial array: 7m + 4 rounded up to 4.
static __host__ __device__ __forceinline__ int partial_pitch(int m) {
  return (7 * m + 4 + 3) & ~3;
}

// partial [gridDim.x, pitch]: per block dcx, dcy, dcz, dr, dcolR, dcolG,
// dcolB (m each), then d_l^ xyz and d_ambient. With ``reduce`` the block
// that finishes last writes total [pitch + 4]: the sum of the rows, in the
// same layout, and d_light [3] after it. scratch and tickets: see sum_tree.
template <int L>
__global__ void __launch_bounds__(SK_WARPS * 32)
shade_bwd_kernel(const float* __restrict__ ro, const float* __restrict__ rd,
                 const float* __restrict__ t, const float* __restrict__ nrm,
                 const float4* __restrict__ tab, const float* __restrict__ gout,
                 int n, int m, const float* __restrict__ kp,
                 int rays_per_block, int reduce, float* __restrict__ partial,
                 float* __restrict__ scratch, int* __restrict__ tickets,
                 float* __restrict__ total) {
  const float k = __ldg(kp);
  extern __shared__ float acc[];  // [warps * G][stride]
  __shared__ int flag;
  constexpr int G = 32 / L;
  const int warps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane % L;
  const int group = (threadIdx.x >> 5) * G + lane / L;
  const int stride = acc_stride(m, L);
  const int row_len = 7 * m + 4;
  for (int i = threadIdx.x; i < warps * G * stride; i += blockDim.x)
    acc[i] = 0.0f;
  __syncthreads();
  float* my = acc + group * stride;

  const ShadeTable tb = read_table(tab, m);
  float d_lhat0 = 0.0f, d_lhat1 = 0.0f, d_lhat2 = 0.0f, d_amb = 0.0f;
  float q, sq;

  // This block's fixed share of the rays; its groups take them in turn.
  const long long first = (long long)blockIdx.x * rays_per_block;
  const long long end = min(first + rays_per_block, (long long)n);
  for (long long base = first; base < end; base += warps * G) {
    // A group past the end shades a copy of the last ray with a zero
    // cotangent: it adds exactly 0 everywhere and the shuffles stay uniform.
    const bool valid = base + group < end;
    const size_t ray = (size_t)(valid ? base + group : n - 1);
    const float ox = ro[3 * ray], oy = ro[3 * ray + 1], oz = ro[3 * ray + 2];
    const float dx = rd[3 * ray], dy = rd[3 * ray + 1], dz = rd[3 * ray + 2];
    const float nx = nrm[3 * ray], ny = nrm[3 * ray + 1], nz = nrm[3 * ray + 2];
    const RayFwd f =
        shade_forward<L>(tb, g, ox, oy, oz, dx, dy, dz, t[ray], nx, ny, nz, k);
    const float g0 = valid ? gout[3 * ray] : 0.0f;
    const float g1 = valid ? gout[3 * ray + 1] : 0.0f;
    const float g2 = valid ? gout[3 * ray + 2] : 0.0f;

    // out = mix * lighting * cov
    const float g_dot_mix = (g0 * f.mix[0] + g1 * f.mix[1]) + g2 * f.mix[2];
    const float dm0 = g0 * f.lighting * f.cov;
    const float dm1 = g1 * f.lighting * f.cov;
    const float dm2 = g2 * f.lighting * f.cov;
    const float d_light_scalar = g_dot_mix * f.cov;
    const float d_cov = g_dot_mix * f.lighting;
    // lighting = amb + diff (1 - amb)
    d_amb += d_light_scalar * (1.0f - f.diff);
    const float d_dot = f.dot > 0.0f ? d_light_scalar * (1.0f - tb.amb) : 0.0f;
    d_lhat0 += d_dot * nx;
    d_lhat1 += d_dot * ny;
    d_lhat2 += d_dot * nz;

    // sum_j w_j (dmix . col_j) = dmix . mix: no pass over the columns.
    const float wsum = (dm0 * f.mix[0] + dm1 * f.mix[1]) + dm2 * f.mix[2];
    const float d_ds = d_cov * (-15.0f) * f.cov * (1.0f - f.cov);
    const float inv_s10 = 1.0f / f.s10, inv_sk = 1.0f / f.sk;

    // Pass B: dD at p -> radii, centers, colors; row sums for dp.
    float sdq = 0.0f, sdqx = 0.0f, sdqy = 0.0f, sdqz = 0.0f;
    for (int j = g; j < tb.n; j += L) {
      const float4 c = __ldg(tb.cq + j), rc = __ldg(tb.rc + j);
      const float d = pair_dist(c, rc.x, f.px, f.py, f.pz, f.psq, &q, &sq);
      const float delta = d - f.dmin;
      const float w = pair_exp(-10.0f * delta) * inv_s10;
      const float v = pair_exp(-k * delta) * inv_sk;
      const float dw = (dm0 * rc.y + dm1 * rc.z) + dm2 * rc.w;
      const float d_D = -10.0f * w * (dw - wsum) + d_ds * v;
      const float dq = q > 1e-6f ? d_D * (0.5f * pair_rcp(sq)) : 0.0f;
      my[0 * m + j] += 2.0f * (c.x * dq - f.px * dq);
      my[1 * m + j] += 2.0f * (c.y * dq - f.py * dq);
      my[2 * m + j] += 2.0f * (c.z * dq - f.pz * dq);
      my[3 * m + j] -= d_D;
      my[4 * m + j] += w * dm0;
      my[5 * m + j] += w * dm1;
      my[6 * m + j] += w * dm2;
      sdq += dq;
      sdqx += dq * c.x;
      sdqy += dq * c.y;
      sdqz += dq * c.z;
    }
    sdq = group_sum<L>(sdq);
    const float dpx = 2.0f * (f.px * sdq - group_sum<L>(sdqx));
    const float dpy = 2.0f * (f.py * sdq - group_sum<L>(sdqy));
    const float dpz = 2.0f * (f.pz * sdq - group_sum<L>(sdqz));

    // Pass C: reattachment chain at the detached p0 (reaches c and r only).
    const float d_dl = (dx * dpx + dy * dpy) + dz * dpz;
    const float scale0 = d_dl / f.s0;
    for (int j = g; j < tb.n; j += L) {
      const float4 c = __ldg(tb.cq + j);
      const float d0 = pair_dist(c, __ldg(tb.rc + j).x, f.p0x, f.p0y, f.p0z,
                                 f.p0sq, &q, &sq);
      const float dd0 = pair_exp(-k * (d0 - f.dmin0)) * scale0;
      const float dq0 = q > 1e-6f ? dd0 * (0.5f * pair_rcp(sq)) : 0.0f;
      my[0 * m + j] += 2.0f * (c.x * dq0 - f.p0x * dq0);
      my[1 * m + j] += 2.0f * (c.y * dq0 - f.p0y * dq0);
      my[2 * m + j] += 2.0f * (c.z * dq0 - f.p0z * dq0);
      my[3 * m + j] -= dd0;
    }
  }
  if (g == 0) {
    my[7 * m] = d_lhat0;
    my[7 * m + 1] = d_lhat1;
    my[7 * m + 2] = d_lhat2;
    my[7 * m + 3] = d_amb;
  }
  __syncthreads();
  // Each warp's groups in group order into its first row, then the warps
  // in warp order -> this block's partial row.
  if (G > 1) {
    for (int i = threadIdx.x; i < warps * row_len; i += blockDim.x) {
      const int w = i / row_len, col = i - w * row_len;
      float* row = acc + w * G * stride + col;
      float s = row[0];
      for (int gg = 1; gg < G; ++gg) s += row[gg * stride];
      row[0] = s;
    }
    __syncthreads();
  }
  const int pitch = partial_pitch(m);
  float* dst = partial + (size_t)blockIdx.x * pitch;
  for (int i = threadIdx.x; i < pitch; i += blockDim.x) {
    float s = 0.0f;
    if (i < row_len)
      for (int w = 0; w < warps; ++w) s += acc[w * G * stride + i];
    dst[i] = s;
  }
  if (!reduce) return;

  if (!sum_tree(partial, gridDim.x, blockIdx.x, pitch, scratch, tickets,
                total, &flag))
    return;
  __syncthreads();
  if (threadIdx.x == 0) {
    // l^ = l / |l|: d_l = (d_l^ - l^ (l^ . d_l^)) / |l|.
    const float a = total[7 * m], b = total[7 * m + 1], c = total[7 * m + 2];
    const float along = (tb.lx * a + tb.ly * b) + tb.lz * c;
    total[pitch] = (a - tb.lx * along) / tb.l_norm;
    total[pitch + 1] = (b - tb.ly * along) / tb.l_norm;
    total[pitch + 2] = (c - tb.lz * along) / tb.l_norm;
  }
}

// Lanes per ray, a power of two: enough that a lane walks about
// ``columns_per_lane`` columns per pass, more while fewer than
// SK_TARGET_WARPS warps would be in flight, never more than the slot count
// rounded up, or 32.
static int pick_lanes(int n, int m, int columns_per_lane) {
  int cap = 1;
  while (cap < m && cap < 32) cap <<= 1;
  int lanes = 1;
  while (lanes < cap && lanes * columns_per_lane < m) lanes <<= 1;
  while (lanes < cap && (long long)n * lanes / 32 < SK_TARGET_WARPS)
    lanes <<= 1;
  return lanes;
}

static bool valid_lanes(int lanes) {
  return lanes >= 1 && lanes <= 32 && (lanes & (lanes - 1)) == 0;
}

static size_t bwd_smem(int m, int lanes, int warps) {
  return (size_t)warps * (32 / lanes) * acc_stride(m, lanes) * sizeof(float);
}

// Largest M whose accumulators fit the shared memory a block may use, with
// 32 lanes per ray and one warp per block.
#define SB_MAX_M ((SMEM_MAX / 4 / 32 * 32 - 4) / 7)

extern "C" int shade_bwd_max_m() { return SB_MAX_M; }

struct BwdPlan {
  int lanes, warps, blocks, rays_per_block;
  size_t smem;
};

// The backward's static grid: at most 2 blocks per SM (1 when the
// accumulators of 2 do not fit), no more than one pass over the rays needs,
// each block a contiguous share of the rays.
static int plan_bwd(int n, int m, int lanes, BwdPlan* plan) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  if (n < 1 || m < 1 || m > SB_MAX_M) return (int)cudaErrorInvalidValue;
  plan->lanes = lanes > 0 ? lanes : pick_lanes(n, m, SB_COLUMNS_PER_LANE);
  if (!valid_lanes(plan->lanes)) return (int)cudaErrorInvalidValue;
  // While the groups' accumulators exceed the shared memory a block may
  // use: more lanes per ray (unless the caller fixed them), then fewer
  // warps per block.
  plan->warps = SK_WARPS;
  while (bwd_smem(m, plan->lanes, plan->warps) > SMEM_MAX) {
    if (lanes == 0 && plan->lanes < 32) plan->lanes <<= 1;
    else if (plan->warps > 1) plan->warps >>= 1;
    else return (int)cudaErrorInvalidValue;
  }
  plan->smem = bwd_smem(m, plan->lanes, plan->warps);
  const int per_pass = plan->warps * (32 / plan->lanes);
  const int max_blocks = sms * (2 * plan->smem + 2048 <= SMEM_MAX ? 2 : 1);
  const int one_pass = (n + per_pass - 1) / per_pass;
  plan->blocks = one_pass < max_blocks ? one_pass : max_blocks;
  plan->rays_per_block = (n + plan->blocks - 1) / plan->blocks;
  // Blocks whose share would be empty are not launched.
  plan->blocks = (n + plan->rays_per_block - 1) / plan->rays_per_block;
  return 0;
}

// Rows of the partial array (blocks of the backward) for n rays and m slots
// with ``lanes`` lanes per ray (0: chosen here); negative on an error.
extern "C" int shade_bwd_blocks(int n, int m, int lanes) {
  BwdPlan plan;
  return plan_bwd(n, m, lanes, &plan) == 0 ? plan.blocks : -1;
}

// centers [m,3], radii [m], colors [m,3], mask [m] bytes or null, light [3],
// ambient [1] -> out [2m+2] float4 (see ShadeTable).
extern "C" int shade_pack_launch(const float* centers, const float* radii,
                                 const float* colors, const unsigned char* mask,
                                 const float* light, const float* ambient,
                                 int m, float* out, void* stream) {
  if (m < 1) return (int)cudaErrorInvalidValue;
  shade_pack_kernel<<<1, 256, 0, (cudaStream_t)stream>>>(
      centers, radii, colors, mask, light, ambient, m, (float4*)out);
  return (int)cudaGetLastError();
}

#define LANES_SWITCH(lanes, CASE) \
  switch (lanes) {                \
    CASE(1);                      \
    CASE(2);                      \
    CASE(4);                      \
    CASE(8);                      \
    CASE(16);                     \
    CASE(32);                     \
  }

// ro, rd, nrm [n,3], t [n], tab from shade_pack_launch; k [1] the soft-min
// sharpness in device memory, read when the kernel runs (the TPU kernel packs
// it into its table as a traced scalar); out [n,3]. ``lanes`` per ray, 0 to
// let pick_lanes choose. Returns a CUDA error code.
extern "C" int shade_fwd_launch(const float* ro, const float* rd,
                                const float* t, const float* nrm,
                                const float* tab, int n, int m, const float* k,
                                int lanes, float* out, void* stream) {
  if (n < 1 || m < 1) return (int)cudaErrorInvalidValue;
  if (lanes == 0) lanes = pick_lanes(n, m, SF_COLUMNS_PER_LANE);
  if (!valid_lanes(lanes)) return (int)cudaErrorInvalidValue;
  const long long per_block = (long long)SK_WARPS * (32 / lanes);
  const dim3 grid((unsigned)((n + per_block - 1) / per_block));
#define FWD_CASE(L)                                                       \
  case L:                                                                 \
    shade_fwd_kernel<L><<<grid, SK_WARPS * 32, 0, (cudaStream_t)stream>>>( \
        ro, rd, t, nrm, (const float4*)tab, n, m, k, out);                \
    break
  LANES_SWITCH(lanes, FWD_CASE)
#undef FWD_CASE
  return (int)cudaGetLastError();
}

template <int L>
static int launch_bwd(const BwdPlan& plan, const float* ro, const float* rd,
                      const float* t, const float* nrm, const float* tab,
                      const float* g, int n, int m, const float* k,
                      int reduce, float* partial, float* scratch,
                      int* tickets, float* total, cudaStream_t stream) {
  // The opt-in for more than 48 KB of dynamic shared memory is made once
  // per size that exceeds what was allowed before, not per launch.
  static size_t allowed = 48 * 1024;
  if (plan.smem > allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        shade_bwd_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)plan.smem);
    if (err != cudaSuccess) return (int)err;
    allowed = plan.smem;
  }
  shade_bwd_kernel<L><<<plan.blocks, plan.warps * 32, plan.smem, stream>>>(
      ro, rd, t, nrm, (const float4*)tab, g, n, m, k, plan.rays_per_block,
      reduce, partial, scratch, tickets, total);
  return (int)cudaGetLastError();
}

// g [n,3] is the cotangent of out; k [1] as for the forward. With pitch =
// 7m + 4 rounded up to 4: partial [shade_bwd_blocks(n, m, lanes), pitch];
// scratch [one row of pitch floats per node of the sum tree] and tickets
// [one int per node; zero, left zero]; with ``reduce`` the sum of the
// partial rows is written to total [pitch + 4] and d_light to its last 4
// floats, without it only ``partial``. Returns a CUDA error code.
extern "C" int shade_bwd_launch(const float* ro, const float* rd,
                                const float* t, const float* nrm,
                                const float* tab, const float* g, int n, int m,
                                const float* k, int lanes, int reduce,
                                float* partial, float* scratch, int* tickets,
                                float* total, void* stream) {
  BwdPlan plan;
  const int err = plan_bwd(n, m, lanes, &plan);
  if (err != 0) return err;
#define BWD_CASE(L)                                                          \
  case L:                                                                    \
    return launch_bwd<L>(plan, ro, rd, t, nrm, tab, g, n, m, k, reduce,      \
                         partial, scratch, tickets, total,                   \
                         (cudaStream_t)stream)
  LANES_SWITCH(plan.lanes, BWD_CASE)
#undef BWD_CASE
  return (int)cudaErrorInvalidValue;
}
