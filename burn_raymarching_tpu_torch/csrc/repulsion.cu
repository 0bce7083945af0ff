// K4: two-level cluster repulsion sum, forward and recompute backward.
//
// Replaces the TPU kernel burn_raymarching_tpu/ops/pallas/repulsion_kernel.py
// (cluster_repulsion_fused -> _rep_call custom VJP: _rep_fwd_kernel,
// _rep_bwd_kernel). Inputs are the differentiable prep's outputs, computed
// outside in torch autograd: member planes cs [3, C, G], neighbor-member
// planes nbcs [3, C, WG], centroid planes cents [3, CA], member and neighbor
// weights w [C, G], nbw [C, WG], primitive ids mi [C, G], nbm [C, WG] and
// far weights fw [C, CA]. The sum is
//   near: sum_{c,i,j} w_ci nbw_cj / (sqrt(max(d2, 1e-6)) + 100 [mi == nbm] + 1e-6)
//   far:  sum_{c,i,a} w_ci fw_ca  / (sqrt(max(d2, 1e-6)) + 1e-6)   (member mode)
// with d2 coordinate-split, (dx^2 + dy^2) + dz^2. The monopole far field is a
// [C, C] term that stays in torch outside the kernel.
//
// What bounds it: arithmetic, not bytes. Every pair costs a sqrt and a
// reciprocal on the SFU among ~15 (forward) to ~30 (backward) other
// instructions; there are C x G x (WG + CA) pairs: 3.0 M at config 4
// (C = 80, G = 64, W = 8), 67 M at M = 51,200 (C = 800). Design:
// (a) a cluster's pair rectangle is G rows (its members) by WG + CA columns
//     (its neighbors' members, then all centroids). The column axis is cut
//     into slices, one block each, so that C = 80 still gives about three
//     blocks per SM (rep_slices); at C = 800 a cluster is one slice;
// (b) a thread owns a column: it keeps the column's position, weight and id
//     in registers and walks the rows, which sit in shared memory as float4
//     (x, y, z, w) + id. No index arithmetic per pair;
// (c) the per-pair sqrt and reciprocal are the SFU's approximate forms, and
//     the gradient coefficient is a select on d2 > 1e-6 (zero where autodiff
//     of max(d2, 1e-6) is zero), not a branch;
// (d) the backward computes each pair once. The column's thread sums the
//     column's gradient in registers. The rows' gradients need a sum over
//     the threads: eight rows at a time, a warp adds its 32 columns by a
//     halving exchange (at xor distances 16, 8 and 4 a lane passes on half of
//     the rows it still holds and keeps the other half; at 2 and 1 it adds
//     the one row left), 27 shuffles for 8 rows x 3 coordinates where a
//     butterfly per row would take 120; the warps' sums are added in warp
//     order;
// (e) the TPU grid ran in order and carried the sum and d_centroids in its
//     output block; Hopper blocks run in any order. Every sum over blocks is
//     taken inside the launch by the block that draws the last integer
//     ticket (common.cuh), in index order: the forward's scalar over all
//     blocks; a cluster's d_members over its slices; d_centroids over the
//     clusters as a fixed tree of 16 rows per node (sum_tree). No float
//     atomics: every output is bitwise repeatable.
#include "common.cuh"

#define RP_THREADS 128
#define RP_WARPS (RP_THREADS / 32)

__device__ __forceinline__ float sq3(float dx, float dy, float dz) {
  return (dx * dx + dy * dy) + dz * dz;
}

struct RepArgs {
  const float* __restrict__ cs;
  const float* __restrict__ nbcs;
  const float* __restrict__ cents;
  const float* __restrict__ w;
  const float* __restrict__ nbw;
  const int* __restrict__ mi;
  const int* __restrict__ nbm;
  const float* __restrict__ fw;
  // ``cols`` = wg + ca with the far field, wg without.
  int n_c, g, wg, ca, cols, slices, slice_cols;
};

// Stages cluster c's members as (x, y, z, w) + id, padded with weightless
// rows to g8 (a multiple of 8).
__device__ __forceinline__ void stage_members(const RepArgs& a, int c, int g8,
                                              float4* om, int* oid) {
  const size_t plane = (size_t)a.n_c * a.g;
  for (int i = threadIdx.x; i < g8; i += blockDim.x) {
    const size_t o = (size_t)c * a.g + i;
    const bool real = i < a.g;
    om[i] = real ? make_float4(a.cs[o], a.cs[plane + o], a.cs[2 * plane + o],
                               a.w[o])
                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    oid[i] = real ? a.mi[o] : -2;
  }
  __syncthreads();
}

// Column ``col`` of cluster c's rectangle: a neighbor member (col < wg) or a
// centroid with the cluster's far weight and an id that matches no member.
// Past ``hi`` a weightless column at the origin: it adds exactly 0.
__device__ __forceinline__ void load_column(const RepArgs& a, int c, int col,
                                            int hi, float4* xw, int* id) {
  if (col >= hi) {
    *xw = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    *id = -1;
  } else if (col < a.wg) {
    const size_t plane = (size_t)a.n_c * a.wg, o = (size_t)c * a.wg + col;
    *xw = make_float4(a.nbcs[o], a.nbcs[plane + o], a.nbcs[2 * plane + o],
                      a.nbw[o]);
    *id = a.nbm[o];
  } else {
    const int k = col - a.wg;
    *xw = make_float4(a.cents[k], a.cents[a.ca + k], a.cents[2 * a.ca + k],
                      a.fw[(size_t)c * a.ca + k]);
    *id = -1;
  }
}

// Sum over rows [0, rows) of src[row * len + c], in row order. The rows were
// written by other blocks: they are read from L2.
__device__ __forceinline__ float sum_column(const float* src, int rows,
                                            size_t len, size_t c) {
  float s = 0.0f;
#pragma unroll 8
  for (int r = 0; r < rows; ++r) s += __ldcg(src + r * len + c);
  return s;
}

// Fixed-order block sum: xor butterfly per warp, then the warps in order.
// Every thread must call it; thread 0 returns the sum.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.0f;
  if (threadIdx.x == 0)
    for (int k = 0; k < RP_WARPS; ++k) s += red[k];
  return s;
}

// partial [n_c * slices]: each block's sum. With ``reduce`` the block that
// finishes last writes their sum to out [1]. tickets [1], 0 on entry and
// exit.
__global__ void __launch_bounds__(RP_THREADS)
rep_fwd_kernel(const RepArgs a, int reduce, float* __restrict__ partial,
               int* __restrict__ tickets, float* __restrict__ out) {
  extern __shared__ float4 sm4[];
  __shared__ float red[RP_WARPS];
  __shared__ int flag;
  const int g8 = (a.g + 7) & ~7;
  float4* om = sm4;
  int* oid = (int*)(om + g8);
  const int c = blockIdx.x / a.slices, s = blockIdx.x - c * a.slices;
  stage_members(a, c, g8, om, oid);
  const int lo = s * a.slice_cols, hi = min(lo + a.slice_cols, a.cols);
  float acc = 0.0f;
  for (int col = lo + threadIdx.x; col < hi; col += RP_THREADS) {
    float4 xw;
    int id;
    load_column(a, c, col, hi, &xw, &id);
    for (int i = 0; i < a.g; ++i) {
      const float4 o = om[i];
      const float d2 = sq3(o.x - xw.x, o.y - xw.y, o.z - xw.z);
      const float denom = pair_sqrt(fmaxf(d2, 1e-6f)) +
                          (oid[i] == id ? 100.0f : 0.0f) + 1e-6f;
      acc = fmaf(o.w * xw.w, pair_rcp(denom), acc);
    }
  }
  const float total = block_sum(acc, red);
  if (threadIdx.x == 0) partial[blockIdx.x] = total;
  if (!reduce || !last_ticket(tickets, gridDim.x, &flag)) return;
  float t = 0.0f;
  for (int i = threadIdx.x; i < gridDim.x; i += RP_THREADS)
    t += __ldcg(partial + i);
  t = block_sum(t, red);
  if (threadIdx.x == 0) out[0] = t;
}

// Adds the warp's 32 columns for 8 rows x 3 coordinates. On return lanes
// with (lane & 3) == 0 hold in v[0] the sums of row
// 4 (lane >> 4 & 1) + 2 (lane >> 3 & 1) + (lane >> 2 & 1); the order of the
// additions is fixed.
__device__ __forceinline__ void warp_rows_sum(float (&v)[8][3], int lane) {
  const bool b16 = lane & 16, b8 = lane & 8, b4 = lane & 4;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int x = 0; x < 3; ++x) {
      const float send = b16 ? v[r][x] : v[r + 4][x];
      const float keep = b16 ? v[r + 4][x] : v[r][x];
      v[r][x] = keep + __shfl_xor_sync(FULL_MASK, send, 16);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int x = 0; x < 3; ++x) {
      const float send = b8 ? v[r][x] : v[r + 2][x];
      const float keep = b8 ? v[r + 2][x] : v[r][x];
      v[r][x] = keep + __shfl_xor_sync(FULL_MASK, send, 8);
    }
#pragma unroll
  for (int x = 0; x < 3; ++x) {
    const float send = b4 ? v[0][x] : v[1][x];
    const float keep = b4 ? v[1][x] : v[0][x];
    float t = keep + __shfl_xor_sync(FULL_MASK, send, 4);
    t += __shfl_xor_sync(FULL_MASK, t, 2);
    t += __shfl_xor_sync(FULL_MASK, t, 1);
    v[0][x] = t;
  }
}

// Floats per row of the d_centroids partials: 3 ca rounded up to 4.
static __host__ __device__ __forceinline__ int cent_pitch(int ca) {
  return (3 * ca + 3) & ~3;
}

// gptr [1]: the upstream gradient of the sum. Writes dcs [3, n_c, g] and
// dnbcs [3, n_c, wg]; with the far field, dcent_part [n_c, pitch] (each
// cluster's d_centroids, [3, ca] in a row of pitch = cent_pitch(ca) floats)
// and, with ``reduce``, their sum dcents [pitch]. Scratch: dcs_part
// [slices, 3, n_c, g] (slices > 1); tree_rows and tickets + n_c for
// sum_tree over n_c rows; tickets [n_c] (one per cluster, slices > 1) before
// them; all tickets 0 on entry and exit. Without ``reduce`` the far field's
// sum over clusters is left out (dcents is not written).
__global__ void __launch_bounds__(RP_THREADS)
rep_bwd_kernel(const RepArgs a, const float* __restrict__ gptr, int reduce,
               float* __restrict__ dcs, float* __restrict__ dcs_part,
               float* __restrict__ dnbcs, float* __restrict__ dcent_part,
               float* __restrict__ tree_rows, float* __restrict__ dcents,
               int* __restrict__ tickets) {
  extern __shared__ float4 sm4[];
  __shared__ int flag;
  const int g8 = (a.g + 7) & ~7;
  float4* om = sm4;
  int* oid = (int*)(om + g8);
  float* rows = (float*)(oid + g8);  // [RP_WARPS][3][g8]
  const int c = blockIdx.x / a.slices, s = blockIdx.x - c * a.slices;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < RP_WARPS * 3 * g8; i += RP_THREADS)
    rows[i] = 0.0f;
  stage_members(a, c, g8, om, oid);
  float* my_rows = rows + warp * 3 * g8;
  const int row_of_lane = ((lane >> 4) & 1) * 4 + ((lane >> 3) & 1) * 2 +
                          ((lane >> 2) & 1);
  const float neg_gbar = -gptr[0];
  const bool far = a.cols > a.wg;
  const size_t plane_wg = (size_t)a.n_c * a.wg;
  const int pitch = cent_pitch(a.ca);

  const int lo = s * a.slice_cols, hi = min(lo + a.slice_cols, a.cols);
  // Block-uniform trip count: every lane reaches the shuffles.
  for (int base = lo; base < hi; base += RP_THREADS) {
    const int col = base + threadIdx.x;
    float4 xw;
    int id;
    load_column(a, c, col, hi, &xw, &id);
    const float ngw = neg_gbar * xw.w;
    float sx = 0.0f, sy = 0.0f, sz = 0.0f;
    for (int i0 = 0; i0 < g8; i0 += 8) {
      float v[8][3];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float4 o = om[i0 + r];
        const float dx = o.x - xw.x, dy = o.y - xw.y, dz = o.z - xw.z;
        const float d2 = sq3(dx, dy, dz);
        const float dist = pair_sqrt(fmaxf(d2, 1e-6f));
        const float denom = dist + (oid[i0 + r] == id ? 100.0f : 0.0f) + 1e-6f;
        // d/d(diff) of wt / denom, times gbar: -gbar wt / (denom^2 dist)
        // where d2 > 1e-6, else 0.
        const float coef = d2 > 1e-6f
                               ? (ngw * o.w) * pair_rcp(denom * denom * dist)
                               : 0.0f;
        v[r][0] = coef * dx, v[r][1] = coef * dy, v[r][2] = coef * dz;
        sx -= v[r][0], sy -= v[r][1], sz -= v[r][2];
      }
      warp_rows_sum(v, lane);
      if ((lane & 3) == 0) {
        my_rows[i0 + row_of_lane] += v[0][0];
        my_rows[g8 + i0 + row_of_lane] += v[0][1];
        my_rows[2 * g8 + i0 + row_of_lane] += v[0][2];
      }
    }
    if (col < hi) {
      if (col < a.wg) {
        const size_t o = (size_t)c * a.wg + col;
        dnbcs[o] = sx;
        dnbcs[plane_wg + o] = sy;
        dnbcs[2 * plane_wg + o] = sz;
      } else {
        float* part = dcent_part + (size_t)c * pitch + (col - a.wg);
        part[0] = sx;
        part[a.ca] = sy;
        part[2 * a.ca] = sz;
      }
    }
  }
  __syncthreads();
  // The warps' row sums in warp order: this slice's d_members.
  const size_t plane_g = (size_t)a.n_c * a.g;
  float* dst = a.slices > 1 ? dcs_part + (size_t)s * 3 * plane_g : dcs;
  for (int i = threadIdx.x; i < 3 * a.g; i += RP_THREADS) {
    const int x = i / a.g, r = i - x * a.g;
    float t = 0.0f;
    for (int k = 0; k < RP_WARPS; ++k) t += rows[(k * 3 + x) * g8 + r];
    dst[x * plane_g + (size_t)c * a.g + r] = t;
  }
  if (a.slices > 1) {
    // The cluster's last slice adds its slices in slice order.
    if (!last_ticket(tickets + c, a.slices, &flag)) return;
    for (int i = threadIdx.x; i < 3 * a.g; i += RP_THREADS) {
      const int x = i / a.g, r = i - x * a.g;
      const size_t o = x * plane_g + (size_t)c * a.g + r;
      dcs[o] = sum_column(dcs_part, a.slices, 3 * plane_g, o);
    }
  }
  if (!far || !reduce) return;
  // d_centroids: the clusters' rows, complete now, in a fixed tree. The
  // floats that pad a row to its pitch are never written: they only ever
  // reach other padding.
  sum_tree(dcent_part, a.n_c, c, pitch, tree_rows, tickets + a.n_c, dcents,
           &flag);
}

static int sm_count(int* sms) {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&cached, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err != cudaSuccess) return (int)err;
  }
  *sms = cached;
  return 0;
}

// Slices per cluster: enough for about three blocks per SM, never narrower
// than one column per thread. ``slices`` > 0 overrides the rule. Fills
// a->cols, a->slices, a->slice_cols.
static int plan_slices(RepArgs* a, int include_far, int slices) {
  if (a->n_c < 1 || a->g < 1 || a->wg < 1 || a->ca < 1 || slices < 0)
    return (int)cudaErrorInvalidValue;
  a->cols = a->wg + (include_far ? a->ca : 0);
  if (slices == 0) {
    int sms = 0;
    const int err = sm_count(&sms);
    if (err != 0) return err;
    const int fill = (3 * sms + a->n_c - 1) / a->n_c;
    const int widest = (a->cols + RP_THREADS - 1) / RP_THREADS;
    slices = fill < widest ? fill : widest;
  }
  if (slices > a->cols) slices = a->cols;
  a->slice_cols = (a->cols + slices - 1) / slices;
  // Slices that would be empty are not launched.
  a->slices = (a->cols + a->slice_cols - 1) / a->slice_cols;
  return 0;
}

// Slices per cluster that the launches will use (``slices`` 0: chosen
// here); negative on an error.
extern "C" int rep_slices(int n_c, int g, int wg, int ca, int include_far,
                          int slices) {
  RepArgs a{};
  a.n_c = n_c, a.g = g, a.wg = wg, a.ca = ca;
  return plan_slices(&a, include_far, slices) == 0 ? a.slices : -1;
}

static size_t members_smem(int g) {
  return (size_t)((g + 7) & ~7) * (sizeof(float4) + sizeof(int));
}

template <class Kernel>
static cudaError_t allow_smem(Kernel* fn, size_t smem, size_t* allowed) {
  if (smem <= *allowed) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) *allowed = smem;
  return err;
}

// partial [n_c * rep_slices(...)], tickets [1] zero ints, out [1]. Returns a
// CUDA error code.
extern "C" int rep_fwd_launch(const float* cs, const float* nbcs,
                              const float* cents, const float* w,
                              const float* nbw, const int* mi, const int* nbm,
                              const float* fw, int n_c, int g, int wg, int ca,
                              int include_far, int slices, int reduce,
                              float* partial, int* tickets, float* out,
                              void* stream) {
  RepArgs a{cs, nbcs, cents, w, nbw, mi, nbm, fw, n_c, g, wg, ca, 0, 0, 0};
  const int bad = plan_slices(&a, include_far, slices);
  if (bad != 0) return bad;
  static size_t allowed = 48 * 1024;
  const size_t smem = members_smem(g);
  cudaError_t err = allow_smem(rep_fwd_kernel, smem, &allowed);
  if (err != cudaSuccess) return (int)err;
  rep_fwd_kernel<<<n_c * a.slices, RP_THREADS, smem, (cudaStream_t)stream>>>(
      a, reduce, partial, tickets, out);
  return (int)cudaGetLastError();
}

// See rep_bwd_kernel for the outputs and scratch. Returns a CUDA error code.
extern "C" int rep_bwd_launch(const float* cs, const float* nbcs,
                              const float* cents, const float* w,
                              const float* nbw, const int* mi, const int* nbm,
                              const float* fw, const float* gptr, int n_c,
                              int g, int wg, int ca, int include_far,
                              int slices, int reduce, float* dcs,
                              float* dcs_part, float* dnbcs, float* dcent_part,
                              float* tree_rows, float* dcents, int* tickets,
                              void* stream) {
  RepArgs a{cs, nbcs, cents, w, nbw, mi, nbm, fw, n_c, g, wg, ca, 0, 0, 0};
  const int bad = plan_slices(&a, include_far, slices);
  if (bad != 0) return bad;
  static size_t allowed = 48 * 1024;
  const size_t smem =
      members_smem(g) + (size_t)RP_WARPS * 3 * ((g + 7) & ~7) * sizeof(float);
  cudaError_t err = allow_smem(rep_bwd_kernel, smem, &allowed);
  if (err != cudaSuccess) return (int)err;
  rep_bwd_kernel<<<n_c * a.slices, RP_THREADS, smem, (cudaStream_t)stream>>>(
      a, gptr, reduce, dcs, dcs_part, dnbcs, dcent_part, tree_rows, dcents,
      tickets);
  return (int)cudaGetLastError();
}
