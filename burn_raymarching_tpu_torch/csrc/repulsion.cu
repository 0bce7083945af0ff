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
// What bounds it: arithmetic, not bytes. Each cluster's 64 + 512 member
// positions (11.5 KB at G = 64, W = 8) sit in shared memory; every pair
// costs a sqrt and a divide on the SFU. There are C x G x (WG + CA) pairs:
// 2.6 M at config 4 (C = 80), 67 M at M = 51,200 (C = 800).
// Design: one block per cluster. The TPU grid ran in order and carried the
// sum and d_centroids in its output block; Hopper blocks run in any order,
// so the forward writes one partial per cluster and the backward one
// d_centroids partial row [3, CA] per cluster, and rep_reduce_kernel sums
// partial rows in row order. d_members and d_neighbor_members belong to one
// cluster each and are written without conflicts: the backward makes a row
// pass (4 lanes per member, combined by xor shuffles) and a column pass
// (one thread per neighbor member or centroid), recomputing each pair in
// both. No float atomics: every output is bitwise repeatable. live =
// d2 > 1e-6 zeroes the gradient where autodiff of max(d2, 1e-6) does.
#include "common.cuh"

#define RP_THREADS 256

struct Cluster {
  // Shared-memory views of one cluster's members and its neighbors' members.
  const float *ox, *oy, *oz, *ow;
  const int* oid;
  const float *nx, *ny, *nz, *nw;
  const int* nid;
};

// Stages cluster c's member and neighbor-member data into shared memory.
__device__ Cluster load_cluster(float* sm, int c, int n_c, int g, int wg,
                                const float* __restrict__ cs,
                                const float* __restrict__ nbcs,
                                const float* __restrict__ w,
                                const float* __restrict__ nbw,
                                const int* __restrict__ mi,
                                const int* __restrict__ nbm) {
  float* ox = sm;
  float* oy = ox + g;
  float* oz = oy + g;
  float* ow = oz + g;
  int* oid = (int*)(ow + g);
  float* nx = (float*)(oid + g);
  float* ny = nx + wg;
  float* nz = ny + wg;
  float* nw = nz + wg;
  int* nid = (int*)(nw + wg);
  const size_t plane_g = (size_t)n_c * g, plane_wg = (size_t)n_c * wg;
  for (int i = threadIdx.x; i < g; i += blockDim.x) {
    const size_t o = (size_t)c * g + i;
    ox[i] = cs[o];
    oy[i] = cs[plane_g + o];
    oz[i] = cs[2 * plane_g + o];
    ow[i] = w[o];
    oid[i] = mi[o];
  }
  for (int j = threadIdx.x; j < wg; j += blockDim.x) {
    const size_t o = (size_t)c * wg + j;
    nx[j] = nbcs[o];
    ny[j] = nbcs[plane_wg + o];
    nz[j] = nbcs[2 * plane_wg + o];
    nw[j] = nbw[o];
    nid[j] = nbm[o];
  }
  __syncthreads();
  return Cluster{ox, oy, oz, ow, oid, nx, ny, nz, nw, nid};
}

__device__ __forceinline__ float sq3(float dx, float dy, float dz) {
  return (dx * dx + dy * dy) + dz * dz;
}

// Gradient coefficient of weight / (dist + extra + 1e-6) with respect to
// the coordinate difference, times -gbar: -gbar wt / (denom^2 dist) on live
// pairs (d2 > 1e-6), 0 otherwise.
__device__ __forceinline__ float pair_coef(float d2, float extra, float wt,
                                           float gbar) {
  if (!(d2 > 1e-6f)) return 0.0f;
  const float dist = sqrtf(d2);
  const float denom = dist + extra + 1e-6f;
  return ((-gbar) * wt) / (denom * denom * dist);
}

__global__ void __launch_bounds__(RP_THREADS)
rep_fwd_kernel(const float* __restrict__ cs, const float* __restrict__ nbcs,
               const float* __restrict__ cents, const float* __restrict__ w,
               const float* __restrict__ nbw, const int* __restrict__ mi,
               const int* __restrict__ nbm, const float* __restrict__ fw,
               int n_c, int g, int wg, int ca, int include_far,
               float* __restrict__ partial) {
  extern __shared__ float sm[];
  __shared__ float red[RP_THREADS / 32];
  const int c = blockIdx.x;
  const Cluster cl = load_cluster(sm, c, n_c, g, wg, cs, nbcs, w, nbw, mi, nbm);
  float acc = 0.0f;
  for (int p = threadIdx.x; p < g * wg; p += blockDim.x) {
    const int i = p / wg, j = p - i * wg;
    const float d2 = sq3(cl.ox[i] - cl.nx[j], cl.oy[i] - cl.ny[j],
                         cl.oz[i] - cl.nz[j]);
    const float denom = sqrtf(fmaxf(d2, 1e-6f))
                        + (cl.oid[i] == cl.nid[j] ? 100.0f : 0.0f) + 1e-6f;
    acc += (cl.ow[i] * cl.nw[j]) / denom;
  }
  if (include_far) {
    const float* fwc = fw + (size_t)c * ca;
    for (int p = threadIdx.x; p < g * ca; p += blockDim.x) {
      const int i = p / ca, a = p - i * ca;
      const float d2 = sq3(cl.ox[i] - cents[a], cl.oy[i] - cents[ca + a],
                           cl.oz[i] - cents[2 * ca + a]);
      acc += (cl.ow[i] * fwc[a]) / (sqrtf(fmaxf(d2, 1e-6f)) + 1e-6f);
    }
  }
  // Fixed-order block sum: xor butterfly per warp, then warps in order.
  acc = warp_sum(acc);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int k = 0; k < RP_THREADS / 32; ++k) s += red[k];
    partial[c] = s;
  }
}

__global__ void __launch_bounds__(RP_THREADS)
rep_bwd_kernel(const float* __restrict__ cs, const float* __restrict__ nbcs,
               const float* __restrict__ cents, const float* __restrict__ w,
               const float* __restrict__ nbw, const int* __restrict__ mi,
               const int* __restrict__ nbm, const float* __restrict__ fw,
               const float* __restrict__ gptr, int n_c, int g, int wg, int ca,
               int include_far, float* __restrict__ dcs,
               float* __restrict__ dnbcs, float* __restrict__ dcent_part) {
  extern __shared__ float sm[];
  const int c = blockIdx.x;
  const Cluster cl = load_cluster(sm, c, n_c, g, wg, cs, nbcs, w, nbw, mi, nbm);
  const float gbar = gptr[0];
  const float* fwc = fw + (size_t)c * ca;
  const size_t plane_g = (size_t)n_c * g, plane_wg = (size_t)n_c * wg;

  // Row pass: d_members. Four lanes per member i, lane q taking columns
  // j = q (mod 4); the loop trip count is block-uniform so every lane
  // reaches the shuffles.
  const int q = threadIdx.x & 3;
  for (int base = 0; base < g; base += RP_THREADS / 4) {
    const int i = base + (threadIdx.x >> 2);
    float sx = 0.0f, sy = 0.0f, sz = 0.0f;
    if (i < g) {
      const float xi = cl.ox[i], yi = cl.oy[i], zi = cl.oz[i], wi = cl.ow[i];
      const int idi = cl.oid[i];
      for (int j = q; j < wg; j += 4) {
        const float dx = xi - cl.nx[j], dy = yi - cl.ny[j], dz = zi - cl.nz[j];
        const float coef = pair_coef(sq3(dx, dy, dz),
                                     idi == cl.nid[j] ? 100.0f : 0.0f,
                                     wi * cl.nw[j], gbar);
        sx += coef * dx;
        sy += coef * dy;
        sz += coef * dz;
      }
      if (include_far) {
        for (int a = q; a < ca; a += 4) {
          const float dx = xi - cents[a], dy = yi - cents[ca + a],
                      dz = zi - cents[2 * ca + a];
          const float coef = pair_coef(sq3(dx, dy, dz), 0.0f, wi * fwc[a],
                                       gbar);
          sx += coef * dx;
          sy += coef * dy;
          sz += coef * dz;
        }
      }
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      sx += __shfl_xor_sync(FULL_MASK, sx, o);
      sy += __shfl_xor_sync(FULL_MASK, sy, o);
      sz += __shfl_xor_sync(FULL_MASK, sz, o);
    }
    if (i < g && q == 0) {
      const size_t o = (size_t)c * g + i;
      dcs[o] = sx;
      dcs[plane_g + o] = sy;
      dcs[2 * plane_g + o] = sz;
    }
  }

  // Column pass: d_neighbor_members, one thread per neighbor member j.
  for (int j = threadIdx.x; j < wg; j += blockDim.x) {
    const float xj = cl.nx[j], yj = cl.ny[j], zj = cl.nz[j], wj = cl.nw[j];
    const int idj = cl.nid[j];
    float sx = 0.0f, sy = 0.0f, sz = 0.0f;
    for (int i = 0; i < g; ++i) {
      const float dx = cl.ox[i] - xj, dy = cl.oy[i] - yj, dz = cl.oz[i] - zj;
      const float coef = pair_coef(sq3(dx, dy, dz),
                                   cl.oid[i] == idj ? 100.0f : 0.0f,
                                   cl.ow[i] * wj, gbar);
      sx += coef * dx;
      sy += coef * dy;
      sz += coef * dz;
    }
    const size_t o = (size_t)c * wg + j;
    dnbcs[o] = -sx;
    dnbcs[plane_wg + o] = -sy;
    dnbcs[2 * plane_wg + o] = -sz;
  }

  // Column pass over centroids: this cluster's d_centroids partial row.
  if (include_far) {
    float* part = dcent_part + (size_t)c * 3 * ca;
    for (int a = threadIdx.x; a < ca; a += blockDim.x) {
      const float cx = cents[a], cy = cents[ca + a], cz = cents[2 * ca + a];
      const float fwa = fwc[a];
      float sx = 0.0f, sy = 0.0f, sz = 0.0f;
      for (int i = 0; i < g; ++i) {
        const float dx = cl.ox[i] - cx, dy = cl.oy[i] - cy, dz = cl.oz[i] - cz;
        const float coef = pair_coef(sq3(dx, dy, dz), 0.0f, cl.ow[i] * fwa,
                                     gbar);
        sx += coef * dx;
        sy += coef * dy;
        sz += coef * dz;
      }
      part[a] = -sx;
      part[ca + a] = -sy;
      part[2 * ca + a] = -sz;
    }
  }
}

// out[col] = sum over rows, in row order, of partial[row, col].
__global__ void rep_reduce_kernel(const float* __restrict__ partial, int rows,
                                  int cols, float* __restrict__ out) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= cols) return;
  float s = 0.0f;
  for (int r = 0; r < rows; ++r) s += partial[(size_t)r * cols + col];
  out[col] = s;
}

static size_t cluster_smem(int g, int wg) {
  return (size_t)5 * (g + wg) * sizeof(float);
}

template <class Kernel>
static cudaError_t allow_smem(Kernel* fn, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// partial [n_c]: each cluster's near (+ far) sum. Returns a CUDA error code.
extern "C" int rep_fwd_launch(const float* cs, const float* nbcs,
                              const float* cents, const float* w,
                              const float* nbw, const int* mi, const int* nbm,
                              const float* fw, int n_c, int g, int wg, int ca,
                              int include_far, float* partial, void* stream) {
  if (n_c < 1 || g < 1 || wg < 1 || ca < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = cluster_smem(g, wg);
  cudaError_t err = allow_smem(rep_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  rep_fwd_kernel<<<n_c, RP_THREADS, smem, (cudaStream_t)stream>>>(
      cs, nbcs, cents, w, nbw, mi, nbm, fw, n_c, g, wg, ca, include_far,
      partial);
  return (int)cudaGetLastError();
}

// gptr [1]: the upstream gradient of the sum. Writes dcs [3, n_c, g],
// dnbcs [3, n_c, wg] and, with include_far, dcent_part [n_c, 3, ca].
extern "C" int rep_bwd_launch(const float* cs, const float* nbcs,
                              const float* cents, const float* w,
                              const float* nbw, const int* mi, const int* nbm,
                              const float* fw, const float* gptr, int n_c,
                              int g, int wg, int ca, int include_far,
                              float* dcs, float* dnbcs, float* dcent_part,
                              void* stream) {
  if (n_c < 1 || g < 1 || wg < 1 || ca < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = cluster_smem(g, wg);
  cudaError_t err = allow_smem(rep_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  rep_bwd_kernel<<<n_c, RP_THREADS, smem, (cudaStream_t)stream>>>(
      cs, nbcs, cents, w, nbw, mi, nbm, fw, gptr, n_c, g, wg, ca, include_far,
      dcs, dnbcs, dcent_part);
  return (int)cudaGetLastError();
}

extern "C" int rep_reduce_launch(const float* partial, int rows, int cols,
                                 float* out, void* stream) {
  if (rows < 1 || cols < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((cols + RP_THREADS - 1) / RP_THREADS);
  rep_reduce_kernel<<<grid, RP_THREADS, 0, (cudaStream_t)stream>>>(
      partial, rows, cols, out);
  return (int)cudaGetLastError();
}
