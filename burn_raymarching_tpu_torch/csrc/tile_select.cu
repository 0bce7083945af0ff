// K7: flat per-tile primitive selection, one launch over a batch of ray
// tiles: each tile's bounding cone, every table row's score against it, and
// the tile's top-K table with its gathers.
//
// Replaces no TPU kernel. The JAX package leaves selection
// (ops/culling.py: tile_cones, select_tile_primitives, and the gathers of
// train/step_body.py::culled_tables) to XLA, which fuses it; the port ran it
// as ~60-70 eager PyTorch ops a batch of tiles: the cone, a dense [B, M]
// score, a stable sort of [B, M] and the gathers (~40 graph kernels and a
// segmented sort, 0.29 ms of a 1.35 ms config-4 step, and ~90 host launch
// calls a prefill batch, whose cold march the host could not keep fed).
// Per tile b of T rays (ro, rd) against the M rows (c, r, mask):
//   apex = mean ro, axis = mean rd / |mean rd|, cos_half = min rd.axis,
//   spread = max |ro - apex|                     (ops/culling.tile_cones)
//   score = cone_distance(c - apex) - r          (_cone_distance_core)
//   kept  = mask and score <= 22 / k + spread    (k in device memory)
//   out   = kept rows by (score, row), then the rows not kept by row, the
//           first min(K, M); valid = kept and finite; cs, rs the gathered
//           rows; qs = |c|^2 on valid slots, 1e30 elsewhere
// which is what the stable sort of the plain version gives. The score
// repeats the plain version's operations in its order, each rounded on its
// own (no contracted multiply-adds; IEEE sqrt and divide), so given the same
// cone it gives the plain scores; the cone's two means are summed in another
// order than PyTorch's reduction and may differ by rounding.
//
// What bounds it: neither bytes nor operations at the step's shapes. Per
// tile it reads the table once (16 bytes a row, from L2 after the first
// tile) and writes K slots of 29 bytes; per row ~30 FP32 operations, 2
// sqrt and 1 divide. At config 4 (32 tiles, M = 8,192, K = 2,048) that is
// ~0.7 us of bytes and less of operations, while one block a tile leaves
// 100 of the 132 SMs idle and the fullest tile (~1,100 kept rows) sets the
// time: measured on an H100, 0.026 ms, of which that block spends ~48% in
// the sort, ~26% in the pass over the rows, ~15% on the cone and ~9% on the
// writes (clock64 stamps). Design:
// (a) a block a tile, TS_THREADS threads: the cone is two block reductions
//     over the tile's rays in a fixed order (bitwise repeatable);
// (b) one pass over the rows in index order, TS_ROWS consecutive rows a
//     thread, scores in registers: a block-wide scan of (kept, not kept)
//     counts compacts the kept rows into shared memory as 64-bit keys
//     (orderable score << 32 | row) in row order, and the first K rows not
//     kept into a second shared array. No [B, M] tensor is written;
// (c) when at most K rows are kept (cull_fill ~10% at config 4: ~200 of
//     2,048 slots), a bitonic sort of the kept keys, padded to a power of
//     two, gives the table (strides below 64 in registers with warp
//     shuffles, the longer ones in shared memory: a third of the barriers
//     of an all-shared sort); the not-kept rows fill its tail in row order;
// (d) when more than K are kept (stage 0's 5,120 seeded spheres, whose
//     cloud init ties exactly at -radius inside a cone), a radix select of
//     the 32-bit score keys (four 8-bit digits, warp-aggregated shared
//     histograms) finds the K-th score; the rows below it and the first of
//     those equal to it, in row order, are compacted and sorted. The kept
//     keys are read from shared memory when they fit in it (TS_MIN_KEYS or
//     more), and rescored from the table when they do not;
// (e) the K slots are written with coalesced stores, each gathering its row.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define TS_THREADS 1024
#define TS_WARPS (TS_THREADS / 32)
// Consecutive rows a thread takes in each ordered pass: a chunk of the pass
// is TS_THREADS * TS_ROWS rows.
#define TS_ROWS 4
#define TS_CHUNK (TS_THREADS * TS_ROWS)
// Kept keys shared memory holds at least (64 KB); more when K is larger.
#define TS_MIN_KEYS 8192
// The largest K: keys and tail rows fill 192 KB of shared memory.
#define TS_MAX_K 16384
// exp(-22): the plain version's CULL_MARGIN (ops/culling.py).
#define TS_CULL_MARGIN 22.0f

typedef unsigned long long u64;

struct Cone {
  float px, py, pz;  // apex
  float ax, ay, az;  // unit axis
  float cost, sint;  // cos and sin of the half-angle
  float cutoff;      // 22 / k + spread
  float spread;
};

struct Scratch {
  float red[8][TS_WARPS];
  int warp_tot[TS_WARPS + 1];
  unsigned hist[256];
  int pick[2];  // radix select: the digit and the count below it
  Cone cone;
};

// torch.clamp: NaN passes through.
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);
}

// A sum over a last dimension of 3 as PyTorch's CUDA reduction takes it: two
// lanes, the first adding elements 0 and 2, then the second's element 1.
__device__ __forceinline__ float sum3(float a, float b, float c) {
  return __fadd_rn(__fadd_rn(a, c), b);
}

// The score of one row: _cone_distance_core(cone, c - apex) - r.
__device__ __forceinline__ float cone_score(const Cone& q, float cx, float cy,
                                            float cz, float r) {
  const float vx = __fsub_rn(cx, q.px), vy = __fsub_rn(cy, q.py),
              vz = __fsub_rn(cz, q.pz);
  const float len = __fsqrt_rn(
      sum3(__fmul_rn(vx, vx), __fmul_rn(vy, vy), __fmul_rn(vz, vz)));
  const float proj =
      sum3(__fmul_rn(vx, q.ax), __fmul_rn(vy, q.ay), __fmul_rn(vz, q.az));
  const float cosa =
      clampf(__fdiv_rn(proj, clamp_min(len, 1e-12f)), -1.0f, 1.0f);
  const float sina =
      __fsqrt_rn(clamp_min(__fsub_rn(1.0f, __fmul_rn(cosa, cosa)), 0.0f));
  const float sin_out = clamp_min(
      __fsub_rn(__fmul_rn(sina, q.cost), __fmul_rn(cosa, q.sint)), 0.0f);
  const float cos_diff =
      __fadd_rn(__fmul_rn(cosa, q.cost), __fmul_rn(sina, q.sint));
  float d = cos_diff < 0.0f ? len : __fmul_rn(len, sin_out);
  if (len < 1e-9f) d = 0.0f;
  return __fsub_rn(d, r);
}

// Ascending float order as unsigned order; -0 counts as +0.
__device__ __forceinline__ unsigned order_key(float s) {
  const unsigned u = __float_as_uint(__fadd_rn(s, 0.0f));
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// The table rows the kernel reads.
struct Table {
  const float* __restrict__ c;            // [M, 3]
  const float* __restrict__ r;            // [M]
  const unsigned char* __restrict__ mask;  // [M] or null
  int m;
};

// Row i's key: true (and its orderable score) if the row is kept, i.e. live,
// within the cutoff and ranked below +inf as the plain version ranks it.
__device__ __forceinline__ bool row_key(const Table& tab, const Cone& q, int i,
                                        unsigned& key) {
  const float s = cone_score(q, tab.c[3 * i], tab.c[3 * i + 1],
                             tab.c[3 * i + 2], tab.r[i]);
  const bool kept = s <= q.cutoff && s != INFINITY &&
                    (tab.mask == nullptr || tab.mask[i] != 0);
  key = order_key(s);
  return kept;
}

__device__ __forceinline__ int warp_incl_scan(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

// Exclusive prefix sum of v over the block's threads in order; the block's
// total in ``total``. Every thread of the block calls it.
__device__ int block_excl_scan(int v, Scratch& sh, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int incl = warp_incl_scan(v);
  if (lane == 31) sh.warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = sh.warp_tot[lane];
    const int wi = warp_incl_scan(w);
    sh.warp_tot[lane] = wi - w;
    if (lane == 31) sh.warp_tot[TS_WARPS] = wi;
  }
  __syncthreads();
  total = sh.warp_tot[TS_WARPS];
  const int excl = sh.warp_tot[warp] + incl - v;
  __syncthreads();
  return excl;
}

// Sum (op 0), min (1) or max (2): a NaN wins min and max, as in PyTorch.
template <int OP>
__device__ __forceinline__ float comb(float a, float b) {
  if (OP == 0) return __fadd_rn(a, b);
  if (a != a || b != b) return a != a ? a : b;
  return OP == 1 ? fminf(a, b) : fmaxf(a, b);
}

template <int OP>
__device__ __forceinline__ float warp_reduce(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = comb<OP>(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;
}

// v[a] combined over the block with OP0 for a < n0 and OP1 for the rest,
// in a fixed order (each warp's lanes, then the warps), into every thread:
// one barrier for all of them.
template <int N, int OP0, int OP1>
__device__ void block_reduce(float (&v)[N], int n0, Scratch& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int a = 0; a < N; ++a) {
    v[a] = a < n0 ? warp_reduce<OP0>(v[a]) : warp_reduce<OP1>(v[a]);
    if (lane == 0) sh.red[a][warp] = v[a];
  }
  __syncthreads();
#pragma unroll
  for (int a = 0; a < N; ++a) {
    const float w = sh.red[a][lane];
    v[a] = __shfl_sync(0xffffffffu,
                       a < n0 ? warp_reduce<OP0>(w) : warp_reduce<OP1>(w), 0);
  }
  __syncthreads();
}

// Tile b's cone (ops/culling.tile_cones), into sh.cone.
__device__ void tile_cone(const float* __restrict__ ro,
                          const float* __restrict__ rd, int t_rays,
                          const float* __restrict__ k, Scratch& sh) {
  float s[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int i = threadIdx.x; i < t_rays; i += TS_THREADS) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      s[a] = __fadd_rn(s[a], ro[3 * i + a]);
      s[3 + a] = __fadd_rn(s[3 + a], rd[3 * i + a]);
    }
  }
  block_reduce<6, 0, 0>(s, 6, sh);
  float mean[6];
  const float n = (float)t_rays;
#pragma unroll
  for (int a = 0; a < 6; ++a) mean[a] = __fdiv_rn(s[a], n);
  const float nrm = clamp_min(
      __fsqrt_rn(sum3(__fmul_rn(mean[3], mean[3]), __fmul_rn(mean[4], mean[4]),
                      __fmul_rn(mean[5], mean[5]))),
      1e-12f);
  const float ax = __fdiv_rn(mean[3], nrm), ay = __fdiv_rn(mean[4], nrm),
              az = __fdiv_rn(mean[5], nrm);
  float ext[2] = {INFINITY, -INFINITY};  // min of rd.axis, max |ro - apex|
  for (int i = threadIdx.x; i < t_rays; i += TS_THREADS) {
    const float dot =
        sum3(__fmul_rn(rd[3 * i], ax), __fmul_rn(rd[3 * i + 1], ay),
             __fmul_rn(rd[3 * i + 2], az));
    const float dx = __fsub_rn(ro[3 * i], mean[0]),
                dy = __fsub_rn(ro[3 * i + 1], mean[1]),
                dz = __fsub_rn(ro[3 * i + 2], mean[2]);
    const float dist = __fsqrt_rn(
        sum3(__fmul_rn(dx, dx), __fmul_rn(dy, dy), __fmul_rn(dz, dz)));
    ext[0] = comb<1>(ext[0], dot);
    ext[1] = comb<2>(ext[1], dist);
  }
  block_reduce<2, 1, 2>(ext, 1, sh);
  const float lo = ext[0], hi = ext[1];
  if (threadIdx.x == 0) {
    Cone q;
    q.px = mean[0];
    q.py = mean[1];
    q.pz = mean[2];
    q.ax = ax;
    q.ay = ay;
    q.az = az;
    q.cost = clampf(lo, -1.0f, 1.0f);
    q.sint = __fsqrt_rn(
        clamp_min(__fsub_rn(1.0f, __fmul_rn(q.cost, q.cost)), 0.0f));
    // CULL_MARGIN / smooth_k as PyTorch divides a number by a tensor:
    // reciprocal, then multiply.
    q.cutoff = __fadd_rn(__fmul_rn(__frcp_rn(k[0]), TS_CULL_MARGIN), hi);
    q.spread = hi;
    sh.cone = q;
  }
  __syncthreads();
}

// Sources of kept keys for the radix select: the kept keys in shared memory
// (row order), or every table row rescored (kept ones only).
struct SharedKeys {
  const u64* keys;
  int n;
  __device__ bool get(int i, unsigned& key, int& row) const {
    const u64 e = keys[i];
    key = (unsigned)(e >> 32);
    row = (int)(e & 0xffffffffu);
    return true;
  }
};

struct Rescored {
  Table tab;
  const Cone* q;
  int n;
  __device__ bool get(int i, unsigned& key, int& row) const {
    row = i;
    return row_key(tab, *q, i, key);
  }
};

// The kept keys that rank among the K smallest by (score, row) → keys[0, K)
// in row order. src.n items, more than K of them kept.
template <class Src>
__device__ void select_k(const Src& src, int kk, u64* keys, Scratch& sh) {
  const int lane = threadIdx.x & 31;
  unsigned prefix = 0, pmask = 0;
  int want = kk;  // rank, among keys matching the prefix, of the K-th
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = threadIdx.x; i < 256; i += TS_THREADS) sh.hist[i] = 0;
    __syncthreads();
    for (int i0 = 0; i0 < src.n; i0 += TS_THREADS) {
      const int i = i0 + threadIdx.x;
      unsigned key = 0;
      int row;
      bool act = i < src.n && src.get(i, key, row) && (key & pmask) == prefix;
      const int digit = act ? (int)((key >> shift) & 255u) : -1;
      const unsigned peers = __match_any_sync(0xffffffffu, digit);
      if (act && lane == __ffs(peers) - 1)
        atomicAdd(&sh.hist[digit], (unsigned)__popc(peers));
    }
    __syncthreads();
    if (threadIdx.x < 32) {
      // Lane l holds bins 8l .. 8l + 7.
      int mine = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) mine += (int)sh.hist[8 * lane + j];
      const int incl = warp_incl_scan(mine);
      const int excl = incl - mine;
      if (excl < want && want <= incl) {
        int below = excl, d = 8 * lane;
        while (below + (int)sh.hist[d] < want) below += (int)sh.hist[d++];
        sh.pick[0] = d;
        sh.pick[1] = below;
      }
    }
    __syncthreads();
    prefix |= (unsigned)sh.pick[0] << shift;
    pmask |= 255u << shift;
    want -= sh.pick[1];
    __syncthreads();
  }
  // prefix is the K-th key; take every key below it and the first ``want``
  // equal to it, in order. Each chunk is read whole before it is written,
  // and a key never moves up, so keys may be the source's own array.
  int base = 0, eq_base = 0;
  for (int c0 = 0; c0 < src.n; c0 += TS_CHUNK) {
    u64 e[TS_ROWS];
    int lt = 0, eq = 0;
    unsigned char kind[TS_ROWS];  // 0 skip, 1 below, 2 equal
#pragma unroll
    for (int j = 0; j < TS_ROWS; ++j) {
      const int i = c0 + threadIdx.x * TS_ROWS + j;
      unsigned key = 0;
      int row = 0;
      kind[j] = 0;
      if (i < src.n && src.get(i, key, row)) {
        e[j] = ((u64)key << 32) | (unsigned)row;
        if (key < prefix) {
          kind[j] = 1;
          ++lt;
        } else if (key == prefix) {
          kind[j] = 2;
          ++eq;
        }
      }
    }
    int total;
    const int excl = block_excl_scan(lt | (eq << 16), sh, total);
    int pos_eq = eq_base + (excl >> 16);
    int pos = base + (excl & 0xffff);
    // Below and taken-equal keys interleave in row order: a slot is the
    // count of earlier taken keys.
    int taken_eq_before = min(pos_eq, want);
    int out = pos + taken_eq_before;
#pragma unroll
    for (int j = 0; j < TS_ROWS; ++j) {
      if (kind[j] == 1) {
        keys[out++] = e[j];
      } else if (kind[j] == 2) {
        if (pos_eq < want) keys[out++] = e[j];
        ++pos_eq;
      }
    }
    base += total & 0xffff;
    eq_base += total >> 16;
    __syncthreads();
  }
}

// One compare-exchange step of the bitonic network on a warp's 64-key
// segment held in registers: lane l holds keys base + l (a) and base + 32 + l
// (b). Stride j < 32 pairs lanes l and l ^ j; j = 32 pairs a with b. The
// pair is put in ascending order where its lower index has bit ``size``
// clear.
__device__ __forceinline__ void bitonic_regs(u64& a, u64& b, int base,
                                             int size, int j) {
  const int lane = threadIdx.x & 31;
  if (j == 32) {
    const bool up = ((base + lane) & size) == 0;
    const u64 lo = a < b ? a : b, hi = a < b ? b : a;
    a = up ? lo : hi;
    b = up ? hi : lo;
    return;
  }
  const bool lower = (lane & j) == 0;
  const u64 pa = __shfl_xor_sync(0xffffffffu, a, j);
  const u64 pb = __shfl_xor_sync(0xffffffffu, b, j);
  const bool min_a = lower == (((base + lane) & size) == 0);
  const bool min_b = lower == (((base + 32 + lane) & size) == 0);
  a = min_a == (pa < a) ? pa : a;
  b = min_b == (pb < b) ? pb : b;
}

// Ascending bitonic sort of keys[0, n2), n2 a power of two, at least 64.
// Strides below 64 run in registers, a warp a 64-key segment, with no
// barrier; the longer ones in shared memory, a barrier each.
__device__ void bitonic_sort(u64* keys, int n2) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int size = 64; size <= n2; size <<= 1) {
    for (int j = size >> 1; j >= 64; j >>= 1) {
      for (int p = threadIdx.x; p < (n2 >> 1); p += TS_THREADS) {
        // The p-th pair's lower index: p with a zero bit inserted at j.
        const int i = 2 * p - (p & (j - 1)), l = i + j;
        const u64 x = keys[i], y = keys[l];
        if ((x > y) == ((i & size) == 0)) {
          keys[i] = y;
          keys[l] = x;
        }
      }
      __syncthreads();
    }
    for (int base = 64 * warp; base < n2; base += 64 * TS_WARPS) {
      u64 a = keys[base + lane], b = keys[base + 32 + lane];
      // The first pass also builds the sorted runs of 2 to 32 keys.
      for (int sz = size == 64 ? 2 : size; sz <= size; sz <<= 1)
        for (int j = (sz == size ? 32 : sz >> 1); j > 0; j >>= 1)
          bitonic_regs(a, b, base, sz, j);
      keys[base + lane] = a;
      keys[base + 32 + lane] = b;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(TS_THREADS, 1)
    tile_select_kernel(const float* __restrict__ ro,
                       const float* __restrict__ rd, int t_rays, Table tab,
                       const float* __restrict__ k, int kk, int n_keys,
                       long long* __restrict__ idx,
                       unsigned char* __restrict__ valid,
                       float* __restrict__ cs, float* __restrict__ rs,
                       float* __restrict__ qs, float* __restrict__ cones) {
  extern __shared__ u64 keys[];              // [n_keys]
  int* tail = (int*)(keys + n_keys);         // [kk]
  __shared__ Scratch sh;
  const int b = blockIdx.x;
  tile_cone(ro + (size_t)b * t_rays * 3, rd + (size_t)b * t_rays * 3, t_rays,
            k, sh);
  const Cone q = sh.cone;

  // (b) One ordered pass: kept keys and the first K rows not kept.
  int n_kept = 0, n_free = 0;
  for (int c0 = 0; c0 < tab.m; c0 += TS_CHUNK) {
    u64 e[TS_ROWS];
    unsigned char kind[TS_ROWS];  // 0 none, 1 kept, 2 not kept
    int nk = 0, nf = 0;
#pragma unroll
    for (int j = 0; j < TS_ROWS; ++j) {
      const int i = c0 + threadIdx.x * TS_ROWS + j;
      kind[j] = 0;
      if (i < tab.m) {
        unsigned key;
        if (row_key(tab, q, i, key)) {
          e[j] = ((u64)key << 32) | (unsigned)i;
          kind[j] = 1;
          ++nk;
        } else {
          e[j] = (u64)i;
          kind[j] = 2;
          ++nf;
        }
      }
    }
    int total;
    const int excl = block_excl_scan(nk | (nf << 16), sh, total);
    int pk = n_kept + (excl & 0xffff), pf = n_free + (excl >> 16);
#pragma unroll
    for (int j = 0; j < TS_ROWS; ++j) {
      if (kind[j] == 1) {
        if (pk < n_keys) keys[pk] = e[j];
        ++pk;
      } else if (kind[j] == 2) {
        if (pf < kk) tail[pf] = (int)e[j];
        ++pf;
      }
    }
    n_kept += total & 0xffff;
    n_free += total >> 16;
  }
  __syncthreads();

  // (c) / (d) The table's kept part: n_sel keys in keys[0, n_sel).
  int n_sel = n_kept;
  if (n_kept > kk) {
    if (n_kept <= n_keys) {
      select_k(SharedKeys{keys, n_kept}, kk, keys, sh);
    } else {
      select_k(Rescored{tab, &sh.cone, tab.m}, kk, keys, sh);
    }
    n_sel = kk;
  }
  int n2 = 64;
  while (n2 < n_sel) n2 <<= 1;
  for (int i = n_sel + threadIdx.x; i < n2; i += TS_THREADS) keys[i] = ~0ull;
  __syncthreads();
  bitonic_sort(keys, n2);

  // (e) The K slots.
  const size_t o = (size_t)b * kk;
  for (int s = threadIdx.x; s < kk; s += TS_THREADS) {
    int row;
    bool v = false;
    if (s < n_sel) {
      const u64 e = keys[s];
      row = (int)(e & 0xffffffffu);
      v = isfinite(key_value((unsigned)(e >> 32)));
    } else {
      row = tail[s - n_sel];
    }
    const float cx = tab.c[3 * row], cy = tab.c[3 * row + 1],
                cz = tab.c[3 * row + 2];
    idx[o + s] = row;
    valid[o + s] = v;
    cs[3 * (o + s)] = cx;
    cs[3 * (o + s) + 1] = cy;
    cs[3 * (o + s) + 2] = cz;
    rs[o + s] = tab.r[row];
    qs[o + s] = v ? sum3(__fmul_rn(cx, cx), __fmul_rn(cy, cy),
                         __fmul_rn(cz, cz))
                  : 1e30f;
  }
  if (cones != nullptr && threadIdx.x == 0) {
    float* out = cones + 8 * b;
    out[0] = q.px;
    out[1] = q.py;
    out[2] = q.pz;
    out[3] = q.ax;
    out[4] = q.ay;
    out[5] = q.az;
    out[6] = q.cost;
    out[7] = q.spread;
  }
}

// Shared memory of one block for K = kk: the kept keys, at least
// TS_MIN_KEYS and a power of two at least kk, then kk tail rows.
static int tile_select_keys(int kk) {
  int n = TS_MIN_KEYS;
  while (n < kk) n <<= 1;
  return n;
}

// ro, rd [b_tiles * t_rays, 3]; centers [m, 3], radii [m], mask [m] bytes or
// null; k [1] the soft-min sharpness in device memory, read when the kernel
// runs; kk = min(K, m) slots a tile. Writes idx [b, kk] int64, valid [b, kk]
// bytes, cs [b, kk, 3], rs [b, kk], qs [b, kk] and, if not null, cones
// [b, 8] (apex, axis, cos_half, spread). Returns a CUDA error code.
extern "C" int tile_select_launch(const float* ro, const float* rd,
                                  int b_tiles, int t_rays,
                                  const float* centers, const float* radii,
                                  const unsigned char* mask, int m,
                                  const float* k, int kk, long long* idx,
                                  unsigned char* valid, float* cs, float* rs,
                                  float* qs, float* cones, void* stream) {
  if (b_tiles < 1 || t_rays < 1 || m < 1 || kk < 1 || kk > m ||
      kk > TS_MAX_K)
    return (int)cudaErrorInvalidValue;
  const int n_keys = tile_select_keys(kk);
  const size_t smem = (size_t)n_keys * sizeof(u64) + (size_t)kk * sizeof(int);
  // The largest dynamic shared memory allowed so far, per device: set once,
  // before a graph capture finds the launch (the warm-up step runs first).
  static size_t allowed[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && smem > allowed[dev]) {
    err = cudaFuncSetAttribute(tile_select_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    allowed[dev] = smem;
  }
  const Table tab{centers, radii, mask, m};
  tile_select_kernel<<<b_tiles, TS_THREADS, smem, (cudaStream_t)stream>>>(
      ro, rd, t_rays, tab, k, kk, n_keys, idx, valid, cs, rs, qs, cones);
  return (int)cudaGetLastError();
}
