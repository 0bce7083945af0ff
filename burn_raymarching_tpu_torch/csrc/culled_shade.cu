// K6: the culled training step's gradient-carrying tail, one forward launch
// and one backward launch over each tile's live table columns.
//
// Replaces no TPU kernel. The JAX package leaves this tail
// (render/culled.py::render_diff_culled given ``precomputed``, model axis
// None) to XLA, which fuses it; the port ran it as eager autograd over
// [B, T, K] float32 tensors (32 x 512 x 2,048 at config 4, 134 MB each):
// three distance evaluations, a softmax and a bmm, each a pass over such a
// tensor, all kept for the backward, 7.8 of the 8.6 ms of a config-4 step,
// for work of ~5 SFU operations forward and ~7 backward per (ray, valid
// slot) pair. Per ray of tile b, with t and the normal from the detached K3
// march, against the tile's table (centers, colours, radii, valid):
//   dist_last = softmin_k(D(p0)),  p0 = ro + rd t          (reattachment)
//   p         = ro + rd (t + dist_last)
//   lighting  = amb + max(n.l^, 0) (1 - amb)
//   D         = D(p)  -- one row shared by
//   mix       = softmax(-a D) . colours  and  cov = sigmoid(-c softmin_k(D))
//   out       = mix lighting cov
// with a, c the softmax and mask sharpness (arguments; config 4 trains at 40
// and 60) and k read from device memory when the kernel runs, so a captured
// graph replays at any step. Invalid slots weigh exactly 0 (their |c|^2 is
// 1e30, as the plain version's) and get exactly 0 gradient; a tile with no
// valid slot shades 0 (its coverage is sigmoid(-c 1e15)) and gets none.
//
// What bounds it: the SFU, not bytes. A ray is 13 floats in, 3 out and 8
// saved, a table column 7 floats; per (ray, valid slot) pair the forward
// needs 2 sqrt and 3 exp, the backward 3 sqrt, 5 exp and 2 divides. At
// config 4 (16,384 rays x ~221 valid slots a tile) that is ~10 us of SFU
// time at any precision, so the per-pair sqrt and exp are the accurate
// sqrtf / expf (the SFU's approximate forms measured 0.007 ms faster forward
// and 0.03 ms backward at config 4's tiles on an H100: under 2% of a step's
// wall time, so not taken). Design:
// (a) a block per CT_RAYS rays of a tile: 32 blocks a 512-ray tile, 1,024 at
//     config 4, where a block a tile would leave 100 of the 132 SMs idle.
//     The tiles' live columns differ (1 to 1,096 of 2,048 at config 4), so
//     the launch ends with the blocks of the fullest tile: measured at 8,
//     16, 32 and 64 rays a block, 16 was fastest (forward 0.040 ms,
//     backward 0.135 ms; 32: 0.048 and 0.174). Every block stages its tile's
//     live columns (up to the last valid slot, as K3 counts them; the
//     selection puts the valid slots first) in shared memory as float4 (c,
//     |c|^2) and float4 (r, colour), CT_CHUNK columns at a time: 32 KB, and
//     a tile with more live columns is staged chunk by chunk;
// (b) forward: CT_LANES lanes a ray stride over the columns, two passes with
//     online minima (as K2): pass 1 the soft-min at p0; pass 2 at p, one
//     distance feeding the softmax and the soft-min. Saved per ray: the
//     (minimum, sum) pairs and mix; the rest is recomputed from them;
// (c) backward, ray-major first: per ray the row sums that give dL/dp (at
//     p), hence the reattachment's scale; the per-ray scalars go to shared
//     memory. Then column-major: each thread owns columns and walks the
//     block's rays, recomputing the two distances (p and p0) with its seven
//     gradient sums in registers, so a slot's sum over rays needs no shuffle,
//     no shared-memory read-modify-write and no atomic (K2's backward, lanes
//     over columns, spends most of its time on shared-memory adds);
// (d) the per-block rows of a tile are summed in block order by the block
//     that draws the tile's last ticket; the light and ambient rows of all
//     blocks by the block that draws the launch's last ticket, each thread
//     a strided share in order and then a fixed tree over the threads (one
//     thread alone took ~0.03 ms over 512 rows), which also projects d_l^
//     onto d_light (common.cuh's last_ticket). No float atomics: the
//     gradients are bitwise repeatable.
#include "common.cuh"

#define CT_RAYS 16
#define CT_LANES 16
#define CT_THREADS (CT_RAYS * CT_LANES)
#define CT_CHUNK 1024
// Floats saved per ray by the forward: dmin0, s0, dmin, s_a, s_k, mix.
#define CT_STATE 8
// float4s of per-ray scalars that the backward's column pass reads.
#define CT_RAY_F4 5

// One tile's table: the global rows of tile b, and their staged copy.
struct TileTable {
  const float* __restrict__ c;            // [K, 3]
  const float* __restrict__ col;          // [K, 3]
  const float* __restrict__ r;            // [K]
  const unsigned char* __restrict__ v;    // [K]
  float4* cq;  // (cx, cy, cz, |c|^2 or 1e30)
  float4* rc;  // (r, colR, colG, colB)
  int n;       // columns to visit: 1 + the last valid slot, 0 if none
  int cap;
  bool resident;

  __device__ __forceinline__ bool live(int j) const { return v[j] != 0; }

  // Stages columns [c0, c0 + len). Every thread of the block must call it:
  // it synchronises before and after.
  __device__ __forceinline__ void stage(int c0, int len) const {
    __syncthreads();
    for (int j = threadIdx.x; j < len; j += blockDim.x) {
      const int o = c0 + j;
      const float x = c[3 * o], y = c[3 * o + 1], z = c[3 * o + 2];
      cq[j] = make_float4(x, y, z, v[o] ? sq_norm3(x, y, z) : 1e30f);
      rc[j] = make_float4(r[o], col[3 * o], col[3 * o + 1], col[3 * o + 2]);
    }
    __syncthreads();
  }

  // The chunk of columns from c0 staged (unless resident) → its length.
  __device__ __forceinline__ int chunk(int c0) const {
    const int len = min(cap, n - c0);
    if (!resident) stage(c0, len);
    return len;
  }
};

// Points the table at tile b, counts its live columns and stages them when
// they fit. Every thread of the block must call it.
__device__ __forceinline__ void open_tile(TileTable& tb, int b, int k_slots,
                                          const float* centers,
                                          const float* colors,
                                          const float* radii,
                                          const unsigned char* valid,
                                          float4* smem, int* scratch) {
  const size_t o = (size_t)b * k_slots;
  tb.c = centers + 3 * o;
  tb.col = colors + 3 * o;
  tb.r = radii + o;
  tb.v = valid + o;
  tb.cap = min(k_slots, CT_CHUNK);
  tb.cq = smem;
  tb.rc = smem + tb.cap;
  tb.n = live_columns(tb, k_slots, scratch);
  tb.resident = tb.n <= tb.cap;
  if (tb.resident && tb.n > 0) tb.stage(0, tb.n);
}

// Surface distance sqrt(max(q, 1e-6)) - r by the expanded form; *q gets the
// unclamped q and *sq the root.
__device__ __forceinline__ float tail_dist(const float4 c, float r, float px,
                                           float py, float pz, float psq,
                                           float* q, float* sq) {
  *q = expanded_q(px, py, pz, psq, c.x, c.y, c.z, c.w);
  *sq = sqrtf(fmaxf(*q, 1e-6f));
  return *sq - r;
}

// (log(s) + dmin (-k)) / (-k): the soft-min from its minimum and its sum.
__device__ __forceinline__ float softmin_of(float dmin, float s, float k) {
  return (logf(s) + dmin * (-k)) / (-k);
}

struct Light {
  float x, y, z, norm, amb;  // l^ = l / |l|, |l|, ambient
};

__device__ __forceinline__ Light read_light(const float* __restrict__ light,
                                            const float* __restrict__ ambient) {
  Light l;
  const float x = light[0], y = light[1], z = light[2];
  l.norm = sqrtf(sq_norm3(x, y, z));
  l.x = x / l.norm, l.y = y / l.norm, l.z = z / l.norm;
  l.amb = ambient[0];
  return l;
}

// One ray: the rays of a block are rays grp CT_RAYS + i of tile b; a lane
// group past the tile's last ray works on a copy of it and stores nothing.
struct RaySlot {
  size_t ray;
  bool store;
};

__device__ __forceinline__ RaySlot ray_slot(int b, int grp, int i,
                                            int t_rays) {
  const int r = grp * CT_RAYS + i;
  return {(size_t)b * t_rays + (r < t_rays ? r : t_rays - 1), r < t_rays};
}

// The forward's geometry of a ray: p0 and p with their |.|^2.
struct RayPoints {
  float p0x, p0y, p0z, p0sq, px, py, pz, psq;
};

__device__ __forceinline__ RayPoints ray_points(const float* __restrict__ ro,
                                                const float* __restrict__ rd,
                                                float t, size_t ray,
                                                float dist_last) {
  RayPoints p;
  const float ox = ro[3 * ray], oy = ro[3 * ray + 1], oz = ro[3 * ray + 2];
  const float dx = rd[3 * ray], dy = rd[3 * ray + 1], dz = rd[3 * ray + 2];
  p.p0x = ox + dx * t, p.p0y = oy + dy * t, p.p0z = oz + dz * t;
  p.p0sq = sq_norm3(p.p0x, p.p0y, p.p0z);
  const float t1 = t + dist_last;
  p.px = ox + dx * t1, p.py = oy + dy * t1, p.pz = oz + dz * t1;
  p.psq = sq_norm3(p.px, p.py, p.pz);
  return p;
}

// Pass 1 of lane g of a ray's CT_LANES lanes: the soft-min's (minimum, sum)
// at (x, y, z); every lane returns the same pair. Every thread of the block
// must call it (the table may be staged chunk by chunk).
__device__ __forceinline__ void softmin_pass(const TileTable& tb, int g,
                                             float x, float y, float z,
                                             float k, float* dmin,
                                             float* sum) {
  const float psq = sq_norm3(x, y, z);
  float dm = INFINITY, s = 0.0f, q, sq;
  for (int c0 = 0; c0 < tb.n; c0 += tb.cap) {
    const int len = tb.chunk(c0);
    for (int j = g; j < len; j += CT_LANES) {
      const float d = tail_dist(tb.cq[j], tb.rc[j].x, x, y, z, psq, &q, &sq);
      const float delta = d - dm;
      const float e = expf(-k * fabsf(delta));
      s = delta < 0.0f ? fmaf(s, e, 1.0f) : s + e;
      dm = fminf(dm, d);
    }
  }
  *dmin = group_min<CT_LANES>(dm);
  // A lane that saw no column holds (inf, 0): 0 * exp(-inf) = 0.
  *sum = fmaxf(group_sum<CT_LANES>(s * expf(-k * (dm - *dmin))), 1e-8f);
}

// Forward. grid (ceil(T / CT_RAYS), B), CT_THREADS threads, dynamic shared
// memory 2 min(K, CT_CHUNK) float4. out [B T, 3]; state [B T, CT_STATE].
__global__ void __launch_bounds__(CT_THREADS)
ctail_fwd_kernel(const float* __restrict__ ro, const float* __restrict__ rd,
                 const float* __restrict__ t, const float* __restrict__ nrm,
                 const float* __restrict__ centers,
                 const float* __restrict__ colors,
                 const float* __restrict__ radii,
                 const unsigned char* __restrict__ valid,
                 const float* __restrict__ light,
                 const float* __restrict__ ambient,
                 const float* __restrict__ kp, int t_rays, int k_slots,
                 float sharp_a, float sharp_c, float* __restrict__ out,
                 float* __restrict__ state) {
  extern __shared__ float4 smem[];
  __shared__ int n_live;
  const int b = blockIdx.y;
  const float k = __ldg(kp);
  TileTable tb;
  open_tile(tb, b, k_slots, centers, colors, radii, valid, smem, &n_live);
  const int g = threadIdx.x % CT_LANES;
  const RaySlot rs = ray_slot(b, blockIdx.x, threadIdx.x / CT_LANES, t_rays);
  const size_t ray = rs.ray;
  const bool writes = rs.store && g == 0;
  if (tb.n == 0) {
    if (writes) {
      for (int i = 0; i < 3; ++i) out[3 * ray + i] = 0.0f;
      for (int i = 0; i < CT_STATE; ++i) state[CT_STATE * ray + i] = 0.0f;
    }
    return;
  }
  const float tr = t[ray];
  float dmin0, s0;
  RayPoints pt = ray_points(ro, rd, tr, ray, 0.0f);
  softmin_pass(tb, g, pt.p0x, pt.p0y, pt.p0z, k, &dmin0, &s0);
  pt = ray_points(ro, rd, tr, ray, softmin_of(dmin0, s0, k));

  // Pass 2 at p: softmax(-a D) . colours and softmin_k(D) together. A
  // column at delta = d - dm adds e = exp(-rate |delta|) as s + e, or as
  // s e + 1 when it lowers the minimum; the colour sums follow s_a.
  float dm = INFINITY, sa = 0.0f, sk = 0.0f, c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;
  float q, sq;
  for (int ch = 0; ch < tb.n; ch += tb.cap) {
    const int len = tb.chunk(ch);
    for (int j = g; j < len; j += CT_LANES) {
      const float4 rc = tb.rc[j];
      const float d = tail_dist(tb.cq[j], rc.x, pt.px, pt.py, pt.pz, pt.psq,
                                &q, &sq);
      const float delta = d - dm;
      const float ea = expf(-sharp_a * fabsf(delta));
      const float ek = expf(-k * fabsf(delta));
      const bool lower = delta < 0.0f;
      // Old sums times a, the new column times w.
      const float a = lower ? ea : 1.0f, w = lower ? 1.0f : ea;
      sa = fmaf(sa, a, w);
      c0 = fmaf(c0, a, w * rc.y);
      c1 = fmaf(c1, a, w * rc.z);
      c2 = fmaf(c2, a, w * rc.w);
      sk = lower ? fmaf(sk, ek, 1.0f) : sk + ek;
      dm = fminf(dm, d);
    }
  }
  const float dmin = group_min<CT_LANES>(dm);
  const float ra = expf(-sharp_a * (dm - dmin));
  sa = group_sum<CT_LANES>(sa * ra);
  c0 = group_sum<CT_LANES>(c0 * ra);
  c1 = group_sum<CT_LANES>(c1 * ra);
  c2 = group_sum<CT_LANES>(c2 * ra);
  sk = fmaxf(group_sum<CT_LANES>(sk * expf(-k * (dm - dmin))), 1e-8f);
  if (!writes) return;
  const float mix0 = c0 / sa, mix1 = c1 / sa, mix2 = c2 / sa;
  const Light l = read_light(light, ambient);
  const float dot = (nrm[3 * ray] * l.x + nrm[3 * ray + 1] * l.y) +
                    nrm[3 * ray + 2] * l.z;
  const float lighting = l.amb + fmaxf(dot, 0.0f) * (1.0f - l.amb);
  const float cov = 1.0f / (1.0f + expf(softmin_of(dmin, sk, k) * sharp_c));
  out[3 * ray] = mix0 * lighting * cov;
  out[3 * ray + 1] = mix1 * lighting * cov;
  out[3 * ray + 2] = mix2 * lighting * cov;
  float* st = state + CT_STATE * ray;
  st[0] = dmin0, st[1] = s0, st[2] = dmin, st[3] = sa, st[4] = sk;
  st[5] = mix0, st[6] = mix1, st[7] = mix2;
}

// Backward. Grid and shared memory as the forward's. part [B, G, 7, K]:
// each block's sums (dcx, dcy, dcz, dr, dcolR, dcolG, dcolB; K each, the
// live columns written); lpart [B G, 4]: each block's d_l^ and d_ambient;
// tickets [B + 1], zero on entry and exit. Writes d_centers [B, K, 3],
// d_radii [B, K], d_colors [B, K, 3] (0 past the live columns), d_light [3]
// and d_ambient [1].
__global__ void __launch_bounds__(CT_THREADS)
ctail_bwd_kernel(const float* __restrict__ ro, const float* __restrict__ rd,
                 const float* __restrict__ t, const float* __restrict__ nrm,
                 const float* __restrict__ centers,
                 const float* __restrict__ colors,
                 const float* __restrict__ radii,
                 const unsigned char* __restrict__ valid,
                 const float* __restrict__ light,
                 const float* __restrict__ ambient,
                 const float* __restrict__ kp,
                 const float* __restrict__ state,
                 const float* __restrict__ gout, int t_rays, int k_slots,
                 float sharp_a, float sharp_c, float* __restrict__ part,
                 float* __restrict__ lpart, int* __restrict__ tickets,
                 float* __restrict__ d_centers, float* __restrict__ d_radii,
                 float* __restrict__ d_colors, float* __restrict__ d_light,
                 float* __restrict__ d_ambient) {
  extern __shared__ float4 smem[];
  __shared__ float4 rsc[CT_RAYS * CT_RAY_F4];
  __shared__ float lrow[CT_RAYS][4];
  __shared__ float4 red[CT_THREADS];
  __shared__ int n_live, flag;
  const int b = blockIdx.y, grp = blockIdx.x, groups = gridDim.x;
  const float k = __ldg(kp);
  TileTable tb;
  open_tile(tb, b, k_slots, centers, colors, radii, valid, smem, &n_live);
  const Light l = read_light(light, ambient);
  float* prow = part + (size_t)(b * groups + grp) * 7 * k_slots;

  if (tb.n > 0) {
    // Ray-major: CT_LANES lanes a ray.
    const int g = threadIdx.x % CT_LANES, i = threadIdx.x / CT_LANES;
    const RaySlot rs = ray_slot(b, grp, i, t_rays);
    const size_t ray = rs.ray;
    const float* st = state + CT_STATE * ray;
    const float dmin0 = st[0], s0 = st[1], dmin = st[2], sa = st[3];
    const float sk = st[4], mix0 = st[5], mix1 = st[6], mix2 = st[7];
    const RayPoints pt = ray_points(ro, rd, t[ray], ray,
                                    softmin_of(dmin0, s0, k));
    const float nx = nrm[3 * ray], ny = nrm[3 * ray + 1], nz = nrm[3 * ray + 2];
    const float dot = (nx * l.x + ny * l.y) + nz * l.z;
    const float diff = fmaxf(dot, 0.0f);
    const float lighting = l.amb + diff * (1.0f - l.amb);
    const float cov = 1.0f / (1.0f + expf(softmin_of(dmin, sk, k) * sharp_c));
    // A copy of the last ray takes a zero cotangent: it adds exactly 0.
    const float g0 = rs.store ? gout[3 * ray] : 0.0f;
    const float g1 = rs.store ? gout[3 * ray + 1] : 0.0f;
    const float g2 = rs.store ? gout[3 * ray + 2] : 0.0f;
    // out = mix lighting cov
    const float g_mix = (g0 * mix0 + g1 * mix1) + g2 * mix2;
    const float dm0 = g0 * lighting * cov, dm1 = g1 * lighting * cov,
                dm2 = g2 * lighting * cov;
    const float d_lighting = g_mix * cov, d_cov = g_mix * lighting;
    // lighting = amb + max(dot, 0) (1 - amb); the clamp passes dot >= 0.
    const float d_dot = dot >= 0.0f ? d_lighting * (1.0f - l.amb) : 0.0f;
    // sum_j w_j (dmix . col_j) = dmix . mix: no pass over the columns.
    const float wsum = (dm0 * mix0 + dm1 * mix1) + dm2 * mix2;
    const float d_ds = d_cov * (-sharp_c) * cov * (1.0f - cov);
    const float inv_sa = 1.0f / sa, inv_sk = 1.0f / sk;

    // Row sums at p: dL/dp = 2 (p sum_j dq_j - sum_j dq_j c_j).
    float sdq = 0.0f, sdqx = 0.0f, sdqy = 0.0f, sdqz = 0.0f, q, sq;
    for (int ch = 0; ch < tb.n; ch += tb.cap) {
      const int len = tb.chunk(ch);
      for (int j = g; j < len; j += CT_LANES) {
        const float4 c = tb.cq[j], rc = tb.rc[j];
        const float delta =
            tail_dist(c, rc.x, pt.px, pt.py, pt.pz, pt.psq, &q, &sq) - dmin;
        const float w = expf(-sharp_a * delta) * inv_sa;
        const float v = expf(-k * delta) * inv_sk;
        const float dw = (dm0 * rc.y + dm1 * rc.z) + dm2 * rc.w;
        const float d_d = -sharp_a * w * (dw - wsum) + d_ds * v;
        const float dq = q >= 1e-6f ? d_d * 0.5f / sq : 0.0f;
        sdq += dq;
        sdqx += dq * c.x;
        sdqy += dq * c.y;
        sdqz += dq * c.z;
      }
    }
    sdq = group_sum<CT_LANES>(sdq);
    const float dpx = 2.0f * (pt.px * sdq - group_sum<CT_LANES>(sdqx));
    const float dpy = 2.0f * (pt.py * sdq - group_sum<CT_LANES>(sdqy));
    const float dpz = 2.0f * (pt.pz * sdq - group_sum<CT_LANES>(sdqz));
    // dL/d dist_last = rd . dL/dp; dist_last's weights are exp(-k (d0 -
    // dmin0)) / s0.
    const float d_dl = (rd[3 * ray] * dpx + rd[3 * ray + 1] * dpy) +
                       rd[3 * ray + 2] * dpz;
    if (g == 0) {
      float4* r4 = rsc + CT_RAY_F4 * i;
      r4[0] = make_float4(pt.px, pt.py, pt.pz, pt.psq);
      r4[1] = make_float4(pt.p0x, pt.p0y, pt.p0z, pt.p0sq);
      r4[2] = make_float4(dmin, dmin0, inv_sa, inv_sk);
      r4[3] = make_float4(dm0, dm1, dm2, wsum);
      r4[4] = make_float4(d_ds, d_dl / s0, 0.0f, 0.0f);
      lrow[i][0] = d_dot * nx;
      lrow[i][1] = d_dot * ny;
      lrow[i][2] = d_dot * nz;
      lrow[i][3] = d_lighting * (1.0f - diff);
    }
    __syncthreads();

    // Column-major: each thread sums its columns' gradients over the
    // block's rays in ray order.
    for (int ch = 0; ch < tb.n; ch += tb.cap) {
      const int len = tb.chunk(ch);
      for (int j = threadIdx.x; j < len; j += blockDim.x) {
        const float4 c = tb.cq[j], rc = tb.rc[j];
        float acx = 0.0f, acy = 0.0f, acz = 0.0f, ar = 0.0f;
        float ac0 = 0.0f, ac1 = 0.0f, ac2 = 0.0f;
        if (c.w < MARCH_MASKED_CSQ) {
#pragma unroll 2
          for (int ri = 0; ri < CT_RAYS; ++ri) {
            const float4* r4 = rsc + CT_RAY_F4 * ri;
            const float4 p = r4[0], p0 = r4[1], m = r4[2], dmw = r4[3];
            const float4 e = r4[4];
            // At p: the softmax and the soft-min (radii, centers, colours).
            const float delta =
                tail_dist(c, rc.x, p.x, p.y, p.z, p.w, &q, &sq) - m.x;
            const float w = expf(-sharp_a * delta) * m.z;
            const float v = expf(-k * delta) * m.w;
            const float dw = (dmw.x * rc.y + dmw.y * rc.z) + dmw.z * rc.w;
            const float d_d = -sharp_a * w * (dw - dmw.w) + e.x * v;
            const float dq = q >= 1e-6f ? d_d * 0.5f / sq : 0.0f;
            acx += 2.0f * dq * (c.x - p.x);
            acy += 2.0f * dq * (c.y - p.y);
            acz += 2.0f * dq * (c.z - p.z);
            ar -= d_d;
            ac0 += w * dmw.x;
            ac1 += w * dmw.y;
            ac2 += w * dmw.z;
            // At the detached p0: the reattachment (radii, centers).
            const float d0 =
                tail_dist(c, rc.x, p0.x, p0.y, p0.z, p0.w, &q, &sq);
            const float dd0 = expf(-k * (d0 - m.y)) * e.y;
            const float dq0 = q >= 1e-6f ? dd0 * 0.5f / sq : 0.0f;
            acx += 2.0f * dq0 * (c.x - p0.x);
            acy += 2.0f * dq0 * (c.y - p0.y);
            acz += 2.0f * dq0 * (c.z - p0.z);
            ar -= dd0;
          }
        }
        float* dst = prow + ch + j;
        dst[0] = acx, dst[k_slots] = acy, dst[2 * k_slots] = acz;
        dst[3 * k_slots] = ar, dst[4 * k_slots] = ac0;
        dst[5 * k_slots] = ac1, dst[6 * k_slots] = ac2;
      }
    }
  }
  if (threadIdx.x == 0) {
    float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (tb.n > 0)
      for (int i = 0; i < CT_RAYS; ++i)
        for (int c = 0; c < 4; ++c) a[c] += lrow[i][c];
    float* dst = lpart + 4 * ((size_t)b * groups + grp);
    for (int c = 0; c < 4; ++c) dst[c] = a[c];
  }

  // The tile's rows in block order, by the block that comes last.
  if (last_ticket(tickets + b, groups, &flag)) {
    const float* rows = part + (size_t)b * groups * 7 * k_slots;
    for (int j = threadIdx.x; j < k_slots; j += blockDim.x) {
      float s[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      if (j < tb.n)
#pragma unroll 4
        for (int gg = 0; gg < groups; ++gg)
#pragma unroll
          for (int c = 0; c < 7; ++c)
            s[c] += __ldcg(rows + ((size_t)gg * 7 + c) * k_slots + j);
      const size_t o = (size_t)b * k_slots + j;
      d_centers[3 * o] = s[0], d_centers[3 * o + 1] = s[1];
      d_centers[3 * o + 2] = s[2];
      d_radii[o] = s[3];
      d_colors[3 * o] = s[4], d_colors[3 * o + 1] = s[5];
      d_colors[3 * o + 2] = s[6];
    }
  }
  // Every block's light row, by the block that comes last: thread i sums
  // rows i, i + CT_THREADS, ... in order, then a fixed tree over threads.
  const int blocks = groups * gridDim.y;
  if (!last_ticket(tickets + gridDim.y, blocks, &flag)) return;
  float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int i = threadIdx.x; i < blocks; i += blockDim.x) {
    const float4 v = __ldcg(reinterpret_cast<const float4*>(lpart) + i);
    a.x += v.x, a.y += v.y, a.z += v.z, a.w += v.w;
  }
  red[threadIdx.x] = a;
  __syncthreads();
  for (int h = CT_THREADS / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) {
      const float4 v = red[threadIdx.x + h];
      a.x += v.x, a.y += v.y, a.z += v.z, a.w += v.w;
      red[threadIdx.x] = a;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    // l^ = l / |l|: d_l = (d_l^ - l^ (l^ . d_l^)) / |l|.
    const float along = (l.x * a.x + l.y * a.y) + l.z * a.z;
    d_light[0] = (a.x - l.x * along) / l.norm;
    d_light[1] = (a.y - l.y * along) / l.norm;
    d_light[2] = (a.z - l.z * along) / l.norm;
    d_ambient[0] = a.w;
  }
}

static size_t ctail_smem(int k_slots) {
  return 2 * sizeof(float4) * (size_t)(k_slots < CT_CHUNK ? k_slots : CT_CHUNK);
}

// Blocks a tile: the groups of CT_RAYS rays of a T-ray tile.
extern "C" int ctail_groups(int t_rays) {
  return (t_rays + CT_RAYS - 1) / CT_RAYS;
}

// ro, rd, nrm [B, T, 3], t [B, T]; centers, colors [B, K, 3], radii [B, K],
// valid [B, K] bytes; light [3], ambient [1]; k [1] the soft-min sharpness
// in device memory, read when the kernel runs; sharp_a, sharp_c the softmax
// and mask sharpness. out [B T, 3], state [B T, 8]. Returns a CUDA error
// code.
extern "C" int ctail_fwd_launch(const float* ro, const float* rd,
                                const float* t, const float* nrm,
                                const float* centers, const float* colors,
                                const float* radii, const unsigned char* valid,
                                const float* light, const float* ambient,
                                const float* k, int b_tiles, int t_rays,
                                int k_slots, float sharp_a, float sharp_c,
                                float* out, float* state, void* stream) {
  if (b_tiles < 1 || t_rays < 1 || k_slots < 1 || b_tiles > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)ctail_groups(t_rays), (unsigned)b_tiles);
  ctail_fwd_kernel<<<grid, CT_THREADS, ctail_smem(k_slots),
                     (cudaStream_t)stream>>>(
      ro, rd, t, nrm, centers, colors, radii, valid, light, ambient, k, t_rays,
      k_slots, sharp_a, sharp_c, out, state);
  return (int)cudaGetLastError();
}

// The forward's arguments and its state, g [B T, 3] the cotangent of out;
// part [B, ctail_groups(T), 7, K] and lpart [B ctail_groups(T), 4] scratch;
// tickets [B + 1] ints, zero, left zero. Writes d_centers [B, K, 3],
// d_radii [B, K], d_colors [B, K, 3], d_light [3], d_ambient [1]. Returns a
// CUDA error code.
extern "C" int ctail_bwd_launch(
    const float* ro, const float* rd, const float* t, const float* nrm,
    const float* centers, const float* colors, const float* radii,
    const unsigned char* valid, const float* light, const float* ambient,
    const float* k, const float* state, const float* g, int b_tiles,
    int t_rays, int k_slots, float sharp_a, float sharp_c, float* part,
    float* lpart, int* tickets, float* d_centers, float* d_radii,
    float* d_colors, float* d_light, float* d_ambient, void* stream) {
  if (b_tiles < 1 || t_rays < 1 || k_slots < 1 || b_tiles > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)ctail_groups(t_rays), (unsigned)b_tiles);
  ctail_bwd_kernel<<<grid, CT_THREADS, ctail_smem(k_slots),
                     (cudaStream_t)stream>>>(
      ro, rd, t, nrm, centers, colors, radii, valid, light, ambient, k, state,
      g, t_rays, k_slots, sharp_a, sharp_c, part, lpart, tickets, d_centers,
      d_radii, d_colors, d_light, d_ambient);
  return (int)cudaGetLastError();
}
