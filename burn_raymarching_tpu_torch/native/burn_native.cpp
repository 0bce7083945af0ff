// Native host-side components for burn_raymarching_tpu.
//
// The reference implements all host-side work in compiled Rust; these are
// the TPU-framework equivalents in C++, exposed through a C ABI for ctypes:
//
//   * prune_and_split — adaptive density control recompaction between
//     training stages (reference src/training.rs:87-238). Data-dependent,
//     branchy, O(M) — host work in the reference too.
//   * camera_rays — per-pixel look-at ray generation (reference
//     src/camera.rs:30-90), multithreaded over rows for large captures
//     (100 views x 512^2 and beyond).
//
// Build: g++ -O3 -march=native -shared -fPIC -o libburn_native.so burn_native.cpp -lpthread
//
// Both functions mirror the NumPy implementations bit-for-bit when given
// the same random draws (prune_and_split accepts optional injected split
// directions for that purpose).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <random>
#include <thread>
#include <vector>

extern "C" {

struct DensityRules {
  float prune_min_radius;        // 0.005
  float prune_max_radius_base;   // 1.0
  float prune_max_radius_decay;  // 0.04
  float prune_flyaway_dist_sq;   // 1.44
  float prune_black_color_sum;   // 0.05
  float split_radius_base;       // 0.25
  float split_radius_decay;      // 0.65
  float split_move_dist;         // 0.05
  float split_child_radius_scale;  // 0.8
  float split_child_min_radius;    // 0.01
};

static inline float sigmoidf_(float x) { return 1.0f / (1.0f + std::exp(-x)); }
static inline float softplusf_(double x) {
  // log(1 + e^x), stable.
  if (x > 30.0) return static_cast<float>(x);
  return static_cast<float>(std::log1p(std::exp(x)));
}
static inline float softplus_inv_(double y) {
  // ln(max(e^y - 1, 1e-6))  (reference training.rs:204)
  double e = std::expm1(y);
  if (e < 1e-6) e = 1e-6;
  return static_cast<float>(std::log(e));
}

// Returns the new primitive count. Output buffers must hold 2*m entries.
// stats_out (optional, 5 ints): pruned_size, pruned_flyaway, pruned_black,
// split, kept. dirs (optional): [m,3] unit split directions; when null an
// internal mt19937 draws z ~ U[-1,1), theta ~ U[0, tau) per split
// (reference training.rs:191-199).
int prune_and_split_native(
    const float* raw_centers,   // [m,3]
    const float* raw_colors,    // [m,3]
    const float* raw_radii,     // [m]
    const float* init_centers,  // [m,3]
    int m, int stage, int stages, uint64_t seed,
    const DensityRules* rules,
    const float* dirs,          // [m,3] or null
    float* out_centers, float* out_colors, float* out_radii,
    int* stats_out) {
  std::mt19937 rng(static_cast<uint32_t>(seed));
  std::uniform_real_distribution<float> uz(-1.0f, 1.0f);
  std::uniform_real_distribution<float> ut(0.0f, 6.2831853071795864769f);

  const float max_r =
      rules->prune_max_radius_base - stage * rules->prune_max_radius_decay;
  const float split_threshold =
      rules->split_radius_base *
      std::pow(rules->split_radius_decay, static_cast<float>(stage));
  const float move_sq_threshold =
      rules->split_move_dist * rules->split_move_dist;
  const bool may_split = stage < stages - 1;

  int n_out = 0, pruned_size = 0, pruned_fly = 0, pruned_black = 0,
      n_split = 0, n_kept = 0;

  for (int i = 0; i < m; ++i) {
    const float r = softplusf_(raw_radii[i]);
    const float cx = raw_centers[i * 3], cy = raw_centers[i * 3 + 1],
                cz = raw_centers[i * 3 + 2];

    // Pruning (reference training.rs:162-180), same short-circuit order.
    if (r > max_r || r < rules->prune_min_radius) {
      ++pruned_size;
      continue;
    }
    if (cx * cx + cy * cy + cz * cz > rules->prune_flyaway_dist_sq) {
      ++pruned_fly;
      continue;
    }
    const float er = sigmoidf_(raw_colors[i * 3]);
    const float eg = sigmoidf_(raw_colors[i * 3 + 1]);
    const float eb = sigmoidf_(raw_colors[i * 3 + 2]);
    if (er + eg + eb < rules->prune_black_color_sum) {
      ++pruned_black;
      continue;
    }

    const float dx0 = cx - init_centers[i * 3];
    const float dy0 = cy - init_centers[i * 3 + 1];
    const float dz0 = cz - init_centers[i * 3 + 2];
    const float move_sq = dx0 * dx0 + dy0 * dy0 + dz0 * dz0;

    if (may_split && r > split_threshold && move_sq > move_sq_threshold) {
      float dx, dy, dz;
      if (dirs) {
        dx = dirs[i * 3];
        dy = dirs[i * 3 + 1];
        dz = dirs[i * 3 + 2];
      } else {
        const float z = uz(rng);
        const float theta = ut(rng);
        const float rxy = std::sqrt(std::max(1.0f - z * z, 0.0f));
        dx = rxy * std::cos(theta);
        dy = rxy * std::sin(theta);
        dz = z;
      }
      const float offset = r * 0.5f;
      float target_r = r * rules->split_child_radius_scale;
      if (target_r < rules->split_child_min_radius)
        target_r = rules->split_child_min_radius;
      const float child_raw_r = softplus_inv_(target_r);
      for (int s = 0; s < 2; ++s) {
        const float sgn = s == 0 ? 1.0f : -1.0f;
        out_centers[n_out * 3] = cx + sgn * dx * offset;
        out_centers[n_out * 3 + 1] = cy + sgn * dy * offset;
        out_centers[n_out * 3 + 2] = cz + sgn * dz * offset;
        std::memcpy(out_colors + n_out * 3, raw_colors + i * 3,
                    3 * sizeof(float));
        out_radii[n_out] = child_raw_r;
        ++n_out;
      }
      ++n_split;
    } else {
      std::memcpy(out_centers + n_out * 3, raw_centers + i * 3,
                  3 * sizeof(float));
      std::memcpy(out_colors + n_out * 3, raw_colors + i * 3,
                  3 * sizeof(float));
      out_radii[n_out] = raw_radii[i];
      ++n_out;
      ++n_kept;
    }
  }

  if (stats_out) {
    stats_out[0] = pruned_size;
    stats_out[1] = pruned_fly;
    stats_out[2] = pruned_black;
    stats_out[3] = n_split;
    stats_out[4] = n_kept;
  }
  return n_out;
}

// Look-at pinhole rays (reference src/camera.rs:30-90): world_up=[0,1,0],
// u at pixel left edge, v flipped, per-pixel normalization. Threaded over
// row blocks.
void camera_rays_native(int width, int height, const float* eye3,
                        const float* target3, float fov_deg,
                        float* out_org,   // [width*height*3]
                        float* out_dir,   // [width*height*3]
                        int num_threads) {
  float fwd[3] = {target3[0] - eye3[0], target3[1] - eye3[1],
                  target3[2] - eye3[2]};
  float n = std::sqrt(fwd[0] * fwd[0] + fwd[1] * fwd[1] + fwd[2] * fwd[2]);
  if (n > 0) {
    fwd[0] /= n;
    fwd[1] /= n;
    fwd[2] /= n;
  }
  // right = normalize(cross(forward, world_up)) with world_up = [0,1,0]:
  // cross(a,b) = (a1*b2-a2*b1, a2*b0-a0*b2, a0*b1-a1*b0) → (-a2, 0, a0).
  float right[3] = {-fwd[2], 0.0f, fwd[0]};
  n = std::sqrt(right[0] * right[0] + right[1] * right[1] +
                right[2] * right[2]);
  if (n > 0) {
    right[0] /= n;
    right[1] /= n;
    right[2] /= n;
  }
  const float up[3] = {right[1] * fwd[2] - right[2] * fwd[1],
                       right[2] * fwd[0] - right[0] * fwd[2],
                       right[0] * fwd[1] - right[1] * fwd[0]};

  const float aspect = static_cast<float>(width) / height;
  const float half_h = std::tan(fov_deg * 3.14159265358979323846f / 360.0f);
  const float half_w = aspect * half_h;

  auto rows = [&](int y0, int y1) {
    for (int y = y0; y < y1; ++y) {
      const float v = -((static_cast<float>(y) / height) * 2.0f - 1.0f);
      const float us = v * half_h;
      for (int x = 0; x < width; ++x) {
        const float u = (static_cast<float>(x) / width) * 2.0f - 1.0f;
        const float rs = u * half_w;
        float dx = right[0] * rs + up[0] * us + fwd[0];
        float dy = right[1] * rs + up[1] * us + fwd[1];
        float dz = right[2] * rs + up[2] * us + fwd[2];
        const float len = std::sqrt(dx * dx + dy * dy + dz * dz);
        const size_t o = (static_cast<size_t>(y) * width + x) * 3;
        out_dir[o] = dx / len;
        out_dir[o + 1] = dy / len;
        out_dir[o + 2] = dz / len;
        out_org[o] = eye3[0];
        out_org[o + 1] = eye3[1];
        out_org[o + 2] = eye3[2];
      }
    }
  };

  if (num_threads <= 1 || height < 64) {
    rows(0, height);
    return;
  }
  std::vector<std::thread> threads;
  const int per = (height + num_threads - 1) / num_threads;
  for (int t = 0; t < num_threads; ++t) {
    const int y0 = t * per;
    const int y1 = std::min(height, y0 + per);
    if (y0 >= y1) break;
    threads.emplace_back(rows, y0, y1);
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"
