// native_host — the port's host runtime: BVH builds and the OBJ parser.
//
// A copy of the JAX package's native/dpt_native.cpp, built by g++ at first
// use (dpt_tpu_torch/utils/native.py) and called through a plain C ABI with
// ctypes.  Its output is byte-identical to the port's numpy code
// (accel/bvh.py, scene/obj.py), which it differs from the original to keep:
//   * the median split sorts each node's triangles by centroid with a
//     stable sort (numpy's argsort kind="stable") on the first longest axis
//     (numpy's argmax), where the original takes nth_element with a
//     triangle-id tie-break and the last longest axis;
//   * OBJ numbers are parsed to double and rounded once to float, as
//     Python's float() followed by a float32 array does (sscanf's %f rounds
//     the decimal to float directly, which can differ in the last bit);
//   * running bounds keep the last of equal values, as numpy's reductions
//     do on x86, so signed zeros come out as numpy's do;
//   * a face's texture index outside the parsed texcoords reads as (0, 0)
//     instead of outside the array.
// Built with -ffp-contract=off and no -march, so no multiply-add is fused
// and the SAH costs round as numpy's do on every host.

#include <algorithm>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct V3 {
  float x, y, z;
};

// numpy's minimum / maximum on x86 (SSE / AVX min / max): a tie returns
// the second operand, so a running bound keeps the last of equal values
// (of either sign of zero), as numpy's reductions over rows do.
inline float min2(float a, float b) { return a < b ? a : b; }
inline float max2(float a, float b) { return a > b ? a : b; }
inline V3 vmin(const V3 &a, const V3 &b) {
  return {min2(a.x, b.x), min2(a.y, b.y), min2(a.z, b.z)};
}
inline V3 vmax(const V3 &a, const V3 &b) {
  return {max2(a.x, b.x), max2(a.y, b.y), max2(a.z, b.z)};
}

// ---------------------------------------------------------------------------
// BVH: iterative top-down median split, pre-order node numbering.
// ---------------------------------------------------------------------------
struct BuildRange {
  int start, end, node_id;
};

}  // namespace

extern "C" {

// Returns number of nodes written, or -1 on error.  Output buffers must be
// sized for 2*T-1 nodes and T tri_order entries.
int dpt_build_bvh(const float *vertices, int n_vertices, const int *indices,
                  int n_tri, int leaf_size, float *node_min, float *node_max,
                  int *node_left, int *node_right, int *tri_order) {
  if (n_tri <= 0 || leaf_size < 1) return -1;
  (void)n_vertices;

  std::vector<V3> tri_lo(n_tri), tri_hi(n_tri), centroid(n_tri);
  for (int t = 0; t < n_tri; ++t) {
    V3 lo = {1e30f, 1e30f, 1e30f}, hi = {-1e30f, -1e30f, -1e30f};
    V3 c = {0, 0, 0};
    for (int k = 0; k < 3; ++k) {
      const float *p = vertices + 3 * indices[3 * t + k];
      V3 v = {p[0], p[1], p[2]};
      lo = vmin(lo, v);
      hi = vmax(hi, v);
      c.x += v.x; c.y += v.y; c.z += v.z;
    }
    tri_lo[t] = lo;
    tri_hi[t] = hi;
    centroid[t] = {c.x / 3.0f, c.y / 3.0f, c.z / 3.0f};
  }

  for (int t = 0; t < n_tri; ++t) tri_order[t] = t;

  std::vector<BuildRange> stack;
  stack.push_back({0, n_tri, 0});
  int n_nodes = 1;

  while (!stack.empty()) {
    BuildRange r = stack.back();
    stack.pop_back();
    V3 lo = {1e30f, 1e30f, 1e30f}, hi = {-1e30f, -1e30f, -1e30f};
    for (int s = r.start; s < r.end; ++s) {
      lo = vmin(lo, tri_lo[tri_order[s]]);
      hi = vmax(hi, tri_hi[tri_order[s]]);
    }
    node_min[3 * r.node_id + 0] = lo.x;
    node_min[3 * r.node_id + 1] = lo.y;
    node_min[3 * r.node_id + 2] = lo.z;
    node_max[3 * r.node_id + 0] = hi.x;
    node_max[3 * r.node_id + 1] = hi.y;
    node_max[3 * r.node_id + 2] = hi.z;

    int count = r.end - r.start;
    if (count <= leaf_size) {
      node_left[r.node_id] = -count;
      node_right[r.node_id] = r.start;
      continue;
    }
    // The first longest axis (numpy argmax), then a stable sort of the
    // node's triangles by centroid along it (numpy argsort kind="stable"),
    // split at the median (BoundingVolumeHierarchy.cpp:56-72).
    float e[3] = {hi.x - lo.x, hi.y - lo.y, hi.z - lo.z};
    int axis = 0;
    for (int a = 1; a < 3; ++a)
      if (e[a] > e[axis]) axis = a;
    std::stable_sort(tri_order + r.start, tri_order + r.end,
                     [&](int a, int b) {
                       const V3 &ca = centroid[a], &cb = centroid[b];
                       return (axis == 0 ? ca.x : axis == 1 ? ca.y : ca.z) <
                              (axis == 0 ? cb.x : axis == 1 ? cb.y : cb.z);
                     });
    int mid = r.start + count / 2;
    int left_id = n_nodes, right_id = n_nodes + 1;
    n_nodes += 2;
    node_left[r.node_id] = left_id;
    node_right[r.node_id] = right_id;
    stack.push_back({mid, r.end, right_id});
    stack.push_back({r.start, mid, left_id});
  }
  return n_nodes;
}

// Binned surface-area-heuristic build — the C++ twin of accel/bvh.py's
// build_bvh_sah with bit-identical tree output (parity-asserted in
// tests/test_torch_native.py): same float32 half-area arithmetic, the same
// float64 bin-scale product (numpy promotes `scale` to double), the same
// first-minimum tie-breaking over axes/bins, stable partitions, and the
// same stable median fallback for degenerate centroids.
int dpt_build_bvh_sah(const float *vertices, int n_vertices,
                      const int *indices, int n_tri, int leaf_size,
                      int n_bins, float *node_min, float *node_max,
                      int *node_left, int *node_right, int *tri_order) {
  if (n_tri <= 0 || leaf_size < 1 || n_bins < 2 || n_bins > 256) return -1;
  (void)n_vertices;

  std::vector<V3> tri_lo(n_tri), tri_hi(n_tri), centroid(n_tri);
  for (int t = 0; t < n_tri; ++t) {
    V3 lo = {1e30f, 1e30f, 1e30f}, hi = {-1e30f, -1e30f, -1e30f};
    V3 c = {0, 0, 0};
    for (int k = 0; k < 3; ++k) {
      const float *p = vertices + 3 * indices[3 * t + k];
      V3 v = {p[0], p[1], p[2]};
      lo = vmin(lo, v);
      hi = vmax(hi, v);
      c.x += v.x; c.y += v.y; c.z += v.z;
    }
    tri_lo[t] = lo;
    tri_hi[t] = hi;
    centroid[t] = {c.x / 3.0f, c.y / 3.0f, c.z / 3.0f};
  }
  for (int t = 0; t < n_tri; ++t) tri_order[t] = t;

  auto axis_of = [](const V3 &v, int a) {
    return a == 0 ? v.x : a == 1 ? v.y : v.z;
  };
  // float32 half-area, matching numpy's float32 intermediates.
  auto half_area32 = [](const V3 &lo, const V3 &hi) {
    float dx = std::max(hi.x - lo.x, 0.0f);
    float dy = std::max(hi.y - lo.y, 0.0f);
    float dz = std::max(hi.z - lo.z, 0.0f);
    return dx * dy + dy * dz + dz * dx;
  };

  std::vector<int> bins(n_tri);
  std::vector<int> scratch(n_tri);
  std::vector<BuildRange> stack;
  stack.push_back({0, n_tri, 0});
  int n_nodes = 1;

  std::vector<long long> cnt(n_bins);
  std::vector<V3> bmin_v(n_bins), bmax_v(n_bins);
  std::vector<V3> lmin(n_bins), lmax(n_bins), rmin(n_bins), rmax(n_bins);
  std::vector<long long> lcnt(n_bins);

  while (!stack.empty()) {
    BuildRange r = stack.back();
    stack.pop_back();
    V3 lo = {1e30f, 1e30f, 1e30f}, hi = {-1e30f, -1e30f, -1e30f};
    for (int s = r.start; s < r.end; ++s) {
      lo = vmin(lo, tri_lo[tri_order[s]]);
      hi = vmax(hi, tri_hi[tri_order[s]]);
    }
    node_min[3 * r.node_id + 0] = lo.x;
    node_min[3 * r.node_id + 1] = lo.y;
    node_min[3 * r.node_id + 2] = lo.z;
    node_max[3 * r.node_id + 0] = hi.x;
    node_max[3 * r.node_id + 1] = hi.y;
    node_max[3 * r.node_id + 2] = hi.z;

    int count = r.end - r.start;
    if (count <= leaf_size) {
      node_left[r.node_id] = -count;
      node_right[r.node_id] = r.start;
      continue;
    }

    V3 cmin = {1e30f, 1e30f, 1e30f}, cmax = {-1e30f, -1e30f, -1e30f};
    for (int s = r.start; s < r.end; ++s) {
      cmin = vmin(cmin, centroid[tri_order[s]]);
      cmax = vmax(cmax, centroid[tri_order[s]]);
    }

    double best_cost = 0.0;
    int best_axis = -1, best_k = -1;
    for (int axis = 0; axis < 3; ++axis) {
      float ext = axis_of(cmax, axis) - axis_of(cmin, axis);
      if (!(ext > 1e-12f)) continue;
      // numpy: n_bins*(1.0-1e-6) is a Python double, so scale and the
      // per-triangle product are computed in double then truncated.
      double scale = (double)n_bins * (1.0 - 1e-6) / (double)ext;
      for (int b = 0; b < n_bins; ++b) {
        cnt[b] = 0;
        bmin_v[b] = {1e30f, 1e30f, 1e30f};
        bmax_v[b] = {-1e30f, -1e30f, -1e30f};
      }
      float c0 = axis_of(cmin, axis);
      for (int s = r.start; s < r.end; ++s) {
        int tid = tri_order[s];
        int b = (int)(((double)(axis_of(centroid[tid], axis) - c0)) * scale);
        bins[s] = b;
        cnt[b] += 1;
        bmin_v[b] = vmin(bmin_v[b], tri_lo[tid]);
        bmax_v[b] = vmax(bmax_v[b], tri_hi[tid]);
      }
      lmin[0] = bmin_v[0];
      lmax[0] = bmax_v[0];
      for (int b = 1; b < n_bins; ++b) {
        lmin[b] = vmin(lmin[b - 1], bmin_v[b]);
        lmax[b] = vmax(lmax[b - 1], bmax_v[b]);
      }
      rmin[n_bins - 1] = bmin_v[n_bins - 1];
      rmax[n_bins - 1] = bmax_v[n_bins - 1];
      for (int b = n_bins - 2; b >= 0; --b) {
        rmin[b] = vmin(rmin[b + 1], bmin_v[b]);
        rmax[b] = vmax(rmax[b + 1], bmax_v[b]);
      }
      lcnt[0] = cnt[0];
      for (int b = 1; b < n_bins; ++b) lcnt[b] = lcnt[b - 1] + cnt[b];

      // First minimum over k (numpy argmin), then strict < across axes.
      double axis_best = 0.0;
      int axis_k = -1;
      for (int k = 0; k < n_bins - 1; ++k) {
        long long lc = lcnt[k], rc = (long long)count - lc;
        if (lc == 0 || rc == 0) continue;
        double cost = (double)lc * (double)half_area32(lmin[k], lmax[k]) +
                      (double)rc * (double)half_area32(rmin[k + 1], rmax[k + 1]);
        if (axis_k < 0 || cost < axis_best) {
          axis_best = cost;
          axis_k = k;
        }
      }
      if (axis_k >= 0 && (best_axis < 0 || axis_best < best_cost)) {
        best_cost = axis_best;
        best_axis = axis;
        best_k = axis_k;
        // keep this axis's bins for the partition
        for (int s = r.start; s < r.end; ++s) scratch[s] = bins[s];
      }
    }

    int mid;
    if (best_axis < 0) {
      // Degenerate centroids: stable median split on the longest node
      // axis, first-maximum tie-breaking exactly like numpy argmax.
      float e[3] = {hi.x - lo.x, hi.y - lo.y, hi.z - lo.z};
      int axis = 0;
      for (int a = 1; a < 3; ++a)
        if (e[a] > e[axis]) axis = a;
      std::stable_sort(tri_order + r.start, tri_order + r.end,
                       [&](int a, int b) {
                         return axis_of(centroid[a], axis) <
                                axis_of(centroid[b], axis);
                       });
      mid = r.start + count / 2;
    } else {
      int k = best_k;
      // stable partition by bin <= k (numpy concatenate of masked slices)
      int w = r.start;
      std::vector<int> right_side;
      right_side.reserve(count);
      for (int s = r.start; s < r.end; ++s) {
        if (scratch[s] <= k)
          tri_order[w++] = tri_order[s];
        else
          right_side.push_back(tri_order[s]);
      }
      mid = w;
      for (size_t i = 0; i < right_side.size(); ++i)
        tri_order[w + (int)i] = right_side[i];
    }

    if (mid == r.start || mid == r.end) {
      // cannot happen for a valid SAH split; guard the fallback
      mid = r.start + count / 2;
    }
    int left_id = n_nodes, right_id = n_nodes + 1;
    n_nodes += 2;
    node_left[r.node_id] = left_id;
    node_right[r.node_id] = right_id;
    stack.push_back({mid, r.end, right_id});
    stack.push_back({r.start, mid, left_id});
  }
  return n_nodes;
}

// ---------------------------------------------------------------------------
// OBJ loader (two-pass C ABI: counts, then fill).
// ---------------------------------------------------------------------------
namespace {

struct ObjData {
  std::vector<float> positions;   // V*3
  std::vector<float> texcoords;   // VT*2
  std::vector<int> tri_pos;       // T*3
  std::vector<int> tri_uv;        // T*3 (-1 = absent)
  std::vector<int> tri_mat;       // T
};

int resolve_index(int idx, int count) { return idx > 0 ? idx - 1 : count + idx; }

bool parse_obj(const char *path, ObjData &out) {
  FILE *f = std::fopen(path, "rb");
  if (!f) return false;
  char line[4096];
  std::vector<std::string> mat_names;
  int cur_mat = -1;
  while (std::fgets(line, sizeof(line), f)) {
    char *s = line;
    while (*s == ' ' || *s == '\t') ++s;
    if (s[0] == 'v' && s[1] == ' ') {
      double x, y, z;
      if (std::sscanf(s + 2, "%lf %lf %lf", &x, &y, &z) == 3) {
        out.positions.push_back((float)x);
        out.positions.push_back((float)y);
        out.positions.push_back((float)z);
      }
    } else if (s[0] == 'v' && s[1] == 't') {
      double u = 0, v = 0;
      std::sscanf(s + 3, "%lf %lf", &u, &v);
      out.texcoords.push_back((float)u);
      out.texcoords.push_back((float)v);
    } else if (s[0] == 'f' && (s[1] == ' ' || s[1] == '\t')) {
      // Parse corner specs a[/b[/c]]; fan-triangulate polygons.
      int pos_idx[64], uv_idx[64], n_corners = 0;
      char *tok = std::strtok(s + 2, " \t\r\n");
      while (tok && n_corners < 64) {
        int pi = std::atoi(tok);
        int ti = 0;
        bool has_t = false;
        const char *slash = std::strchr(tok, '/');
        if (slash && slash[1] != '/' && slash[1] != '\0') {
          ti = std::atoi(slash + 1);
          has_t = true;
        }
        pos_idx[n_corners] =
            resolve_index(pi, (int)(out.positions.size() / 3));
        uv_idx[n_corners] =
            has_t ? resolve_index(ti, (int)(out.texcoords.size() / 2)) : -1;
        ++n_corners;
        tok = std::strtok(nullptr, " \t\r\n");
      }
      for (int k = 1; k + 1 < n_corners; ++k) {
        out.tri_pos.push_back(pos_idx[0]);
        out.tri_pos.push_back(pos_idx[k]);
        out.tri_pos.push_back(pos_idx[k + 1]);
        out.tri_uv.push_back(uv_idx[0]);
        out.tri_uv.push_back(uv_idx[k]);
        out.tri_uv.push_back(uv_idx[k + 1]);
        out.tri_mat.push_back(cur_mat < 0 ? 0 : cur_mat);
      }
    } else if (std::strncmp(s, "usemtl", 6) == 0) {
      char name[512] = {0};
      if (std::sscanf(s + 6, "%511s", name) == 1) {
        auto it = std::find(mat_names.begin(), mat_names.end(), name);
        if (it == mat_names.end()) {
          mat_names.push_back(name);
          cur_mat = (int)mat_names.size() - 1;
        } else {
          cur_mat = (int)(it - mat_names.begin());
        }
      }
    }
  }
  std::fclose(f);
  return true;
}

}  // namespace

int dpt_load_obj_counts(const char *path, int *n_vertices, int *n_triangles) {
  ObjData d;
  if (!parse_obj(path, d)) return -1;
  *n_vertices = (int)(d.positions.size() / 3);
  *n_triangles = (int)(d.tri_pos.size() / 3);
  return 0;
}

int dpt_load_obj_fill(const char *path, float *vertices, int *indices,
                      float *uvs, int *mat_idx) {
  ObjData d;
  if (!parse_obj(path, d)) return -1;
  std::memcpy(vertices, d.positions.data(), d.positions.size() * sizeof(float));
  int n_tri = (int)(d.tri_pos.size() / 3);
  for (int t = 0; t < n_tri; ++t) {
    for (int k = 0; k < 3; ++k) {
      indices[3 * t + k] = d.tri_pos[3 * t + k];
      int ti = d.tri_uv[3 * t + k];
      if (2 * (size_t)ti + 1 >= d.texcoords.size()) ti = -1;
      uvs[(3 * t + k) * 2 + 0] = ti >= 0 ? d.texcoords[2 * ti + 0] : 0.0f;
      uvs[(3 * t + k) * 2 + 1] = ti >= 0 ? d.texcoords[2 * ti + 1] : 0.0f;
    }
    mat_idx[t] = d.tri_mat[t];
  }
  return 0;
}

}  // extern "C"
