// Native SAH BVH builder (host runtime component).
//
// Same build semantics as the reference's SAHBVH (bvh.cpp:426-511) and the
// Python reference implementation in accel/bvh.py:
//   - leaf when <= leaf_size prims (bvh.cpp:441)
//   - sort by centroid (mean of 3 verts * 0.333333f, bvh.cpp:100-103)
//     DESCENDING along round-robin axis x->y->z (bvh.cpp:451-454)
//   - split minimizing CSA[i-1]*i + (CSAtot-CSA[i-1])*(n-i) over prefix
//     sums of parallelogram areas (bvh.cpp:458-477)
//   - bottom-up AABBs (bvh.cpp:392-419, 496-511)
//   - pre-order flatten with skip threading (next_hit/next_miss) and
//     leaf-contiguous primitive reorder (CudaPrimitive.cu:8-145 analog)
//
// Exposed as a C ABI for ctypes; Python allocates worst-case buffers
// (2T-1 nodes) and we return the actual node count.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

struct BuildNode {
  float bmin[3], bmax[3];
  int32_t left = -1, right = -1;
  int64_t prim_begin = -1, prim_end = -1;  // into the ids array (leaf only)
  int32_t depth = 0;
};

struct Ctx {
  const float* tris;  // (T, 9): v0 v1 v2
  std::vector<float> cent;   // (T, 3)
  std::vector<float> area;   // (T)
  std::vector<float> pmin;   // (T, 3)
  std::vector<float> pmax;   // (T, 3)
};

inline void tri_bounds(const float* t, float* mn, float* mx) {
  for (int k = 0; k < 3; ++k) {
    mn[k] = std::min(t[k], std::min(t[3 + k], t[6 + k]));
    mx[k] = std::max(t[k], std::max(t[3 + k], t[6 + k]));
  }
}

}  // namespace

extern "C" int64_t pt_build_bvh(
    const float* tris, int64_t num_tris, int32_t leaf_size,
    // outputs (caller-allocated, capacity 2*num_tris nodes):
    float* out_bmin, float* out_bmax, int32_t* out_next_hit,
    int32_t* out_next_miss, int32_t* out_prim_start,
    int32_t* out_prim_count, int64_t* out_prim_order,
    int32_t* out_max_depth) {
  if (num_tris <= 0) return 0;
  Ctx ctx;
  ctx.tris = tris;
  ctx.cent.resize(num_tris * 3);
  ctx.area.resize(num_tris);
  ctx.pmin.resize(num_tris * 3);
  ctx.pmax.resize(num_tris * 3);
  for (int64_t i = 0; i < num_tris; ++i) {
    const float* t = tris + i * 9;
    for (int k = 0; k < 3; ++k)
      ctx.cent[i * 3 + k] = (t[k] + t[3 + k] + t[6 + k]) * 0.333333f;
    float e1[3], e2[3];
    for (int k = 0; k < 3; ++k) {
      e1[k] = t[3 + k] - t[k];
      e2[k] = t[6 + k] - t[k];
    }
    float cx = e1[1] * e2[2] - e1[2] * e2[1];
    float cy = e1[2] * e2[0] - e1[0] * e2[2];
    float cz = e1[0] * e2[1] - e1[1] * e2[0];
    ctx.area[i] = std::sqrt(cx * cx + cy * cy + cz * cz);
    tri_bounds(t, &ctx.pmin[i * 3], &ctx.pmax[i * 3]);
  }

  std::vector<int64_t> ids(num_tris);
  for (int64_t i = 0; i < num_tris; ++i) ids[i] = i;

  std::vector<BuildNode> nodes;
  nodes.reserve(2 * num_tris);
  std::vector<float> csa;  // scratch prefix sums

  struct Task {
    int32_t node;
    int64_t begin, end;  // range in ids
    int32_t axis, depth;
  };
  std::vector<Task> stack;
  nodes.push_back(BuildNode{});
  stack.push_back({0, 0, num_tris, 0, 0});
  int32_t max_depth = 0;

  while (!stack.empty()) {
    Task task = stack.back();
    stack.pop_back();
    BuildNode& node = nodes[task.node];
    node.depth = task.depth;
    max_depth = std::max(max_depth, task.depth);
    int64_t n = task.end - task.begin;
    if (n <= leaf_size) {
      node.prim_begin = task.begin;
      node.prim_end = task.end;
      float mn[3] = {1e30f, 1e30f, 1e30f}, mx[3] = {-1e30f, -1e30f, -1e30f};
      for (int64_t i = task.begin; i < task.end; ++i) {
        const float* pm = &ctx.pmin[ids[i] * 3];
        const float* px = &ctx.pmax[ids[i] * 3];
        for (int k = 0; k < 3; ++k) {
          mn[k] = std::min(mn[k], pm[k]);
          mx[k] = std::max(mx[k], px[k]);
        }
      }
      for (int k = 0; k < 3; ++k) {
        node.bmin[k] = mn[k];
        node.bmax[k] = mx[k];
      }
      continue;
    }
    const int axis = task.axis;
    const float* cent = ctx.cent.data();
    // stable descending centroid sort (matches accel/bvh.py mergesort)
    std::stable_sort(ids.begin() + task.begin, ids.begin() + task.end,
                     [cent, axis](int64_t a, int64_t b) {
                       return cent[a * 3 + axis] > cent[b * 3 + axis];
                     });
    csa.resize(n);
    float acc = 0.f;
    for (int64_t i = 0; i < n; ++i) {
      acc += ctx.area[ids[task.begin + i]];
      csa[i] = acc;
    }
    // The cost in double, as the numpy reference computes it (float32 prefix
    // sums times int64 counts promote to float64): a float32 cost, as the
    // JAX package's copy of this file has, picks another split where two
    // costs nearly tie.
    double best = 3.4e38;
    int64_t split = 1;
    const float total = csa[n - 1];
    for (int64_t i = 1; i < n; ++i) {
      double cost = (double)csa[i - 1] * (double)i + (double)(total - csa[i - 1]) * (double)(n - i);
      if (cost < best) {
        best = cost;
        split = i;
      }
    }
    int32_t l = (int32_t)nodes.size();
    nodes.push_back(BuildNode{});
    int32_t r = (int32_t)nodes.size();
    nodes.push_back(BuildNode{});
    nodes[task.node].left = l;
    nodes[task.node].right = r;
    int32_t next_axis = (axis + 1) % 3;
    stack.push_back({l, task.begin, task.begin + split, next_axis,
                     task.depth + 1});
    stack.push_back({r, task.begin + split, task.end, next_axis,
                     task.depth + 1});
  }

  // bottom-up AABBs for inner nodes (children have higher indices)
  for (int64_t i = (int64_t)nodes.size() - 1; i >= 0; --i) {
    BuildNode& nd = nodes[i];
    if (nd.prim_begin >= 0) continue;
    const BuildNode& a = nodes[nd.left];
    const BuildNode& b = nodes[nd.right];
    for (int k = 0; k < 3; ++k) {
      nd.bmin[k] = std::min(a.bmin[k], b.bmin[k]);
      nd.bmax[k] = std::max(a.bmax[k], b.bmax[k]);
    }
  }

  // pre-order flatten with skip threading
  const int64_t n_nodes = (int64_t)nodes.size();
  std::vector<int32_t> flat_idx(n_nodes, -1);
  struct Visit {
    int32_t node, miss;  // miss = OLD node id of skip target (-1 = none)
  };
  std::vector<Visit> vstack;
  std::vector<Visit> order;
  order.reserve(n_nodes);
  vstack.push_back({0, -1});
  int32_t counter = 0;
  while (!vstack.empty()) {
    Visit v = vstack.back();
    vstack.pop_back();
    flat_idx[v.node] = counter++;
    order.push_back(v);
    const BuildNode& nd = nodes[v.node];
    if (nd.prim_begin < 0) {
      vstack.push_back({nd.right, v.miss});
      vstack.push_back({nd.left, nd.right});
    }
  }

  int64_t prim_cursor = 0;
  for (const Visit& v : order) {
    const BuildNode& nd = nodes[v.node];
    int32_t idx = flat_idx[v.node];
    for (int k = 0; k < 3; ++k) {
      out_bmin[idx * 3 + k] = nd.bmin[k];
      out_bmax[idx * 3 + k] = nd.bmax[k];
    }
    int32_t miss_idx = v.miss >= 0 ? flat_idx[v.miss] : -1;
    out_next_miss[idx] = miss_idx;
    if (nd.prim_begin < 0) {
      out_next_hit[idx] = flat_idx[nodes[v.node].left];
      out_prim_start[idx] = -1;
      out_prim_count[idx] = 0;
    } else {
      int64_t cnt = nd.prim_end - nd.prim_begin;
      out_prim_start[idx] = (int32_t)prim_cursor;
      out_prim_count[idx] = (int32_t)cnt;
      for (int64_t i = 0; i < cnt; ++i)
        out_prim_order[prim_cursor + i] = ids[nd.prim_begin + i];
      prim_cursor += cnt;
      out_next_hit[idx] = miss_idx;
    }
  }

  *out_max_depth = max_depth;
  return n_nodes;
}
