// Native host runtime: OBJ parsing and BVH construction (host CPU code).
//
// A copy of raytracer_tpu/runtime/native/host_runtime.cpp, kept identical
// in everything it computes: the port builds it with the same g++ flags
// (runtime/loader.py), so both packages order a scene's primitives the same
// way on the same machine. It is the counterpart of the reference's OBJ
// loader (src/obj_read.cu:47-146) and BVH build (src/objects.cu:602-770),
// exposed through a plain C ABI and bound via ctypes. Differences from the
// reference by design: longest-axis median splits over triangle centroids
// (std::nth_element) instead of distance-to-face-point merge sort,
// leaf-only triangle storage (SURVEY.md quirk #15), and a contiguous
// triangle ordering so each leaf is a dense [start, count) range.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Vec3 {
  float x = 0, y = 0, z = 0;
};

inline Vec3 vmin(const Vec3 &a, const Vec3 &b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline Vec3 vmax(const Vec3 &a, const Vec3 &b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

}  // namespace

extern "C" {

// Parse a Wavefront OBJ file.
//   vertices_out: cap_v * 3 floats
//   face_idx_out: flattened vertex indices, cap_fi ints
//   face_size_out: per-face vertex counts, cap_f ints
//   counts_out: [num_vertices, num_faces, total_face_indices]
// Returns 0 on success, nonzero on error.
int rt_parse_obj(const char *path, float *vertices_out, int cap_v,
                 int *face_idx_out, int cap_fi, int *face_size_out, int cap_f,
                 int *counts_out) {
  FILE *f = std::fopen(path, "rb");
  if (!f) return 1;

  int nv = 0, nf = 0, nfi = 0;
  char line[8192];
  while (std::fgets(line, sizeof(line), f)) {
    if (line[0] == 'v' && (line[1] == ' ' || line[1] == '\t')) {
      if (nv >= cap_v) { std::fclose(f); return 2; }
      float x, y, z;
      if (std::sscanf(line + 2, "%f %f %f", &x, &y, &z) == 3) {
        vertices_out[nv * 3 + 0] = x;
        vertices_out[nv * 3 + 1] = y;
        vertices_out[nv * 3 + 2] = z;
        nv++;
      }
    } else if (line[0] == 'f' && (line[1] == ' ' || line[1] == '\t')) {
      if (nf >= cap_f) { std::fclose(f); return 2; }
      int count = 0;
      char *p = line + 2;
      while (*p) {
        while (*p == ' ' || *p == '\t') p++;
        if (*p == '\0' || *p == '\n' || *p == '\r') break;
        // keep only the vertex index of v/vt/vn (reference:
        // src/obj_read.cu:130-133); OBJ is 1-indexed.
        long idx = std::strtol(p, &p, 10);
        if (nfi >= cap_fi) { std::fclose(f); return 2; }
        face_idx_out[nfi++] = static_cast<int>(idx - 1);
        count++;
        while (*p && *p != ' ' && *p != '\t' && *p != '\n' && *p != '\r') p++;
      }
      if (count > 0) face_size_out[nf++] = count;
    }
  }
  std::fclose(f);
  counts_out[0] = nv;
  counts_out[1] = nf;
  counts_out[2] = nfi;
  return 0;
}

namespace {

struct BvhBuilder {
  const float *tris;  // T * 9 floats
  int leaf_size;
  std::vector<Vec3> centroids, tmin, tmax;
  std::vector<int> order;
  std::vector<float> bounds;  // num_nodes * 6
  std::vector<int> meta;      // num_nodes * 4: left, right, start, count

  int build(std::vector<int> &idxs, int lo, int hi) {
    int node = static_cast<int>(meta.size() / 4);
    Vec3 bmin = tmin[idxs[lo]], bmax = tmax[idxs[lo]];
    for (int i = lo; i < hi; i++) {
      bmin = vmin(bmin, tmin[idxs[i]]);
      bmax = vmax(bmax, tmax[idxs[i]]);
    }
    bounds.insert(bounds.end(), {bmin.x, bmin.y, bmin.z, bmax.x, bmax.y, bmax.z});
    meta.insert(meta.end(), {-1, -1, 0, 0});

    if (hi - lo <= leaf_size) {
      meta[node * 4 + 2] = static_cast<int>(order.size());
      meta[node * 4 + 3] = hi - lo;
      for (int i = lo; i < hi; i++) order.push_back(idxs[i]);
      return node;
    }

    // split on the longest centroid axis at the median
    Vec3 ext{bmax.x - bmin.x, bmax.y - bmin.y, bmax.z - bmin.z};
    int axis = 0;
    if (ext.y > ext.x && ext.y >= ext.z) axis = 1;
    else if (ext.z > ext.x && ext.z > ext.y) axis = 2;

    int mid = (lo + hi) / 2;
    std::nth_element(
        idxs.begin() + lo, idxs.begin() + mid, idxs.begin() + hi,
        [&](int a, int b) {
          const Vec3 &ca = centroids[a], &cb = centroids[b];
          float va = axis == 0 ? ca.x : (axis == 1 ? ca.y : ca.z);
          float vb = axis == 0 ? cb.x : (axis == 1 ? cb.y : cb.z);
          return va < vb;
        });

    int l = build(idxs, lo, mid);
    int r = build(idxs, mid, hi);
    meta[node * 4 + 0] = l;
    meta[node * 4 + 1] = r;
    return node;
  }
};

}  // namespace

// Build a BVH over T triangles (tri_verts: T*9 floats, v0 v1 v2 per tri).
// Outputs: order_out (T ints, leaf-contiguous permutation), bounds_out
// (num_nodes*6 floats), meta_out (num_nodes*4 ints), n_nodes_out (1 int).
// Caller must size bounds/meta for at least 4*T+2 nodes. Returns 0 on success.
int rt_build_bvh(const float *tri_verts, int num_tris, int leaf_size,
                 int *order_out, float *bounds_out, int *meta_out,
                 int *n_nodes_out) {
  if (num_tris <= 0) return 1;
  if (leaf_size <= 0) leaf_size = 64;

  BvhBuilder b;
  b.tris = tri_verts;
  b.leaf_size = leaf_size;
  b.centroids.resize(num_tris);
  b.tmin.resize(num_tris);
  b.tmax.resize(num_tris);
  for (int t = 0; t < num_tris; t++) {
    const float *v = tri_verts + t * 9;
    Vec3 v0{v[0], v[1], v[2]}, v1{v[3], v[4], v[5]}, v2{v[6], v[7], v[8]};
    b.tmin[t] = vmin(v0, vmin(v1, v2));
    b.tmax[t] = vmax(v0, vmax(v1, v2));
    b.centroids[t] = {(v0.x + v1.x + v2.x) / 3.0f,
                      (v0.y + v1.y + v2.y) / 3.0f,
                      (v0.z + v1.z + v2.z) / 3.0f};
  }
  std::vector<int> idxs(num_tris);
  for (int i = 0; i < num_tris; i++) idxs[i] = i;
  b.build(idxs, 0, num_tris);

  std::memcpy(order_out, b.order.data(), b.order.size() * sizeof(int));
  std::memcpy(bounds_out, b.bounds.data(), b.bounds.size() * sizeof(float));
  std::memcpy(meta_out, b.meta.data(), b.meta.size() * sizeof(int));
  n_nodes_out[0] = static_cast<int>(b.meta.size() / 4);
  return 0;
}

}  // extern "C"
