// Native runtime components for rvpt_tpu.
//
// The reference implements its scene-ingest hot path in C++ (binned-SAH BVH
// builder, src/rvpt/bvh_builder.cpp:11-199; tinyobjloader mesh ingest,
// src/rvpt/main.cpp:12-62).  These are the native equivalents here: same
// algorithms, exposed through a C ABI consumed via ctypes (rvpt_tpu.native).
// Device-side compute stays in XLA/Pallas; this is host-side scene build.
//
// The two reference defects are fixed exactly as in the Python builder
// (SURVEY.md §2): consistent bin indexing between cost search and partition,
// and a correct median split (bvh_builder.cpp:44-46, :167).
//
// Build: make -C native   ->   librvpt_native.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <limits>
#include <numeric>
#include <vector>

namespace {

constexpr int kBinCount = 16;          // bvh_builder.h:49-50
constexpr uint32_t kMinLeaf = 2;       // bvh_builder.h:45
constexpr uint32_t kMaxLeaf = 8;       // bvh_builder.h:46

struct V3 {
  double x, y, z;
  double operator[](int i) const { return i == 0 ? x : (i == 1 ? y : z); }
};

struct Box {
  V3 mn{1e300, 1e300, 1e300};
  V3 mx{-1e300, -1e300, -1e300};
  void expand(const Box& b) {
    mn = {std::min(mn.x, b.mn.x), std::min(mn.y, b.mn.y), std::min(mn.z, b.mn.z)};
    mx = {std::max(mx.x, b.mx.x), std::max(mx.y, b.mx.y), std::max(mx.z, b.mx.z)};
  }
  // Half surface area (reference: geometry.h:38-41), degenerate-clamped.
  double half_area() const {
    double dx = std::max(mx.x - mn.x, 0.0);
    double dy = std::max(mx.y - mn.y, 0.0);
    double dz = std::max(mx.z - mn.z, 0.0);
    return dx * (dy + dz) + dy * dz;
  }
};

struct Node {
  uint32_t first = 0;   // first child (interior) or first primitive (leaf)
  uint32_t count = 0;   // 0 = interior
  Box box;
};

struct Builder {
  const V3* centers;
  const Box* boxes;
  std::vector<uint32_t> prim;   // permutation
  std::vector<Node> nodes;

  void build(size_t n) {
    prim.resize(n);
    std::iota(prim.begin(), prim.end(), 0u);
    nodes.reserve(2 * n - 1);
    nodes.push_back(Node{0, static_cast<uint32_t>(n), {}});
    std::vector<uint32_t> stack{0};
    while (!stack.empty()) {
      uint32_t ni = stack.back();
      stack.pop_back();
      process(ni, stack);
    }
  }

  void process(uint32_t ni, std::vector<uint32_t>& stack) {
    Node& node = nodes[ni];
    const uint32_t begin = node.first, count = node.count;
    Box nb;
    for (uint32_t i = begin; i < begin + count; ++i) nb.expand(boxes[prim[i]]);
    node.box = nb;
    if (count < kMinLeaf) return;

    // --- binned SAH split search (bvh_builder.cpp:56-127)
    double min_cost = std::numeric_limits<double>::infinity();
    int min_axis = -1;
    int min_bin = 0;
    for (int axis = 0; axis < 3; ++axis) {
      double diag = std::max(nb.mx[axis] - nb.mn[axis], 1e-30);
      double scale = kBinCount / diag;
      Box bins[kBinCount];
      uint32_t bcount[kBinCount] = {0};
      for (uint32_t i = begin; i < begin + count; ++i) {
        int b = bin_of(axis, prim[i], nb, scale);
        bins[b].expand(boxes[prim[i]]);
        bcount[b]++;
      }
      double left_cost[kBinCount];
      {
        Box acc;
        uint32_t c = 0;
        for (int i = 0; i < kBinCount; ++i) {
          acc.expand(bins[i]);
          c += bcount[i];
          left_cost[i] = c ? acc.half_area() * c : 0.0;
        }
      }
      {
        Box acc;
        uint32_t c = 0;
        for (int i = kBinCount - 1; i > 0; --i) {
          acc.expand(bins[i]);
          c += bcount[i];
          double right = c ? acc.half_area() * c : 0.0;
          double cost = right + left_cost[i - 1];
          if (cost < min_cost) {
            min_cost = cost;
            min_axis = axis;
            min_bin = i;
          }
        }
      }
    }

    const double no_split = nb.half_area() * count;
    uint32_t mid;
    if (min_cost >= no_split || min_axis < 0) {
      if (count <= kMaxLeaf) return;
      mid = median_split(begin, count, std::max(min_axis, 0));
    } else {
      double diag = std::max(nb.mx[min_axis] - nb.mn[min_axis], 1e-30);
      double scale = kBinCount / diag;
      // stable partition like std::partition order preservation of NumPy path
      auto it = std::stable_partition(
          prim.begin() + begin, prim.begin() + begin + count,
          [&](uint32_t p) { return bin_of(min_axis, p, nb, scale) < min_bin; });
      mid = static_cast<uint32_t>(it - prim.begin());
      if (mid == begin || mid == begin + count)
        mid = median_split(begin, count, min_axis);
    }

    uint32_t left = static_cast<uint32_t>(nodes.size());
    Node l, r;
    l.first = begin;
    l.count = mid - begin;
    r.first = mid;
    r.count = begin + count - mid;
    nodes[ni].first = left;
    nodes[ni].count = 0;
    nodes.push_back(l);
    nodes.push_back(r);
    stack.push_back(left);
    stack.push_back(left + 1);
  }

  int bin_of(int axis, uint32_t p, const Box& nb, double scale) const {
    int b = static_cast<int>((centers[p][axis] - nb.mn[axis]) * scale);
    return std::min(kBinCount - 1, std::max(0, b));
  }

  uint32_t median_split(uint32_t begin, uint32_t count, int axis) {
    std::stable_sort(prim.begin() + begin, prim.begin() + begin + count,
                     [&](uint32_t a, uint32_t b) {
                       return centers[a][axis] < centers[b][axis];
                     });
    return begin + (count >> 1);  // bvh_builder.cpp:167, precedence fixed
  }
};

}  // namespace

extern "C" {

// Build a BVH over n primitive AABBs.
//   centers, bmin, bmax: f64[n*3]
//   out_first, out_count: u32[2n-1]; out_bounds: f64[(2n-1)*6]
//   out_prim: u32[n]
// Returns the number of nodes written, or -1 on error.
int64_t rvpt_build_bvh(int64_t n, const double* centers, const double* bmin,
                       const double* bmax, uint32_t* out_first,
                       uint32_t* out_count, double* out_bounds,
                       uint32_t* out_prim) {
  if (n <= 0) return -1;
  std::vector<V3> cen(n);
  std::vector<Box> boxes(n);
  for (int64_t i = 0; i < n; ++i) {
    cen[i] = {centers[3 * i], centers[3 * i + 1], centers[3 * i + 2]};
    boxes[i].mn = {bmin[3 * i], bmin[3 * i + 1], bmin[3 * i + 2]};
    boxes[i].mx = {bmax[3 * i], bmax[3 * i + 1], bmax[3 * i + 2]};
  }
  Builder b;
  b.centers = cen.data();
  b.boxes = boxes.data();
  b.build(static_cast<size_t>(n));
  for (size_t i = 0; i < b.nodes.size(); ++i) {
    out_first[i] = b.nodes[i].first;
    out_count[i] = b.nodes[i].count;
    const Box& box = b.nodes[i].box;
    out_bounds[6 * i + 0] = box.mn.x;
    out_bounds[6 * i + 1] = box.mn.y;
    out_bounds[6 * i + 2] = box.mn.z;
    out_bounds[6 * i + 3] = box.mx.x;
    out_bounds[6 * i + 4] = box.mx.y;
    out_bounds[6 * i + 5] = box.mx.z;
  }
  std::memcpy(out_prim, b.prim.data(), sizeof(uint32_t) * n);
  return static_cast<int64_t>(b.nodes.size());
}

// --- OBJ parsing (positions + fan-triangulated faces, like the reference's
// tinyobjloader usage, main.cpp:12-62) -------------------------------------

struct ObjData {
  std::vector<float> verts;
  std::vector<int32_t> faces;
};

static bool parse_obj_file(const char* path, ObjData& out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  char line[8192];
  std::vector<long> idx;
  while (std::fgets(line, sizeof(line), f)) {
    if (line[0] == 'v' && (line[1] == ' ' || line[1] == '\t')) {
      double x = 0, y = 0, z = 0;
      if (std::sscanf(line + 2, "%lf %lf %lf", &x, &y, &z) == 3) {
        out.verts.push_back(static_cast<float>(x));
        out.verts.push_back(static_cast<float>(y));
        out.verts.push_back(static_cast<float>(z));
      }
    } else if (line[0] == 'f' && (line[1] == ' ' || line[1] == '\t')) {
      idx.clear();
      const char* p = line + 2;
      while (*p) {
        while (*p == ' ' || *p == '\t') ++p;
        if (*p == '\0' || *p == '\n' || *p == '\r') break;
        char* end = nullptr;
        long v = std::strtol(p, &end, 10);
        if (end == p) break;
        long nv = static_cast<long>(out.verts.size() / 3);
        idx.push_back(v > 0 ? v - 1 : nv + v);
        p = end;
        while (*p && *p != ' ' && *p != '\t' && *p != '\n') ++p;  // skip /vt/vn
      }
      for (size_t k = 1; k + 1 < idx.size(); ++k) {
        out.faces.push_back(static_cast<int32_t>(idx[0]));
        out.faces.push_back(static_cast<int32_t>(idx[k]));
        out.faces.push_back(static_cast<int32_t>(idx[k + 1]));
      }
    }
  }
  std::fclose(f);
  long nv = static_cast<long>(out.verts.size() / 3);
  for (int32_t fi : out.faces)
    if (fi < 0 || fi >= nv) return false;
  return true;
}

static thread_local ObjData g_obj;

// Pass 1: parse and report counts.  Returns 0 on success.
int32_t rvpt_obj_open(const char* path, int64_t* n_verts, int64_t* n_faces) {
  g_obj.verts.clear();
  g_obj.faces.clear();
  if (!parse_obj_file(path, g_obj)) return -1;
  *n_verts = static_cast<int64_t>(g_obj.verts.size() / 3);
  *n_faces = static_cast<int64_t>(g_obj.faces.size() / 3);
  return 0;
}

// Pass 2: copy out the parsed arrays (f32[nv*3], i32[nf*3]).
int32_t rvpt_obj_read(float* verts, int32_t* faces) {
  std::memcpy(verts, g_obj.verts.data(), g_obj.verts.size() * sizeof(float));
  std::memcpy(faces, g_obj.faces.data(), g_obj.faces.size() * sizeof(int32_t));
  g_obj.verts.clear();
  g_obj.faces.clear();
  return 0;
}

}  // extern "C"
