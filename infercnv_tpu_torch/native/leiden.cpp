// Native Leiden community detection — fast path for large cell counts.
//
// The reference leans on igraph's C cluster_leiden
// (R/inferCNV_tumor_subclusters.R:714-715,736-737).  This is a from-scratch
// C++ implementation of the Leiden algorithm (local moving with a work
// queue -> singleton refinement -> graph aggregation, iterated) over a CSR
// adjacency, with CPM and modularity objectives, deterministic under a
// seed.  Exposed through a plain C ABI for ctypes (no pybind11 in image).
//
// Build: g++ -O3 -march=native -shared -fPIC leiden.cpp -o libleiden.so

#include <cstdint>
#include <cstring>
#include <numeric>
#include <unordered_map>
#include <vector>

namespace {

struct XorShift {
  uint64_t s;
  explicit XorShift(uint64_t seed) : s(seed ? seed : 0x9E3779B97F4A7C15ull) {}
  uint64_t next() {
    s ^= s << 13;
    s ^= s >> 7;
    s ^= s << 17;
    return s;
  }
  // unbiased-enough bounded draw for shuffling
  uint64_t bounded(uint64_t n) { return next() % n; }
};

struct Graph {
  std::vector<int64_t> indptr;
  std::vector<int32_t> indices;
  std::vector<double> data;
  int n = 0;
};

struct Partition {
  const Graph& g;
  std::vector<double> node_size;
  std::vector<double> strength;
  std::vector<int32_t> membership;
  std::vector<double> comm_size;
  std::vector<double> comm_strength;
  bool cpm;
  double gamma;
  double m2;

  Partition(const Graph& graph, const std::vector<double>& sizes, bool use_cpm,
            double resolution, double total_weight)
      : g(graph), node_size(sizes), cpm(use_cpm), gamma(resolution),
        m2(total_weight) {
    strength.assign(g.n, 0.0);
    for (int v = 0; v < g.n; ++v)
      for (int64_t j = g.indptr[v]; j < g.indptr[v + 1]; ++j)
        strength[v] += g.data[j];
    membership.resize(g.n);
    std::iota(membership.begin(), membership.end(), 0);
    comm_size = node_size;
    comm_strength = strength;
  }

  double gain(int v, double edges_to, int target) const {
    if (cpm) return edges_to - gamma * node_size[v] * comm_size[target];
    return edges_to - gamma * strength[v] * comm_strength[target] / m2;
  }

  bool move_nodes(XorShift& rng, int64_t max_steps) {
    std::vector<int32_t> queue(g.n);
    std::iota(queue.begin(), queue.end(), 0);
    for (int i = g.n - 1; i > 0; --i)
      std::swap(queue[i], queue[rng.bounded(i + 1)]);
    std::vector<uint8_t> in_queue(g.n, 1);
    std::unordered_map<int32_t, double> acc;
    bool improved = false;
    size_t head = 0;
    int64_t steps = 0;
    while (head < queue.size() && steps < max_steps) {
      int v = queue[head++];
      in_queue[v] = 0;
      ++steps;
      int cv = membership[v];
      comm_size[cv] -= node_size[v];
      comm_strength[cv] -= strength[v];
      acc.clear();
      for (int64_t j = g.indptr[v]; j < g.indptr[v + 1]; ++j) {
        int u = g.indices[j];
        if (u == v) continue;
        acc[membership[u]] += g.data[j];
      }
      int best_c = cv;
      auto it = acc.find(cv);
      double best_gain = gain(v, it == acc.end() ? 0.0 : it->second, cv);
      for (auto& kv : acc) {
        if (kv.first == cv) continue;
        double gg = gain(v, kv.second, kv.first);
        if (gg > best_gain + 1e-12) {
          best_gain = gg;
          best_c = kv.first;
        }
      }
      membership[v] = best_c;
      comm_size[best_c] += node_size[v];
      comm_strength[best_c] += strength[v];
      if (best_c != cv) {
        improved = true;
        for (int64_t j = g.indptr[v]; j < g.indptr[v + 1]; ++j) {
          int u = g.indices[j];
          if (u != v && membership[u] != best_c && !in_queue[u]) {
            queue.push_back(u);
            in_queue[u] = 1;
          }
        }
      }
    }
    return improved;
  }
};

void relabel(std::vector<int32_t>& m) {
  std::unordered_map<int32_t, int32_t> map;
  int32_t next = 0;
  for (auto& x : m) {
    auto it = map.find(x);
    if (it == map.end()) {
      map.emplace(x, next);
      x = next++;
    } else {
      x = it->second;
    }
  }
}

// singleton-merge refinement within communities
std::vector<int32_t> refine(const Graph& g, const std::vector<double>& sizes,
                            const std::vector<int32_t>& membership, bool cpm,
                            double gamma, double m2, XorShift& rng) {
  int n = g.n;
  std::vector<int32_t> refined(n);
  std::iota(refined.begin(), refined.end(), 0);
  std::vector<double> sub_size(sizes);
  std::vector<double> strength(n, 0.0), sub_strength;
  for (int v = 0; v < n; ++v)
    for (int64_t j = g.indptr[v]; j < g.indptr[v + 1]; ++j)
      strength[v] += g.data[j];
  sub_strength = strength;
  std::vector<int32_t> order(n);
  std::iota(order.begin(), order.end(), 0);
  for (int i = n - 1; i > 0; --i) std::swap(order[i], order[rng.bounded(i + 1)]);
  std::unordered_map<int32_t, double> acc;
  for (int v : order) {
    if (refined[v] != v || sub_size[v] != sizes[v]) continue;  // merged already
    acc.clear();
    for (int64_t j = g.indptr[v]; j < g.indptr[v + 1]; ++j) {
      int u = g.indices[j];
      if (u == v || membership[u] != membership[v]) continue;
      acc[refined[u]] += g.data[j];
    }
    int best_c = v;
    double best_gain = 0.0;
    for (auto& kv : acc) {
      if (kv.first == v) continue;
      double gg = cpm ? kv.second - gamma * sizes[v] * sub_size[kv.first]
                      : kv.second - gamma * strength[v] * sub_strength[kv.first] / m2;
      if (gg > best_gain + 1e-12) {
        best_gain = gg;
        best_c = kv.first;
      }
    }
    if (best_c != v) {
      sub_size[best_c] += sizes[v];
      sub_strength[best_c] += strength[v];
      sub_size[v] -= sizes[v];
      sub_strength[v] -= strength[v];
      refined[v] = best_c;
    }
  }
  relabel(refined);
  return refined;
}

Graph aggregate(const Graph& g, const std::vector<int32_t>& membership,
                const std::vector<double>& sizes, std::vector<double>& out_sizes) {
  int k = 0;
  for (auto m : membership) k = std::max(k, m + 1);
  out_sizes.assign(k, 0.0);
  for (int v = 0; v < g.n; ++v) out_sizes[membership[v]] += sizes[v];
  std::vector<std::unordered_map<int32_t, double>> rows(k);
  for (int v = 0; v < g.n; ++v)
    for (int64_t j = g.indptr[v]; j < g.indptr[v + 1]; ++j)
      rows[membership[v]][membership[g.indices[j]]] += g.data[j];
  Graph out;
  out.n = k;
  out.indptr.resize(k + 1, 0);
  for (int r = 0; r < k; ++r) out.indptr[r + 1] = out.indptr[r] + rows[r].size();
  out.indices.resize(out.indptr[k]);
  out.data.resize(out.indptr[k]);
  for (int r = 0; r < k; ++r) {
    int64_t p = out.indptr[r];
    for (auto& kv : rows[r]) {
      out.indices[p] = kv.first;
      out.data[p] = kv.second;
      ++p;
    }
  }
  return out;
}

}  // namespace

extern "C" int leiden_partition(const int64_t* indptr, const int32_t* indices,
                                const double* data, int32_t n, int32_t use_cpm,
                                double resolution, uint64_t seed,
                                int32_t max_levels, int32_t* membership_out) {
  if (n <= 0) return -1;
  Graph g;
  g.n = n;
  g.indptr.assign(indptr, indptr + n + 1);
  g.indices.assign(indices, indices + indptr[n]);
  g.data.assign(data, data + indptr[n]);
  double total = 0.0;
  for (double w : g.data) total += w;
  if (total <= 0.0) {
    std::memset(membership_out, 0, sizeof(int32_t) * n);
    return 0;
  }
  XorShift rng(seed);
  std::vector<double> sizes(n, 1.0);
  std::vector<int32_t> full(n);
  std::iota(full.begin(), full.end(), 0);
  Graph cur = g;
  bool final_done = false;
  for (int level = 0; level < max_levels; ++level) {
    Partition part(cur, sizes, use_cpm != 0, resolution, total);
    bool improved = part.move_nodes(rng, (int64_t)cur.n * 40);
    std::vector<int32_t> memb = part.membership;
    relabel(memb);
    std::vector<int32_t> ref =
        refine(cur, sizes, memb, use_cpm != 0, resolution, total, rng);
    int k = 0;
    for (auto m : ref) k = std::max(k, m + 1);
    if (!improved || k == cur.n) {
      // canonical Leiden returns the MOVE partition of the final level;
      // composing only `ref` would discard its merges (mirrors leiden.py)
      for (auto& f : full) f = memb[f];
      final_done = true;
      break;
    }
    for (auto& f : full) f = ref[f];
    std::vector<double> new_sizes;
    cur = aggregate(cur, ref, sizes, new_sizes);
    sizes = std::move(new_sizes);
  }
  if (!final_done) {
    // level budget exhausted mid-merge: one last move pass realizes the
    // pending merges on the final aggregate graph
    Partition part(cur, sizes, use_cpm != 0, resolution, total);
    part.move_nodes(rng, (int64_t)cur.n * 40);
    std::vector<int32_t> memb = part.membership;
    relabel(memb);
    for (auto& f : full) f = memb[f];
  }
  relabel(full);
  std::memcpy(membership_out, full.data(), sizeof(int32_t) * n);
  return 0;
}
