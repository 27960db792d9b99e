// Native graph builder: the host-side runtime for relation-bucketed graph
// construction, for the static padded-bucket format of data/graph.py. The
// source is the JAX package's (primekg_rgcn_tpu/native/graphbuild.cpp);
// the port keeps its own copy so that it imports nothing of that package.
//
// Exposes a C ABI consumed via ctypes (bindings in native/__init__.py):
//   - gb_count_buckets: valid edges per relation.
//   - gb_build_rel_graph: validate edges, sort by (relation, dst) with a
//     multi-threaded LSD radix sort (16-bit digits, only as many passes as
//     the key width needs), emit padded src/dst buckets, the src-sorted
//     transpose buckets, and the per-relation reciprocal in-degree table
//     (run-length over the sorted keys, no per-relation histograms).
//   - gb_rmat: parallel R-MAT edge generator (Chakrabarti et al. 2004) for
//     BASELINE.json config 5. Each chunk of parallel_for seeds its own
//     mt19937_64 from the chunk's first edge, so the arrays depend on the
//     thread count (hw_threads) once num_edges >= 2 * 65536: on one machine
//     they equal the JAX package's library, whose parallel_for and
//     hw_threads are the same.
//
// All buffers are caller-allocated numpy arrays; no ownership crosses the
// ABI. Sorts are stable, so output matches the numpy lexsort path bit-
// for-bit.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <random>
#include <thread>
#include <vector>

namespace {

int hw_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n == 0 ? 4 : static_cast<int>(n);
}

template <typename F>
void parallel_for(int64_t n, F&& fn) {
  int nt = std::min<int64_t>(hw_threads(), std::max<int64_t>(n / 65536, 1));
  if (nt <= 1) {
    fn(0, n, 0);
    return;
  }
  std::vector<std::thread> ts;
  int64_t chunk = (n + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int64_t lo = t * chunk, hi = std::min<int64_t>(lo + chunk, n);
    if (lo >= hi) break;
    ts.emplace_back([&fn, lo, hi, t] { fn(lo, hi, t); });
  }
  for (auto& t : ts) t.join();
}

// Stable parallel LSD radix sort of (key, payload) pairs by 16-bit digits.
// Sorts only the digit positions the maximum key actually uses.
struct Edge64 {
  uint64_t key;
  int32_t src;
  int32_t dst;
};

void radix_sort(std::vector<Edge64>& a, uint64_t max_key) {
  int passes = 0;
  while (max_key >> (16 * passes)) ++passes;
  if (passes == 0) passes = 1;

  const int64_t n = static_cast<int64_t>(a.size());
  std::vector<Edge64> b(a.size());
  const int nt =
      std::min<int64_t>(hw_threads(), std::max<int64_t>(n / 65536, 1));
  const int64_t chunk = (n + nt - 1) / nt;
  std::vector<int64_t> hist(static_cast<size_t>(nt) * 65536);

  for (int pass = 0; pass < passes; ++pass) {
    const int shift = 16 * pass;
    std::fill(hist.begin(), hist.end(), 0);
    // Per-thread digit histograms.
    parallel_for(n, [&](int64_t lo, int64_t hi, int t) {
      int64_t* h = hist.data() + static_cast<int64_t>(t) * 65536;
      for (int64_t i = lo; i < hi; ++i)
        ++h[(a[i].key >> shift) & 0xFFFF];
    });
    // Exclusive prefix: digit-major, thread-minor preserves stability.
    int64_t acc = 0;
    for (int d = 0; d < 65536; ++d) {
      for (int t = 0; t < nt; ++t) {
        int64_t& h = hist[static_cast<int64_t>(t) * 65536 + d];
        int64_t c = h;
        h = acc;
        acc += c;
      }
    }
    // Scatter.
    parallel_for(n, [&](int64_t lo, int64_t hi, int t) {
      int64_t* h = hist.data() + static_cast<int64_t>(t) * 65536;
      for (int64_t i = lo; i < hi; ++i)
        b[h[(a[i].key >> shift) & 0xFFFF]++] = a[i];
    });
    a.swap(b);
  }
}

}  // namespace

extern "C" {

// Count valid edges per relation. Returns number of valid edges.
int64_t gb_count_buckets(const int64_t* src, const int64_t* dst,
                         const int64_t* rel, int64_t num_edges,
                         int64_t num_nodes, int64_t num_relations,
                         int64_t* counts) {
  std::memset(counts, 0, sizeof(int64_t) * num_relations);
  int64_t valid = 0;
  for (int64_t i = 0; i < num_edges; ++i) {
    int64_t s = src[i], d = dst[i], r = rel[i];
    if (s < 0 || s >= num_nodes || d < 0 || d >= num_nodes || r < 0 ||
        r >= num_relations)
      continue;
    ++counts[r];
    ++valid;
  }
  return valid;
}

// Build the padded relation-bucketed graph. See data/graph.py for the
// layout contract. norm mode: edge_norm == 0 writes the dense
// float32[R, N+1] inv_deg table; edge_norm == 1 writes per-edge scales into
// edge_scale/t_edge_scale (float32[total]) instead (inv_deg may be null).
// Returns 0 on success, -1 if a capacity is too small.
int32_t gb_build_rel_graph(const int64_t* src, const int64_t* dst,
                           const int64_t* rel, int64_t num_edges,
                           int64_t num_nodes, int64_t num_relations,
                           const int64_t* caps, int32_t* src_pad,
                           int32_t* dst_pad, int32_t* t_src_pad,
                           int32_t* t_dst_pad, float* inv_deg,
                           int32_t edge_norm, float* edge_scale,
                           float* t_edge_scale) {
  // Pack valid edges with (relation, dst) keys.
  std::vector<Edge64> edges;
  edges.reserve(num_edges);
  std::vector<int64_t> counts(num_relations, 0);
  const uint64_t stride = static_cast<uint64_t>(num_nodes) + 1;
  for (int64_t i = 0; i < num_edges; ++i) {
    int64_t s = src[i], d = dst[i], r = rel[i];
    if (s < 0 || s >= num_nodes || d < 0 || d >= num_nodes || r < 0 ||
        r >= num_relations)
      continue;
    edges.push_back({static_cast<uint64_t>(r) * stride +
                         static_cast<uint64_t>(d),
                     static_cast<int32_t>(s), static_cast<int32_t>(d)});
    ++counts[r];
  }
  std::vector<int64_t> offsets(num_relations + 1, 0);
  for (int64_t r = 0; r < num_relations; ++r) {
    if (caps[r] < counts[r]) return -1;
    offsets[r + 1] = offsets[r] + caps[r];
  }
  const int64_t total = offsets[num_relations];
  const int32_t sentinel = static_cast<int32_t>(num_nodes);

  parallel_for(total, [&](int64_t lo, int64_t hi, int) {
    std::fill(src_pad + lo, src_pad + hi, sentinel);
    std::fill(dst_pad + lo, dst_pad + hi, sentinel);
    std::fill(t_src_pad + lo, t_src_pad + hi, sentinel);
    std::fill(t_dst_pad + lo, t_dst_pad + hi, sentinel);
  });
  if (edge_norm == 0) {
    parallel_for(num_relations * (num_nodes + 1),
                 [&](int64_t lo, int64_t hi, int) {
                   std::fill(inv_deg + lo, inv_deg + hi, 0.0f);
                 });
  } else {
    parallel_for(total, [&](int64_t lo, int64_t hi, int) {
      std::fill(edge_scale + lo, edge_scale + hi, 0.0f);
      std::fill(t_edge_scale + lo, t_edge_scale + hi, 0.0f);
    });
  }
  // Transient per-relation reciprocal-degree table for edge mode.
  std::vector<float> inv_tmp;
  if (edge_norm != 0) inv_tmp.assign(num_nodes + 1, 0.0f);

  const uint64_t max_key =
      num_relations > 0 ? static_cast<uint64_t>(num_relations) * stride - 1
                        : 0;
  radix_sort(edges, max_key);

  // Emit dst-sorted buckets + run-length in-degrees over the sorted keys.
  {
    int64_t pos = 0;  // index into `edges`
    for (int64_t r = 0; r < num_relations; ++r) {
      const int64_t out0 = offsets[r];
      const int64_t n_bucket = counts[r];
      parallel_for(n_bucket, [&](int64_t lo, int64_t hi, int) {
        for (int64_t i = lo; i < hi; ++i) {
          src_pad[out0 + i] = edges[pos + i].src;
          dst_pad[out0 + i] = edges[pos + i].dst;
        }
      });
      // Degree runs (sequential per bucket; O(bucket)).
      int64_t i = 0;
      float* inv_r =
          edge_norm == 0 ? inv_deg + r * (num_nodes + 1) : inv_tmp.data();
      while (i < n_bucket) {
        int64_t j = i;
        const int32_t d = edges[pos + i].dst;
        while (j < n_bucket && edges[pos + j].dst == d) ++j;
        const float inv = 1.0f / static_cast<float>(j - i);
        inv_r[d] = inv;
        if (edge_norm != 0)
          std::fill(edge_scale + out0 + i, edge_scale + out0 + j, inv);
        i = j;
      }
      pos += n_bucket;
    }
  }

  // Transpose buckets: re-key by (relation, src) and radix sort again.
  parallel_for(static_cast<int64_t>(edges.size()),
               [&](int64_t lo, int64_t hi, int) {
                 for (int64_t i = lo; i < hi; ++i) {
                   Edge64& e = edges[i];
                   const uint64_t r = e.key / stride;
                   e.key = r * stride + static_cast<uint64_t>(e.src);
                 }
               });
  radix_sort(edges, max_key);
  {
    int64_t pos = 0;
    for (int64_t r = 0; r < num_relations; ++r) {
      const int64_t out0 = offsets[r];
      const int64_t n_bucket = counts[r];
      if (edge_norm != 0) {
        // Rebuild the relation's reciprocal-degree table from the already
        // emitted dst-sorted bucket (touch only present nodes).
        int64_t i = 0;
        while (i < n_bucket) {
          int64_t j = i;
          const int32_t d = dst_pad[out0 + i];
          while (j < n_bucket && dst_pad[out0 + j] == d) ++j;
          inv_tmp[d] = 1.0f / static_cast<float>(j - i);
          i = j;
        }
      }
      parallel_for(n_bucket, [&](int64_t lo, int64_t hi, int) {
        for (int64_t i = lo; i < hi; ++i) {
          t_src_pad[out0 + i] = edges[pos + i].src;
          t_dst_pad[out0 + i] = edges[pos + i].dst;
          if (edge_norm != 0)
            t_edge_scale[out0 + i] = inv_tmp[edges[pos + i].dst];
        }
      });
      if (edge_norm != 0) {
        // Clear only the touched entries for the next relation.
        int64_t i = 0;
        while (i < n_bucket) {
          inv_tmp[dst_pad[out0 + i]] = 0.0f;
          int64_t j = i;
          const int32_t d = dst_pad[out0 + i];
          while (j < n_bucket && dst_pad[out0 + j] == d) ++j;
          i = j;
        }
      }
      pos += n_bucket;
    }
  }
  return 0;
}

// Parallel R-MAT generator. Fills src/dst/rel (int64[num_edges]).
void gb_rmat(int64_t num_nodes, int64_t num_edges, int64_t num_relations,
             uint64_t seed, double a, double b, double c, int64_t* src,
             int64_t* dst, int64_t* rel) {
  int n_bits = 1;
  while ((int64_t(1) << n_bits) < num_nodes) ++n_bits;
  parallel_for(num_edges, [&](int64_t lo, int64_t hi, int) {
    std::mt19937_64 rng(seed + 0x9e3779b97f4a7c15ULL * (lo + 1));
    std::uniform_real_distribution<double> uni(0.0, 1.0);
    for (int64_t i = lo; i < hi; ++i) {
      int64_t s = 0, d = 0;
      for (int bit = 0; bit < n_bits; ++bit) {
        double r = uni(rng);
        int64_t sb = (r >= a + b) ? 1 : 0;
        int64_t db = ((r >= a && r < a + b) || r >= a + b + c) ? 1 : 0;
        s = (s << 1) | sb;
        d = (d << 1) | db;
      }
      src[i] = s % num_nodes;
      dst[i] = d % num_nodes;
      rel[i] = static_cast<int64_t>(rng() % num_relations);
    }
  });
}

}  // extern "C"
