// Native max-clique solvers for PCM outlier rejection (copy of
// cvids_tpu/native/fmc.cpp, so that the port builds it without the JAX
// package; built by cvids_tpu_torch/_build.py with the host's C++ compiler).
//
// C++ counterpart of the reference's fmc library
// (server_pose_graph/include/fmc/findClique.cpp,
// findCliqueHeu.cpp): an exact branch-and-bound with candidate-count pruning
// and the Pattabiraman-style degree-guided greedy heuristic. The graphs are
// tiny (one node per inter-agent loop edge in a client-pair bucket), so this
// stays host-side native code rather than a device kernel — exactly as the
// reference keeps it on CPU.
//
// C ABI, ctypes-friendly: adjacency is a row-major uint8 matrix (0/1).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Ctx {
  const uint8_t* adj;
  int n;
  std::vector<int> best;

  bool edge(int i, int j) const { return adj[i * n + j] != 0; }
};

void expand(Ctx& ctx, std::vector<int>& r, std::vector<uint8_t>& cand,
            int cand_count) {
  if ((int)r.size() + cand_count <= (int)ctx.best.size()) return;
  if (cand_count == 0) {
    if (r.size() > ctx.best.size()) ctx.best = r;
    return;
  }
  for (int v = 0; v < ctx.n; ++v) {
    if (!cand[v]) continue;
    if ((int)r.size() + cand_count <= (int)ctx.best.size()) return;
    // branch with v
    std::vector<uint8_t> cand2(ctx.n, 0);
    int c2 = 0;
    for (int u = v + 1; u < ctx.n; ++u) {
      if (cand[u] && ctx.edge(v, u)) {
        cand2[u] = 1;
        ++c2;
      }
    }
    r.push_back(v);
    expand(ctx, r, cand2, c2);
    r.pop_back();
    cand[v] = 0;
    --cand_count;
  }
}

}  // namespace

extern "C" {

// Exact branch-and-bound. Returns clique size; indices in out (caller
// allocates n ints).
int cvids_max_clique_exact(const uint8_t* adj, int n, int* out) {
  Ctx ctx{adj, n, {}};
  std::vector<int> r;
  std::vector<uint8_t> cand(n, 1);
  expand(ctx, r, cand, n);
  for (size_t i = 0; i < ctx.best.size(); ++i) out[i] = ctx.best[i];
  return (int)ctx.best.size();
}

// Degree-guided greedy heuristic (multi-seed), the reference's maxCliqueHeu.
int cvids_max_clique_heu(const uint8_t* adj, int n, int* out, int num_seeds) {
  if (n == 0) return 0;
  std::vector<int> deg(n, 0);
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < n; ++j)
      if (i != j && adj[i * n + j]) ++deg[i];
  std::vector<int> order(n);
  for (int i = 0; i < n; ++i) order[i] = i;
  // sort by degree descending (insertion sort: n is tiny)
  for (int i = 1; i < n; ++i) {
    int v = order[i], k = i;
    while (k > 0 && deg[order[k - 1]] < deg[v]) {
      order[k] = order[k - 1];
      --k;
    }
    order[k] = v;
  }
  std::vector<int> best;
  int seeds = num_seeds < n ? num_seeds : n;
  std::vector<uint8_t> cand(n);
  for (int s = 0; s < seeds; ++s) {
    int seed = order[s];
    std::vector<int> clique{seed};
    for (int j = 0; j < n; ++j) cand[j] = (j != seed) && adj[seed * n + j];
    while (true) {
      int bestv = -1, bestd = -1;
      for (int v = 0; v < n; ++v) {
        if (!cand[v]) continue;
        int d = 0;
        for (int u = 0; u < n; ++u)
          if (cand[u] && u != v && adj[v * n + u]) ++d;
        if (d > bestd) {
          bestd = d;
          bestv = v;
        }
      }
      if (bestv < 0) break;
      clique.push_back(bestv);
      for (int u = 0; u < n; ++u) cand[u] = cand[u] && adj[bestv * n + u];
      cand[bestv] = 0;
    }
    if (clique.size() > best.size()) best = clique;
  }
  for (size_t i = 0; i < best.size(); ++i) out[i] = best[i];
  return (int)best.size();
}

}  // extern "C"
