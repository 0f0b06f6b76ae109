// rnaelem_tpu native runtime pieces (C ABI, loaded via ctypes).
//
// The reference keeps its whole runtime in C++; in this rebuild the
// compute path is XLA, and the host-side hot loops live here:
//   * klet_shuffle: uniform k-let-preserving shuffle (Euler walk over a
//     random arborescence on the (k-1)-let de Bruijn multigraph), the
//     negative-sample generator of the training loop.  Behavioral twin
//     of the ushuffle C library the reference links.
//   * fastq_index: one-pass newline indexer for mmap'ed FASTQ slurps.
//
// Build: see build_native.py (plain g++, no external deps).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <random>
#include <string>
#include <unordered_map>
#include <vector>

extern "C" {

// Uniform k-let preserving shuffle of seq (ASCII) into out (same size).
// Deterministic in `seed`. Returns 0 on success.
int klet_shuffle(const char* seq, char* out, int n, int k,
                 uint64_t seed) {
  if (k >= n || n <= 0) {
    std::memcpy(out, seq, n);
    return 0;
  }
  std::mt19937_64 rng(seed);
  if (k <= 1) {
    std::memcpy(out, seq, n);
    for (int i = n - 1; i > 0; --i) {
      int j = (int)(rng() % (uint64_t)(i + 1));
      std::swap(out[i], out[j]);
    }
    return 0;
  }
  const int km1 = k - 1;
  const int nv_seq = n - km1 + 1;

  std::unordered_map<std::string, int> ids;
  std::vector<std::string> labels;
  std::vector<int> sv(nv_seq);
  for (int i = 0; i < nv_seq; ++i) {
    std::string key(seq + i, km1);
    auto it = ids.find(key);
    if (it == ids.end()) {
      it = ids.emplace(key, (int)labels.size()).first;
      labels.push_back(key);
    }
    sv[i] = it->second;
  }
  const int nv = (int)labels.size();
  std::vector<std::vector<int>> adj(nv);
  for (int t = 0; t + 1 < nv_seq; ++t) adj[sv[t]].push_back(sv[t + 1]);

  const int root = sv[nv_seq - 1];
  std::vector<int> last_exit(nv, -1);
  std::vector<char> in_tree(nv, 0);
  in_tree[root] = 1;
  std::vector<int> path(nv, -1);
  for (int v0 = 0; v0 < nv; ++v0) {
    int v = v0;
    while (!in_tree[v]) {
      const auto& a = adj[v];
      if (a.empty()) return 1;
      path[v] = a[rng() % a.size()];
      v = path[v];
    }
    v = v0;
    while (!in_tree[v]) {
      last_exit[v] = path[v];
      in_tree[v] = 1;
      v = path[v];
    }
  }

  std::vector<std::vector<int>> out_edges(nv);
  for (int v = 0; v < nv; ++v) {
    auto rest = adj[v];
    if (last_exit[v] >= 0) {
      auto it = std::find(rest.begin(), rest.end(), last_exit[v]);
      if (it != rest.end()) rest.erase(it);
    }
    for (int i = (int)rest.size() - 1; i > 0; --i) {
      int j = (int)(rng() % (uint64_t)(i + 1));
      std::swap(rest[i], rest[j]);
    }
    if (last_exit[v] >= 0) rest.push_back(last_exit[v]);
    out_edges[v] = std::move(rest);
  }

  std::vector<int> ptr(nv, 0);
  int v = sv[0];
  std::memcpy(out, labels[v].data(), km1);
  int pos = km1;
  for (int step = 0; step + 1 < nv_seq; ++step) {
    int nxt = out_edges[v][ptr[v]++];
    out[pos++] = labels[nxt][km1 - 1];
    v = nxt;
  }
  return 0;
}

// Index a FASTQ byte buffer: records (id_off, id_len, seq_off, seq_len,
// qual_off, qual_len) packed as int64 sextuples. Returns record count,
// or -1 if out_cap records do not fit.
int64_t fastq_index(const char* buf, int64_t n, int64_t* out,
                    int64_t out_cap) {
  int64_t nrec = 0, p = 0;
  auto line = [&](int64_t& off, int64_t& len) -> bool {
    off = p;
    while (p < n && buf[p] != '\n') ++p;
    len = p - off;
    if (p < n) ++p;  // skip newline
    return len > 0 || p < n;
  };
  while (p < n) {
    int64_t io, il, so, sl, po, pl, qo, ql;
    if (!line(io, il)) break;
    if (!line(so, sl)) break;
    if (!line(po, pl)) break;
    if (!line(qo, ql)) break;
    if (ql == 0) break;
    if (nrec >= out_cap) return -1;
    int64_t* r = out + nrec * 6;
    r[0] = io; r[1] = il; r[2] = so; r[3] = sl; r[4] = qo; r[5] = ql;
    ++nrec;
  }
  return nrec;
}

}  // extern "C"
