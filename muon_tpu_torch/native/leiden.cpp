// Multiplex Leiden/Louvain local-moving engine.
//
// The reference delegates community detection to leidenalg (C++ via
// igraph, muon/_core/tools.py:1034-1038). This is the native equivalent
// for muon-tpu: sequential local moving over multiple graph layers with a
// shared partition (RB-configuration quality, per-layer resolution and
// weight), plus the randomized restricted variant used for Leiden
// refinement (Traag et al. 2019 §B: merge singletons with probability
// proportional to exp(gain/theta), the mechanism that lets the optimizer
// escape the local optima a purely greedy merge sequence gets stuck in).
// The Python side (muon_tpu_torch/ops/leiden.py) keeps the level loop;
// this file owns the per-node hot loop, the symmetrisation and the
// aggregation. It is the port's own copy of the JAX package's engine
// (muon_tpu/native/leiden.cpp), kept identical in its arithmetic so that
// both packages give the same labels for the same graphs and seed.
//
// Layers arrive flattened: indptr_all is L stacked (n+1)-vectors,
// indices/data are stacked CSR payloads with per-layer offsets.
//
// Memory layout notes (the loop is cache-miss-bound, not FLOP-bound):
// community totals are stored community-major (n+1, L) so the gain loop
// touches ONE cache line per candidate community; per-community edge
// weights live in slot-compacted scratch that stays in L1; the neighbor
// list collected during accumulation is reused for re-enqueueing so a
// move never re-reads the CSR payload.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <random>
#include <vector>

namespace {

struct AggResult {
  std::vector<int64_t> indptr;
  std::vector<int32_t> indices;
  std::vector<double> data;
};

}  // namespace

extern "C" {

// Aggregate a CSR graph onto a partition: out[labels[i], labels[j]] +=
// A[i, j]. One counting-sort pass buckets the relabeled triplets by
// output row, then a slot map dedups each row — O(nnz), no sort. This
// replaces the scipy coo->csr constructor in the Leiden level loop,
// whose sort+dedup was ~half the wall time at 1M cells x 3 modality
// graphs. Returns an opaque handle; read the arrays out then free it.
void* csr_aggregate(
    int64_t n, int64_t n_comm,
    const int64_t* indptr, const int32_t* indices, const double* data,
    const int64_t* labels) {
  const int64_t nnz = indptr[n];
  // per-out-row entry counts
  std::vector<int64_t> cursor(n_comm + 1, 0);
  for (int64_t i = 0; i < n; i++)
    cursor[labels[i] + 1] += indptr[i + 1] - indptr[i];
  for (int64_t c = 0; c < n_comm; c++) cursor[c + 1] += cursor[c];
  std::vector<int64_t> bstart(cursor);  // bucket starts (copy)

  // scatter relabeled (col, val) into row buckets
  std::vector<int32_t> bcol(nnz);
  std::vector<double> bval(nnz);
  for (int64_t i = 0; i < n; i++) {
    int64_t& pos = cursor[labels[i]];
    for (int64_t p = indptr[i]; p < indptr[i + 1]; p++) {
      bcol[pos] = (int32_t)labels[indices[p]];
      bval[pos] = data[p];
      pos++;
    }
  }

  // per-row dedup with a slot map
  auto* out = new AggResult();
  out->indptr.resize(n_comm + 1);
  out->indices.reserve(std::min<int64_t>(nnz, n_comm * 64));
  out->data.reserve(std::min<int64_t>(nnz, n_comm * 64));
  std::vector<int64_t> slot(n_comm, -1);
  out->indptr[0] = 0;
  for (int64_t c = 0; c < n_comm; c++) {
    const int64_t row_base = (int64_t)out->indices.size();
    for (int64_t p = bstart[c]; p < (c + 1 <= n_comm ? bstart[c + 1] : nnz);
         p++) {
      const int32_t cc = bcol[p];
      int64_t s = slot[cc];
      if (s < 0) {
        s = (int64_t)out->indices.size();
        slot[cc] = s;
        out->indices.push_back(cc);
        out->data.push_back(0.0);
      }
      out->data[s] += bval[p];
    }
    for (int64_t q = row_base; q < (int64_t)out->indices.size(); q++)
      slot[out->indices[q]] = -1;
    out->indptr[c + 1] = (int64_t)out->indices.size();
  }
  return out;
}

// Build the symmetrized, diagonal-free layer matrix (A+Aᵀ)/2 in one
// counting-sort pass (the scipy (A+Aᵀ)/2 → setdiag → eliminate_zeros
// chain costs 3 sort/copy passes). Same handle protocol as
// csr_aggregate.
void* csr_symmetrize(
    int64_t n,
    const int64_t* indptr, const int32_t* indices, const double* data,
    int32_t drop_diag) {
  // out-degree per row counting both directions
  std::vector<int64_t> cursor(n + 1, 0);
  for (int64_t i = 0; i < n; i++) {
    for (int64_t p = indptr[i]; p < indptr[i + 1]; p++) {
      const int64_t j = indices[p];
      if (drop_diag && j == i) continue;
      cursor[i + 1]++;
      cursor[j + 1]++;
    }
  }
  for (int64_t r = 0; r < n; r++) cursor[r + 1] += cursor[r];
  std::vector<int64_t> bstart(cursor);
  const int64_t total = cursor[n];

  std::vector<int32_t> bcol(total);
  std::vector<double> bval(total);
  for (int64_t i = 0; i < n; i++) {
    for (int64_t p = indptr[i]; p < indptr[i + 1]; p++) {
      const int64_t j = indices[p];
      if (drop_diag && j == i) continue;
      const double v = 0.5 * data[p];
      bcol[cursor[i]] = (int32_t)j;
      bval[cursor[i]++] = v;
      bcol[cursor[j]] = (int32_t)i;
      bval[cursor[j]++] = v;
    }
  }

  auto* out = new AggResult();
  out->indptr.resize(n + 1);
  out->indices.reserve(total);
  out->data.reserve(total);
  std::vector<int64_t> slot(n, -1);
  out->indptr[0] = 0;
  for (int64_t r = 0; r < n; r++) {
    const int64_t row_base = (int64_t)out->indices.size();
    for (int64_t p = bstart[r]; p < bstart[r + 1]; p++) {
      const int32_t cc = bcol[p];
      int64_t s = slot[cc];
      if (s < 0) {
        s = (int64_t)out->indices.size();
        slot[cc] = s;
        out->indices.push_back(cc);
        out->data.push_back(0.0);
      }
      out->data[s] += bval[p];
    }
    for (int64_t q = row_base; q < (int64_t)out->indices.size(); q++)
      slot[out->indices[q]] = -1;
    out->indptr[r + 1] = (int64_t)out->indices.size();
  }
  return out;
}

// Fuzzy-union connectivities straight from a dense kNN membership table
// (umap-learn's fuzzy simplicial set union):
//   out[i,j] = mix·(a + b − a·b) + (1−mix)·(a·b)
// over the directed memberships a = v(i→j), b = v(j→i). One counting-sort
// scatter and one slot-merge pass, O(n·k); the scipy chain it stands in for
// (coo→csr, transpose, multiply, add, eliminate_zeros) sorts several times.
// idx: (n,k) int32 neighbour ids (−1, the row itself and zero memberships
// are skipped), vals: (n,k) float32. A row's columns come out in insertion
// order, so the caller sorts them. Same handle protocol as csr_aggregate;
// the port's own copy of the JAX package's knn_fuzzy_union, arithmetic
// unchanged.
void* knn_fuzzy_union(
    int64_t n, int64_t k,
    const int32_t* idx, const float* vals, double mix) {
  std::vector<int64_t> cursor(n + 1, 0);
  for (int64_t i = 0; i < n; i++) {
    const int64_t base = i * k;
    for (int64_t p = 0; p < k; p++) {
      const int32_t j = idx[base + p];
      if (j < 0 || j == i || vals[base + p] == 0.0f) continue;
      cursor[i + 1]++;
      cursor[j + 1]++;
    }
  }
  for (int64_t r = 0; r < n; r++) cursor[r + 1] += cursor[r];
  std::vector<int64_t> bstart(cursor);
  const int64_t total = cursor[n];

  std::vector<int32_t> bcol(total);
  std::vector<double> bval(total);
  for (int64_t i = 0; i < n; i++) {
    const int64_t base = i * k;
    for (int64_t p = 0; p < k; p++) {
      const int32_t j = idx[base + p];
      const double v = (double)vals[base + p];
      if (j < 0 || j == i || v == 0.0) continue;
      bcol[cursor[i]] = j;
      bval[cursor[i]++] = v;
      bcol[cursor[j]] = (int32_t)i;
      bval[cursor[j]++] = v;
    }
  }

  auto* out = new AggResult();
  out->indptr.resize(n + 1);
  out->indices.reserve(total);
  out->data.reserve(total);
  std::vector<int64_t> slot(n, -1);
  std::vector<uint8_t> seen;
  seen.reserve(total);
  out->indptr[0] = 0;
  for (int64_t r = 0; r < n; r++) {
    const int64_t row_base = (int64_t)out->indices.size();
    for (int64_t p = bstart[r]; p < bstart[r + 1]; p++) {
      const int32_t cc = bcol[p];
      const double v = bval[p];
      int64_t s = slot[cc];
      if (s < 0) {
        s = (int64_t)out->indices.size();
        slot[cc] = s;
        out->indices.push_back(cc);
        out->data.push_back(v);  // raw a, finalised below
        seen.push_back(1);
      } else {
        const double a = out->data[s];
        out->data[s] = mix * (a + v - a * v) + (1.0 - mix) * (a * v);
        seen[s] = 2;
      }
    }
    for (int64_t q = row_base; q < (int64_t)out->indices.size(); q++) {
      slot[out->indices[q]] = -1;
      if (seen[q] == 1) out->data[q] *= mix;  // b = 0, so mix·a
    }
    out->indptr[r + 1] = (int64_t)out->indices.size();
  }
  return out;
}

int64_t agg_nnz(void* h) { return ((AggResult*)h)->indptr.back(); }
const int64_t* agg_indptr(void* h) { return ((AggResult*)h)->indptr.data(); }
const int32_t* agg_indices(void* h) { return ((AggResult*)h)->indices.data(); }
const double* agg_data(void* h) { return ((AggResult*)h)->data.data(); }
void agg_free(void* h) { delete (AggResult*)h; }

// Returns the number of applied moves; *total_gain (if non-null) gets the
// summed ΔQ of the applied moves — the Python level loop uses it to stop
// descending once a level's improvement is negligible. labels is updated
// in place.
//
// randomized == 0: greedy queue-based local moving ("fast local move" of
//   Traag et al. 2019): after an initial shuffled sweep, only nodes whose
//   neighborhood changed are revisited. Each node considers joining any
//   neighboring community AND splitting off into an empty community (the
//   classic Louvain "isolate" move — without it, weakly attached nodes
//   can never leave an oversized community).
// randomized == 1: one shuffled pass over the nodes; only nodes that are
//   currently alone in their community may move, and the target among the
//   positive-gain candidates (plus "stay") is sampled with probability
//   proportional to exp(gain / theta), theta = theta_frac * max_gain
//   (scale-free: selection depends only on gain ratios, so it behaves
//   identically on raw and aggregated levels).
//
// Labels and community counts are kept in int32 internally: the move loop
// is bound by random reads of labels[j] over the neighbor stream (~120M
// gathers at 1M cells x 3 layers), and halving the array from 8MB to 4MB
// keeps far more of it resident in L2 (measured ~25% off the fine-level
// move at 1M cells).
int64_t multiplex_local_move(
    int64_t n,
    int32_t n_layers,
    const int64_t* indptr_all,    // (L*(n+1),)
    const int32_t* indices_all,   // concatenated
    const double* data_all,       // concatenated
    const int64_t* payload_off,   // (L,) offsets into indices/data
    const double* deg_all,        // (L*n,)
    const double* two_m,          // (L,)
    const double* gamma,          // (L,)
    const double* layer_w,        // (L,)
    int64_t* labels,              // (n,) in/out
    const int64_t* restrict_grp,  // (n,) or nullptr
    int32_t max_passes,
    uint64_t seed,
    int32_t randomized,
    double theta_frac,
    double* total_gain) {
  const int L = n_layers;

  // per-layer 2/2m_l premultiplied with the layer weight: the exact
  // per-layer factor of ΔQ (layers of different mass must NOT be scaled
  // by their own m_l, which a bare w_l factor would implicitly do)
  double wscale[16], g_over_2m[16];
  for (int l = 0; l < L; l++) {
    wscale[l] = layer_w[l] * 2.0 / two_m[l];
    g_over_2m[l] = gamma[l] / two_m[l];
  }

  // int32 working copies of the two hottest random-access arrays
  std::vector<int32_t> lab(n);
  for (int64_t i = 0; i < n; i++) lab[i] = (int32_t)labels[i];
  std::vector<int32_t> rgrp;
  if (restrict_grp) {
    rgrp.resize(n);
    for (int64_t i = 0; i < n; i++) rgrp[i] = (int32_t)restrict_grp[i];
  }

  // community degree totals, community-major (n+1, L), and node counts
  std::vector<double> tots((size_t)(n + 1) * L, 0.0);
  std::vector<int32_t> comm_count(n + 1, 0);
  for (int64_t i = 0; i < n; i++) {
    double* t = tots.data() + (size_t)lab[i] * L;
    for (int l = 0; l < L; l++) t[l] += deg_all[(size_t)l * n + i];
    comm_count[lab[i]]++;
  }
  // empty community ids — targets for split-off moves
  std::vector<int32_t> free_ids;
  for (int64_t c = n; c >= 0; c--)
    if (comm_count[c] == 0) free_ids.push_back((int32_t)c);

  // scratch: slot-compacted per-community edge weights — touched
  // communities get sequential slots so the accumulation stays in L1
  // instead of striding a (n+1)*L array, and no per-community clear loop
  // is needed (slot_of reset via the touched list)
  std::vector<int32_t> slot_of(n + 1, -1);
  std::vector<double> comm_w;   // (slot, layer), grown on demand
  comm_w.reserve(4096 * L);
  std::vector<int64_t> touched;
  touched.reserve(4096);
  std::vector<double> gains;
  gains.reserve(4096);
  std::vector<int32_t> nbrs;    // neighbors seen this visit (for re-enqueue)
  nbrs.reserve(4096);

  std::vector<int64_t> order(n);
  for (int64_t i = 0; i < n; i++) order[i] = i;
  std::mt19937_64 rng(seed);
  // initial shuffled visit order (Fisher-Yates)
  for (int64_t i = n - 1; i > 0; i--) {
    int64_t j = (int64_t)(rng() % (uint64_t)(i + 1));
    std::swap(order[i], order[j]);
  }
  std::uniform_real_distribution<double> unif(0.0, 1.0);

  std::vector<int64_t> queue(order);
  std::vector<uint8_t> in_q(n, 1);
  size_t head = 0;
  const uint64_t budget = randomized
      ? (uint64_t)n
      : (uint64_t)max_passes * (uint64_t)n;  // safety cap
  uint64_t visits = 0;

  int64_t n_moves = 0;
  double gain_sum = 0.0;
  for (; head < queue.size() && visits < budget; visits++) {
    if (head > (size_t)n && head * 2 > queue.size()) {
      // compact the ring to bound memory
      queue.erase(queue.begin(), queue.begin() + head);
      head = 0;
    }
    const int64_t i = queue[head++];
    in_q[i] = 0;
    const int32_t ci = lab[i];
    if (randomized && comm_count[ci] != 1) continue;  // merged already

    // accumulate k_{i->comm} per layer into compacted slots, remembering
    // the neighbor ids so a move can re-enqueue without re-reading CSR
    touched.clear();
    nbrs.clear();
    for (int l = 0; l < L; l++) {
      const int64_t* indptr = indptr_all + (size_t)l * (n + 1);
      const int32_t* idx = indices_all + payload_off[l];
      const double* dat = data_all + payload_off[l];
      for (int64_t p = indptr[i]; p < indptr[i + 1]; p++) {
        const int64_t j = idx[p];
        if (j == i) continue;  // self-loop moves with the node
        if (restrict_grp && rgrp[j] != rgrp[i]) continue;
        const int32_t c = lab[j];
        nbrs.push_back((int32_t)j);
        int32_t s = slot_of[c];
        if (s < 0) {
          s = (int32_t)touched.size();
          slot_of[c] = s;
          touched.push_back(c);
          if (comm_w.size() < (size_t)(s + 1) * L)
            comm_w.resize((size_t)(s + 1) * L);
          for (int ll = 0; ll < L; ll++) comm_w[(size_t)s * L + ll] = 0.0;
        }
        comm_w[(size_t)s * L + l] += dat[p];
      }
    }

    // gain of moving i: ci -> d
    double base[16], ki[16];  // L capped in the Python wrapper
    const int32_t ci_slot = slot_of[ci];
    for (int l = 0; l < L; l++) {
      base[l] = ci_slot >= 0 ? comm_w[(size_t)ci_slot * L + l] : 0.0;
      ki[l] = deg_all[(size_t)l * n + i];
    }
    const double* tot_ci = tots.data() + (size_t)ci * L;
    double tot_c[16];
    for (int l = 0; l < L; l++) tot_c[l] = tot_ci[l] - ki[l];

    int64_t best_comm = ci;
    double best_gain = 0.0;
    gains.clear();
    for (int64_t t_i = 0; t_i < (int64_t)touched.size(); t_i++) {
      const int64_t d = touched[t_i];
      if (d == ci) {
        gains.push_back(0.0);
        continue;
      }
      const double* tot_d = tots.data() + (size_t)d * L;
      const double* cw = comm_w.data() + (size_t)t_i * L;
      double gain = 0.0;
      for (int l = 0; l < L; l++)
        gain += wscale[l] * ((cw[l] - base[l]) -
                             g_over_2m[l] * ki[l] * (tot_d[l] - tot_c[l]));
      gains.push_back(gain);
      if (gain > best_gain + 1e-12) {
        best_gain = gain;
        best_comm = d;
      }
    }

    bool to_empty = false;
    if (!randomized && comm_count[ci] > 1 && !free_ids.empty()) {
      // split-off candidate: i alone in a fresh community
      double gain = 0.0;
      for (int l = 0; l < L; l++)
        gain += wscale[l] * (-base[l] + g_over_2m[l] * ki[l] * tot_c[l]);
      if (gain > best_gain + 1e-12) {
        best_gain = gain;
        best_comm = free_ids.back();
        to_empty = true;
      }
    }

    double applied_gain = best_gain;
    if (randomized && best_gain > 0.0) {
      // sample target ∝ exp(gain/theta) among {stay} ∪ {gain>0}
      const double theta = theta_frac * best_gain + 1e-300;
      double z = std::exp(-best_gain / theta);  // "stay", gain 0
      for (size_t t_i = 0; t_i < touched.size(); t_i++)
        if (gains[t_i] > 0.0 && touched[t_i] != ci)
          z += std::exp((gains[t_i] - best_gain) / theta);
      double r = unif(rng) * z - std::exp(-best_gain / theta);
      best_comm = ci;  // default: stay
      if (r >= 0.0) {
        for (size_t t_i = 0; t_i < touched.size(); t_i++) {
          if (gains[t_i] <= 0.0 || touched[t_i] == ci) continue;
          r -= std::exp((gains[t_i] - best_gain) / theta);
          if (r < 0.0) {
            best_comm = touched[t_i];
            applied_gain = gains[t_i];
            break;
          }
        }
        if (r >= 0.0) best_comm = ci;  // numerical tail
      }
    }

    // clear scratch before any re-enqueueing (touched is reused)
    for (int64_t t_i = 0; t_i < (int64_t)touched.size(); t_i++)
      slot_of[touched[t_i]] = -1;

    if (best_comm != ci) {
      if (to_empty) free_ids.pop_back();
      double* t_old = tots.data() + (size_t)ci * L;
      double* t_new = tots.data() + (size_t)best_comm * L;
      for (int l = 0; l < L; l++) {
        t_old[l] -= ki[l];
        t_new[l] += ki[l];
      }
      comm_count[ci]--;
      comm_count[best_comm]++;
      if (comm_count[ci] == 0) free_ids.push_back(ci);
      lab[i] = (int32_t)best_comm;
      n_moves++;
      gain_sum += applied_gain;  // sampled (randomized) or best (greedy)
      if (!randomized) {
        // revisit neighbors whose best move may have changed: any
        // neighbor not already queued and not in i's new community —
        // replayed from the nbrs buffer, no CSR re-read
        for (size_t p = 0; p < nbrs.size(); p++) {
          const int64_t j = nbrs[p];
          if (in_q[j] || lab[j] == best_comm) continue;
          in_q[j] = 1;
          queue.push_back(j);
        }
      }
    }
  }
  for (int64_t i = 0; i < n; i++) labels[i] = lab[i];
  if (total_gain) *total_gain = gain_sum;
  return n_moves;
}

}  // extern "C"
