// Host-side CTC prefix beam search with a dense bigram LM: the hot loop of
// the ``Beam`` decoder (decode/beam.py), a copy of the JAX package's native
// search (ctc_native.cpp there), whose scoring rules are the reference's
// (timit/utils/BeamSearch.py): blank-skip > 0.9, the prBlank-vs-prTotal
// repeat rule on the previous frame, the LM on every extension, </s>
// scoring, length normalisation.  Beside it, a copy of the same file's
// batch Levenshtein distance, the host edit distance of
// ops/editdistance.py:padded_edit_distance (the reference's `editdistance`
// C++ extension, timit/models/model_ctc.py:7,200).
//
// Built as a plain shared library (no pybind11) by g++ at first use and
// bound with ctypes (native/__init__.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Batch Levenshtein edit distance over padded int32 arrays.
// refs: (b, rl), hyps: (b, hl); unit insert/delete/substitute costs
// (matches timit/utils/ctcDecoder.py:131-149).
// ---------------------------------------------------------------------------
void batch_edit_distance(const int32_t* refs, const int32_t* ref_lens,
                         const int32_t* hyps, const int32_t* hyp_lens,
                         int32_t b, int32_t rl, int32_t hl, int64_t* out) {
  std::vector<int64_t> prev(hl + 1), cur(hl + 1);
  for (int32_t i = 0; i < b; ++i) {
    const int32_t* ref = refs + (int64_t)i * rl;
    const int32_t* hyp = hyps + (int64_t)i * hl;
    // clamp to the padded widths like the numpy twin (a caller passing a
    // length beyond the padding must not read/write out of bounds)
    int32_t n = std::min(std::max(ref_lens[i], 0), rl);
    int32_t m = std::min(std::max(hyp_lens[i], 0), hl);
    if (n == 0) { out[i] = m; continue; }
    if (m == 0) { out[i] = n; continue; }
    for (int32_t j = 0; j <= m; ++j) prev[j] = j;
    for (int32_t r = 1; r <= n; ++r) {
      cur[0] = r;
      int32_t rc = ref[r - 1];
      for (int32_t j = 1; j <= m; ++j) {
        int64_t sub = prev[j - 1] + (hyp[j - 1] != rc);
        int64_t del = prev[j] + 1;
        int64_t ins = cur[j - 1] + 1;
        cur[j] = std::min(sub, std::min(del, ins));
      }
      std::swap(prev, cur);
    }
    out[i] = prev[m];
  }
}

// ---------------------------------------------------------------------------
// CTC prefix beam search with dense bigram LM.
// ---------------------------------------------------------------------------

namespace {

constexpr double kLogZero = -99999999.0;

inline double log_add(double x, double y) {
  if (x <= kLogZero) return y;
  if (y <= kLogZero) return x;
  if (y > x) std::swap(x, y);
  return x + std::log1p(std::exp(y - x));
}

struct Node {
  int32_t parent;  // index into nodes; -1 for root
  int32_t label;   // -1 for root
  int32_t len;
};

struct Entry {
  int32_t node;
  double pr_blank;
  double pr_nonblank;
  double total() const { return log_add(pr_blank, pr_nonblank); }
};

}  // namespace

// probs: (T, C) probabilities (not log). lm_table: (V+1, V+1) natural-log
// bigram matrix (row V = <s>, col V = </s>) or nullptr.  Returns decoded
// length; sequence written into out_seq (capacity T).
int32_t ctc_beam_search(const float* probs, int32_t t_len, int32_t c,
                        int32_t length, int32_t beam_width,
                        const float* lm_table, int32_t lm_dim,
                        float lm_alpha, int32_t blank, int32_t* out_seq,
                        double* out_score) {
  std::vector<Node> nodes;
  nodes.push_back({-1, -1, 0});  // root = empty prefix

  std::vector<Entry> beams;
  beams.push_back({0, 0.0, kLogZero});

  std::vector<Entry> best;
  // (parent node, label) -> child node, PERSISTENT across frames: node ids
  // are canonical per label sequence, so a prefix that was pruned and later
  // re-created folds into the same node — the reference's dict keyed on the
  // full label tuple (BeamSearch.py addLabelling/log_add).  A per-frame map
  // here would split probability mass between duplicate nodes.
  std::unordered_map<int64_t, int32_t> child_id;
  std::unordered_map<int32_t, int32_t> frame_idx;  // node -> curr idx
  std::vector<Entry> curr;
  const int32_t sent = lm_dim - 1;  // sentinel row <s> / col </s>

  int32_t t_use = std::min(length, t_len);
  for (int32_t t = 0; t < t_use; ++t) {
    const float* p = probs + (int64_t)t * c;
    if (1.0f - p[blank] < 0.1f) continue;  // blank-skip (BeamSearch.py:93)

    // top beam_width by total
    best.assign(beams.begin(), beams.end());
    std::sort(best.begin(), best.end(), [](const Entry& a, const Entry& b) {
      return a.total() > b.total();
    });
    if ((int32_t)best.size() > beam_width) best.resize(beam_width);

    curr.clear();
    frame_idx.clear();

    bool prev_blank_ge =
        (t == 0) ? true
                 : (probs[(int64_t)(t - 1) * c + blank] >= 0.9f);
    double lp_blank = std::log(std::max((double)p[blank], 1e-300));

    // PASS 1 — copy paths.  Node ids are canonical (one per label tuple),
    // so registering each survivor under its node id lets pass 2's
    // extensions that produce the same tuple fold into it.
    for (const Entry& e : best) {
      const Node nd = nodes[e.node];
      double pr_total = e.total();
      frame_idx[e.node] = (int32_t)curr.size();
      curr.push_back({e.node, kLogZero, kLogZero});
      Entry& ce = curr.back();
      ce.pr_blank = log_add(ce.pr_blank, pr_total + lp_blank);
      if (nd.label >= 0) {
        double lp_last = std::log(std::max((double)p[nd.label], 1e-300));
        ce.pr_nonblank = log_add(ce.pr_nonblank, e.pr_nonblank + lp_last);
      }
    }
    // PASS 2 — extensions (order-insensitive: log_add is commutative).
    for (const Entry& e : best) {
      const Node nd = nodes[e.node];
      double pr_total = e.total();
      const float* lm_row = nullptr;
      if (lm_table) {
        int32_t c1 = nd.label >= 0 ? nd.label : sent;
        lm_row = lm_table + (int64_t)c1 * lm_dim;
      }
      for (int32_t k = 0; k < c; ++k) {
        if (k == blank) continue;
        double lp_k = std::log(std::max((double)p[k], 1e-300));
        double lm = lm_row ? (double)lm_row[k] * lm_alpha : 0.0;
        double base =
            (nd.label == k && !prev_blank_ge) ? e.pr_blank : pr_total;
        double score = lp_k + lm + base;
        int64_t key = (int64_t)e.node * c + k;
        auto cit = child_id.find(key);
        int32_t child;
        if (cit == child_id.end()) {
          nodes.push_back({e.node, k, nd.len + 1});
          child = (int32_t)nodes.size() - 1;
          child_id.emplace(key, child);
        } else {
          child = cit->second;
        }
        auto it = frame_idx.find(child);
        int32_t idx;
        if (it == frame_idx.end()) {
          idx = (int32_t)curr.size();
          frame_idx.emplace(child, idx);
          curr.push_back({child, kLogZero, kLogZero});
        } else {
          idx = it->second;
        }
        curr[idx].pr_nonblank = log_add(curr[idx].pr_nonblank, score);
      }
    }
    beams.assign(curr.begin(), curr.end());
  }

  // final: </s> LM + length normalisation (BeamSearch.py:130-145)
  best.assign(beams.begin(), beams.end());
  std::sort(best.begin(), best.end(), [](const Entry& a, const Entry& b) {
    return a.total() > b.total();
  });
  if ((int32_t)best.size() > beam_width) best.resize(beam_width);

  double best_score = -1e308;
  int32_t best_node = 0;
  for (const Entry& e : best) {
    const Node& nd = nodes[e.node];
    double total = e.total();
    if (lm_table && nd.label >= 0) {
      total += (double)lm_table[(int64_t)nd.label * lm_dim + sent] * lm_alpha;
    }
    double norm = total / (nd.len > 0 ? nd.len : 1);
    if (norm > best_score) {
      best_score = norm;
      best_node = e.node;
    }
  }
  // reconstruct
  int32_t len = nodes[best_node].len;
  int32_t cur_node = best_node;
  for (int32_t i = len - 1; i >= 0; --i) {
    out_seq[i] = nodes[cur_node].label;
    cur_node = nodes[cur_node].parent;
  }
  if (out_score) *out_score = best_score;
  return len;
}

}  // extern "C"
