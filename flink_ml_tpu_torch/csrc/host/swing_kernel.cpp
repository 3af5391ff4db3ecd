// Native core for the Swing item-similarity computation.
//
// Ref parity: the ComputingSimilarItems inner loops of
// flink-ml-lib/.../recommendation/swing/Swing.java (pairwise purchaser
// intersection + score accumulation + top-k). This host-side work is
// set-intersection over ragged id lists — XLA-hostile — so it is the
// framework's native (C++) tier; the Python orchestration in
// models/recommendation/swing.py falls back to a pure-Python loop when the
// shared library is unavailable.
//
// Data layout (CSR-style, matching the Python wrapper in
// flink_ml_tpu/native/__init__.py):
//   user_items / user_offsets : sorted item ids per filtered user
//   user_weights              : 1/(alpha1+|I_u|)^beta per user
//   item_users / item_offsets : user indices per item (capped upstream)
//   item_ids                  : the item id for each row of item_offsets
// Output: for each item, up to k (similar_item, score) pairs sorted by
// score descending; out_counts[i] holds the number filled.

#include <algorithm>
#include <cstdint>
#include <unordered_map>
#include <vector>

namespace {

// |a ∩ b| plus the intersection itself, for sorted arrays
inline void intersect(const int64_t* a, int64_t na, const int64_t* b,
                      int64_t nb, std::vector<int64_t>* out) {
  out->clear();
  int64_t i = 0, j = 0;
  while (i < na && j < nb) {
    if (a[i] < b[j]) {
      ++i;
    } else if (a[i] > b[j]) {
      ++j;
    } else {
      out->push_back(a[i]);
      ++i;
      ++j;
    }
  }
}

}  // namespace

extern "C" {

// Returns 0 on success.
int swing_similarity(const int64_t* user_items, const int64_t* user_offsets,
                     const double* user_weights, int64_t /*n_users*/,
                     const int64_t* item_users, const int64_t* item_offsets,
                     const int64_t* item_ids, int64_t n_items, double alpha2,
                     int64_t k, int64_t* out_items, double* out_scores,
                     int64_t* out_counts) {
  std::vector<int64_t> inter;
  std::unordered_map<int64_t, double> scores;

  for (int64_t it = 0; it < n_items; ++it) {
    const int64_t main_item = item_ids[it];
    const int64_t* purchasers = item_users + item_offsets[it];
    const int64_t n_p = item_offsets[it + 1] - item_offsets[it];
    scores.clear();

    for (int64_t a = 0; a < n_p; ++a) {
      const int64_t u = purchasers[a];
      const int64_t* iu = user_items + user_offsets[u];
      const int64_t nu = user_offsets[u + 1] - user_offsets[u];
      for (int64_t b = a + 1; b < n_p; ++b) {
        const int64_t v = purchasers[b];
        const int64_t* iv = user_items + user_offsets[v];
        const int64_t nv = user_offsets[v + 1] - user_offsets[v];
        intersect(iu, nu, iv, nv, &inter);
        if (inter.empty()) continue;
        const double sim = user_weights[u] * user_weights[v] /
                           (alpha2 + static_cast<double>(inter.size()));
        for (int64_t item : inter) {
          if (item != main_item) scores[item] += sim;
        }
      }
    }

    // top-k by score descending (stable on item id for determinism)
    std::vector<std::pair<int64_t, double>> ranked(scores.begin(),
                                                   scores.end());
    std::sort(ranked.begin(), ranked.end(),
              [](const auto& x, const auto& y) {
                if (x.second != y.second) return x.second > y.second;
                return x.first < y.first;
              });
    const int64_t take =
        std::min<int64_t>(k, static_cast<int64_t>(ranked.size()));
    for (int64_t r = 0; r < take; ++r) {
      out_items[it * k + r] = ranked[r].first;
      out_scores[it * k + r] = ranked[r].second;
    }
    out_counts[it] = take;
  }
  return 0;
}
}
