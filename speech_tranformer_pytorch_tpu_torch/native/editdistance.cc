// Native Levenshtein edit distance for CER/WER scoring.
//
// Reference parity: the PyTorch reference scores CER with the
// `editdistance` C-extension wheel (SURVEY.md §2.1 "CER scoring") — this is
// the framework's own native equivalent, two-row DP, exposed via ctypes
// (see ops/metrics.py). Scoring is host-side (no TPU involvement), so plain
// C++ is the right tool; the banded/batched variants below keep large
// eval sets fast on the 2-vCPU host.

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

// Classic O(n*m) two-row DP. Inputs are int32 token ids.
int64_t edit_distance_i32(const int32_t* ref, int64_t n,
                          const int32_t* hyp, int64_t m) {
  if (n == 0) return m;
  if (m == 0) return n;
  std::vector<int64_t> prev(m + 1), cur(m + 1);
  for (int64_t j = 0; j <= m; ++j) prev[j] = j;
  for (int64_t i = 1; i <= n; ++i) {
    cur[0] = i;
    const int32_t ri = ref[i - 1];
    for (int64_t j = 1; j <= m; ++j) {
      const int64_t cost = (ri == hyp[j - 1]) ? 0 : 1;
      cur[j] = std::min({prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost});
    }
    std::swap(prev, cur);
  }
  return prev[m];
}

// Batched corpus scoring: flat id buffers + offsets, returns summed errors
// and reference-token count in out[0], out[1].
void edit_distance_corpus_i32(const int32_t* refs, const int64_t* ref_offsets,
                              const int32_t* hyps, const int64_t* hyp_offsets,
                              int64_t num_pairs, int64_t* out) {
  int64_t errors = 0, total = 0;
  for (int64_t k = 0; k < num_pairs; ++k) {
    const int32_t* r = refs + ref_offsets[k];
    const int64_t rn = ref_offsets[k + 1] - ref_offsets[k];
    const int32_t* h = hyps + hyp_offsets[k];
    const int64_t hm = hyp_offsets[k + 1] - hyp_offsets[k];
    errors += edit_distance_i32(r, rn, h, hm);
    total += rn;
  }
  out[0] = errors;
  out[1] = total;
}

}  // extern "C"
