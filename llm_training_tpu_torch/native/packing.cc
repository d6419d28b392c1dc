// Native data-engine functions of the PyTorch port (host C++, not a kernel).
//
// The port's own copy of the JAX package's `native/packing.cc`, the same
// algorithms with the same C ABI: best-fit bin packing over a std::set
// (O(n log n); the Python version's sorted list is O(n * bins)) and the
// padded-batch assembly of the collators. `llm_training_tpu_torch/native/
// __init__.py` compiles it with g++ at first use and loads it with ctypes;
// a failed build raises there (no Python fallback).
//
// ABI stability rules: only C types at the boundary, int64 everywhere,
// caller allocates outputs.

#include <cstdint>
#include <set>
#include <utility>
#include <vector>

extern "C" {

// Best-fit bin packing. Each item is placed into the bin with the SMALLEST
// remaining free space that still fits it (ties -> lowest bin index), new
// bin otherwise — byte-identical grouping to the Python implementation
// (bisect over a sorted (free_space, bin_index) list,
// pre_training/datamodule.py:138-157), so the HF datasets fingerprint cache
// stays valid whichever implementation produced it.
//
// lengths: n item lengths (caller pre-sorts descending for BFD semantics).
// bins_out: n entries; bins_out[i] = bin index of item i.
// Returns the number of bins, or -1 if any item exceeds capacity.
int64_t bfd_pack(int64_t capacity, const int64_t* lengths, int64_t n,
                 int64_t* bins_out) {
  // (free_space, bin_index), ordered ascending — lower_bound(length) is the
  // fullest bin that still fits, matching bisect_left((length, -1)).
  std::set<std::pair<int64_t, int64_t>> spaces;
  int64_t num_bins = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t len = lengths[i];
    if (len > capacity || len < 0) return -1;
    auto it = spaces.lower_bound({len, -1});
    if (it != spaces.end()) {
      auto [free, bin] = *it;
      spaces.erase(it);
      spaces.insert({free - len, bin});
      bins_out[i] = bin;
    } else {
      spaces.insert({capacity - len, num_bins});
      bins_out[i] = num_bins++;
    }
  }
  return num_bins;
}

// Padded-batch assembly: scatter variable-length rows (flat tokens +
// offsets) into a [n_rows, width] int32 batch with segment ids, labels and
// per-document-restarting position ids in one pass — the per-step collator
// hot loop fused into a single C call.
//
// tokens/segments/labels: flat concatenated streams; offsets has n_rows+1
// entries. labels may be null (labels_out filled from tokens). Outputs are
// pre-allocated [n_rows * width] int32 arrays.
void pad_batch(const int32_t* tokens, const int32_t* segments,
               const int32_t* labels, const int64_t* offsets, int64_t n_rows,
               int64_t width, int32_t pad_id, int32_t ignore_index,
               int32_t* ids_out, int32_t* segs_out, int32_t* labels_out,
               int32_t* pos_out, int32_t restart_positions) {
  for (int64_t r = 0; r < n_rows; ++r) {
    const int64_t begin = offsets[r], end = offsets[r + 1];
    const int64_t len = end - begin;
    int32_t* ids = ids_out + r * width;
    int32_t* segs = segs_out + r * width;
    int32_t* labs = labels_out + r * width;
    int32_t* pos = pos_out + r * width;
    int32_t prev_seg = -1, next_pos = 0;
    for (int64_t c = 0; c < width; ++c) {
      if (c < len) {
        const int64_t src = begin + c;
        ids[c] = tokens[src];
        segs[c] = segments ? segments[src] : 1;
        labs[c] = labels ? labels[src] : tokens[src];
        if (restart_positions && segs[c] != prev_seg) next_pos = 0;
        prev_seg = segs[c];
        pos[c] = next_pos++;
      } else {
        ids[c] = pad_id;
        segs[c] = 0;
        labs[c] = ignore_index;
        pos[c] = 0;
      }
    }
  }
}

}  // extern "C"
