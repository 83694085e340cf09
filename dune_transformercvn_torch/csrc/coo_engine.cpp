// Host-side COO engine of the port: kernel maps for the general sparse
// convolution and the batched CSR gather of the data pipeline.
//
// The port's copy of the JAX package's native engine, built with g++ into
// build/torch_kernels at first use (utils/build.py) and bound with ctypes
// (utils/native.py).  Given the COO coordinates of occupied sites on a
// (batch, H, W) grid, tcvn_build_conv_maps enumerates the kernel-dilated
// output coordinate set and, for every kernel offset, the (input row,
// output row) pairs that ops/coo_conv.py's gather-matmul-scatter consumes
// (MinkowskiEngine's "kernel map").  Convention of ops/sparse.py:
// out[o] = sum_j in[o*s - lo + j] * W[j] with lo = k/2 for odd kernels and
// 0 for even ones, so input i feeds output (i + lo - j) through weight j.
//
// One difference from the JAX package's engine: the output sites are
// numbered in ascending (owner, x, y) order, the order numpy's np.unique
// gives the numpy builder, so both builders return the same arrays.

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <unordered_map>
#include <utility>
#include <vector>

namespace {

inline int64_t pack_key(int64_t owner, int64_t x, int64_t y) {
  return (owner << 40) | (x << 20) | y;
}

}  // namespace

extern "C" {

// Inputs:
//   coords      [n * 3] int64 (owner, x, y), unique sites
//   n, kernel, stride, height, width
// Outputs (caller allocates):
//   out_coords  [n * kernel * kernel * 3] int64: first M rows valid
//   pair_in     [n * kernel * kernel] int32: grouped by kernel offset
//   pair_out    [n * kernel * kernel] int32
//   pair_counts [kernel * kernel] int64: pairs per offset
// Returns M (number of output sites), or -1 on bad arguments.
int64_t tcvn_build_conv_maps(const int64_t* coords, int64_t n, int64_t kernel,
                             int64_t stride, int64_t height, int64_t width,
                             int64_t* out_coords, int32_t* pair_in,
                             int32_t* pair_out, int64_t* pair_counts) {
  if (n < 0 || kernel <= 0 || stride <= 0) return -1;
  const int64_t lo = (kernel % 2 == 1) ? kernel / 2 : 0;
  const int64_t volume = kernel * kernel;

  std::unordered_map<int64_t, int32_t> site_index;
  site_index.reserve(static_cast<size_t>(n) * 4);
  std::vector<int64_t> keys;  // packed key of each output site, first seen order
  int64_t cursor = 0;

  for (int64_t j = 0; j < volume; ++j) {
    const int64_t dx = lo - j / kernel;
    const int64_t dy = lo - j % kernel;
    int64_t count = 0;
    for (int64_t i = 0; i < n; ++i) {
      const int64_t owner = coords[3 * i];
      const int64_t ox = coords[3 * i + 1] + dx;
      const int64_t oy = coords[3 * i + 2] + dy;
      if (ox < 0 || ox >= height || oy < 0 || oy >= width) continue;
      if (stride > 1 && (ox % stride != 0 || oy % stride != 0)) continue;

      const int64_t key = pack_key(owner, ox, oy);
      auto found = site_index.emplace(key, static_cast<int32_t>(keys.size()));
      if (found.second) keys.push_back(key);
      pair_in[cursor] = static_cast<int32_t>(i);
      pair_out[cursor] = found.first->second;
      ++cursor;
      ++count;
    }
    pair_counts[j] = count;
  }

  // renumber the sites in ascending key order
  const int64_t num_out = static_cast<int64_t>(keys.size());
  std::vector<std::pair<int64_t, int32_t>> order(keys.size());
  for (int64_t r = 0; r < num_out; ++r) order[r] = {keys[r], static_cast<int32_t>(r)};
  std::sort(order.begin(), order.end());
  std::vector<int32_t> rank(keys.size());
  for (int64_t s = 0; s < num_out; ++s) {
    const int64_t key = order[s].first;
    rank[order[s].second] = static_cast<int32_t>(s);
    out_coords[3 * s] = key >> 40;
    out_coords[3 * s + 1] = ((key >> 20) & 0xFFFFF) / stride;
    out_coords[3 * s + 2] = (key & 0xFFFFF) / stride;
  }
  for (int64_t c = 0; c < cursor; ++c) pair_out[c] = rank[pair_out[c]];
  return num_out;
}

// Batched CSR slicing: copy [first, last) ranges of a COO bank into one
// contiguous output with a per-hit owner column (the row of the range).
//
//   ranges      [m * 2] int64: (first, last) per event
//   coords_in   [total * 3] int64, values_in [total * c] float32
//   coords_out / values_out / owner_out: caller-allocated (sum of ranges)
// Returns the number of hits copied.
int64_t tcvn_gather_ranges(const int64_t* ranges, int64_t m,
                           const int64_t* coords_in, const float* values_in,
                           int64_t c, int64_t* coords_out, float* values_out,
                           int64_t* owner_out) {
  int64_t cursor = 0;
  for (int64_t row = 0; row < m; ++row) {
    const int64_t first = ranges[2 * row];
    const int64_t last = ranges[2 * row + 1];
    for (int64_t i = first; i < last; ++i) {
      coords_out[3 * cursor] = coords_in[3 * i];
      coords_out[3 * cursor + 1] = coords_in[3 * i + 1];
      coords_out[3 * cursor + 2] = coords_in[3 * i + 2];
      for (int64_t k = 0; k < c; ++k) {
        values_out[c * cursor + k] = values_in[c * i + k];
      }
      owner_out[cursor] = row;
      ++cursor;
    }
  }
  return cursor;
}

}  // extern "C"
