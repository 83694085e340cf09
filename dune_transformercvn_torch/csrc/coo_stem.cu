// K2: scatter of the sparse stem conv's per-hit patches, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel
// dune_transformercvn_tpu/ops/pallas_coo_stem.py::_kernel (wrapper
// _scatter_patches, entry coo_stem_conv_pallas).  Inputs: patches
// [R, 4, 4, C] float32 (each hit's 7x7/2/3 stem output over the 4x4 window
// of output pixels it reaches, from stem_patches), xy [R, 2] int32 and CSR
// offsets starts [N + 1] int32 of an owner-sorted bank (non-decreasing, as
// the batcher writes them), bias [C] float32.  Output: out
// [N, out_h, out_w, C] in float32 or bfloat16, where
//   out[i, ox0 + a, oy0 + b, :] = bias + sum of patches[g, a, b, :]
// over the hits g of image i (bank rows [starts[i], starts[i+1]), clamped
// to the bank), with ox0 = floor((x - 2) / 2) and oy0 likewise.  Taps off
// the output and hits off the input grid are dropped; rows outside every
// CSR range are never read.  Sums run in float32 in bank order; the bias is
// added and the result rounded to the output type once.
//
// What bounds it: writing the output.  A 200x140x64 image is 1.8 M values
// and holds ~160 hits, so the kernel writes N*out_h*out_w*C values and reads
// only R*16*C float32 of patches: at batch 16 (event bank 16 + prong bank
// 128 images) 0.52 GB of bfloat16, ~0.15 ms at 3.35 TB/s.  Nearly all of
// that is the bias over pixels no hit reaches.  What keeps it from that
// bound is latency: a touched tile waits on its bin, its entries and its
// patch rows, one after the other, before it can store.
//
// Design: two launches.
// 1. coo_stem_bin_kernel, one block per image, bins the image's hits by the
//    output tiles (kTileRows = 4 rows x tile_cols columns x all channels)
//    their 4x4 window touches: at most 2 x 2 tiles, since a tile is at
//    least 4 pixels each way or spans the image.  A stable counting sort:
//    count per tile (shared-memory integer atomics), exclusive scan, then
//    one warp scatters the (hit, slot) pairs in bank order, ranking equal
//    tiles within 32 pairs by __match_any_sync.  An entry is the hit's
//    index and its window's origin, packed.  Image i's lists live in
//    entries [4 starts[i], 4 starts[i+1]), so no scan across images is
//    needed.
// 2. coo_stem_scatter_kernel, one block per tile: thread (column, channel
//    group of 8) keeps its 4 x 8 float32 sums in registers (64 registers a
//    thread, 4 blocks of 256 threads an SM, which hides more of the latency
//    than 8-row tiles at 2 blocks an SM did), adds the tile's hits in bank
//    order (deterministic, no atomics, no shared memory; a warp loads 32
//    entries at once and passes them round by shuffle, so a hit costs one
//    dependent load, its patch rows), adds its bias held in registers, and
//    stores each row's 8 channels with one 16-byte store (bfloat16) or two
//    (float32): a warp writes 4 whole pixels of 64 channels a row, 512
//    contiguous bytes of bfloat16.  A tile no hit touches is bias written
//    straight from registers.  Many small blocks, not a persistent grid:
//    a grid of a few blocks an SM, each fetching its next tile's bin and
//    entries while it stored the current one, measured no faster.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTileRows = 4;      // output rows a thread owns
constexpr int kGroup = 8;         // channels a thread owns
constexpr int kThreads = 256;     // scatter block size, at most
constexpr int kBlocksPerSM = 4;   // 64 registers a thread
constexpr int kBinThreads = 256;
constexpr int kBinChunk = 1024;   // hits whose tile keys are staged at a time
constexpr int kMaxTilesPerImage = 8192;

// floor((v - 2) / 2) for any int v; C's `/` truncates toward zero.
__device__ __forceinline__ int window_origin(int v) {
  return v >= 2 ? (v - 2) / 2 : -((3 - v) / 2);
}

// Tile (within its image) of slot s (0..3) of hit g's window, or -1: the
// hit is off the input grid, or its window reaches fewer tiles.
__device__ __forceinline__ int tile_key(const int32_t* __restrict__ xy,
                                        int64_t g, int s, int height,
                                        int width, int out_h, int out_w,
                                        int tile_cols, int tiles_w) {
  const int x = xy[2 * g], y = xy[2 * g + 1];
  if (x < 0 || x >= height || y < 0 || y >= width) return -1;
  const int ox0 = window_origin(x), oy0 = window_origin(y);
  const int tr_hi = min(ox0 + 3, out_h - 1) / kTileRows;
  const int tc_hi = min(oy0 + 3, out_w - 1) / tile_cols;
  const int tr = max(ox0, 0) / kTileRows + (s >> 1);
  const int tc = max(oy0, 0) / tile_cols + (s & 1);
  return tr <= tr_hi && tc <= tc_hi ? tr * tiles_w + tc : -1;
}

__global__ void __launch_bounds__(kBinThreads) coo_stem_bin_kernel(
    const int32_t* __restrict__ xy, const int32_t* __restrict__ starts,
    int2* __restrict__ bins, int2* __restrict__ entries, int num_hits,
    int height, int width, int out_h, int out_w, int tile_cols, int tiles_h,
    int tiles_w) {
  extern __shared__ int smem[];
  const int tiles = tiles_h * tiles_w;
  int* cursor = smem;            // [tiles]: counts, then next free entry
  int* keys = smem + tiles;      // [4 * kBinChunk]
  const int image = blockIdx.x;
  const int start = min(max(starts[image], 0), num_hits);
  const int end = min(max(starts[image + 1], start), num_hits);
  const int lane = threadIdx.x & 31;

  for (int t = threadIdx.x; t < tiles; t += blockDim.x) cursor[t] = 0;
  __syncthreads();
  for (int64_t p = 4 * (int64_t)start + threadIdx.x; p < 4 * (int64_t)end;
       p += blockDim.x) {
    const int key = tile_key(xy, p >> 2, (int)(p & 3), height, width, out_h,
                             out_w, tile_cols, tiles_w);
    if (key >= 0) atomicAdd(&cursor[key], 1);
  }
  __syncthreads();

  if (threadIdx.x < 32) {  // exclusive scan of the counts
    int running = 4 * start;
    for (int base = 0; base < tiles; base += 32) {
      const int t = base + lane;
      const int count = t < tiles ? cursor[t] : 0;
      int incl = count;
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += v;
      }
      if (t < tiles) {
        bins[(int64_t)image * tiles + t] = make_int2(running + incl - count, count);
        cursor[t] = running + incl - count;
      }
      running += __shfl_sync(0xffffffffu, incl, 31);
    }
  }

  // pairs p = 4 g + s in bank order; a hit's slots name distinct tiles, so
  // every tile's list comes out in bank order
  const int64_t last = 4 * (int64_t)end;
  for (int64_t base = 4 * (int64_t)start; base < last; base += 4 * kBinChunk) {
    const int n = last - base < 4 * kBinChunk ? (int)(last - base) : 4 * kBinChunk;
    __syncthreads();  // the scan, or the previous chunk's scatter, is done
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      keys[i] = tile_key(xy, (base + i) >> 2, (int)((base + i) & 3), height,
                         width, out_h, out_w, tile_cols, tiles_w);
    }
    __syncthreads();
    if (threadIdx.x < 32) {
      for (int i0 = 0; i0 < n; i0 += 32) {
        const int i = i0 + lane;
        const int key = i < n ? keys[i] : -1;
        const unsigned peers = __match_any_sync(0xffffffffu, key);
        if (key >= 0) {
          const int rank = __popc(peers & ((1u << lane) - 1));
          const int64_t g = (base + i) >> 2;
          const int origin = (window_origin(xy[2 * g]) + 1) << 16 |
                             (window_origin(xy[2 * g + 1]) + 1);
          entries[cursor[key] + rank] = make_int2((int)g, origin);
        }
        __syncwarp();
        if (key >= 0 && lane == __ffs(peers) - 1) cursor[key] += __popc(peers);
        __syncwarp();
      }
    }
  }
}

template <typename T, bool kVec>
__device__ __forceinline__ void store_group(T* dst, const float* acc,
                                            const float* bias, int n);

template <>
__device__ __forceinline__ void store_group<float, true>(float* dst,
                                                         const float* acc,
                                                         const float* bias,
                                                         int) {
  float4* d = reinterpret_cast<float4*>(dst);
  d[0] = make_float4(acc[0] + bias[0], acc[1] + bias[1], acc[2] + bias[2],
                     acc[3] + bias[3]);
  d[1] = make_float4(acc[4] + bias[4], acc[5] + bias[5], acc[6] + bias[6],
                     acc[7] + bias[7]);
}

template <>
__device__ __forceinline__ void store_group<__nv_bfloat16, true>(
    __nv_bfloat16* dst, const float* acc, const float* bias, int) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    h[j] = __floats2bfloat162_rn(acc[2 * j] + bias[2 * j],
                                 acc[2 * j + 1] + bias[2 * j + 1]);
  }
  *reinterpret_cast<uint4*>(dst) = v;
}

template <>
__device__ __forceinline__ void store_group<float, false>(float* dst,
                                                          const float* acc,
                                                          const float* bias,
                                                          int n) {
#pragma unroll
  for (int c = 0; c < kGroup; ++c) {
    if (c < n) dst[c] = acc[c] + bias[c];
  }
}

template <>
__device__ __forceinline__ void store_group<__nv_bfloat16, false>(
    __nv_bfloat16* dst, const float* acc, const float* bias, int n) {
#pragma unroll
  for (int c = 0; c < kGroup; ++c) {
    if (c < n) dst[c] = __float2bfloat16_rn(acc[c] + bias[c]);
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM) coo_stem_scatter_kernel(
    const float* __restrict__ patches, const int2* __restrict__ bins,
    const int2* __restrict__ entries, const float* __restrict__ bias,
    T* __restrict__ out, int out_h, int out_w, int channels, int tile_cols,
    int tiles_w) {
  const int groups = (channels + kGroup - 1) / kGroup;
  const int col = threadIdx.x / groups;  // >= tile_cols: a thread that only
  const bool owner = col < tile_cols;    // fills out the last warp
  const int ch0 = (threadIdx.x - col * groups) * kGroup;
  const int nch = min(kGroup, channels - ch0);
  const int lane = threadIdx.x & 31;
  const int tiles_per_image = (out_h + kTileRows - 1) / kTileRows * tiles_w;

  float b[kGroup];
  if (kVec) {
    const float4* src = reinterpret_cast<const float4*>(bias + ch0);
    const float4 lo = src[0], hi = src[1];
    b[0] = lo.x; b[1] = lo.y; b[2] = lo.z; b[3] = lo.w;
    b[4] = hi.x; b[5] = hi.y; b[6] = hi.z; b[7] = hi.w;
  } else {
#pragma unroll
    for (int c = 0; c < kGroup; ++c) b[c] = c < nch ? bias[ch0 + c] : 0.f;
  }

  const int tile = blockIdx.x;
  const int image = tile / tiles_per_image;
  const int t = tile - image * tiles_per_image;
  const int tr = t / tiles_w;
  const int r0 = tr * kTileRows;
  const int oy = (t - tr * tiles_w) * tile_cols + col;

  float acc[kTileRows][kGroup];
#pragma unroll
  for (int r = 0; r < kTileRows; ++r) {
#pragma unroll
    for (int c = 0; c < kGroup; ++c) acc[r][c] = 0.f;
  }

  // the tile's hits, 32 at a time: one coalesced load of their entries per
  // warp, then each hit's (index, origin) by shuffle, in list order
  const int2 bin = bins[tile];
  for (int k0 = 0; k0 < bin.y; k0 += 32) {
    const int2 e = k0 + lane < bin.y ? entries[bin.x + k0 + lane] : make_int2(0, 0);
    const int n = min(32, bin.y - k0);
    for (int k = 0; k < n; ++k) {
      const int64_t g = __shfl_sync(0xffffffffu, e.x, k);
      const int origin = __shfl_sync(0xffffffffu, e.y, k);
      const int tap_col = oy - ((origin & 0xffff) - 1);
      if ((unsigned)tap_col > 3u) continue;
      const int dr = r0 - ((origin >> 16) - 1);  // tap row of tile row r: r + dr
      const float* p = patches + (g * 16 + tap_col) * channels + ch0;
#pragma unroll
      for (int r = 0; r < kTileRows; ++r) {
        const int a = r + dr;
        if ((unsigned)a > 3u) continue;
        const float* src = p + (int64_t)a * 4 * channels;
        if (kVec) {
          const float4 lo = __ldg(reinterpret_cast<const float4*>(src));
          const float4 hi = __ldg(reinterpret_cast<const float4*>(src) + 1);
          acc[r][0] += lo.x; acc[r][1] += lo.y; acc[r][2] += lo.z; acc[r][3] += lo.w;
          acc[r][4] += hi.x; acc[r][5] += hi.y; acc[r][6] += hi.z; acc[r][7] += hi.w;
        } else {
#pragma unroll
          for (int c = 0; c < kGroup; ++c) {
            if (c < nch) acc[r][c] += __ldg(src + c);
          }
        }
      }
    }
  }

  if (owner && oy < out_w) {
    const int rows = min(kTileRows, out_h - r0);
    const int64_t row_stride = (int64_t)out_w * channels;
    T* dst = out + (((int64_t)image * out_h + r0) * out_w + oy) * channels + ch0;
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) {
      if (r < rows) store_group<T, kVec>(dst + r * row_stride, acc[r], b, nch);
    }
  }
}

struct Plan {
  int out_h, out_w, tiles_h, tiles_w, threads;
};

// The tile plan, or false where the wrapper's plan (ops/coo_stem.py
// tile_plan) would not give these numbers.  A block has the tile's
// tile_cols * groups threads, rounded up to whole warps.
bool make_plan(int num_images, int height, int width, int channels,
               int tile_cols, Plan* plan) {
  if (num_images <= 0 || height <= 0 || width <= 0 || channels <= 0 ||
      tile_cols <= 0) {
    return false;
  }
  const int groups = (channels + kGroup - 1) / kGroup;
  plan->out_h = (height - 1) / 2 + 1;
  plan->out_w = (width - 1) / 2 + 1;
  plan->tiles_h = (plan->out_h + kTileRows - 1) / kTileRows;
  plan->tiles_w = (plan->out_w + tile_cols - 1) / tile_cols;
  plan->threads = (tile_cols * groups + 31) / 32 * 32;
  return tile_cols * groups <= kThreads &&
         (tile_cols >= 4 || tile_cols == plan->out_w) &&
         plan->out_h < 65535 && plan->out_w < 65535 &&  // packed origins
         plan->tiles_h * plan->tiles_w <= kMaxTilesPerImage &&
         (int64_t)num_images * plan->tiles_h * plan->tiles_w <= INT32_MAX;
}

int launch_bin(const void* xy, const void* starts, void* bins, void* entries,
               int num_hits, int num_images, int height, int width,
               int tile_cols, const Plan& plan, cudaStream_t stream) {
  const size_t smem =
      ((size_t)plan.tiles_h * plan.tiles_w + 4 * kBinChunk) * sizeof(int);
  coo_stem_bin_kernel<<<num_images, kBinThreads, smem, stream>>>(
      static_cast<const int32_t*>(xy), static_cast<const int32_t*>(starts),
      static_cast<int2*>(bins), static_cast<int2*>(entries), num_hits, height,
      width, plan.out_h, plan.out_w, tile_cols, plan.tiles_h, plan.tiles_w);
  return (int)cudaGetLastError();
}

template <typename T, bool kVec>
int launch_scatter(const void* patches, const void* bins, const void* entries,
                   const void* bias, void* out, int channels, int tile_cols,
                   int num_tiles, const Plan& plan, cudaStream_t stream) {
  coo_stem_scatter_kernel<T, kVec><<<num_tiles, plan.threads, 0, stream>>>(
      static_cast<const float*>(patches), static_cast<const int2*>(bins),
      static_cast<const int2*>(entries), static_cast<const float*>(bias),
      static_cast<T*>(out), plan.out_h, plan.out_w, channels, tile_cols,
      plan.tiles_w);
  return (int)cudaGetLastError();
}

}  // namespace

// The binning pass alone: bins [N * tiles_per_image] int2 (first entry,
// count) and entries [4 R] int2 (hit, packed window origin).  Returns a
// cudaError_t code.
extern "C" int tcvn_coo_stem_bin(const void* xy, const void* starts,
                                 void* bins, void* entries, int num_hits,
                                 int num_images, int height, int width,
                                 int channels, int tile_cols, void* stream) {
  Plan plan;
  if (num_hits < 0 ||
      !make_plan(num_images, height, width, channels, tile_cols, &plan)) {
    return (int)cudaErrorInvalidValue;
  }
  return launch_bin(xy, starts, bins, entries, num_hits, num_images, height,
                    width, tile_cols, plan, static_cast<cudaStream_t>(stream));
}

// K2: the binning pass into the scratch bins / entries, then the scatter,
// one block per tile.  out_dtype: 0 float32, 1 bfloat16.  Returns a
// cudaError_t code.
extern "C" int tcvn_coo_stem_scatter(const void* patches, const void* xy,
                                     const void* starts, const void* bias,
                                     void* out, void* bins, void* entries,
                                     int out_dtype, int num_hits,
                                     int num_images, int height, int width,
                                     int channels, int tile_cols,
                                     void* stream) {
  Plan plan;
  if (num_hits < 0 || out_dtype < 0 || out_dtype > 1 ||
      !make_plan(num_images, height, width, channels, tile_cols, &plan)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = launch_bin(xy, starts, bins, entries, num_hits, num_images,
                             height, width, tile_cols, plan, s);
  if (err != 0) return err;
  const int num_tiles = num_images * plan.tiles_h * plan.tiles_w;
  const bool vec = channels % kGroup == 0;
#define TCVN_SCATTER(T, V)                                                  \
  launch_scatter<T, V>(patches, bins, entries, bias, out, channels,         \
                       tile_cols, num_tiles, plan, s)
  if (out_dtype == 0) {
    return vec ? TCVN_SCATTER(float, true) : TCVN_SCATTER(float, false);
  }
  return vec ? TCVN_SCATTER(__nv_bfloat16, true)
             : TCVN_SCATTER(__nv_bfloat16, false);
#undef TCVN_SCATTER
}

extern "C" const char* tcvn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
