// K1: COO -> dense image scatter-add for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// dune_transformercvn_tpu/ops/pallas_densify.py::_kernel (wrapper
// densify_images_pallas).  Input is an owner-sorted hit bank: xy [R, 2]
// int32, values [R, C] and CSR offsets starts [N + 1] int32.  Output is
// NHWC [N, H, W, C] in the values' dtype, or the 2x2 space-to-depth layout
// [N, H/2, W/2, 4C] where hit (x, y, c) lands at row x/2, column y/2,
// channel (x%2)*2C + (y%2)*C + c.  Image i reads only bank rows
// [starts[i], starts[i+1]); duplicate pixels accumulate, in bank order and
// in the output dtype as the TPU kernel does; hits with x or y out of range
// (negative included) are dropped.
//
// What bounds it: writing the output.  The images are almost all zeros (a
// 400x280x3 image holds ~160 hits), so the kernel moves N*H*W*C elements
// out and only tens of KB of hits in: at batch 16 the two banks are ~97 MB
// of bf16, ~30 us at 3.35 TB/s.
//
// Design: the TPU kernel keeps one whole image in VMEM per program; one
// fp32 400x280x3 image is 1.3 MB, far over the 227 KB of shared memory a
// block may use.  So each block owns one tile of one image (a band of
// output rows, and a band of columns where a row alone does not fit),
// zero-fills it in shared memory, walks that image's hits, adds the ones
// that fall in its tile, and writes the tile out once, coalesced.  The walk
// is deterministic with no atomics: warp w owns the tile rows r with
// r % num_warps == w, each warp takes 32 hits per round in bank order, and
// lanes that hit the same element are merged by __match_any_sync with the
// lowest lane adding its peers' values in lane (= bank) order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
// fp32 accumulators per tile: 48 KB, the shared memory a block gets
// without opting in.  The Python wrapper sizes tiles to this.
constexpr int kMaxTileFloats = 12288;

template <typename T> __device__ __forceinline__ float to_float(T v);
template <> __device__ __forceinline__ float to_float<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Round an fp32 partial sum to T, so the tile accumulates in T's precision.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_float<T>(from_float<T>(v));
}

template <typename T>
__global__ void __launch_bounds__(kThreads) densify_kernel(
    const int32_t* __restrict__ xy, const T* __restrict__ values,
    const int32_t* __restrict__ starts, T* __restrict__ out, int num_hits,
    int height, int width, int channels, int s2d, int out_h, int out_w,
    int out_c, int tile_rows, int tile_cols, int tiles_per_row) {
  extern __shared__ float tile[];
  const int image = blockIdx.y;
  const int r0 = (blockIdx.x / tiles_per_row) * tile_rows;
  const int c0 = (blockIdx.x % tiles_per_row) * tile_cols;
  const int rows = min(tile_rows, out_h - r0);
  const int cols = min(tile_cols, out_w - c0);
  const int row_elems = cols * out_c;
  const int tile_elems = rows * row_elems;

  for (int i = threadIdx.x; i < tile_elems; i += blockDim.x) tile[i] = 0.f;
  __syncthreads();

  // this image's hit range, clamped to the bank
  const int start = min(max(starts[image], 0), num_hits);
  const int end = min(max(starts[image + 1], start), num_hits);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int num_warps = blockDim.x >> 5;

  for (int base = start; base < end; base += 32) {
    const int j = base + lane;
    int key = -1;  // element offset in the tile, or -1: not this warp's
    if (j < end) {
      const int x = xy[2 * (int64_t)j];
      const int y = xy[2 * (int64_t)j + 1];
      if (x >= 0 && x < height && y >= 0 && y < width) {
        const int r = (s2d ? x >> 1 : x) - r0;
        const int c = (s2d ? y >> 1 : y) - c0;
        if (r >= 0 && r < rows && c >= 0 && c < cols && r % num_warps == warp) {
          const int ch = s2d ? ((x & 1) * 2 + (y & 1)) * channels : 0;
          key = r * row_elems + c * out_c + ch;
        }
      }
    }
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    if (key >= 0 && lane == __ffs(peers) - 1) {
      for (unsigned m = peers; m; m &= m - 1) {
        const T* v = values + (int64_t)(base + __ffs(m) - 1) * channels;
        for (int c = 0; c < channels; ++c) {
          tile[key + c] = round_to<T>(tile[key + c] + to_float<T>(v[c]));
        }
      }
    }
    __syncwarp();
  }
  __syncthreads();

  T* dst = out + (((int64_t)image * out_h + r0) * out_w + c0) * out_c;
  const int64_t row_stride = (int64_t)out_w * out_c;
  for (int i = threadIdx.x; i < tile_elems; i += blockDim.x) {
    const int r = i / row_elems;
    dst[r * row_stride + (i - r * row_elems)] = from_float<T>(tile[i]);
  }
}

template <typename T>
void launch(const void* xy, const void* values, const void* starts, void* out,
            int num_hits, int num_images, int height, int width, int channels,
            int s2d, int tile_rows, int tile_cols, cudaStream_t stream) {
  const int out_h = s2d ? height / 2 : height;
  const int out_w = s2d ? width / 2 : width;
  const int out_c = s2d ? 4 * channels : channels;
  const int tiles_per_row = (out_w + tile_cols - 1) / tile_cols;
  const int tiles = ((out_h + tile_rows - 1) / tile_rows) * tiles_per_row;
  const size_t smem = (size_t)tile_rows * tile_cols * out_c * sizeof(float);
  densify_kernel<T><<<dim3(tiles, num_images), kThreads, smem, stream>>>(
      static_cast<const int32_t*>(xy), static_cast<const T*>(values),
      static_cast<const int32_t*>(starts), static_cast<T*>(out), num_hits,
      height, width, channels, s2d, out_h, out_w, out_c, tile_rows, tile_cols,
      tiles_per_row);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  Returns a cudaError_t code.
extern "C" int tcvn_densify(const void* xy, const void* values,
                            const void* starts, void* out, int dtype,
                            int num_hits, int num_images, int height, int width,
                            int channels, int s2d, int tile_rows, int tile_cols,
                            void* stream) {
  const int out_c = s2d ? 4 * channels : channels;
  if (num_images <= 0 || num_images > 65535 || height <= 0 || width <= 0 ||
      channels <= 0 || num_hits < 0 || tile_rows <= 0 || tile_cols <= 0 ||
      (s2d && (height % 2 || width % 2)) ||
      (int64_t)tile_rows * tile_cols * out_c > kMaxTileFloats) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      launch<float>(xy, values, starts, out, num_hits, num_images, height,
                    width, channels, s2d, tile_rows, tile_cols, s);
      break;
    case 1:
      launch<__nv_bfloat16>(xy, values, starts, out, num_hits, num_images,
                            height, width, channels, s2d, tile_rows, tile_cols, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* tcvn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
