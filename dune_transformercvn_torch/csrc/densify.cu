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
// of bf16, ~30 us at 3.35 TB/s.  The prong bank (128 images) comes near
// that; the event bank (16 images, one wave of blocks) is as long as one
// block's zero fill plus its walk over the image's ~160 hits.
//
// Design: no shared memory.  A block owns a region of one image that is
// contiguous in memory: a band of whole output rows, or, where one row is
// over the budget (ops/densify.py region_shape), a band of columns of one
// row.  It (1) zero-fills the region with 16-byte stores straight from
// registers, (2) __syncthreads() so those writes are visible to the block,
// (3) walks the image's hits in bank order and adds the region's ones in
// place, read-modify-write on the output (the lines are in L2); each
// round's coordinates are loaded during the round before (the first
// during the zero fill), so the walk waits on no coordinate load.  The walk
// is deterministic with no atomics: warp w owns the region's pixels p with
// p % num_warps == w, each warp takes 32 hits per round in bank order, and
// lanes that hit the same element are merged by __match_any_sync with the
// lowest lane adding its peers' values in lane (= bank) order, rounding to
// the output type after every add.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

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

// Zero n elements at dst: scalar stores up to the first 16-byte boundary,
// 16-byte stores, scalar stores for the tail.
template <typename T>
__device__ __forceinline__ void zero_fill(T* dst, int64_t n) {
  constexpr int kPerVec = 16 / sizeof(T);
  const int64_t to_boundary =
      (int64_t)((16 - reinterpret_cast<uintptr_t>(dst) % 16) % 16 / sizeof(T));
  const int64_t head = to_boundary < n ? to_boundary : n;
  if (threadIdx.x < head) dst[threadIdx.x] = from_float<T>(0.f);
  uint4* body = reinterpret_cast<uint4*>(dst + head);
  const int64_t vecs = (n - head) / kPerVec;
  for (int64_t i = threadIdx.x; i < vecs; i += blockDim.x) {
    body[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  const int64_t tail = head + vecs * kPerVec;
  if (tail + threadIdx.x < n) dst[tail + threadIdx.x] = from_float<T>(0.f);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) densify_kernel(
    const int32_t* __restrict__ xy, const T* __restrict__ values,
    const int32_t* __restrict__ starts, T* __restrict__ out, int num_hits,
    int height, int width, int channels, int s2d, int out_h, int out_w,
    int out_c, int region_rows, int region_cols, int regions_w,
    int regions_per_image) {
  const int image = blockIdx.x / regions_per_image;
  const int region = blockIdx.x - image * regions_per_image;
  const int r0 = (region / regions_w) * region_rows;
  const int c0 = (region % regions_w) * region_cols;
  const int rows = min(region_rows, out_h - r0);
  const int cols = min(region_cols, out_w - c0);
  // this image's hit range, clamped to the bank
  const int start = min(max(starts[image], 0), num_hits);
  const int end = min(max(starts[image + 1], start), num_hits);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int num_warps = blockDim.x >> 5;
  const int2* hits = reinterpret_cast<const int2*>(xy);
  // the first round's coordinates load while the block zero-fills
  int2 next = start + lane < end ? hits[start + lane] : make_int2(-1, -1);

  // whole rows (cols == out_w) or part of one row: contiguous either way
  T* dst = out + (((int64_t)image * out_h + r0) * out_w + c0) * out_c;
  zero_fill(dst, (int64_t)rows * cols * out_c);
  __syncthreads();

  const int64_t row_elems = (int64_t)out_w * out_c;
  for (int base = start; base < end; base += 32) {
    const int2 hit = next;  // hit base + lane, or (-1, -1) past the end
    next = base + 32 + lane < end ? hits[base + 32 + lane] : make_int2(-1, -1);
    const int x = hit.x, y = hit.y;
    int64_t key = -1;  // element offset from dst, or -1: not this warp's
    if (x >= 0 && x < height && y >= 0 && y < width) {
      const int r = (s2d ? x >> 1 : x) - r0;
      const int c = (s2d ? y >> 1 : y) - c0;
      if (r >= 0 && r < rows && c >= 0 && c < cols &&
          (r * cols + c) % num_warps == warp) {
        const int ch = s2d ? ((x & 1) * 2 + (y & 1)) * channels : 0;
        key = r * row_elems + (int64_t)c * out_c + ch;
      }
    }
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    if (key >= 0 && lane == __ffs(peers) - 1) {
      for (int c = 0; c < channels; ++c) {
        float sum = to_float<T>(dst[key + c]);
        for (unsigned m = peers; m; m &= m - 1) {
          const T v = values[(int64_t)(base + __ffs(m) - 1) * channels + c];
          sum = to_float<T>(from_float<T>(sum + to_float<T>(v)));
        }
        dst[key + c] = from_float<T>(sum);
      }
    }
    __syncwarp();  // this round's writes are visible to the next round's leaders
  }
}

template <typename T>
int launch(const void* xy, const void* values, const void* starts, void* out,
           int num_hits, int num_images, int height, int width, int channels,
           int s2d, int region_rows, int region_cols, cudaStream_t stream) {
  const int out_h = s2d ? height / 2 : height;
  const int out_w = s2d ? width / 2 : width;
  const int out_c = s2d ? 4 * channels : channels;
  const int regions_w = (out_w + region_cols - 1) / region_cols;
  const int regions_per_image = ((out_h + region_rows - 1) / region_rows) * regions_w;
  if ((int64_t)regions_per_image * num_images > INT32_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  densify_kernel<T><<<regions_per_image * num_images, kThreads, 0, stream>>>(
      static_cast<const int32_t*>(xy), static_cast<const T*>(values),
      static_cast<const int32_t*>(starts), static_cast<T*>(out), num_hits,
      height, width, channels, s2d, out_h, out_w, out_c, region_rows,
      region_cols, regions_w, regions_per_image);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  A region is region_rows whole rows
// (region_cols == the output width) or region_cols columns of one row.
// Returns a cudaError_t code.
extern "C" int tcvn_densify(const void* xy, const void* values,
                            const void* starts, void* out, int dtype,
                            int num_hits, int num_images, int height, int width,
                            int channels, int s2d, int region_rows,
                            int region_cols, void* stream) {
  const int out_w = s2d ? width / 2 : width;
  if (num_images <= 0 || height <= 0 || width <= 0 || channels <= 0 ||
      num_hits < 0 || region_rows <= 0 || region_cols <= 0 ||
      (s2d && (height % 2 || width % 2)) ||
      (region_cols != out_w && (region_rows != 1 || region_cols > out_w))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(xy, values, starts, out, num_hits, num_images,
                           height, width, channels, s2d, region_rows,
                           region_cols, s);
    case 1:
      return launch<__nv_bfloat16>(xy, values, starts, out, num_hits,
                                   num_images, height, width, channels, s2d,
                                   region_rows, region_cols, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* tcvn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
