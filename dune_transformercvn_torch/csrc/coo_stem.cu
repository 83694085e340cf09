// K2: scatter of the sparse stem conv's per-hit patches, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel
// dune_transformercvn_tpu/ops/pallas_coo_stem.py::_kernel (wrapper
// _scatter_patches, entry coo_stem_conv_pallas).  Inputs: patches
// [R, 4, 4, C] float32 (each hit's 7x7/2/3 stem output over the 4x4 window
// of output pixels it reaches, from stem_patches), xy [R, 2] int32 and CSR
// offsets starts [N + 1] int32 of an owner-sorted bank, bias [C] float32.
// Output: out [N, out_h, out_w, C] in float32 or bfloat16, where
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
// 128 images) 0.52 GB of bfloat16, ~0.15 ms at 3.35 TB/s.
//
// Design: one fp32 image (7.2 MB) is far over the 227 KB of shared memory a
// block may use, so a block owns a band of `band_rows` output rows of one
// image (4 rows x 140 x 64 floats = 143 KB, past the 48 KB default: the
// launch opts in).  It zeroes the band in shared memory, walks the image's
// hits in bank order in chunks staged in shared memory (hits whose window
// misses the band are marked there and skipped), adds the taps that fall in
// the band, and writes the band once, coalesced, with the bias and the cast.
// Deterministic with no atomics: thread (r, j, c) owns the band elements of
// row r, channel c and the columns col with col % 4 == j.  A hit's four
// column taps cover the four residues once each, so every hit gives each
// thread at most one add, and each thread adds its hits in bank order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kSmemLimit = 232448;  // bytes of shared memory a block may use

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// floor((v - 2) / 2) for any int v; C's `/` truncates toward zero.
__device__ __forceinline__ int window_origin(int v) {
  return v >= 2 ? (v - 2) / 2 : -((3 - v) / 2);
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads) coo_stem_scatter_kernel(
    const float* __restrict__ patches, const int32_t* __restrict__ xy,
    const int32_t* __restrict__ starts, const float* __restrict__ bias,
    T* __restrict__ out, int num_hits, int height, int width, int out_h,
    int out_w, int channels, int band_rows, int hit_chunk) {
  extern __shared__ float smem[];
  float* tile = smem;  // [band_rows, out_w, channels]
  int* hit_ox = reinterpret_cast<int*>(tile + band_rows * out_w * channels);
  int* hit_oy = hit_ox + hit_chunk;

  const int image = blockIdx.y;
  const int r0 = blockIdx.x * band_rows;
  const int rows = min(band_rows, out_h - r0);
  const int row_elems = out_w * channels;
  const int band_elems = rows * row_elems;
  for (int i = threadIdx.x; i < band_elems; i += blockDim.x) tile[i] = 0.f;

  // this thread's elements: band row r, column residue j, channel c
  const int c = threadIdx.x % channels;
  const int j = (threadIdx.x / channels) & 3;
  const int r = threadIdx.x / (4 * channels);
  float* trow = tile + r * row_elems;

  const int start = min(max(starts[image], 0), num_hits);
  const int end = min(max(starts[image + 1], start), num_hits);
  for (int base = start; base < end; base += hit_chunk) {
    const int n = min(hit_chunk, end - base);
    __syncthreads();  // the zero fill, or the previous chunk, is done
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      const int x = xy[2 * (int64_t)(base + k)];
      const int y = xy[2 * (int64_t)(base + k) + 1];
      const int ox0 = window_origin(x);
      const bool keep = x >= 0 && x < height && y >= 0 && y < width &&
                        ox0 + 3 >= r0 && ox0 < r0 + rows;
      hit_ox[k] = keep ? ox0 : INT_MIN;
      hit_oy[k] = window_origin(y);
    }
    __syncthreads();
    if (r < rows) {
      for (int k = 0; k < n; ++k) {
        const int ox0 = hit_ox[k];
        if (ox0 == INT_MIN) continue;
        const int a = r0 + r - ox0;
        if (a < 0 || a > 3) continue;
        const int oy0 = hit_oy[k];
        const int b = (j - oy0) & 3;  // (j - oy0) mod 4
        const int col = oy0 + b;
        if (col < 0 || col >= out_w) continue;
        trow[col * channels + c] +=
            patches[((int64_t)(base + k) * 16 + a * 4 + b) * channels + c];
      }
    }
  }
  __syncthreads();

  T* dst = out + ((int64_t)image * out_h + r0) * row_elems;
  for (int i = threadIdx.x; i < band_elems; i += blockDim.x) {
    dst[i] = from_float<T>(tile[i] + bias[i % channels]);
  }
}

template <typename T>
int launch(const void* patches, const void* xy, const void* starts,
           const void* bias, void* out, int num_hits, int num_images,
           int height, int width, int channels, int band_rows, int hit_chunk,
           cudaStream_t stream) {
  const int out_h = (height - 1) / 2 + 1;
  const int out_w = (width - 1) / 2 + 1;
  const size_t smem = (size_t)band_rows * out_w * channels * sizeof(float) +
                      2 * (size_t)hit_chunk * sizeof(int);
  if (smem > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      coo_stem_scatter_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int bands = (out_h + band_rows - 1) / band_rows;
  coo_stem_scatter_kernel<T>
      <<<dim3(bands, num_images), band_rows * 4 * channels, smem, stream>>>(
          static_cast<const float*>(patches), static_cast<const int32_t*>(xy),
          static_cast<const int32_t*>(starts), static_cast<const float*>(bias),
          static_cast<T*>(out), num_hits, height, width, out_h, out_w,
          channels, band_rows, hit_chunk);
  return (int)cudaGetLastError();
}

}  // namespace

// out_dtype: 0 float32, 1 bfloat16.  Returns a cudaError_t code.
extern "C" int tcvn_coo_stem_scatter(const void* patches, const void* xy,
                                     const void* starts, const void* bias,
                                     void* out, int out_dtype, int num_hits,
                                     int num_images, int height, int width,
                                     int channels, int band_rows,
                                     int hit_chunk, void* stream) {
  if (num_images <= 0 || num_images > 65535 || height <= 0 || width <= 0 ||
      channels <= 0 || num_hits < 0 || band_rows <= 0 || hit_chunk <= 0 ||
      band_rows * 4 * channels > kMaxThreads) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (out_dtype) {
    case 0:
      return launch<float>(patches, xy, starts, bias, out, num_hits, num_images,
                           height, width, channels, band_rows, hit_chunk, s);
    case 1:
      return launch<__nv_bfloat16>(patches, xy, starts, bias, out, num_hits,
                                   num_images, height, width, channels,
                                   band_rows, hit_chunk, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* tcvn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
