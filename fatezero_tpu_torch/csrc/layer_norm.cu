// K4: LayerNorm over the last axis, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel fatezero_tpu/ops/fused_norm.py::_ln_kernel
// (launched by _ln_fwd_call): fp32 statistics with the variance written as
// E[x^2] - E[x]^2, normalise and affine in one pass, one read and one write
// of x. y = (x - mean) * rsqrt(var + eps) * scale + bias, in x's dtype.
//
// Layout: x, y [rows, c] contiguous, fp32 or bf16; scale, bias [c] fp32.
// c <= 2048 (the UNet's 320/640/1280 and CLIP's 768).
//
// What bounds it on the H100: ~8 FLOPs per element against 2 (bf16) or 4
// (fp32) bytes read and as many written, so it is bound by device-memory
// bytes. One warp per row keeps the row in registers (c/32 values per lane)
// between the reduction and the normalise, so x is read once; the two sums
// are reduced with warp shuffles, with no shared memory and no block barrier.
// Neighbouring lanes touch neighbouring elements (coalesced), 8 rows per
// block of 256 threads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS_PER_BLOCK = THREADS / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// CPL: elements per lane (c <= 32 * CPL)
template <typename T, int CPL>
__global__ void __launch_bounds__(THREADS)
layer_norm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ bias, T* __restrict__ y, int rows, int c, float eps) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / 32;
  if (row >= rows) return;  // whole warps leave together
  const T* xr = x + (size_t)row * c;
  float vals[CPL];
  float sum = 0.f, sumsq = 0.f;
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int col = lane + 32 * j;
    vals[j] = col < c ? to_f32(xr[col]) : 0.f;
    sum += vals[j];
    sumsq = fmaf(vals[j], vals[j], sumsq);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
    sumsq += __shfl_xor_sync(0xffffffffu, sumsq, off);
  }
  const float mean = sum / c;
  const float var = sumsq / c - mean * mean;
  const float rstd = rsqrtf(var + eps);
  T* yr = y + (size_t)row * c;
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int col = lane + 32 * j;
    if (col < c) store(yr + col, (vals[j] - mean) * rstd * scale[col] + bias[col]);
  }
}

template <typename T, int CPL>
cudaError_t launch(const void* x, const float* scale, const float* bias, void* y, int rows, int c,
                   float eps, cudaStream_t stream) {
  const int blocks = (rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  layer_norm_kernel<T, CPL><<<blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(x), scale, bias, static_cast<T*>(y), rows, c, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const float* scale, const float* bias, void* y, int rows,
                     int c, float eps, cudaStream_t s) {
  if (c <= 128) return launch<T, 4>(x, scale, bias, y, rows, c, eps, s);
  if (c <= 320) return launch<T, 10>(x, scale, bias, y, rows, c, eps, s);
  if (c <= 640) return launch<T, 20>(x, scale, bias, y, rows, c, eps, s);
  if (c <= 768) return launch<T, 24>(x, scale, bias, y, rows, c, eps, s);
  if (c <= 1280) return launch<T, 40>(x, scale, bias, y, rows, c, eps, s);
  return launch<T, 64>(x, scale, bias, y, rows, c, eps, s);
}

}  // namespace

// Returns cudaGetLastError() of the launch (0 on success). dtype: 0 fp32, 1 bf16.
extern "C" int fz_layer_norm(const void* x, const float* scale, const float* bias, void* y,
                             int rows, int c, float eps, int dtype, void* stream) {
  if (rows < 1 || c < 1 || c > 2048 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 1 ? dispatch<__nv_bfloat16>(x, scale, bias, y, rows, c, eps, s)
                          : dispatch<float>(x, scale, bias, y, rows, c, eps, s));
}
