// K1: flash-attention forward, softmax(q k^T * scale) v, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel fatezero_tpu/ops/flash_attention.py::_fwd_kernel
// (launched by _fwd_call): the same online softmax over KV tiles with fp32
// running max, sum and accumulator, so no [Sq, Skv] score matrix ever reaches
// device memory. The TPU version's 128-lane padding and lane masks are not
// carried over: this kernel reads the unpadded head dims (40/80/160) directly
// and masks only the ragged KV tail (77 text tokens at cross-attention).
//
// Layout: q [rows, Sq, d], k [rows, Skv, d], v [rows, Skv, dv], o [rows, Sq, dv],
// all contiguous, fp32 or bf16 (o has the input dtype). d <= 160, dv <= 320
// (dv = 2d is the value-space edit's double-wide V). Under differentiation the
// kernel also writes the fp32 log-sum-exp of each query row, lse [rows, Sq]
// (m + log l of the online softmax), which the backward kernels K2 and K3
// (flash_bwd.cu) read; inference passes a null lse and writes none. The TPU
// kernel's 128-lane broadcast of the LSE is a TPU layout and is not carried over.
//
// What bounds it on the H100: at the 64x64-latent self sites (Sq = Skv = 4096,
// d = 40) the work is 4*Sq*Skv*d FLOPs per row against 2*(Sq+Skv)*d elements
// read, so it is compute-bound by a wide margin: the matrix products have to
// run on the tensor cores, or the fp32 FMA rate (and the shared-memory reads
// feeding it) is the limit. Two paths, both deliberately simple (no TMA,
// wgmma, cp.async pipelining or warp specialisation yet):
//
// * bf16 with dv <= 160, every call of the edit: mma.sync tensor cores with
//   fp32 accumulation (flash_fwd_mma_kernel, below), keeping fp32 accuracy.
// * fp32, or dv > 160: fp32 CUDA-core FMAs (flash_fwd_kernel). One block of
//   256 threads per (folded row, 32 queries), 8 threads per query row. Each
//   KV tile of 64 keys is staged in shared memory as fp32; each thread scores
//   8 keys of its row, the row max/sum are reduced with warp shuffles inside
//   the 8-lane group, and the probabilities go through shared memory to the
//   threads that own the output columns. The Q and K tiles use a row stride
//   of d+1 so the 8 key rows a warp reads fall in distinct banks. At d=160,
//   dv=320 the tiles take ~150 KB, above the 48 KB static limit, hence
//   dynamic shared memory and cudaFuncSetAttribute (both paths).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using fz::NEG_INF;

constexpr int BQ = 32;                     // queries per block
constexpr int BK = 64;                     // keys per KV tile
constexpr int ROW_LANES = 8;               // threads per query row
constexpr int THREADS = BQ * ROW_LANES;    // 256
constexpr int KEYS_PER_LANE = BK / ROW_LANES;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// NCOL: output columns per thread (dv <= 8 * NCOL).
template <typename T, int NCOL>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int sq, int skv, int d, int dv,
                 float scale) {
  extern __shared__ float smem[];
  const int ds = d + 1;
  float* qs = smem;              // [BQ][ds], pre-scaled
  float* ks = qs + BQ * ds;      // [BK][ds]
  float* vs = ks + BK * ds;      // [BK][dv]
  float* ps = vs + BK * dv;      // [BQ][BK] probabilities of the current tile

  const int row = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int r = tid / ROW_LANES;
  const int lane = tid % ROW_LANES;

  const T* qrow = q + (size_t)row * sq * d;
  const T* krow = k + (size_t)row * skv * d;
  const T* vrow = v + (size_t)row * skv * dv;

  for (int i = tid; i < BQ * d; i += THREADS) {
    const int rr = i / d, c = i - rr * d;
    const int qi = q0 + rr;
    qs[rr * ds + c] = qi < sq ? to_f32(qrow[(size_t)qi * d + c]) * scale : 0.f;
  }

  float acc[NCOL];
#pragma unroll
  for (int c = 0; c < NCOL; ++c) acc[c] = 0.f;
  float m = NEG_INF, l = 0.f;

  for (int k0 = 0; k0 < skv; k0 += BK) {
    __syncthreads();  // the previous tile is fully consumed
    for (int i = tid; i < BK * d; i += THREADS) {
      const int rr = i / d, c = i - rr * d;
      const int ki = k0 + rr;
      ks[rr * ds + c] = ki < skv ? to_f32(krow[(size_t)ki * d + c]) : 0.f;
    }
    for (int i = tid; i < BK * dv; i += THREADS) {
      const int rr = i / dv, c = i - rr * dv;
      const int ki = k0 + rr;
      vs[rr * dv + c] = ki < skv ? to_f32(vrow[(size_t)ki * dv + c]) : 0.f;
    }
    __syncthreads();

    float s[KEYS_PER_LANE];
#pragma unroll
    for (int j = 0; j < KEYS_PER_LANE; ++j) s[j] = 0.f;
    const float* qr = qs + r * ds;
    for (int c = 0; c < d; ++c) {
      const float qv = qr[c];
#pragma unroll
      for (int j = 0; j < KEYS_PER_LANE; ++j)
        s[j] = fmaf(qv, ks[(lane + j * ROW_LANES) * ds + c], s[j]);
    }

    float tile_max = NEG_INF;
#pragma unroll
    for (int j = 0; j < KEYS_PER_LANE; ++j) {
      if (k0 + lane + j * ROW_LANES >= skv) s[j] = NEG_INF;  // ragged KV tail
      tile_max = fmaxf(tile_max, s[j]);
    }
#pragma unroll
    for (int off = ROW_LANES / 2; off > 0; off >>= 1)
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, off));
    const float m_new = fmaxf(m, tile_max);

    float tile_sum = 0.f;
#pragma unroll
    for (int j = 0; j < KEYS_PER_LANE; ++j) {
      const float p = expf(s[j] - m_new);
      ps[r * BK + lane + j * ROW_LANES] = p;
      tile_sum += p;
    }
#pragma unroll
    for (int off = ROW_LANES / 2; off > 0; off >>= 1)
      tile_sum += __shfl_xor_sync(0xffffffffu, tile_sum, off);
    const float alpha = expf(m - m_new);
    l = alpha * l + tile_sum;
    m = m_new;
    // a row's probabilities are written and read by the 8 lanes of one warp
    __syncwarp();

#pragma unroll
    for (int c = 0; c < NCOL; ++c) acc[c] *= alpha;
    const float* pr = ps + r * BK;
    const int kn = min(BK, skv - k0);
    for (int j = 0; j < kn; ++j) {
      const float p = pr[j];
      const float* vr = vs + j * dv;
#pragma unroll
      for (int c = 0; c < NCOL; ++c) {
        const int col = lane + c * ROW_LANES;
        if (col < dv) acc[c] = fmaf(p, vr[col], acc[c]);
      }
    }
  }

  const int qi = q0 + r;
  if (qi < sq) {
    T* orow = o + ((size_t)row * sq + qi) * dv;
#pragma unroll
    for (int c = 0; c < NCOL; ++c) {
      const int col = lane + c * ROW_LANES;
      if (col < dv) store_out(orow + col, acc[c] / l);
    }
    if (lse != nullptr && lane == 0) lse[(size_t)row * sq + qi] = m + logf(l);
  }
}

// ---------------------------------------------------------------- bf16, tensor cores
//
// bf16 inputs with d <= 160 and dv <= 160 (every call of the edit) run on the
// tensor cores with mma.sync m16n8k16 (bf16 in, fp32 accumulate), keeping
// K1's fp32 arithmetic: a bf16 x bf16 product is exact in fp32, so Q K^T is
// the fp32 score up to summation order; the probabilities P (fp32 after the
// online softmax) are split into two bf16 terms, P = hi + lo, and P V is
// computed as hi V + lo V, which keeps ~16 mantissa bits of P (rounding P to
// one bf16 term would be the separate, lower-precision variant K1b).
//
// One block of 4 warps per (row, 64 queries); each warp owns 16 query rows
// and keeps their Q fragments, 16x64 scores and 16xdv output accumulators in
// registers (the FlashAttention-2 layout: the score accumulators are the P
// operand of the next mma without any shuffle). K is staged in shared memory
// row-major and V transposed, with an 8-element row pad so the 8 rows a
// fragment load touches fall in distinct banks.

constexpr int MMA_BQ = 64;
constexpr int MMA_BK = 64;
constexpr int MMA_THREADS = 128;

using fz::ld_pair;
using fz::mma_bf16;

// DK: 16-wide k-steps of the head dim (d <= 16*DK); DVN: 8-wide n-tiles of V (dv <= 8*DVN)
template <int DK, int DVN>
__global__ void __launch_bounds__(MMA_THREADS)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                     float* __restrict__ lse, int sq, int skv, int d, int dv, float scale) {
  constexpr int DP = DK * 16;
  constexpr int QS = DP + 8;       // row stride of the Q and K tiles
  constexpr int DVP = DVN * 8;
  constexpr int VS = MMA_BK + 8;   // row stride of the V^T tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BQ][QS]
  __nv_bfloat16* ks = qs + MMA_BQ * QS;                            // [BK][QS]
  __nv_bfloat16* vt = ks + MMA_BK * QS;                            // [DVP][VS]
  const int smem_words = ((MMA_BQ + MMA_BK) * QS + DVP * VS) / 2;

  const int row = blockIdx.y;
  const int q0 = blockIdx.x * MMA_BQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;

  // zero everything once: padded columns are never written again, and stale
  // rows past a ragged tail stay finite (0 * NaN would poison the sums)
  for (int i = tid; i < smem_words; i += MMA_THREADS) reinterpret_cast<uint32_t*>(smem_raw)[i] = 0u;
  __syncthreads();

  const int q_rows = min(MMA_BQ, sq - q0);
  const __nv_bfloat16* qsrc = q + ((size_t)row * sq + q0) * d;
  for (int i = tid; i < q_rows * d; i += MMA_THREADS) {
    const int r = i / d;
    qs[r * QS + (i - r * d)] = qsrc[i];
  }
  __syncthreads();

  uint32_t qa[DK][4];
  const __nv_bfloat16* qw = qs + warp * 16 * QS;
#pragma unroll
  for (int kk = 0; kk < DK; ++kk) fz::load_a(qa[kk], qw, QS, kk, g, t);

  float oacc[DVN][4];
#pragma unroll
  for (int n = 0; n < DVN; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;  // rows g and g + 8

  for (int k0 = 0; k0 < skv; k0 += MMA_BK) {
    __syncthreads();  // the previous tile is fully consumed
    const int kn = min(MMA_BK, skv - k0);
    const __nv_bfloat16* ksrc = k + ((size_t)row * skv + k0) * d;
    for (int i = tid; i < kn * d; i += MMA_THREADS) {
      const int r = i / d;
      ks[r * QS + (i - r * d)] = ksrc[i];
    }
    const __nv_bfloat16* vsrc = v + ((size_t)row * skv + k0) * dv;
    for (int i = tid; i < kn * dv; i += MMA_THREADS) {
      const int r = i / dv;
      vt[(i - r * dv) * VS + r] = vsrc[i];
    }
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const __nv_bfloat16* kr = ks + (8 * j + g) * QS + kk * 16 + 2 * t;
        mma_bf16(s[j], qa[kk], ld_pair(kr), ld_pair(kr + 8));
      }
    }

    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * j + 2 * t + (e & 1);
        s[j][e] = col < skv ? s[j][e] * scale : NEG_INF;  // ragged KV tail
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = expf(s[j][0] - mn0);
      s[j][1] = expf(s[j][1] - mn0);
      s[j][2] = expf(s[j][2] - mn1);
      s[j][3] = expf(s[j][3] - mn1);
      sum0 += s[j][0] + s[j][1];
      sum1 += s[j][2] + s[j][3];
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
    }
    const float a0 = expf(m0 - mn0), a1 = expf(m1 - mn1);
    l0 = a0 * l0 + sum0;
    l1 = a1 * l1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int n = 0; n < DVN; ++n) {
      oacc[n][0] *= a0;
      oacc[n][1] *= a0;
      oacc[n][2] *= a1;
      oacc[n][3] *= a1;
    }

#pragma unroll
    for (int kk = 0; kk < MMA_BK / 16; ++kk) {
      // A operand from the score accumulators of key columns 16kk..16kk+15:
      // rows g / g+8 of n-tile 2kk, then of n-tile 2kk+1
      uint32_t hi[4], lo[4];
      fz::split_a(hi, lo, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < DVN; ++n) {
        const __nv_bfloat16* vr = vt + (8 * n + g) * VS + kk * 16 + 2 * t;
        const uint32_t b0 = ld_pair(vr), b1 = ld_pair(vr + 8);
        mma_bf16(oacc[n], hi, b0, b1);
        mma_bf16(oacc[n], lo, b0, b1);
      }
    }
  }

  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
  for (int n = 0; n < DVN; ++n) {
    const int col = 8 * n + 2 * t;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (col + e >= dv) continue;
      if (r0 < sq) o[((size_t)row * sq + r0) * dv + col + e] = __float2bfloat16(oacc[n][e] * inv0);
      if (r1 < sq) o[((size_t)row * sq + r1) * dv + col + e] = __float2bfloat16(oacc[n][2 + e] * inv1);
    }
  }
  if (lse != nullptr && t == 0) {
    if (r0 < sq) lse[(size_t)row * sq + r0] = m0 + logf(l0);
    if (r1 < sq) lse[(size_t)row * sq + r1] = m1 + logf(l1);
  }
}

template <int DK, int DVN>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, float* lse, int rows,
                       int sq, int skv, int d, int dv, float scale, cudaStream_t stream) {
  constexpr int QS = DK * 16 + 8;
  const size_t smem = ((size_t)(MMA_BQ + MMA_BK) * QS + (size_t)DVN * 8 * (MMA_BK + 8)) *
                      sizeof(__nv_bfloat16);
  auto kernel = flash_fwd_mma_kernel<DK, DVN>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + MMA_BQ - 1) / MMA_BQ, rows);
  kernel<<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, sq, skv, d, dv,
      scale);
  return cudaGetLastError();
}

template <int DK>
cudaError_t dispatch_mma(const void* q, const void* k, const void* v, void* o, float* lse, int rows,
                         int sq, int skv, int d, int dv, float scale, cudaStream_t stream) {
  if (dv <= 40) return launch_mma<DK, 5>(q, k, v, o, lse, rows, sq, skv, d, dv, scale, stream);
  if (dv <= 80) return launch_mma<DK, 10>(q, k, v, o, lse, rows, sq, skv, d, dv, scale, stream);
  return launch_mma<DK, 20>(q, k, v, o, lse, rows, sq, skv, d, dv, scale, stream);
}

// ---------------------------------------------------------------- launchers

template <typename T, int NCOL>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int rows,
                   int sq, int skv, int d, int dv, float scale, cudaStream_t stream) {
  const size_t smem = (size_t)(BQ * (d + 1) + BK * (d + 1) + BK * dv + BQ * BK) * sizeof(float);
  auto kernel = flash_fwd_kernel<T, NCOL>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + BQ - 1) / BQ, rows);
  kernel<<<grid, THREADS, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                          static_cast<const T*>(v), static_cast<T*>(o), lse, sq,
                                          skv, d, dv, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, float* lse, int rows,
                     int sq, int skv, int d, int dv, float scale, cudaStream_t stream) {
  if (dv <= 8 * 5) return launch<T, 5>(q, k, v, o, lse, rows, sq, skv, d, dv, scale, stream);
  if (dv <= 8 * 10) return launch<T, 10>(q, k, v, o, lse, rows, sq, skv, d, dv, scale, stream);
  if (dv <= 8 * 20) return launch<T, 20>(q, k, v, o, lse, rows, sq, skv, d, dv, scale, stream);
  return launch<T, 40>(q, k, v, o, lse, rows, sq, skv, d, dv, scale, stream);
}

}  // namespace

// Returns cudaGetLastError() of the launch (0 on success). dtype: 0 fp32, 1 bf16.
// lse may be null (inference); else it receives [rows, sq] fp32 log-sum-exps.
extern "C" int fz_flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                            int rows, int sq, int skv, int d, int dv, float scale, int dtype,
                            void* stream) {
  if (rows < 1 || rows > 65535 || sq < 1 || skv < 1 || d < 1 || d > 160 || dv < 1 || dv > 320)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && dv <= 160) {
    if (d <= 48) return (int)dispatch_mma<3>(q, k, v, o, lse, rows, sq, skv, d, dv, scale, s);
    if (d <= 80) return (int)dispatch_mma<5>(q, k, v, o, lse, rows, sq, skv, d, dv, scale, s);
    return (int)dispatch_mma<10>(q, k, v, o, lse, rows, sq, skv, d, dv, scale, s);
  }
  cudaError_t err = dtype == 1
      ? dispatch<__nv_bfloat16>(q, k, v, o, lse, rows, sq, skv, d, dv, scale, s)
      : dispatch<float>(q, k, v, o, lse, rows, sq, skv, d, dv, scale, s);
  return (int)err;
}
