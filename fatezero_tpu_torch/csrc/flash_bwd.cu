// K2 and K3: the flash-attention backward, for Hopper (sm_90a).
//
// Replace the Pallas TPU kernels fatezero_tpu/ops/flash_attention.py::_dq_kernel
// (K2, launched by _bwd_call) and ::_dkv_kernel (K3). Both recompute the
// probabilities from the forward's fp32 log-sum-exp instead of reading them:
//
//   P  = exp(scale * Q K^T - lse)            delta = rowsum(dO o O)   (fp32)
//   dS = P o (dO V^T - delta)
//   K2: dQ = scale * dS K                    (one block per 64 queries, streaming KV)
//   K3: dV = P^T dO,  dK = scale * dS^T Q    (one block per 64 keys, streaming Q)
//
// delta is computed inside each kernel from dO and O, as the TPU kernels do.
// Layout: q, o, dO [rows, Sq, d]; k, v [rows, Skv, d]; lse [rows, Sq] fp32;
// contiguous; dq/dk/dv have the input dtype. d <= 160 and dv = d (the wide-V
// forward of the value-space edit is inference-only, as on the TPU). The ragged
// KV tail (77 text tokens) and a ragged query tail are masked to P = 0.
//
// What bounds it on the H100: at the 64x64-latent self site (Sq 4096, Skv
// 8192, d 40) K2 does 6 and K3 8 FLOPs per (query, key, d) against ~8
// bytes per (token, d) read, so both are compute-bound: the products run on
// the tensor cores. Deliberately simple (no cp.async/TMA, wgmma or warp
// specialisation yet); two paths, as K1:
//
// * bf16: mma.sync m16n8k16 with fp32 accumulation, keeping the TPU kernels'
//   fp32 arithmetic: bf16 x bf16 products are exact in fp32, and the fp32 P and
//   dS that feed the second products are split into two bf16 terms (hi + lo,
//   ~16 mantissa bits), as K1 does for P.
// * fp32: CUDA-core FMAs, 8 threads per query (K2) or key (K3) row, the tiles
//   staged in shared memory as fp32 with a d+1 row stride (distinct banks).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using fz::ld_pair;
using fz::mma_bf16;

// ================================================================ bf16, tensor cores

constexpr int MMA_THREADS = 128;  // 4 warps, 16 rows each
constexpr int MMA_ROWS = 64;      // queries (K2) or keys (K3) per block

// ds[i] = sum_c dO[i, c] * O[i, c] in fp32 for the `n` rows starting at o / dout;
// two threads per row, 64 slots, rows >= n get 0
__device__ __forceinline__ void row_delta(const __nv_bfloat16* o, const __nv_bfloat16* dout,
                                          int n, int d, float* ds, int tid) {
  const int r = tid >> 1, half = tid & 1;
  float acc = 0.f;
  if (r < n) {
    const __nv_bfloat16* orow = o + (size_t)r * d;
    const __nv_bfloat16* drow = dout + (size_t)r * d;
    for (int c = half; c < d; c += 2) acc = fmaf(__bfloat162float(drow[c]), __bfloat162float(orow[c]), acc);
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  if (half == 0) ds[r] = acc;
}

// K2. DK: 16-wide k-steps of d (d <= 16*DK); dQ has 2*DK n-tiles of 8 columns.
template <int DK>
__global__ void __launch_bounds__(MMA_THREADS)
flash_dq_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ o,
                    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                    __nv_bfloat16* __restrict__ dq, int sq, int skv, int d, float scale) {
  constexpr int BQ = MMA_ROWS, BK = 64;
  constexpr int DP = DK * 16, DN = 2 * DK;
  constexpr int QS = DP + 8;  // row stride of the row-major tiles
  constexpr int TS = BK + 8;  // row stride of the K^T tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BQ][QS]
  __nv_bfloat16* dos = qs + BQ * QS;                               // [BQ][QS]
  __nv_bfloat16* ks = dos + BQ * QS;                               // [BK][QS]
  __nv_bfloat16* vs = ks + BK * QS;                                // [BK][QS]
  __nv_bfloat16* kt = vs + BK * QS;                                // [DP][TS]
  float* delta_s = reinterpret_cast<float*>(kt + DP * TS);         // [BQ]
  const int smem_words = (2 * BQ * QS + 2 * BK * QS + DP * TS) / 2 + BQ;

  const int row = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;

  // zero once: padded columns stay zero, stale rows past a ragged tail stay finite
  for (int i = tid; i < smem_words; i += MMA_THREADS) reinterpret_cast<uint32_t*>(smem_raw)[i] = 0u;
  __syncthreads();

  const int qn = min(BQ, sq - q0);
  const size_t qoff = ((size_t)row * sq + q0) * d;
  for (int i = tid; i < qn * d; i += MMA_THREADS) {
    const int r = i / d, c = i - r * d;
    qs[r * QS + c] = q[qoff + i];
    dos[r * QS + c] = dout[qoff + i];
  }
  row_delta(o + qoff, dout + qoff, qn, d, delta_s, tid);
  __syncthreads();

  const int r0 = warp * 16 + g, r1 = r0 + 8;  // this thread's query rows in the tile
  const float lse0 = r0 < qn ? lse[(size_t)row * sq + q0 + r0] : 0.f;
  const float lse1 = r1 < qn ? lse[(size_t)row * sq + q0 + r1] : 0.f;
  const float dl0 = delta_s[r0], dl1 = delta_s[r1];
  const __nv_bfloat16* qw = qs + warp * 16 * QS;
  const __nv_bfloat16* dow = dos + warp * 16 * QS;

  float acc[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int k0 = 0; k0 < skv; k0 += BK) {
    __syncthreads();  // the previous tile is fully consumed
    const int kn = min(BK, skv - k0);
    const size_t koff = ((size_t)row * skv + k0) * d;
    for (int i = tid; i < kn * d; i += MMA_THREADS) {
      const int r = i / d, c = i - r * d;
      const __nv_bfloat16 kv = k[koff + i];
      ks[r * QS + c] = kv;
      kt[c * TS + r] = kv;
      vs[r * QS + c] = v[koff + i];
    }
    __syncthreads();

    // S = Q K^T and dP = dO V^T, 16 x 64 per warp
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      uint32_t qa[4], da[4];
      fz::load_a(qa, qw, QS, kk, g, t);
      fz::load_a(da, dow, QS, kk, g, t);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const __nv_bfloat16* kr = ks + (8 * j + g) * QS + kk * 16 + 2 * t;
        mma_bf16(s[j], qa, ld_pair(kr), ld_pair(kr + 8));
        const __nv_bfloat16* vr = vs + (8 * j + g) * QS + kk * 16 + 2 * t;
        mma_bf16(dp[j], da, ld_pair(vr), ld_pair(vr + 8));
      }
    }

    // dS = P o (dP - delta), in place of s
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * j + 2 * t + (e & 1);
        const float p = col < skv ? expf(s[j][e] * scale - (e < 2 ? lse0 : lse1)) : 0.f;
        s[j][e] = p * (dp[j][e] - (e < 2 ? dl0 : dl1));
      }
    }

    // dQ += dS K, with dS split into hi + lo bf16 terms
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t hi[4], lo[4];
      fz::split_a(hi, lo, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < DN; ++n) {
        const __nv_bfloat16* kr = kt + (8 * n + g) * TS + kk * 16 + 2 * t;
        const uint32_t b0 = ld_pair(kr), b1 = ld_pair(kr + 8);
        mma_bf16(acc[n], hi, b0, b1);
        mma_bf16(acc[n], lo, b0, b1);
      }
    }
  }

#pragma unroll
  for (int n = 0; n < DN; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * n + 2 * t + e;
      if (col >= d) continue;
      if (r0 < qn) dq[qoff + (size_t)r0 * d + col] = __float2bfloat16(acc[n][e] * scale);
      if (r1 < qn) dq[qoff + (size_t)r1 * d + col] = __float2bfloat16(acc[n][2 + e] * scale);
    }
  }
}

// K3. DK as in K2; BQ queries per streamed tile (64, or 32 at d = 160 to keep
// the two 16 x d accumulators of each warp in registers).
template <int DK, int BQ>
__global__ void __launch_bounds__(MMA_THREADS)
flash_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ o,
                     const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                     __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int sq,
                     int skv, int d, float scale) {
  constexpr int BK = MMA_ROWS;
  constexpr int DP = DK * 16, DN = 2 * DK;
  constexpr int QS = DP + 8;  // row stride of the row-major tiles
  constexpr int TS = BQ + 8;  // row stride of the Q^T and dO^T tiles
  constexpr int NJ = BQ / 8;  // 8-wide query n-tiles per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BK][QS]
  __nv_bfloat16* vs = ks + BK * QS;                                // [BK][QS]
  __nv_bfloat16* qs = vs + BK * QS;                                // [BQ][QS]
  __nv_bfloat16* dos = qs + BQ * QS;                               // [BQ][QS]
  __nv_bfloat16* qt = dos + BQ * QS;                               // [DP][TS]
  __nv_bfloat16* dot = qt + DP * TS;                               // [DP][TS]
  float* lse_s = reinterpret_cast<float*>(dot + DP * TS);          // [BQ]
  float* delta_s = lse_s + BQ;                                     // [BQ], 64 slots used by row_delta
  const int smem_words = (2 * BK * QS + 2 * BQ * QS + 2 * DP * TS) / 2 + BQ + MMA_ROWS;

  const int row = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;

  for (int i = tid; i < smem_words; i += MMA_THREADS) reinterpret_cast<uint32_t*>(smem_raw)[i] = 0u;
  __syncthreads();

  const int kn = min(BK, skv - k0);
  const size_t koff = ((size_t)row * skv + k0) * d;
  for (int i = tid; i < kn * d; i += MMA_THREADS) {
    const int r = i / d, c = i - r * d;
    ks[r * QS + c] = k[koff + i];
    vs[r * QS + c] = v[koff + i];
  }

  const __nv_bfloat16* kw = ks + warp * 16 * QS;
  const __nv_bfloat16* vw = vs + warp * 16 * QS;
  float dka[DN][4], dva[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n) {
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
    dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
  }

  for (int q0 = 0; q0 < sq; q0 += BQ) {
    __syncthreads();  // the previous tile is fully consumed (and the K/V tiles are in)
    const int qn = min(BQ, sq - q0);
    const size_t qoff = ((size_t)row * sq + q0) * d;
    for (int i = tid; i < qn * d; i += MMA_THREADS) {
      const int r = i / d, c = i - r * d;
      const __nv_bfloat16 qv = q[qoff + i], dv_ = dout[qoff + i];
      qs[r * QS + c] = qv;
      qt[c * TS + r] = qv;
      dos[r * QS + c] = dv_;
      dot[c * TS + r] = dv_;
    }
    for (int i = tid; i < BQ; i += MMA_THREADS) lse_s[i] = i < qn ? lse[(size_t)row * sq + q0 + i] : 0.f;
    row_delta(o + qoff, dout + qoff, qn, d, delta_s, tid);
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x BQ queries per warp
    float s[NJ][4], dp[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      uint32_t ka[4], va[4];
      fz::load_a(ka, kw, QS, kk, g, t);
      fz::load_a(va, vw, QS, kk, g, t);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const __nv_bfloat16* qr = qs + (8 * j + g) * QS + kk * 16 + 2 * t;
        mma_bf16(s[j], ka, ld_pair(qr), ld_pair(qr + 8));
        const __nv_bfloat16* dr = dos + (8 * j + g) * QS + kk * 16 + 2 * t;
        mma_bf16(dp[j], va, ld_pair(dr), ld_pair(dr + 8));
      }
    }

    // P^T in s, dS^T in dp; queries past the ragged tail get P = 0
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = 8 * j + 2 * t + (e & 1);
        const float p = qi < qn ? expf(s[j][e] * scale - lse_s[qi]) : 0.f;
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - delta_s[qi]);
      }
    }

    // dV += P^T dO and dK += dS^T Q, with P and dS split into hi + lo bf16 terms
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t phi[4], plo[4], dhi[4], dlo[4];
      fz::split_a(phi, plo, s[2 * kk], s[2 * kk + 1]);
      fz::split_a(dhi, dlo, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < DN; ++n) {
        const __nv_bfloat16* dr = dot + (8 * n + g) * TS + kk * 16 + 2 * t;
        const uint32_t b0 = ld_pair(dr), b1 = ld_pair(dr + 8);
        mma_bf16(dva[n], phi, b0, b1);
        mma_bf16(dva[n], plo, b0, b1);
        const __nv_bfloat16* qr = qt + (8 * n + g) * TS + kk * 16 + 2 * t;
        const uint32_t c0 = ld_pair(qr), c1 = ld_pair(qr + 8);
        mma_bf16(dka[n], dhi, c0, c1);
        mma_bf16(dka[n], dlo, c0, c1);
      }
    }
  }

  const int r0 = warp * 16 + g, r1 = r0 + 8;  // this thread's key rows in the tile
#pragma unroll
  for (int n = 0; n < DN; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * n + 2 * t + e;
      if (col >= d) continue;
      if (r0 < kn) {
        dk[koff + (size_t)r0 * d + col] = __float2bfloat16(dka[n][e] * scale);
        dv[koff + (size_t)r0 * d + col] = __float2bfloat16(dva[n][e]);
      }
      if (r1 < kn) {
        dk[koff + (size_t)r1 * d + col] = __float2bfloat16(dka[n][2 + e] * scale);
        dv[koff + (size_t)r1 * d + col] = __float2bfloat16(dva[n][2 + e]);
      }
    }
  }
}

template <int DK>
cudaError_t launch_dq_mma(const void* q, const void* k, const void* v, const void* o,
                          const void* dout, const float* lse, void* dq, int rows, int sq, int skv,
                          int d, float scale, cudaStream_t stream) {
  constexpr int DP = DK * 16, QS = DP + 8;
  const size_t smem = (size_t)(4 * MMA_ROWS * QS + DP * (64 + 8)) * sizeof(__nv_bfloat16) +
                      MMA_ROWS * sizeof(float);
  auto kernel = flash_dq_mma_kernel<DK>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + MMA_ROWS - 1) / MMA_ROWS, rows);
  using B = __nv_bfloat16;
  kernel<<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const B*>(q), static_cast<const B*>(k), static_cast<const B*>(v),
      static_cast<const B*>(o), static_cast<const B*>(dout), lse, static_cast<B*>(dq), sq, skv, d,
      scale);
  return cudaGetLastError();
}

template <int DK, int BQ>
cudaError_t launch_dkv_mma(const void* q, const void* k, const void* v, const void* o,
                           const void* dout, const float* lse, void* dk, void* dv, int rows,
                           int sq, int skv, int d, float scale, cudaStream_t stream) {
  constexpr int DP = DK * 16, QS = DP + 8;
  const size_t smem =
      (size_t)(2 * MMA_ROWS * QS + 2 * BQ * QS + 2 * DP * (BQ + 8)) * sizeof(__nv_bfloat16) +
      (BQ + MMA_ROWS) * sizeof(float);
  auto kernel = flash_dkv_mma_kernel<DK, BQ>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((skv + MMA_ROWS - 1) / MMA_ROWS, rows);
  using B = __nv_bfloat16;
  kernel<<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const B*>(q), static_cast<const B*>(k), static_cast<const B*>(v),
      static_cast<const B*>(o), static_cast<const B*>(dout), lse, static_cast<B*>(dk),
      static_cast<B*>(dv), sq, skv, d, scale);
  return cudaGetLastError();
}

// ================================================================ fp32, CUDA cores

constexpr int ROW_LANES = 8;                  // threads per query (K2) or key (K3) row
constexpr int F_THREADS = 256;
constexpr int F_ROWS = F_THREADS / ROW_LANES;  // 32 rows per block
constexpr int F_TILE = 64;                     // streamed keys (K2) or queries (K3) per tile
constexpr int PER_LANE = F_TILE / ROW_LANES;   // 8

// K2. NCOL: output columns per thread (d <= 8 * NCOL).
template <int NCOL>
__global__ void __launch_bounds__(F_THREADS)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ o,
                const float* __restrict__ dout, const float* __restrict__ lse,
                float* __restrict__ dq, int sq, int skv, int d, float scale) {
  extern __shared__ float smem[];
  const int ds = d + 1;
  float* qs = smem;               // [F_ROWS][ds]
  float* dos = qs + F_ROWS * ds;  // [F_ROWS][ds]
  float* ks = dos + F_ROWS * ds;  // [F_TILE][ds]
  float* vs = ks + F_TILE * ds;   // [F_TILE][ds]
  float* pss = vs + F_TILE * ds;  // [F_ROWS][F_TILE] dS of the current tile

  const int row = blockIdx.y;
  const int q0 = blockIdx.x * F_ROWS;
  const int tid = threadIdx.x;
  const int r = tid / ROW_LANES, lane = tid % ROW_LANES;
  const int qi = q0 + r;
  const bool valid = qi < sq;
  const size_t qoff = ((size_t)row * sq + q0) * d;

  for (int i = tid; i < F_ROWS * d; i += F_THREADS) {
    const int rr = i / d, c = i - rr * d;
    const bool in = q0 + rr < sq;
    qs[rr * ds + c] = in ? q[qoff + i] : 0.f;
    dos[rr * ds + c] = in ? dout[qoff + i] : 0.f;
  }
  float delta = 0.f;
  if (valid)
    for (int c = lane; c < d; c += ROW_LANES)
      delta = fmaf(dout[qoff + (size_t)r * d + c], o[qoff + (size_t)r * d + c], delta);
#pragma unroll
  for (int off = ROW_LANES / 2; off > 0; off >>= 1)
    delta += __shfl_xor_sync(0xffffffffu, delta, off);
  const float lse_r = valid ? lse[(size_t)row * sq + qi] : 0.f;

  float acc[NCOL];
#pragma unroll
  for (int c = 0; c < NCOL; ++c) acc[c] = 0.f;

  for (int k0 = 0; k0 < skv; k0 += F_TILE) {
    __syncthreads();
    const size_t koff = (size_t)row * skv * d;
    for (int i = tid; i < F_TILE * d; i += F_THREADS) {
      const int rr = i / d, c = i - rr * d;
      const bool in = k0 + rr < skv;
      ks[rr * ds + c] = in ? k[koff + (size_t)(k0 + rr) * d + c] : 0.f;
      vs[rr * ds + c] = in ? v[koff + (size_t)(k0 + rr) * d + c] : 0.f;
    }
    __syncthreads();

    float s[PER_LANE], dp[PER_LANE];
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) s[j] = dp[j] = 0.f;
    const float* qr = qs + r * ds;
    const float* dr = dos + r * ds;
    for (int c = 0; c < d; ++c) {
      const float qv = qr[c], dv_ = dr[c];
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j) {
        const int kr = (lane + j * ROW_LANES) * ds + c;
        s[j] = fmaf(qv, ks[kr], s[j]);
        dp[j] = fmaf(dv_, vs[kr], dp[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) {
      const int kj = lane + j * ROW_LANES;
      const float p = k0 + kj < skv ? expf(s[j] * scale - lse_r) : 0.f;
      pss[r * F_TILE + kj] = p * (dp[j] - delta);
    }
    __syncwarp();  // a row's dS is written and read by the 8 lanes of one warp

    const float* pr = pss + r * F_TILE;
    const int kn = min(F_TILE, skv - k0);
    for (int j = 0; j < kn; ++j) {
      const float dsv = pr[j];
      const float* kr = ks + j * ds;
#pragma unroll
      for (int c = 0; c < NCOL; ++c) {
        const int col = lane + c * ROW_LANES;
        if (col < d) acc[c] = fmaf(dsv, kr[col], acc[c]);
      }
    }
  }

  if (valid) {
#pragma unroll
    for (int c = 0; c < NCOL; ++c) {
      const int col = lane + c * ROW_LANES;
      if (col < d) dq[qoff + (size_t)r * d + col] = acc[c] * scale;
    }
  }
}

// K3. NCOL as in K2.
template <int NCOL>
__global__ void __launch_bounds__(F_THREADS)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ o,
                 const float* __restrict__ dout, const float* __restrict__ lse,
                 float* __restrict__ dk, float* __restrict__ dv, int sq, int skv, int d,
                 float scale) {
  extern __shared__ float smem[];
  const int ds = d + 1;
  float* ks = smem;                  // [F_ROWS][ds]
  float* vs = ks + F_ROWS * ds;      // [F_ROWS][ds]
  float* qs = vs + F_ROWS * ds;      // [F_TILE][ds]
  float* dos = qs + F_TILE * ds;     // [F_TILE][ds]
  float* pts = dos + F_TILE * ds;    // [F_ROWS][F_TILE] P^T of the current tile
  float* dss = pts + F_ROWS * F_TILE;  // [F_ROWS][F_TILE] dS^T
  float* lse_s = dss + F_ROWS * F_TILE;  // [F_TILE]
  float* delta_s = lse_s + F_TILE;       // [F_TILE]

  const int row = blockIdx.y;
  const int k0 = blockIdx.x * F_ROWS;
  const int tid = threadIdx.x;
  const int r = tid / ROW_LANES, lane = tid % ROW_LANES;
  const bool valid = k0 + r < skv;
  const size_t koff = ((size_t)row * skv + k0) * d;

  for (int i = tid; i < F_ROWS * d; i += F_THREADS) {
    const int rr = i / d, c = i - rr * d;
    const bool in = k0 + rr < skv;
    ks[rr * ds + c] = in ? k[koff + i] : 0.f;
    vs[rr * ds + c] = in ? v[koff + i] : 0.f;
  }

  float dka[NCOL], dva[NCOL];
#pragma unroll
  for (int c = 0; c < NCOL; ++c) dka[c] = dva[c] = 0.f;

  for (int q0 = 0; q0 < sq; q0 += F_TILE) {
    __syncthreads();
    const size_t qoff = ((size_t)row * sq + q0) * d;
    const int qn = min(F_TILE, sq - q0);
    for (int i = tid; i < F_TILE * d; i += F_THREADS) {
      const int rr = i / d, c = i - rr * d;
      const bool in = rr < qn;
      qs[rr * ds + c] = in ? q[qoff + i] : 0.f;
      dos[rr * ds + c] = in ? dout[qoff + i] : 0.f;
    }
    {  // delta of the tile's queries: 4 threads per query
      const int qq = tid / 4, part = tid % 4;
      float acc = 0.f;
      if (qq < qn)
        for (int c = part; c < d; c += 4)
          acc = fmaf(dout[qoff + (size_t)qq * d + c], o[qoff + (size_t)qq * d + c], acc);
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (part == 0) {
        delta_s[qq] = acc;
        lse_s[qq] = qq < qn ? lse[(size_t)row * sq + q0 + qq] : 0.f;
      }
    }
    __syncthreads();

    float s[PER_LANE], dp[PER_LANE];
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) s[j] = dp[j] = 0.f;
    const float* kr = ks + r * ds;
    const float* vr = vs + r * ds;
    for (int c = 0; c < d; ++c) {
      const float kv = kr[c], vv = vr[c];
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j) {
        const int qr = (lane + j * ROW_LANES) * ds + c;
        s[j] = fmaf(kv, qs[qr], s[j]);
        dp[j] = fmaf(vv, dos[qr], dp[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) {
      const int qj = lane + j * ROW_LANES;
      const float p = qj < qn ? expf(s[j] * scale - lse_s[qj]) : 0.f;
      pts[r * F_TILE + qj] = p;
      dss[r * F_TILE + qj] = p * (dp[j] - delta_s[qj]);
    }
    __syncwarp();  // a key row's P^T and dS^T are written and read by the 8 lanes of one warp

    const float* pr = pts + r * F_TILE;
    const float* sr = dss + r * F_TILE;
    for (int j = 0; j < qn; ++j) {
      const float pv = pr[j], sv = sr[j];
      const float* qrow = qs + j * ds;
      const float* drow = dos + j * ds;
#pragma unroll
      for (int c = 0; c < NCOL; ++c) {
        const int col = lane + c * ROW_LANES;
        if (col < d) {
          dva[c] = fmaf(pv, drow[col], dva[c]);
          dka[c] = fmaf(sv, qrow[col], dka[c]);
        }
      }
    }
  }

  if (valid) {
#pragma unroll
    for (int c = 0; c < NCOL; ++c) {
      const int col = lane + c * ROW_LANES;
      if (col < d) {
        dk[koff + (size_t)r * d + col] = dka[c] * scale;
        dv[koff + (size_t)r * d + col] = dva[c];
      }
    }
  }
}

template <int NCOL>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
                      const float* lse, void* dq, int rows, int sq, int skv, int d, float scale,
                      cudaStream_t stream) {
  const size_t smem = (size_t)(2 * F_ROWS * (d + 1) + 2 * F_TILE * (d + 1) + F_ROWS * F_TILE) *
                      sizeof(float);
  auto kernel = flash_dq_kernel<NCOL>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + F_ROWS - 1) / F_ROWS, rows);
  kernel<<<grid, F_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(o), static_cast<const float*>(dout), lse, static_cast<float*>(dq),
      sq, skv, d, scale);
  return cudaGetLastError();
}

template <int NCOL>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* o,
                       const void* dout, const float* lse, void* dk, void* dv, int rows, int sq,
                       int skv, int d, float scale, cudaStream_t stream) {
  const size_t smem = (size_t)(2 * F_ROWS * (d + 1) + 2 * F_TILE * (d + 1) +
                               2 * F_ROWS * F_TILE + 2 * F_TILE) *
                      sizeof(float);
  auto kernel = flash_dkv_kernel<NCOL>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((skv + F_ROWS - 1) / F_ROWS, rows);
  kernel<<<grid, F_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(o), static_cast<const float*>(dout), lse, static_cast<float*>(dk),
      static_cast<float*>(dv), sq, skv, d, scale);
  return cudaGetLastError();
}

bool bad_args(int rows, int sq, int skv, int d, int dtype) {
  return rows < 1 || rows > 65535 || sq < 1 || skv < 1 || d < 1 || d > 160 ||
         (dtype != 0 && dtype != 1);
}

}  // namespace

// Both return cudaGetLastError() of the launch (0 on success). dtype: 0 fp32, 1 bf16.
extern "C" int fz_flash_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                               const void* dout, const float* lse, void* dq, int rows, int sq,
                               int skv, int d, float scale, int dtype, void* stream) {
  if (bad_args(rows, sq, skv, d, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (d <= 48) return (int)launch_dq_mma<3>(q, k, v, o, dout, lse, dq, rows, sq, skv, d, scale, s);
    if (d <= 80) return (int)launch_dq_mma<5>(q, k, v, o, dout, lse, dq, rows, sq, skv, d, scale, s);
    return (int)launch_dq_mma<10>(q, k, v, o, dout, lse, dq, rows, sq, skv, d, scale, s);
  }
  if (d <= 40) return (int)launch_dq<5>(q, k, v, o, dout, lse, dq, rows, sq, skv, d, scale, s);
  if (d <= 80) return (int)launch_dq<10>(q, k, v, o, dout, lse, dq, rows, sq, skv, d, scale, s);
  return (int)launch_dq<20>(q, k, v, o, dout, lse, dq, rows, sq, skv, d, scale, s);
}

extern "C" int fz_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* o,
                                const void* dout, const float* lse, void* dk, void* dv, int rows,
                                int sq, int skv, int d, float scale, int dtype, void* stream) {
  if (bad_args(rows, sq, skv, d, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (d <= 48)
      return (int)launch_dkv_mma<3, 64>(q, k, v, o, dout, lse, dk, dv, rows, sq, skv, d, scale, s);
    if (d <= 80)
      return (int)launch_dkv_mma<5, 64>(q, k, v, o, dout, lse, dk, dv, rows, sq, skv, d, scale, s);
    return (int)launch_dkv_mma<10, 32>(q, k, v, o, dout, lse, dk, dv, rows, sq, skv, d, scale, s);
  }
  if (d <= 40) return (int)launch_dkv<5>(q, k, v, o, dout, lse, dk, dv, rows, sq, skv, d, scale, s);
  if (d <= 80) return (int)launch_dkv<10>(q, k, v, o, dout, lse, dk, dv, rows, sq, skv, d, scale, s);
  return (int)launch_dkv<20>(q, k, v, o, dout, lse, dk, dv, rows, sq, skv, d, scale, s);
}
