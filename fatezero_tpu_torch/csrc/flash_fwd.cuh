// Flash-attention forward kernels shared by K1 (flash_fwd.cu), K1b
// (flash_fwd_bf16.cu) and K1c (flash_fwd_merged.cu), for Hopper (sm_90a).
//
// softmax(q k^T * scale) v with the online softmax over KV tiles: fp32 running
// max, sum and accumulator, so no [Sq, Skv] score matrix reaches device memory.
//
// Layout: every operand is [batch, tokens, heads * width], a token's heads side
// by side (width d for q and k, dv for v and o). Grid row y = b * heads + h
// reads and writes the columns h * width .. (h + 1) * width - 1 of batch row b,
// so the row stride of an operand is heads * width. K1c takes the
// projection's merged-head layout [R, S, H * D] as it is (MERGED = true), so no
// head-split copy exists. K1 and K1b take the folded [rows, S, d] layout
// (MERGED = false, heads = 1), whose tiles are contiguous: their loads index a
// tile by its flat element number, as K1 did before the merged layout existed
// (indexing them through a runtime row stride made K1 ~30 % slower on an H100).
// lse, when not null, is [batch * heads, Sq] fp32 (m + log l of each query row).
//
// Two kernels, both deliberately simple (no TMA, wgmma, cp.async pipelining or
// warp specialisation yet):
//
// * flash_fwd_mma_kernel: bf16 mma.sync m16n8k16 tensor cores with fp32
//   accumulation, d <= 160 and dv <= 160. One block of 4 warps per (grid row,
//   64 queries); each warp owns 16 query rows and keeps their Q fragments,
//   16x64 scores and 16xdv output accumulators in registers (the
//   FlashAttention-2 layout: the score accumulators are the P operand of the
//   next mma without any shuffle). K is staged in shared memory row-major and
//   V transposed, with an 8-element row pad so the 8 rows a fragment load
//   touches fall in distinct banks. The ragged KV tail is padded in shared
//   memory and masked in registers. Two numerics, chosen by BF16_P:
//     - false (K1, K1c): fp32 semantics. q and k are the bf16 inputs, whose
//       product is exact in fp32, and the fp32 score is scaled after the
//       product; the probabilities P are split into two bf16 terms, P = hi +
//       lo, and P V is computed as hi V + lo V (~16 mantissa bits of P).
//     - true (K1b): bf16 operands into both products, as the bf16 variant of
//       the TPU kernel: q is rounded to bf16 after scaling (bf16(fp32(q) *
//       scale)), k and v are rounded to bf16, and P is rounded to one bf16
//       term relative to the running max of its KV tile, so the result
//       depends on the tile size (MMA_BK). The sum l takes the unrounded P.
//     Inputs of type T (fp32 or bf16) are rounded to bf16 as they are staged.
// * flash_fwd_kernel: fp32 CUDA-core FMAs (fp32 inputs, or dv > 160). One block
//   of 256 threads per (grid row, 32 queries), 8 threads per query row. Each
//   KV tile of 64 keys is staged in shared memory as fp32; each thread scores
//   8 keys of its row, the row max/sum are reduced with warp shuffles inside
//   the 8-lane group, and the probabilities go through shared memory to the
//   threads that own the output columns. The Q and K tiles use a row stride
//   of d+1 so the 8 key rows a warp reads fall in distinct banks.
//
// At d=160, dv=320 the tiles take ~150 KB, above the 48 KB static limit, hence
// dynamic shared memory and cudaFuncSetAttribute (both kernels).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace fz {
namespace fwd {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ __nv_bfloat16 to_bf16(float x) { return __float2bfloat16(x); }
__device__ __forceinline__ __nv_bfloat16 to_bf16(__nv_bfloat16 x) { return x; }
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// offset of element (r, c), flat number i = r * width + c, of a tile whose rows
// lie `ld` elements apart: i itself where rows are contiguous
template <bool MERGED>
__device__ __forceinline__ int at(int i, int r, int c, int ld) { return MERGED ? r * ld + c : i; }

// ---------------------------------------------------------------- fp32, CUDA cores

constexpr int BQ = 32;                     // queries per block
constexpr int BK = 64;                     // keys per KV tile
constexpr int ROW_LANES = 8;               // threads per query row
constexpr int THREADS = BQ * ROW_LANES;    // 256
constexpr int KEYS_PER_LANE = BK / ROW_LANES;

// NCOL: output columns per thread (dv <= 8 * NCOL).
template <typename T, int NCOL, bool MERGED>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int sq, int skv, int d, int dv,
                 int heads, float scale) {
  extern __shared__ float smem[];
  const int ds = d + 1;
  float* qs = smem;              // [BQ][ds], pre-scaled
  float* ks = qs + BQ * ds;      // [BK][ds]
  float* vs = ks + BK * ds;      // [BK][dv]
  float* ps = vs + BK * dv;      // [BQ][BK] probabilities of the current tile

  const int row = blockIdx.y;
  const int b = MERGED ? row / heads : row, h = MERGED ? row - b * heads : 0;
  const int ldq = MERGED ? heads * d : d, ldv = MERGED ? heads * dv : dv;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int r = tid / ROW_LANES;
  const int lane = tid % ROW_LANES;

  const T* qrow = q + ((size_t)b * sq + q0) * ldq + h * d;
  const T* krow = k + (size_t)b * skv * ldq + h * d;
  const T* vrow = v + (size_t)b * skv * ldv + h * dv;

  for (int i = tid; i < BQ * d; i += THREADS) {
    const int rr = i / d, c = i - rr * d;
    qs[rr * ds + c] = q0 + rr < sq ? to_f32(qrow[at<MERGED>(i, rr, c, ldq)]) * scale : 0.f;
  }

  float acc[NCOL];
#pragma unroll
  for (int c = 0; c < NCOL; ++c) acc[c] = 0.f;
  float m = NEG_INF, l = 0.f;

  for (int k0 = 0; k0 < skv; k0 += BK) {
    __syncthreads();  // the previous tile is fully consumed
    const T* ktile = krow + (size_t)k0 * ldq;
    const T* vtile = vrow + (size_t)k0 * ldv;
    for (int i = tid; i < BK * d; i += THREADS) {
      const int rr = i / d, c = i - rr * d;
      ks[rr * ds + c] = k0 + rr < skv ? to_f32(ktile[at<MERGED>(i, rr, c, ldq)]) : 0.f;
    }
    for (int i = tid; i < BK * dv; i += THREADS) {
      const int rr = i / dv, c = i - rr * dv;
      vs[rr * dv + c] = k0 + rr < skv ? to_f32(vtile[at<MERGED>(i, rr, c, ldv)]) : 0.f;
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
    T* orow = o + ((size_t)b * sq + qi) * ldv + h * dv;
#pragma unroll
    for (int c = 0; c < NCOL; ++c) {
      const int col = lane + c * ROW_LANES;
      if (col < dv) store_out(orow + col, acc[c] / l);
    }
    if (lse != nullptr && lane == 0) lse[(size_t)row * sq + qi] = m + logf(l);
  }
}

template <typename T, int NCOL, bool MERGED>
cudaError_t launch_fma(const void* q, const void* k, const void* v, void* o, float* lse, int rows,
                       int heads, int sq, int skv, int d, int dv, float scale, cudaStream_t stream) {
  const size_t smem = (size_t)(BQ * (d + 1) + BK * (d + 1) + BK * dv + BQ * BK) * sizeof(float);
  auto kernel = flash_fwd_kernel<T, NCOL, MERGED>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + BQ - 1) / BQ, rows * heads);
  kernel<<<grid, THREADS, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                          static_cast<const T*>(v), static_cast<T*>(o), lse, sq,
                                          skv, d, dv, heads, scale);
  return cudaGetLastError();
}

// fp32 CUDA-core kernel for dv <= 320
template <typename T, bool MERGED>
cudaError_t dispatch_fma(const void* q, const void* k, const void* v, void* o, float* lse, int rows,
                         int heads, int sq, int skv, int d, int dv, float scale,
                         cudaStream_t stream) {
  if (dv <= 8 * 5) return launch_fma<T, 5, MERGED>(q, k, v, o, lse, rows, heads, sq, skv, d, dv, scale, stream);
  if (dv <= 8 * 10) return launch_fma<T, 10, MERGED>(q, k, v, o, lse, rows, heads, sq, skv, d, dv, scale, stream);
  if (dv <= 8 * 20) return launch_fma<T, 20, MERGED>(q, k, v, o, lse, rows, heads, sq, skv, d, dv, scale, stream);
  return launch_fma<T, 40, MERGED>(q, k, v, o, lse, rows, heads, sq, skv, d, dv, scale, stream);
}

// ---------------------------------------------------------------- bf16, tensor cores

constexpr int MMA_BQ = 64;
constexpr int MMA_BK = 64;   // the KV tile, which K1b's rounding of P depends on
constexpr int MMA_THREADS = 128;

// DK: 16-wide k-steps of the head dim (d <= 16*DK); DVN: 8-wide n-tiles of V (dv <= 8*DVN)
template <typename T, int DK, int DVN, bool BF16_P, bool MERGED>
__global__ void __launch_bounds__(MMA_THREADS)
flash_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ o, float* __restrict__ lse, int sq, int skv, int d, int dv,
                     int heads, float scale) {
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
  const int b = MERGED ? row / heads : row, h = MERGED ? row - b * heads : 0;
  const int ldq = MERGED ? heads * d : d, ldv = MERGED ? heads * dv : dv;
  const int q0 = blockIdx.x * MMA_BQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;

  // zero everything once: padded columns are never written again, and stale
  // rows past a ragged tail stay finite (0 * NaN would poison the sums)
  for (int i = tid; i < smem_words; i += MMA_THREADS) reinterpret_cast<uint32_t*>(smem_raw)[i] = 0u;
  __syncthreads();

  const int q_rows = min(MMA_BQ, sq - q0);
  const T* qsrc = q + ((size_t)b * sq + q0) * ldq + h * d;
  for (int i = tid; i < q_rows * d; i += MMA_THREADS) {
    const int r = i / d, c = i - r * d;
    const T x = qsrc[at<MERGED>(i, r, c, ldq)];
    qs[r * QS + c] = BF16_P ? to_bf16(to_f32(x) * scale) : to_bf16(x);
  }
  __syncthreads();

  uint32_t qa[DK][4];
  const __nv_bfloat16* qw = qs + warp * 16 * QS;
#pragma unroll
  for (int kk = 0; kk < DK; ++kk) load_a(qa[kk], qw, QS, kk, g, t);

  float oacc[DVN][4];
#pragma unroll
  for (int n = 0; n < DVN; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;  // rows g and g + 8
  const float s_scale = BF16_P ? 1.f : scale;           // K1b's q is pre-scaled

  for (int k0 = 0; k0 < skv; k0 += MMA_BK) {
    __syncthreads();  // the previous tile is fully consumed
    const int kn = min(MMA_BK, skv - k0);
    const T* ksrc = k + ((size_t)b * skv + k0) * ldq + h * d;
    for (int i = tid; i < kn * d; i += MMA_THREADS) {
      const int r = i / d, c = i - r * d;
      ks[r * QS + c] = to_bf16(ksrc[at<MERGED>(i, r, c, ldq)]);
    }
    const T* vsrc = v + ((size_t)b * skv + k0) * ldv + h * dv;
    for (int i = tid; i < kn * dv; i += MMA_THREADS) {
      const int r = i / dv, c = i - r * dv;
      vt[c * VS + r] = to_bf16(vsrc[at<MERGED>(i, r, c, ldv)]);
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
        s[j][e] = col < skv ? s[j][e] * s_scale : NEG_INF;  // ragged KV tail
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
      if constexpr (BF16_P) {
        round_a(hi, s[2 * kk], s[2 * kk + 1]);
      } else {
        split_a(hi, lo, s[2 * kk], s[2 * kk + 1]);
      }
#pragma unroll
      for (int n = 0; n < DVN; ++n) {
        const __nv_bfloat16* vr = vt + (8 * n + g) * VS + kk * 16 + 2 * t;
        const uint32_t b0 = ld_pair(vr), b1 = ld_pair(vr + 8);
        mma_bf16(oacc[n], hi, b0, b1);
        if constexpr (!BF16_P) mma_bf16(oacc[n], lo, b0, b1);
      }
    }
  }

  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  T* obase = o + (size_t)b * sq * ldv + h * dv;
#pragma unroll
  for (int n = 0; n < DVN; ++n) {
    const int col = 8 * n + 2 * t;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (col + e >= dv) continue;
      if (r0 < sq) store_out(obase + (size_t)r0 * ldv + col + e, oacc[n][e] * inv0);
      if (r1 < sq) store_out(obase + (size_t)r1 * ldv + col + e, oacc[n][2 + e] * inv1);
    }
  }
  if (lse != nullptr && t == 0) {
    if (r0 < sq) lse[(size_t)row * sq + r0] = m0 + logf(l0);
    if (r1 < sq) lse[(size_t)row * sq + r1] = m1 + logf(l1);
  }
}

template <typename T, int DK, int DVN, bool BF16_P, bool MERGED>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, float* lse, int rows,
                       int heads, int sq, int skv, int d, int dv, float scale,
                       cudaStream_t stream) {
  constexpr int QS = DK * 16 + 8;
  const size_t smem = ((size_t)(MMA_BQ + MMA_BK) * QS + (size_t)DVN * 8 * (MMA_BK + 8)) *
                      sizeof(__nv_bfloat16);
  auto kernel = flash_fwd_mma_kernel<T, DK, DVN, BF16_P, MERGED>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + MMA_BQ - 1) / MMA_BQ, rows * heads);
  kernel<<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, sq, skv, d, dv, heads, scale);
  return cudaGetLastError();
}

template <typename T, int DK, bool BF16_P, bool MERGED>
cudaError_t dispatch_mma_dv(const void* q, const void* k, const void* v, void* o, float* lse,
                            int rows, int heads, int sq, int skv, int d, int dv, float scale,
                            cudaStream_t stream) {
  if (dv <= 40)
    return launch_mma<T, DK, 5, BF16_P, MERGED>(q, k, v, o, lse, rows, heads, sq, skv, d, dv, scale, stream);
  if (dv <= 80)
    return launch_mma<T, DK, 10, BF16_P, MERGED>(q, k, v, o, lse, rows, heads, sq, skv, d, dv, scale, stream);
  return launch_mma<T, DK, 20, BF16_P, MERGED>(q, k, v, o, lse, rows, heads, sq, skv, d, dv, scale, stream);
}

// tensor-core kernel for d <= 160 and dv <= 160
template <typename T, bool BF16_P, bool MERGED>
cudaError_t dispatch_mma(const void* q, const void* k, const void* v, void* o, float* lse, int rows,
                         int heads, int sq, int skv, int d, int dv, float scale,
                         cudaStream_t stream) {
  if (d <= 48)
    return dispatch_mma_dv<T, 3, BF16_P, MERGED>(q, k, v, o, lse, rows, heads, sq, skv, d, dv, scale, stream);
  if (d <= 80)
    return dispatch_mma_dv<T, 5, BF16_P, MERGED>(q, k, v, o, lse, rows, heads, sq, skv, d, dv, scale, stream);
  return dispatch_mma_dv<T, 10, BF16_P, MERGED>(q, k, v, o, lse, rows, heads, sq, skv, d, dv, scale, stream);
}

}  // namespace fwd
}  // namespace fz
