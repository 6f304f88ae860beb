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
// (MERGED = false, heads = 1), whose tiles are contiguous. The layout is a
// compile-time flag because the CUDA-core kernel loads by element, where a
// run-time row stride costs ~30 % on an H100; for the 16-byte copies of the
// tensor-core kernels a stride costs nothing.
// lse, when not null, is [batch * heads, Sq] fp32 (m + log l of each query row).
//
// Three kernels:
//
// * flash_fwd_wgmma_kernel: bf16 operands on 16-byte boundaries with d <= 80 and
//   dv <= 80 (the 64x64 and 32x32 latent sites, nearly all of the work). One
//   block of 8 warps per (grid row, 128 queries), two blocks per SM. Each
//   warpgroup of 4 warps owns 64 queries and runs q k^T and P v as
//   asynchronous warpgroup products (wgmma m64nNk16): Q and P come from
//   registers, K and V are read by the tensor cores straight from shared
//   memory, where 16-byte cp.async copies lay them out as unswizzled 8x8 core
//   matrices (wgmma_bf16.cuh), so that K^T and the row-major V need no
//   transposed staging. A ring of 3 KV slots is handed over by mbarriers: the
//   copies arrive on a slot's `full` barrier as they land, the warps on its
//   `empty` barrier when they are done with it, so no block-wide barrier sits
//   in the loop and the two warpgroups drift apart by up to a tile.
// * flash_fwd_mma_kernel: every other tensor-core case (d <= 160, dv <= 160):
//   the large head dims, fp32 input that is rounded to bf16 while it is staged
//   (K1b), and operands that are misaligned or whose widths are no multiples of
//   8. mma.sync m16n8k16; 8 warps and 128 queries per block with a ring of 3 KV
//   slots at d, dv <= 80, else 4 warps and 2 slots. Tiles are row-major with
//   rows padded to an odd number of 16-byte chunks, filled by 16-byte cp.async
//   (bf16), by 16-byte loads rounded in registers (fp32) or element by element
//   (misaligned), one block barrier per tile; fragments come from ldmatrix, V's
//   through ldmatrix.trans.
//   In both, each warp owns 16 query rows and keeps their Q fragments, 16x64
//   scores and 16xdv output accumulators in registers (the FlashAttention-2
//   layout: the score accumulators are the P operand of the next product
//   without any shuffle). The ragged KV tail is zero-filled by the copies'
//   source-size operand and masked in registers, in the last tile only. The
//   softmax takes the running max of the unscaled scores (so K1 and K1c need a
//   positive scale; K1b's q is scaled before the product, so it takes any) and
//   computes 2^((s - m) * scale * log2 e) with one multiply-add and one ex2
//   each. Two numerics, chosen by BF16_P:
//     - false (K1, K1c): fp32 semantics. q and k are the bf16 inputs, whose
//       product is exact in fp32; the probabilities P are split into two bf16
//       terms, P = hi + lo (hi by truncation, ~16 mantissa bits together), and
//       P V is computed as hi V + lo V.
//     - true (K1b): bf16 operands into both products, as the bf16 variant of
//       the TPU kernel: q is rounded to bf16 after scaling (bf16(fp32(q) *
//       scale)), k and v are rounded to bf16, and P is rounded to one bf16
//       term relative to the running max of its KV tile, so the result
//       depends on the tile size (MMA_BK). The sum l takes the unrounded P.
//   What bounds them on an H100: not the products. At d = 40 a tile of 64 keys
//   costs each thread ~500 instructions, of which 11 are warpgroup products;
//   the exponentials (one MUFU each), the max, the sum and the hi/lo split of
//   every score, about 7 instructions an element, fill the instruction slots. Hence
//   the design spends nothing else there: no fragment loads (wgmma), no
//   per-tile block barrier, no division, no select for the mask, one
//   conversion per split pair.
// * flash_fwd_kernel: fp32 CUDA-core FMAs (fp32 inputs, or dv > 160). One block
//   of 256 threads per (grid row, 32 queries), 8 threads per query row. Each
//   KV tile of 64 keys is staged in shared memory as fp32; each thread scores
//   8 keys of its row, the row max/sum are reduced with warp shuffles inside
//   the 8-lane group, and the probabilities go through shared memory to the
//   threads that own the output columns. The Q and K tiles use a row stride
//   of d+1 so the 8 key rows a warp reads fall in distinct banks.
//
// Every tile set is dynamic shared memory (up to ~150 KB, above the 48 KB
// static limit), hence cudaFuncSetAttribute before each launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_bf16.cuh"
#include "wgmma_bf16.cuh"

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

constexpr int MMA_BK = 64;   // the KV tile, which K1b's rounding of P depends on
constexpr int MMA_PAD = 8;   // elements added to a tile row so 8 ldmatrix rows fall in 8 bank groups
// mma.sync kernel, "small" head dims (d <= 16 * MMA_SMALL_DK and dv <= 8 *
// MMA_SMALL_DVN): 8 warps of 16 queries and a ring of 3 KV stages; larger ones
// 4 warps and 2 stages
constexpr int MMA_SMALL_DK = 5;
constexpr int MMA_SMALL_DVN = 10;
constexpr int MMA_WARPS_SMALL = 8;
constexpr int MMA_WARPS_LARGE = 4;
constexpr int MMA_STAGES_SMALL = 3;
constexpr int MMA_STAGES_LARGE = 2;
// wgmma kernel (small head dims only): warps of 16 queries, ring slots, and the
// bytes set aside for the ring's barriers
constexpr int WG_WARPS = 8;
constexpr int WG_STAGES = 3;
constexpr int WG_BAR_BYTES = 128;
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory one block may have on sm_90
constexpr float LOG2E = 1.4426950408889634f;

// Tile geometry of flash_fwd_mma_kernel for DK 16-wide k-steps of the head dim
// and DVN 8-wide n-tiles of V (ops/flash_attention.py::kernel_plan mirrors it).
// Row strides are odd multiples of 16 bytes: the eight 16-byte rows of one
// ldmatrix then fall in eight distinct bank groups.
template <int DK, int DVN>
struct MmaCfg {
  static constexpr bool SMALL = DK <= MMA_SMALL_DK && DVN <= MMA_SMALL_DVN;
  static constexpr int WARPS = SMALL ? MMA_WARPS_SMALL : MMA_WARPS_LARGE;
  static constexpr int THREADS = WARPS * 32;
  static constexpr int BQ = WARPS * 16;
  static constexpr int STAGES = SMALL ? MMA_STAGES_SMALL : MMA_STAGES_LARGE;
  static constexpr int MIN_BLOCKS = SMALL ? 2 : 1;  // 8 warps at <= 128 registers: two blocks per SM
  static constexpr int QS = DK * 16 + MMA_PAD;                    // Q and K row stride
  static constexpr int VS = DVN * 8 + (DVN % 2 ? 0 : MMA_PAD);    // V row stride
  static constexpr int STAGE = MMA_BK * (QS + VS);                // elements of one ring slot
  static constexpr int SMEM = (BQ * QS + STAGES * STAGE) * 2;     // bytes
  static_assert(SMEM <= SMEM_LIMIT, "tile does not fit the shared memory of one block");
};

// Tile geometry of flash_fwd_wgmma_kernel: the Q tile as above, K and V slots
// as unpadded core-matrix tiles (wgmma_bf16.cuh), the ring's barriers in front.
template <int DK, int DVN>
struct WgCfg {
  static_assert(MmaCfg<DK, DVN>::SMALL, "the wgmma kernel takes the small head dims only");
  static constexpr int WARPS = WG_WARPS;
  static constexpr int THREADS = WARPS * 32;
  static constexpr int BQ = WARPS * 16;
  static constexpr int STAGES = WG_STAGES;
  static constexpr int AHEAD = STAGES - 2;  // tiles in flight ahead of the one being multiplied
  static constexpr int MIN_BLOCKS = 65536 / (THREADS * 128);  // 128 registers a thread
  static constexpr int QS = DK * 16 + MMA_PAD;
  static constexpr int KTILE = MMA_BK * DK * 16;  // elements
  static constexpr int VTILE = MMA_BK * DVN * 8;
  static constexpr int STAGE = KTILE + VTILE;
  static constexpr int SMEM = WG_BAR_BYTES + (BQ * QS + STAGES * STAGE) * 2;
  static_assert(SMEM <= SMEM_LIMIT && 16 * STAGES <= WG_BAR_BYTES && AHEAD >= 1, "ring does not fit");
};

// A thread's walk over the 16-byte chunks (8 elements) of a tile whose rows
// hold `cpr` chunks: chunk number tid, tid + NT, ...; the one division is made
// here, once per kernel, and the walk advances by constants.
struct ChunkWalk {
  int r0, c0, dr, dc, cpr;
};
template <int NT>
__device__ __forceinline__ ChunkWalk chunk_walk(int tid, int cpr) {
  ChunkWalk w;
  w.cpr = cpr;
  w.r0 = tid / cpr;
  w.c0 = tid - w.r0 * cpr;
  w.dr = NT / cpr;
  w.dc = NT - w.dr * cpr;
  return w;
}

__device__ __forceinline__ void load8(float (&x)[8], const float* p) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(float (&x)[8], const __nv_bfloat16* p) {
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Stage `total` rows of `8 * w.cpr` elements from a global tile (rows `ld`
// elements apart) into a bf16 shared tile (rows `ss` apart) by 16-byte chunks;
// rows from `valid` on become zeros. ASYNC (bf16 input only): cp.async, the
// zero rows by its source-size operand; else a 16-byte load (two for fp32),
// a conversion (after scaling, if SCALE) and a 16-byte store.
template <typename T, bool ASYNC, bool SCALE>
__device__ __forceinline__ void stage_chunks(__nv_bfloat16* dst, int ss, const T* src, int ld,
                                             int valid, int total, const ChunkWalk& w, float scale) {
  int r = w.r0, c = w.c0;
  while (r < total) {
    const bool ok = r < valid;
    const T* g = src + (size_t)(ok ? r : 0) * ld + c * 8;
    __nv_bfloat16* s = dst + r * ss + c * 8;
    if constexpr (ASYNC) {
      cp_async16(smem_u32(s), g, ok ? 16 : 0);
    } else {
      uint4 out = make_uint4(0u, 0u, 0u, 0u);
      if (ok) {
        float x[8];
        load8(x, g);
        if constexpr (SCALE) {
#pragma unroll
          for (int i = 0; i < 8; ++i) x[i] *= scale;
        }
        out = make_uint4(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]), pack_bf16(x[4], x[5]),
                         pack_bf16(x[6], x[7]));
      }
      *reinterpret_cast<uint4*>(s) = out;
    }
    r += w.dr;
    c += w.dc;
    if (c >= w.cpr) {
      c -= w.cpr;
      ++r;
    }
  }
}

// MMA_BK rows of w.cpr chunks into a core-matrix tile (wgmma_bf16.cuh) of `cpad`
// chunks per row, by cp.async. A thread owns row `r8` of the 8-row groups and
// walks over (group, chunk): eight neighbouring threads fill the eight 16-byte
// rows of one core matrix, 128 contiguous bytes, so the copies meet no bank
// conflict, and four neighbouring eights read 64 contiguous bytes of each of
// their rows.
__device__ __forceinline__ void stage_core(uint32_t dst, int cpad, const __nv_bfloat16* src, int ld,
                                           int valid, const ChunkWalk& w, int r8) {
  int grp = w.r0, c = w.c0;
  while (grp < MMA_BK / 8) {
    const int r = grp * 8 + r8;
    const bool ok = r < valid;
    cp_async16(dst + (grp * cpad + c) * 128 + r8 * 16, src + (size_t)(ok ? r : 0) * ld + c * 8,
               ok ? 16 : 0);
    grp += w.dr;
    c += w.dc;
    if (c >= w.cpr) {
      c -= w.cpr;
      ++grp;
    }
  }
}

// The same tile element by element, for operands that are not 16-byte aligned
// or whose width is no multiple of 8: any pointer, any width, a division per
// element.
template <typename T, int NT, bool SCALE>
__device__ __forceinline__ void stage_elems(__nv_bfloat16* dst, int ss, const T* src, int ld,
                                            int valid, int total, int width, float scale, int tid) {
  for (int i = tid; i < total * width; i += NT) {
    const int r = i / width, c = i - r * width;
    const float x = r < valid ? to_f32(src[(size_t)r * ld + c]) : 0.f;
    dst[r * ss + c] = to_bf16(SCALE ? x * scale : x);
  }
}

// zero the 16-byte chunks c_lo .. c_hi - 1 of every row of a row-major shared tile
template <int NT>
__device__ __forceinline__ void zero_chunks(__nv_bfloat16* dst, int ss, int rows, int c_lo, int c_hi,
                                            int tid) {
  const int n = c_hi - c_lo;
  for (int i = tid; i < rows * n; i += NT) {
    const int r = i / n, c = c_lo + (i - r * n);
    *reinterpret_cast<uint4*>(dst + r * ss + c * 8) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// and of a core-matrix tile of MMA_BK rows
template <int NT>
__device__ __forceinline__ void zero_core(__nv_bfloat16* dst, int cpad, int c_lo, int c_hi, int tid) {
  for (int i = tid; i < MMA_BK * (c_hi - c_lo); i += NT) {
    const int r = i % MMA_BK, c = c_lo + i / MMA_BK;
    *reinterpret_cast<uint4*>(dst + ((r / 8 * cpad + c) * 128 + r % 8 * 16) / 2) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// The online softmax of one warp's 16 x 64 scores, between the two products of
// either kernel. On entry s holds q k^T of rows g and g + 8 (s[j][0..1] and
// s[j][2..3]: key columns 8j + 2t, +1 of the tile starting at key k0); on exit
// the probabilities 2^((s - m) * s_scale), one multiply-add and one exponential
// instruction each (s_scale = scale * log2(e) > 0). m0, m1 are the rows'
// running maxima of the unscaled scores, l0, l1 their running sums; a0, a1
// receive the factors by which the rows' earlier sums and accumulators shrink.
// RAGGED is a compile-time flag, and each kernel compiles its tile step twice,
// because the compiler turns a run-time test into 56 selects in every tile.
template <bool RAGGED>
__device__ __forceinline__ void softmax_tile(float (&s)[8][4], float& m0, float& m1, float& l0, float& l1,
                                             float& a0, float& a1, int k0, int skv, float s_scale, int t) {
  if constexpr (RAGGED) {  // the last tile: keys past the ragged KV tail count for nothing
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k0 + 8 * j + 2 * t + (e & 1) >= skv) s[j][e] = NEG_INF;
    }
  }
  float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
    mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  const float c0 = mn0 * s_scale, c1 = mn1 * s_scale;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s[j][0] = fast_exp2(fmaf(s[j][0], s_scale, -c0));
    s[j][1] = fast_exp2(fmaf(s[j][1], s_scale, -c0));
    s[j][2] = fast_exp2(fmaf(s[j][2], s_scale, -c1));
    s[j][3] = fast_exp2(fmaf(s[j][3], s_scale, -c1));
    sum0 += s[j][0] + s[j][1];
    sum1 += s[j][2] + s[j][3];
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
  }
  a0 = fast_exp2((m0 - mn0) * s_scale);
  a1 = fast_exp2((m1 - mn1) * s_scale);
  l0 = a0 * l0 + sum0;
  l1 = a1 * l1 + sum1;
  m0 = mn0;
  m1 = mn1;
}

// Normalise a warp's accumulators and write its rows r0 and r0 + 8 of the
// output, and of the log-sum-exp m * m_scale + log l if asked for. PAIRED: dv is even and every
// output row 4-byte aligned, so bf16 goes out two at a time.
template <typename T, int DVN, bool PAIRED>
__device__ __forceinline__ void store_rows(const float (&oacc)[DVN][4], float m0, float m1, float l0,
                                           float l1, float m_scale, T* obase, int ldv, int dv,
                                           float* lse_row, int r0, int sq, int t) {
  const int r1 = r0 + 8;
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
  for (int n = 0; n < DVN; ++n) {
    const int col = 8 * n + 2 * t;
    if constexpr (PAIRED) {
      if (col < dv) {
        if (r0 < sq)
          *reinterpret_cast<uint32_t*>(obase + (size_t)r0 * ldv + col) =
              pack_bf16(oacc[n][0] * inv0, oacc[n][1] * inv0);
        if (r1 < sq)
          *reinterpret_cast<uint32_t*>(obase + (size_t)r1 * ldv + col) =
              pack_bf16(oacc[n][2] * inv1, oacc[n][3] * inv1);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (col + e >= dv) continue;
        if (r0 < sq) store_out(obase + (size_t)r0 * ldv + col + e, oacc[n][e] * inv0);
        if (r1 < sq) store_out(obase + (size_t)r1 * ldv + col + e, oacc[n][2 + e] * inv1);
      }
    }
  }
  if (lse_row != nullptr && t == 0) {  // m_scale: the scores' scale, which the maxima lack
    if (r0 < sq) lse_row[r0] = m0 * m_scale + logf(l0);
    if (r1 < sq) lse_row[r1] = m1 * m_scale + logf(l1);
  }
}

// ---- the mma.sync kernel: any input type, any loader, every head dim
//
// DK: 16-wide k-steps of the head dim (d <= 16*DK); DVN: 8-wide n-tiles of V
// (dv <= 8*DVN); VEC: 16-byte loader (every operand 16-byte aligned, d and dv
// multiples of 8), else the element loader.
template <typename T, int DK, int DVN, bool BF16_P, bool MERGED, bool VEC>
__global__ void __launch_bounds__(MmaCfg<DK, DVN>::THREADS, MmaCfg<DK, DVN>::MIN_BLOCKS)
flash_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ o, float* __restrict__ lse, int sq, int skv, int d, int dv,
                     int heads, float scale) {
  using Cfg = MmaCfg<DK, DVN>;
  constexpr int NT = Cfg::THREADS, BQ = Cfg::BQ, STAGES = Cfg::STAGES, QS = Cfg::QS, VS = Cfg::VS;
  constexpr bool BF16_IN = sizeof(T) == 2;
  constexpr bool ASYNC = VEC && BF16_IN;      // K and V tiles by cp.async
  constexpr bool ASYNC_Q = ASYNC && !BF16_P;  // K1b scales q before rounding it: through registers
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BQ][QS]
  __nv_bfloat16* ring = qs + BQ * QS;  // STAGES x (K [BK][QS], then V [BK][VS]), both row-major

  const int row = blockIdx.y;
  const int b = MERGED ? row / heads : row, h = MERGED ? row - b * heads : 0;
  const int ldq = MERGED ? heads * d : d, ldv = MERGED ? heads * dv : dv;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;

  // Columns d .. 16*DK - 1 of Q and K enter the first product and columns
  // dv .. 8*DVN - 1 of V the second; no load ever writes them, so they are
  // zeroed once (a stale NaN times zero would poison the sums). Whole chunks:
  // the element loader's columns may share the first one, hence its barrier.
  zero_chunks<NT>(qs, QS, BQ, d / 8, 2 * DK, tid);
#pragma unroll
  for (int st = 0; st < STAGES; ++st) {
    zero_chunks<NT>(ring + st * Cfg::STAGE, QS, MMA_BK, d / 8, 2 * DK, tid);
    zero_chunks<NT>(ring + st * Cfg::STAGE + MMA_BK * QS, VS, MMA_BK, dv / 8, DVN, tid);
  }
  if constexpr (!VEC) __syncthreads();

  const ChunkWalk wk = chunk_walk<NT>(tid, VEC ? d / 8 : 1);
  const ChunkWalk wv = chunk_walk<NT>(tid, VEC ? dv / 8 : 1);
  const T* ksrc = k + (size_t)b * skv * ldq + h * d;
  const T* vsrc = v + (size_t)b * skv * ldv + h * dv;
  const int ntiles = (skv + MMA_BK - 1) / MMA_BK;

  // start the loads of KV tile `tile` into ring slot tile % STAGES; rows past
  // the ragged tail become zeros (masked below, but 0 * stale NaN is NaN).
  // Every call commits one group, empty past the last tile, so that the wait
  // below always counts the same number of groups.
  auto load_tile = [&](int tile) {
    if (tile < ntiles) {
      const int k0 = tile * MMA_BK, kn = min(MMA_BK, skv - k0);
      __nv_bfloat16* ks = ring + (tile % STAGES) * Cfg::STAGE;
      __nv_bfloat16* vs = ks + MMA_BK * QS;
      if constexpr (VEC) {
        stage_chunks<T, ASYNC, false>(ks, QS, ksrc + (size_t)k0 * ldq, ldq, kn, MMA_BK, wk, 1.f);
        stage_chunks<T, ASYNC, false>(vs, VS, vsrc + (size_t)k0 * ldv, ldv, kn, MMA_BK, wv, 1.f);
      } else {
        stage_elems<T, NT, false>(ks, QS, ksrc + (size_t)k0 * ldq, ldq, kn, MMA_BK, d, 1.f, tid);
        stage_elems<T, NT, false>(vs, VS, vsrc + (size_t)k0 * ldv, ldv, kn, MMA_BK, dv, 1.f, tid);
      }
    }
    if constexpr (ASYNC) cp_async_commit();
  };

  const T* qsrc = q + ((size_t)b * sq + q0) * ldq + h * d;
  const int q_rows = min(BQ, sq - q0);
  if constexpr (VEC) {
    stage_chunks<T, ASYNC_Q, BF16_P>(qs, QS, qsrc, ldq, q_rows, BQ, wk, scale);
  } else {
    stage_elems<T, NT, BF16_P>(qs, QS, qsrc, ldq, q_rows, BQ, d, scale, tid);
  }
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) load_tile(st);  // Q travels in tile 0's group
  if constexpr (ASYNC) cp_async_wait<STAGES - 2>();
  __syncthreads();  // Q and tile 0 have landed

  // lane's row and column inside the 16x16 block one ldmatrix.x4 reads:
  //   A (Q) and the transposed B (V): matrices (rows 0-7, 8-15) x (cols 0-7, 8-15), rows first
  //   B stored [n][k] (K):            matrices (keys 0-7: d 0-7, 8-15), (keys 8-15: d 0-7, 8-15)
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
  const int k_row = (lane & 7) + (lane >> 4) * 8, k_col = ((lane >> 3) & 1) * 8;
  const uint32_t ring_addr = smem_u32(ring);
  const uint32_t k_lane = (k_row * QS + k_col) * 2;
  const uint32_t v_lane = (a_row * VS + a_col) * 2;
  const uint32_t v_lane2 = a_row * VS * 2;  // the odd last n-tile: two matrices, one column block

  uint32_t qa[DK][4];
#pragma unroll
  for (int kk = 0; kk < DK; ++kk)
    ldmatrix_x4(qa[kk], smem_u32(qs + (warp * 16 + a_row) * QS + kk * 16 + a_col));

  float oacc[DVN][4];
#pragma unroll
  for (int n = 0; n < DVN; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;  // rows g and g + 8
  const float s_scale = BF16_P ? LOG2E : scale * LOG2E;  // K1b's q is pre-scaled

  // one KV tile; RAGGED (the last tile only) also masks the keys past skv
  auto step = [&](int tile, auto ragged) {
    // every warp is past tile - 1 (the barrier below), so its slot is free
    load_tile(tile + STAGES - 1);
    const uint32_t ks_addr = ring_addr + (tile % STAGES) * Cfg::STAGE * 2;
    const uint32_t vs_addr = ks_addr + MMA_BK * QS * 2;

    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {  // keys 16 jp .. 16 jp + 15: n-tiles 2 jp and 2 jp + 1
        uint32_t kb[4];
        ldmatrix_x4(kb, ks_addr + k_lane + (jp * 16 * QS + kk * 16) * 2);
        mma_bf16(s[2 * jp], qa[kk], kb[0], kb[1]);
        mma_bf16(s[2 * jp + 1], qa[kk], kb[2], kb[3]);
      }
    }

    float a0, a1;
    softmax_tile<decltype(ragged)::value>(s, m0, m1, l0, l1, a0, a1, tile * MMA_BK, skv, s_scale, t);
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
        split_a_trunc(hi, lo, s[2 * kk], s[2 * kk + 1]);
      }
      // B operand from the row-major V tile, transposed by the load: keys
      // 16kk..16kk+15 of value columns 16np..16np+15 (n-tiles 2np, 2np+1)
#pragma unroll
      for (int np = 0; np < DVN / 2; ++np) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vs_addr + v_lane + (kk * 16 * VS + np * 16) * 2);
        mma_bf16(oacc[2 * np], hi, vb[0], vb[1]);
        mma_bf16(oacc[2 * np + 1], hi, vb[2], vb[3]);
        if constexpr (!BF16_P) {
          mma_bf16(oacc[2 * np], lo, vb[0], vb[1]);
          mma_bf16(oacc[2 * np + 1], lo, vb[2], vb[3]);
        }
      }
      if constexpr (DVN % 2 == 1) {
        uint32_t vb[2];
        ldmatrix_x2_trans(vb, vs_addr + v_lane2 + (kk * 16 * VS + (DVN - 1) * 8) * 2);
        mma_bf16(oacc[DVN - 1], hi, vb[0], vb[1]);
        if constexpr (!BF16_P) mma_bf16(oacc[DVN - 1], lo, vb[0], vb[1]);
      }
    }

    // tile + 1 has landed (this thread's copies, then everyone's), and every
    // warp is done with this tile: the one barrier of the tile
    if constexpr (ASYNC) cp_async_wait<STAGES - 2>();
    __syncthreads();
  };
  for (int tile = 0; tile + 1 < ntiles; ++tile) step(tile, std::false_type{});
  step(ntiles - 1, std::true_type{});

  store_rows<T, DVN, VEC && BF16_IN>(oacc, m0, m1, l0, l1, BF16_P ? 1.f : scale,
                                     o + (size_t)b * sq * ldv + h * dv, ldv, dv,
                                     lse == nullptr ? nullptr : lse + (size_t)row * sq,
                                     q0 + warp * 16 + g, sq, t);
}

// ---- the wgmma kernel: bf16 operands on 16-byte boundaries, the small head dims
//
// Each warpgroup (4 warps) owns 64 queries and runs its two products as
// asynchronous warpgroup MMAs: Q, and P after the softmax, from registers, K
// and V straight from shared memory, so no fragment of K or V passes through
// registers and each is read once per 64 queries, not once per 16. The ring's
// slots are handed over by mbarriers instead of a block-wide barrier: `full`
// counts every thread's copies of a tile as they land (cp.async's own
// arrive-on), `empty` counts the warps that are done with a slot. Warpgroups
// therefore drift up to STAGES - AHEAD tiles apart, and one's softmax overlaps
// another's products.
template <int DK, int DVN, bool BF16_P, bool MERGED>
__global__ void __launch_bounds__(WgCfg<DK, DVN>::THREADS, WgCfg<DK, DVN>::MIN_BLOCKS)
flash_fwd_wgmma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                       float* __restrict__ lse, int sq, int skv, int d, int dv, int heads, float scale) {
  using Cfg = WgCfg<DK, DVN>;
  using T = __nv_bfloat16;
  constexpr int NT = Cfg::THREADS, BQ = Cfg::BQ, STAGES = Cfg::STAGES, AHEAD = Cfg::AHEAD, QS = Cfg::QS;
  static_assert(DVN == 5 || DVN == 10, "wgmma value widths: 40 and 80");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t full = smem_u32(smem_raw), empty = full + 8 * STAGES;  // one 8-byte barrier per slot
  T* qs = reinterpret_cast<T*>(smem_raw + WG_BAR_BYTES);  // [BQ][QS] row-major
  T* ring = qs + BQ * QS;  // STAGES x (K, then V), core-matrix tiles of 2*DK and DVN chunks per row

  const int row = blockIdx.y;
  const int b = MERGED ? row / heads : row, h = MERGED ? row - b * heads : 0;
  const int ldq = MERGED ? heads * d : d, ldv = MERGED ? heads * dv : dv;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;

  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full + 8 * st, NT);       // every thread's copies of the slot's tile
      mbar_init(empty + 8 * st, NT / 32);  // every warp done with the slot
    }
    mbar_init_fence();
  }
  // the padding columns, as in the mma.sync kernel; no copy ever writes them
  zero_chunks<NT>(qs, QS, BQ, d / 8, 2 * DK, tid);
#pragma unroll
  for (int st = 0; st < STAGES; ++st) {
    zero_core<NT>(ring + st * Cfg::STAGE, 2 * DK, d / 8, 2 * DK, tid);
    zero_core<NT>(ring + st * Cfg::STAGE + Cfg::KTILE, DVN, dv / 8, DVN, tid);
  }
  __syncthreads();  // the barriers exist before anyone arrives on them

  const ChunkWalk wq = chunk_walk<NT>(tid, d / 8);
  // the core-matrix tiles' walks: over (8-row group, chunk), for row tid % 8 of each group
  const ChunkWalk ck = chunk_walk<NT / 8>(tid / 8, d / 8);
  const ChunkWalk cv = chunk_walk<NT / 8>(tid / 8, dv / 8);
  const T* ksrc = k + (size_t)b * skv * ldq + h * d;
  const T* vsrc = v + (size_t)b * skv * ldv + h * dv;
  const int ntiles = (skv + MMA_BK - 1) / MMA_BK;
  const uint32_t ring_addr = smem_u32(ring);

  // start this thread's copies of KV tile `tile` into slot tile % STAGES and
  // let them arrive on the slot's `full` barrier as they land; rows past the
  // ragged tail become zeros
  auto fill = [&](int tile) {
    const int k0 = tile * MMA_BK, kn = min(MMA_BK, skv - k0), slot = tile % STAGES;
    const uint32_t ks = ring_addr + slot * Cfg::STAGE * 2;
    stage_core(ks, 2 * DK, ksrc + (size_t)k0 * ldq, ldq, kn, ck, tid % 8);
    stage_core(ks + Cfg::KTILE * 2, DVN, vsrc + (size_t)k0 * ldv, ldv, kn, cv, tid % 8);
    mbar_arrive_cp_async(full + 8 * slot);
  };

  // Q in a commit group of its own: the wait below is for it alone
  stage_chunks<T, !BF16_P, BF16_P>(qs, QS, q + ((size_t)b * sq + q0) * ldq + h * d, ldq, min(BQ, sq - q0),
                                   BQ, wq, scale);
  cp_async_commit();
#pragma unroll
  for (int tile = 0; tile < AHEAD; ++tile)
    if (tile < ntiles) fill(tile);
  cp_async_wait<0>();
  __syncthreads();  // Q has landed

  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
  uint32_t qa[DK][4];
#pragma unroll
  for (int kk = 0; kk < DK; ++kk)
    ldmatrix_x4(qa[kk], smem_u32(qs + (warp * 16 + a_row) * QS + kk * 16 + a_col));

  float oacc[DVN][4];
#pragma unroll
  for (int n = 0; n < DVN; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  float(&of)[DVN * 4] = reinterpret_cast<float(&)[DVN * 4]>(oacc);
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;  // rows g and g + 8
  const float s_scale = BF16_P ? LOG2E : scale * LOG2E;  // K1b's q is pre-scaled

  // one KV tile; RAGGED (the last tile only) also masks the keys past skv
  auto step = [&](int tile, auto ragged) {
    const int slot = tile % STAGES;
    mbar_wait(full + 8 * slot, (tile / STAGES) & 1);
    fence_async_shared();  // the copies' writes, before the tensor cores read them
    // tile + AHEAD goes into the slot of tile + AHEAD - STAGES, once every
    // warp is done with that one: completion number (tile + AHEAD) / STAGES - 1
    // of the slot's `empty` barrier. After the fence, which would otherwise
    // wait for these copies too.
    const int ahead = tile + AHEAD;
    if (ahead < ntiles) {
      if (ahead >= STAGES) mbar_wait(empty + 8 * (ahead % STAGES), (ahead / STAGES - 1) & 1);
      fill(ahead);
    }
    const uint32_t ks_addr = ring_addr + slot * Cfg::STAGE * 2;
    const uint32_t vs_addr = ks_addr + Cfg::KTILE * 2;

    // S[64 x 64] = Q K^T: the warpgroup's Q fragments against the K tile read
    // as B[n = key][k = d], one asynchronous product per 16 columns of d
    float s[8][4];
    float(&sf)[32] = reinterpret_cast<float(&)[32]>(s);
    const uint64_t kdesc = wgmma_desc(ks_addr, 128, 2 * DK * 128);
    wgmma_fence();
    wgmma_m64n64k16_first<0>(sf, qa[0], kdesc);
#pragma unroll
    for (int kk = 1; kk < DK; ++kk) wgmma_m64n64k16<0>(sf, qa[kk], kdesc + kk * (256 >> 4));
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_hold(sf);

    float a0, a1;
    softmax_tile<decltype(ragged)::value>(s, m0, m1, l0, l1, a0, a1, tile * MMA_BK, skv, s_scale, t);
#pragma unroll
    for (int n = 0; n < DVN; ++n) {
      oacc[n][0] *= a0;
      oacc[n][1] *= a0;
      oacc[n][2] *= a1;
      oacc[n][3] *= a1;
    }

    // O[64 x dv] += P V: P (hi, then lo) from registers against the V tile
    // read as B[k = key][n = value column], one product per 16 keys. Every A
    // fragment is made before the fence: no register of an asynchronous
    // product changes while it is in flight.
    uint32_t hi[MMA_BK / 16][4], lo[MMA_BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < MMA_BK / 16; ++kk) {
      if constexpr (BF16_P) {
        round_a(hi[kk], s[2 * kk], s[2 * kk + 1]);
      } else {
        split_a_trunc(hi[kk], lo[kk], s[2 * kk], s[2 * kk + 1]);
      }
    }
    const uint64_t vdesc = wgmma_desc(vs_addr, DVN * 128, 128);
    wgmma_hold(of);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < MMA_BK / 16; ++kk) {
      const uint64_t vd = vdesc + kk * (2 * DVN * 128 >> 4);
      if constexpr (DVN == 5) {
        wgmma_m64n40k16<1>(of, hi[kk], vd);
        if constexpr (!BF16_P) wgmma_m64n40k16<1>(of, lo[kk], vd);
      } else {
        wgmma_m64n80k16<1>(of, hi[kk], vd);
        if constexpr (!BF16_P) wgmma_m64n80k16<1>(of, lo[kk], vd);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_hold(of);
    if (lane == 0) mbar_arrive(empty + 8 * slot);  // this warp is done with the slot
  };
  for (int tile = 0; tile + 1 < ntiles; ++tile) step(tile, std::false_type{});
  step(ntiles - 1, std::true_type{});

  store_rows<T, DVN, true>(oacc, m0, m1, l0, l1, BF16_P ? 1.f : scale, o + (size_t)b * sq * ldv + h * dv, ldv, dv,
                           lse == nullptr ? nullptr : lse + (size_t)row * sq, q0 + warp * 16 + g, sq, t);
}

// What a call's dispatch chose; the fz_*_plan entry points report it.
enum Path { PATH_FMA = 0, PATH_MMA_SYNC = 1, PATH_WGMMA = 2 };
enum Loader { LOADER_ELEMENT = 0, LOADER_STAGED = 1, LOADER_ASYNC = 2 };
struct Plan {
  int path, loader, block_q, block_kv, stages, smem_bytes;
};

inline void export_plan(const Plan& p, int* out) {  // the six ints of an fz_*_plan entry point
  const int v[6] = {p.path, p.loader, p.block_q, p.block_kv, p.stages, p.smem_bytes};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
}

// One forward call. With `plan` set, the dispatch fills it and launches nothing.
struct FwdArgs {
  const void *q, *k, *v;
  void* o;
  float* lse;
  int rows, heads, sq, skv, d, dv;
  float scale;
  cudaStream_t stream;
  Plan* plan;
};

// The 16-byte loaders read and write whole chunks of 8 elements: every operand
// must start on a 16-byte boundary and every row (d and dv wide) must hold
// whole chunks; in the merged layout a row is heads * d wide and a head's
// slice starts h * d elements in, multiples of 8 like d itself.
inline bool chunked(const FwdArgs& a) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
                         reinterpret_cast<uintptr_t>(a.v) | reinterpret_cast<uintptr_t>(a.o);
  return bits % 16 == 0 && a.d % 8 == 0 && a.dv % 8 == 0;
}

// launch a tensor-core kernel of geometry Cfg over (query tiles, rows * heads)
template <typename Cfg, typename T, typename Kernel>
cudaError_t launch_tiles(Kernel kernel, const FwdArgs& a) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.sq + Cfg::BQ - 1) / Cfg::BQ, a.rows * a.heads);
  kernel<<<grid, Cfg::THREADS, Cfg::SMEM, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.o), a.lse, a.sq, a.skv, a.d, a.dv, a.heads, a.scale);
  return cudaGetLastError();
}

template <typename T, int DK, int DVN, bool BF16_P, bool MERGED, bool VEC>
cudaError_t launch_mma(const FwdArgs& a) {
  using Cfg = MmaCfg<DK, DVN>;
  if (a.plan != nullptr) {
    *a.plan = {PATH_MMA_SYNC, !VEC ? LOADER_ELEMENT : sizeof(T) == 2 ? LOADER_ASYNC : LOADER_STAGED,
               Cfg::BQ, MMA_BK, Cfg::STAGES, Cfg::SMEM};
    return cudaSuccess;
  }
  return launch_tiles<Cfg, T>(flash_fwd_mma_kernel<T, DK, DVN, BF16_P, MERGED, VEC>, a);
}

template <int DK, int DVN, bool BF16_P, bool MERGED>
cudaError_t launch_wgmma(const FwdArgs& a) {
  using Cfg = WgCfg<DK, DVN>;
  if (a.plan != nullptr) {
    *a.plan = {PATH_WGMMA, LOADER_ASYNC, Cfg::BQ, MMA_BK, Cfg::STAGES, Cfg::SMEM};
    return cudaSuccess;
  }
  return launch_tiles<Cfg, __nv_bfloat16>(flash_fwd_wgmma_kernel<DK, DVN, BF16_P, MERGED>, a);
}

template <typename T, int DK, int DVN, bool BF16_P, bool MERGED>
cudaError_t dispatch_mma_loader(const FwdArgs& a) {
  // a rule, not a fallback: operands that do not start on 16-byte boundaries,
  // or whose rows do not hold whole chunks, take the element loader
  if (!chunked(a)) return launch_mma<T, DK, DVN, BF16_P, MERGED, false>(a);
  // bf16 at the small head dims: the products by wgmma
  if constexpr (sizeof(T) == 2 && MmaCfg<DK, DVN>::SMALL) {
    return launch_wgmma<DK, DVN, BF16_P, MERGED>(a);
  } else {
    return launch_mma<T, DK, DVN, BF16_P, MERGED, true>(a);
  }
}

template <typename T, int DK, bool BF16_P, bool MERGED>
cudaError_t dispatch_mma_dv(const FwdArgs& a) {
  if (a.dv <= 40) return dispatch_mma_loader<T, DK, 5, BF16_P, MERGED>(a);
  if (a.dv <= 80) return dispatch_mma_loader<T, DK, 10, BF16_P, MERGED>(a);
  return dispatch_mma_loader<T, DK, 20, BF16_P, MERGED>(a);
}

// tensor-core kernel for d <= 160 and dv <= 160
template <typename T, bool BF16_P, bool MERGED>
cudaError_t dispatch_mma(const FwdArgs& a) {
  if (a.d <= 48) return dispatch_mma_dv<T, 3, BF16_P, MERGED>(a);
  if (a.d <= 80) return dispatch_mma_dv<T, 5, BF16_P, MERGED>(a);
  return dispatch_mma_dv<T, 10, BF16_P, MERGED>(a);
}

// fp32 CUDA-core kernel for dv <= 320
template <typename T, bool MERGED>
cudaError_t dispatch_fma(const FwdArgs& a) {
  if (a.plan != nullptr) {
    *a.plan = {PATH_FMA, LOADER_ELEMENT, BQ, BK, 1,
               (int)((BQ * (a.d + 1) + BK * (a.d + 1) + BK * a.dv + BQ * BK) * sizeof(float))};
    return cudaSuccess;
  }
  return dispatch_fma<T, MERGED>(a.q, a.k, a.v, a.o, a.lse, a.rows, a.heads, a.sq, a.skv, a.d,
                                 a.dv, a.scale, a.stream);
}

}  // namespace fwd
}  // namespace fz
