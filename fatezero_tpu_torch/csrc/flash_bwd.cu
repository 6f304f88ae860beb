// K2 and K3: the flash-attention backward, for Hopper (sm_90a).
//
// Replace the Pallas TPU kernels fatezero_tpu/ops/flash_attention.py::_dq_kernel
// (K2, launched by _bwd_call) and ::_dkv_kernel (K3). Both recompute the
// probabilities from the forward's fp32 log-sum-exp instead of reading them:
//
//   P  = exp(scale * Q K^T - lse)            delta = rowsum(dO o O)   (fp32)
//   dS = P o (dO V^T - delta)
//   K2: dQ = scale * dS K                    (a block owns queries, streams K and V)
//   K3: dV = P^T dO,  dK = scale * dS^T Q    (a block owns keys, streams Q and dO)
//
// delta is computed inside each kernel from dO and O, as the TPU kernels do.
// Layout: q, o, dO [rows, Sq, d]; k, v [rows, Skv, d]; lse [rows, Sq] fp32;
// contiguous; dq/dk/dv have the input dtype. d <= 160 and dv = d (the wide-V
// forward of the value-space edit is inference-only, as on the TPU). The
// ragged KV and query tails are zero-filled in shared memory.
//
// What bounds it on the H100: at the 64x64-latent self site (Sq 4096, Skv
// 8192, d 40) K2 does 6 and K3 8 FLOPs per (query, key, d) against ~8 bytes
// per (token, d) read, so both are compute-bound: the products run on the
// tensor cores, and between them each score takes an exponential, the dS
// arithmetic and two hi/lo splits. Measured there (H100 SXM, 700 W): the
// exponentials cost nothing visible, the lo terms' products ~14 % of K3 and
// ~18 % of K2, and at d 40 registers bind (128 a thread for 16 warps an SM,
// with a few spills), so the kernels issue products and wait on them more
// than they compute around them. Two paths, as K1:
//
// * bf16: mma.sync m16n8k16 with fp32 accumulation, keeping the TPU kernels'
//   fp32 arithmetic: bf16 x bf16 products are exact in fp32, and the fp32 P and
//   dS that feed the second products are split into two bf16 terms (hi by
//   truncation, then lo; ~16 mantissa bits together, for either sign), as K1
//   does for P. The design is the backward's counterpart of the forward's
//   mma.sync kernel (flash_fwd.cuh), whose loaders it shares: each warp owns
//   16 rows of the block (K2: queries, K3: keys) and holds their A fragments
//   in registers (K2 at d <= 80, K3 at d <= 40; else each tile re-reads them
//   from shared memory); the streamed tiles go through a ring of 16-byte
//   cp.async copies, one block barrier per tile;
//   every fragment comes from ldmatrix, and the second products read the same
//   row-major tiles through ldmatrix.trans (K3: Q and dO, K2: K), so no
//   transposed copy exists. exp(x) is 2^x in one instruction, with the scale
//   and log2 e folded into one multiply-add. K3's ring slots hold Q, dO and O:
//   while a tile is in use the next one has landed, and delta of its queries
//   is computed from its dO and O tiles by 16-byte shared loads, so it is in
//   shared memory by the barrier that hands that tile over; K2 computes delta
//   once, from device memory. Rows
//   past a ragged query tail get lse = delta = 0 beside their zero Q and dO
//   rows, so their P^T dO and dS^T Q terms are 0 without a mask; the keys past
//   K2's ragged KV tail are masked in the last tile's step only.
//   Operands that are misaligned, or a d that is no multiple of 8, take an
//   element loader into the same tiles (an alignment test decides).
// * fp32: CUDA-core FMAs, 8 threads per query (K2) or key (K3) row, the tiles
//   staged in shared memory as fp32 with a d+1 row stride (distinct banks).
//
// fz_flash_bwd_plan reports which kernel a call takes (ops/flash_attention.py::
// bwd_kernel_plan mirrors it).
#include "flash_fwd.cuh"

namespace {

using fz::mma_bf16;
using fz::fwd::ChunkWalk;
using fz::fwd::LOG2E;
using fz::fwd::MMA_PAD;

// ================================================================ bf16, tensor cores

constexpr int BWD_SMALL_DK = 5;      // d <= 80: K2 holds its A fragments in registers, a ring of 3 slots
constexpr int BWD_NARROW_DK = 3;     // d <= 40: at most 128 registers a thread, 16 warps an SM
constexpr int BWD_STAGES_SMALL = 3;  // K2's ring
constexpr int BWD_STAGES_LARGE = 2;  // and at d = 160
constexpr int DKV_STAGES = 3;        // K3's: one tile in use, the next read for delta, one loading
constexpr int DQ_WARPS = 8;          // K2: 16 queries a warp
constexpr int DQ_BK = 64;            // K2: keys per streamed tile
constexpr int DKV_WARPS_NARROW = 8;  // K3 at d <= 40: 16 keys a warp
constexpr int DKV_WARPS = 4;         // and above, where 8 warps would fit one block an SM
constexpr int DKV_BQ_NARROW = 64;    // K3: queries per streamed tile, d <= 40
constexpr int DKV_BQ_SMALL = 32;     // d <= 80 (two blocks an SM in shared memory)
constexpr int DKV_BQ_LARGE = 16;     // d = 160 (two 16 x d accumulators a warp, and the same)

// blocks an SM that __launch_bounds__ asks for, so that a thread keeps at
// most `regs` registers: 128 at d <= 40 (more warps hide more of each one's
// chain of waits: 1.2x at the 64^2 self site against 168 registers and 12
// warps)
constexpr int bwd_min_blocks(int threads, int regs) {
  return 65536 / (threads * regs) > 1 ? 65536 / (threads * regs) : 1;
}

// K2's geometry for DK 16-wide k-steps of d: Q and dO [BQ][QS], then the ring
// of K and V [BK][QS] slots, then delta [BQ] fp32. Row strides are odd
// multiples of 16 bytes (flash_fwd.cuh's MmaCfg).
template <int DK>
struct DqCfg {
  static constexpr bool SMALL = DK <= BWD_SMALL_DK;
  static constexpr int THREADS = DQ_WARPS * 32;
  static constexpr int BQ = DQ_WARPS * 16;
  static constexpr int BK = DQ_BK;
  static constexpr int STAGES = SMALL ? BWD_STAGES_SMALL : BWD_STAGES_LARGE;
  static constexpr bool HOLD = SMALL;  // Q's and dO's A fragments in registers
  static constexpr int MIN_BLOCKS = bwd_min_blocks(THREADS, DK <= BWD_NARROW_DK ? 128 : 255);
  static constexpr int QS = DK * 16 + MMA_PAD;
  static constexpr int STAGE = 2 * BK * QS;                        // elements of one ring slot
  static constexpr int SMEM = (2 * BQ * QS + STAGES * STAGE) * 2 + BQ * 4;
  static_assert(SMEM <= fz::fwd::SMEM_LIMIT, "K2's tiles do not fit one block");
};

// K3's: K and V [BK][QS], then the ring, each slot Q, dO and O [BQ][QS] and
// -lse * log2 e and delta [BQ] fp32.
template <int DK>
struct DkvCfg {
  static constexpr bool SMALL = DK <= BWD_SMALL_DK;
  static constexpr int WARPS = DK <= BWD_NARROW_DK ? DKV_WARPS_NARROW : DKV_WARPS;
  static constexpr int THREADS = WARPS * 32;
  static constexpr int BK = WARPS * 16;
  static constexpr int BQ = DK <= BWD_NARROW_DK ? DKV_BQ_NARROW : SMALL ? DKV_BQ_SMALL : DKV_BQ_LARGE;
  static constexpr int STAGES = DKV_STAGES;
  // K's and V's A fragments in registers at d <= 40 only: at d 80 re-reading
  // them lets three blocks share an SM (0.57 -> 0.50 ms at the 32^2 self site)
  static constexpr bool HOLD = DK <= BWD_NARROW_DK;
  static constexpr int MIN_BLOCKS = bwd_min_blocks(THREADS, DK <= BWD_NARROW_DK ? 128 : SMALL ? 168 : 255);
  static constexpr int QS = DK * 16 + MMA_PAD;
  static constexpr int STAGE = 3 * BQ * QS + 4 * BQ;               // elements (bf16 units)
  static constexpr int SMEM = (2 * BK * QS + STAGES * STAGE) * 2;
  static_assert(SMEM <= fz::fwd::SMEM_LIMIT, "K3's tiles do not fit one block");
};

using B = __nv_bfloat16;

// rows of `w.cpr` chunks (VEC) or `width` elements into a row-major bf16 tile;
// rows from `valid` to `total` become zeros
template <int NT, bool VEC>
__device__ __forceinline__ void stage(B* dst, int ss, const B* src, int ld, int valid, int total, int width,
                                      const ChunkWalk& w, int tid) {
  if constexpr (VEC) {
    fz::fwd::stage_chunks<B, true, false>(dst, ss, src, ld, valid, total, w, 1.f);
  } else {
    fz::fwd::stage_elems<B, NT, false>(dst, ss, src, ld, valid, total, width, 1.f, tid);
  }
}

// delta = sum_c dO[r, c] * O[r, c] in fp32 of row r = tid / (NT / ROWS) of
// the `n` rows at o / dout (NT / ROWS neighbouring threads a row, 16-byte
// loads where VEC); rows >= n give 0. Every thread returns its row's sum.
template <int NT, int ROWS, bool VEC>
__device__ __forceinline__ float row_delta(const B* o, const B* dout, int n, int d, int tid) {
  constexpr int TPR = NT / ROWS;
  static_assert(TPR >= 1 && TPR <= 32 && (TPR & (TPR - 1)) == 0, "threads per row: a power of two");
  const int r = tid / TPR, part = tid % TPR;
  float acc = 0.f;
  if (r < n) {
    const B* orow = o + (size_t)r * d;
    const B* drow = dout + (size_t)r * d;
    if constexpr (VEC) {
      for (int c = part; c < d / 8; c += TPR) {
        float x[8], y[8];
        fz::fwd::load8(x, orow + c * 8);
        fz::fwd::load8(y, drow + c * 8);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc = fmaf(y[i], x[i], acc);
      }
    } else {
      for (int c = part; c < d; c += TPR) acc = fmaf(__bfloat162float(drow[c]), __bfloat162float(orow[c]), acc);
    }
  }
#pragma unroll
  for (int off = 1; off < TPR; off <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  return acc;
}

// The same from a bf16 shared tile of dO rows and one of O rows (`ss` elements
// apart), whose columns past d are zeros: 16-byte loads whatever the loader
template <int NT, int ROWS>
__device__ __forceinline__ float tile_delta(const B* dos, const B* os, int ss, int d, int tid) {
  constexpr int TPR = NT / ROWS;
  static_assert(TPR >= 1 && TPR <= 32 && (TPR & (TPR - 1)) == 0, "threads per row: a power of two");
  const int r = tid / TPR, part = tid % TPR;
  float acc = 0.f;
  for (int c = part; c < (d + 7) / 8; c += TPR) {
    const uint4 a = *reinterpret_cast<const uint4*>(dos + r * ss + c * 8);
    const uint4 b = *reinterpret_cast<const uint4*>(os + r * ss + c * 8);
    const uint32_t x[4] = {a.x, a.y, a.z, a.w}, y[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc = fmaf(__uint_as_float(x[i] << 16), __uint_as_float(y[i] << 16), acc);
      acc = fmaf(__uint_as_float(x[i] & 0xffff0000u), __uint_as_float(y[i] & 0xffff0000u), acc);
    }
  }
#pragma unroll
  for (int off = 1; off < TPR; off <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  return acc;
}

// Write a warp's accumulators (x mul) to rows r0 and r0 + 8 of a [*, d] tile
// whose valid rows are < n. PAIRED: d is a multiple of 8 and the output
// 16-byte aligned, so bf16 goes out two at a time.
template <int DN, bool PAIRED>
__device__ __forceinline__ void store_rows(const float (&acc)[DN][4], float mul, B* base, int d, int r0, int n,
                                           int t) {
  const int r1 = r0 + 8;
#pragma unroll
  for (int j = 0; j < DN; ++j) {
    const int col = 8 * j + 2 * t;
    if constexpr (PAIRED) {
      if (col < d) {
        if (r0 < n) *reinterpret_cast<uint32_t*>(base + (size_t)r0 * d + col) = fz::pack_bf16(acc[j][0] * mul, acc[j][1] * mul);
        if (r1 < n) *reinterpret_cast<uint32_t*>(base + (size_t)r1 * d + col) = fz::pack_bf16(acc[j][2] * mul, acc[j][3] * mul);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (col + e >= d) continue;
        if (r0 < n) base[(size_t)r0 * d + col + e] = __float2bfloat16(acc[j][e] * mul);
        if (r1 < n) base[(size_t)r1 * d + col + e] = __float2bfloat16(acc[j][2 + e] * mul);
      }
    }
  }
}

// acc[n-tiles 2np, 2np + 1] += hi B + lo B with B the 16 x 16 block (rows
// 16kk.., columns 16np..) of a row-major tile, transposed by the load; an odd
// last n-tile takes two matrices. `lane_addr`: the tile's address plus this
// lane's ldmatrix offset, `lane_addr2` the same for the odd tile.
template <int DN, int LD>
__device__ __forceinline__ void mma_rowmajor_b(float (&acc)[DN][4], const uint32_t (&hi)[4], const uint32_t (&lo)[4],
                                               uint32_t lane_addr, uint32_t lane_addr2, int kk) {
#pragma unroll
  for (int np = 0; np < DN / 2; ++np) {
    uint32_t b[4];
    fz::ldmatrix_x4_trans(b, lane_addr + (kk * 16 * LD + np * 16) * 2);
    mma_bf16(acc[2 * np], hi, b[0], b[1]);
    mma_bf16(acc[2 * np + 1], hi, b[2], b[3]);
    mma_bf16(acc[2 * np], lo, b[0], b[1]);
    mma_bf16(acc[2 * np + 1], lo, b[2], b[3]);
  }
  if constexpr (DN % 2 == 1) {
    uint32_t b[2];
    fz::ldmatrix_x2_trans(b, lane_addr2 + (kk * 16 * LD + (DN - 1) * 8) * 2);
    mma_bf16(acc[DN - 1], hi, b[0], b[1]);
    mma_bf16(acc[DN - 1], lo, b[0], b[1]);
  }
}

// lane's row and column inside the 16x16 block one ldmatrix.x4 reads (as flash_fwd.cuh):
//   A, and B stored [k][n] (transposed by the load): matrices (rows 0-7, 8-15) x (cols 0-7, 8-15), rows first
//   B stored [n][k]: matrices (n 0-7: k 0-7, 8-15), (n 8-15: k 0-7, 8-15)
struct Lanes {
  int a_row, a_col, b_row, b_col;
  __device__ explicit Lanes(int lane)
      : a_row((lane & 7) + ((lane >> 3) & 1) * 8), a_col((lane >> 4) * 8),
        b_row((lane & 7) + (lane >> 4) * 8), b_col(((lane >> 3) & 1) * 8) {}
};

// K2. DK: 16-wide k-steps of d (d <= 16 DK); DN: 8-wide n-tiles of dQ (d <= 8 DN);
// VEC: the 16-byte loader (operands 16-byte aligned, d a multiple of 8).
template <int DK, int DN, bool VEC>
__global__ void __launch_bounds__(DqCfg<DK>::THREADS, DqCfg<DK>::MIN_BLOCKS)
flash_dq_mma_kernel(const B* __restrict__ q, const B* __restrict__ k, const B* __restrict__ v,
                    const B* __restrict__ o, const B* __restrict__ dout, const float* __restrict__ lse,
                    B* __restrict__ dq, int sq, int skv, int d, float scale) {
  using Cfg = DqCfg<DK>;
  constexpr int NT = Cfg::THREADS, BQ = Cfg::BQ, BK = Cfg::BK, STAGES = Cfg::STAGES, QS = Cfg::QS;
  constexpr bool HOLD = Cfg::HOLD;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  B* qs = reinterpret_cast<B*>(smem_raw);  // [BQ][QS]
  B* dos = qs + BQ * QS;                   // [BQ][QS]
  B* ring = dos + BQ * QS;                 // STAGES x (K [BK][QS], then V [BK][QS])
  float* delta_s = reinterpret_cast<float*>(ring + STAGES * Cfg::STAGE);  // [BQ]

  const int row = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;

  // columns d .. 16 DK - 1 enter the first products and are never loaded:
  // zeroed once (whole chunks; the element loader's barrier below)
  fz::fwd::zero_chunks<NT>(qs, QS, 2 * BQ, d / 8, 2 * DK, tid);
#pragma unroll
  for (int st = 0; st < STAGES; ++st) fz::fwd::zero_chunks<NT>(ring + st * Cfg::STAGE, QS, 2 * BK, d / 8, 2 * DK, tid);
  if constexpr (!VEC) __syncthreads();

  const ChunkWalk w = fz::fwd::chunk_walk<NT>(tid, VEC ? d / 8 : 1);
  const B* kbase = k + (size_t)row * skv * d;
  const B* vbase = v + (size_t)row * skv * d;
  const int ntiles = (skv + BK - 1) / BK;

  // start the loads of KV tile `tile` into slot tile % STAGES; one commit
  // group per call, empty past the last tile
  auto load_tile = [&](int tile) {
    if (tile < ntiles) {
      const int k0 = tile * BK, kn = min(BK, skv - k0);
      B* ks = ring + (tile % STAGES) * Cfg::STAGE;
      stage<NT, VEC>(ks, QS, kbase + (size_t)k0 * d, d, kn, BK, d, w, tid);
      stage<NT, VEC>(ks + BK * QS, QS, vbase + (size_t)k0 * d, d, kn, BK, d, w, tid);
    }
    if constexpr (VEC) fz::cp_async_commit();
  };

  const size_t qoff = ((size_t)row * sq + q0) * d;
  const int qn = min(BQ, sq - q0);
  stage<NT, VEC>(qs, QS, q + qoff, d, qn, BQ, d, w, tid);
  stage<NT, VEC>(dos, QS, dout + qoff, d, qn, BQ, d, w, tid);
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) load_tile(st);  // Q and dO travel in tile 0's group
  {
    const float dl = row_delta<NT, BQ, VEC>(o + qoff, dout + qoff, qn, d, tid);
    if (tid % (NT / BQ) == 0) delta_s[tid / (NT / BQ)] = dl;
  }
  if constexpr (VEC) fz::cp_async_wait<STAGES - 2>();
  __syncthreads();  // Q, dO, delta and tile 0 are in

  const Lanes ln(lane);
  const uint32_t ring_addr = fz::smem_u32(ring);
  const uint32_t b_lane = (ln.b_row * QS + ln.b_col) * 2;   // K and V as B [n = key][k = d]
  const uint32_t t_lane = (ln.a_row * QS + ln.a_col) * 2;   // K as B [k = key][n = d]
  const uint32_t t_lane2 = ln.a_row * QS * 2;
  const uint32_t qa_addr = fz::smem_u32(qs + (warp * 16 + ln.a_row) * QS + ln.a_col);
  const uint32_t da_addr = qa_addr + BQ * QS * 2;
  uint32_t qa[HOLD ? DK : 1][4], da[HOLD ? DK : 1][4];
  if constexpr (HOLD) {
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      fz::ldmatrix_x4(qa[kk], qa_addr + kk * 32);
      fz::ldmatrix_x4(da[kk], da_addr + kk * 32);
    }
  }

  const int r0 = warp * 16 + g, r1 = r0 + 8;  // this thread's query rows in the block
  const float* lrow = lse + (size_t)row * sq + q0;
  const float nl0 = r0 < qn ? -lrow[r0] * LOG2E : 0.f, nl1 = r1 < qn ? -lrow[r1] * LOG2E : 0.f;
  const float dl0 = delta_s[r0], dl1 = delta_s[r1];
  const float sl2 = scale * LOG2E;

  float acc[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  // one KV tile; RAGGED (the last tile only) also masks the keys past skv
  auto step = [&](int tile, auto ragged) {
    load_tile(tile + STAGES - 1);  // its slot's last tile was consumed before the last barrier
    const uint32_t ks_addr = ring_addr + (tile % STAGES) * Cfg::STAGE * 2;
    const uint32_t vs_addr = ks_addr + BK * QS * 2;

    // S = Q K^T and dP = dO V^T, 16 x 64 per warp
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      uint32_t qf[4], df[4];
      if constexpr (HOLD) {
#pragma unroll
        for (int i = 0; i < 4; ++i) qf[i] = qa[kk][i], df[i] = da[kk][i];
      } else {
        fz::ldmatrix_x4(qf, qa_addr + kk * 32);
        fz::ldmatrix_x4(df, da_addr + kk * 32);
      }
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {  // keys 16 jp .. 16 jp + 15: n-tiles 2 jp and 2 jp + 1
        uint32_t b[4];
        fz::ldmatrix_x4(b, ks_addr + b_lane + (jp * 16 * QS + kk * 16) * 2);
        mma_bf16(s[2 * jp], qf, b[0], b[1]);
        mma_bf16(s[2 * jp + 1], qf, b[2], b[3]);
        fz::ldmatrix_x4(b, vs_addr + b_lane + (jp * 16 * QS + kk * 16) * 2);
        mma_bf16(dp[2 * jp], df, b[0], b[1]);
        mma_bf16(dp[2 * jp + 1], df, b[2], b[3]);
      }
    }

    // dS = P o (dP - delta), in place of s
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = fz::fast_exp2(fmaf(s[j][e], sl2, e < 2 ? nl0 : nl1));
        if constexpr (decltype(ragged)::value) {
          if (tile * BK + 8 * j + 2 * t + (e & 1) >= skv) p = 0.f;
        }
        s[j][e] = p * (dp[j][e] - (e < 2 ? dl0 : dl1));
      }
    }

    // dQ += dS K, dS split into hi + lo bf16 terms, K read [k = key][n = d]
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t hi[4], lo[4];
      fz::split_a_trunc(hi, lo, s[2 * kk], s[2 * kk + 1]);
      mma_rowmajor_b<DN, QS>(acc, hi, lo, ks_addr + t_lane, ks_addr + t_lane2, kk);
    }

    // tile + 1 has landed (this thread's copies, then everyone's), and every
    // warp is done with this tile: the one barrier of the tile
    if constexpr (VEC) fz::cp_async_wait<STAGES - 2>();
    __syncthreads();
  };
  for (int tile = 0; tile + 1 < ntiles; ++tile) step(tile, std::false_type{});
  step(ntiles - 1, std::true_type{});

  store_rows<DN, VEC>(acc, scale, dq + qoff, d, r0, qn, t);
}

// K3. DK, DN, VEC as in K2.
template <int DK, int DN, bool VEC>
__global__ void __launch_bounds__(DkvCfg<DK>::THREADS, DkvCfg<DK>::MIN_BLOCKS)
flash_dkv_mma_kernel(const B* __restrict__ q, const B* __restrict__ k, const B* __restrict__ v,
                     const B* __restrict__ o, const B* __restrict__ dout, const float* __restrict__ lse,
                     B* __restrict__ dk, B* __restrict__ dv, int sq, int skv, int d, float scale) {
  using Cfg = DkvCfg<DK>;
  constexpr int NT = Cfg::THREADS, BQ = Cfg::BQ, BK = Cfg::BK, STAGES = Cfg::STAGES, QS = Cfg::QS;
  constexpr int NJ = BQ / 8;  // 8-wide query n-tiles of S^T
  constexpr bool HOLD = Cfg::HOLD;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  B* ks = reinterpret_cast<B*>(smem_raw);  // [BK][QS]
  B* vs = ks + BK * QS;                    // [BK][QS]
  B* ring = vs + BK * QS;  // STAGES x (Q, dO, O [BQ][QS], -lse log2 e [BQ] and delta [BQ] fp32)

  const int row = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;

  fz::fwd::zero_chunks<NT>(ks, QS, 2 * BK, d / 8, 2 * DK, tid);
#pragma unroll
  for (int st = 0; st < STAGES; ++st) fz::fwd::zero_chunks<NT>(ring + st * Cfg::STAGE, QS, 3 * BQ, d / 8, 2 * DK, tid);
  if constexpr (!VEC) __syncthreads();

  const ChunkWalk w = fz::fwd::chunk_walk<NT>(tid, VEC ? d / 8 : 1);
  const int kn = min(BK, skv - k0);
  const size_t koff = ((size_t)row * skv + k0) * d;
  stage<NT, VEC>(ks, QS, k + koff, d, kn, BK, d, w, tid);
  stage<NT, VEC>(vs, QS, v + koff, d, kn, BK, d, w, tid);

  const size_t rbase = (size_t)row * sq * d;
  const int ntiles = (sq + BQ - 1) / BQ;

  auto load_tile = [&](int tile) {
    if (tile < ntiles) {
      const int q0 = tile * BQ, qn = min(BQ, sq - q0);
      B* qs = ring + (tile % STAGES) * Cfg::STAGE;
      stage<NT, VEC>(qs, QS, q + rbase + (size_t)q0 * d, d, qn, BQ, d, w, tid);
      stage<NT, VEC>(qs + BQ * QS, QS, dout + rbase + (size_t)q0 * d, d, qn, BQ, d, w, tid);
      stage<NT, VEC>(qs + 2 * BQ * QS, QS, o + rbase + (size_t)q0 * d, d, qn, BQ, d, w, tid);
    }
    if constexpr (VEC) fz::cp_async_commit();
  };
  // -lse * log2 e and delta of tile `tile`'s queries into its slot, delta
  // from the landed dO and O tiles; rows past sq get 0 for both (their dO and
  // O rows are zeros)
  auto load_stats = [&](int tile) {
    if (tile >= ntiles) return;
    const int q0 = tile * BQ, qn = min(BQ, sq - q0);
    const B* dos = ring + (tile % STAGES) * Cfg::STAGE + BQ * QS;
    const float dl = tile_delta<NT, BQ>(dos, dos + BQ * QS, QS, d, tid);
    if (tid % (NT / BQ) == 0) {
      const int r = tid / (NT / BQ);
      float* st = reinterpret_cast<float*>(ring + (tile % STAGES) * Cfg::STAGE + 3 * BQ * QS);
      st[r] = r < qn ? -lse[(size_t)row * sq + q0 + r] * LOG2E : 0.f;
      st[BQ + r] = dl;
    }
  };

  // Tiles 0 and 1, then tile 0's statistics. In the loop, step `tile` starts
  // the loads of tile + 2 and computes the statistics of tile + 1 (landed
  // before the last barrier) beside the products of tile; its one barrier
  // then waits for tile + 2.
  static_assert(STAGES == 3, "K3's ring: the tile in use, the next one, one loading");
  load_tile(0);  // K and V travel in tile 0's group
  load_tile(1);
  if constexpr (VEC) fz::cp_async_wait<0>();
  __syncthreads();
  load_stats(0);
  __syncthreads();  // K, V, tiles 0 and 1 and tile 0's statistics are in

  const Lanes ln(lane);
  const uint32_t ring_addr = fz::smem_u32(ring);
  const uint32_t b_lane = (ln.b_row * QS + ln.b_col) * 2;  // Q and dO as B [n = query][k = d]
  const uint32_t t_lane = (ln.a_row * QS + ln.a_col) * 2;  // Q and dO as B [k = query][n = d]
  const uint32_t t_lane2 = ln.a_row * QS * 2;
  const uint32_t ka_addr = fz::smem_u32(ks + (warp * 16 + ln.a_row) * QS + ln.a_col);
  const uint32_t va_addr = ka_addr + BK * QS * 2;
  uint32_t ka[HOLD ? DK : 1][4], va[HOLD ? DK : 1][4];
  if constexpr (HOLD) {
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      fz::ldmatrix_x4(ka[kk], ka_addr + kk * 32);
      fz::ldmatrix_x4(va[kk], va_addr + kk * 32);
    }
  }

  float dka[DN][4], dva[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n) {
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
    dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
  }
  const float sl2 = scale * LOG2E;

  for (int tile = 0; tile < ntiles; ++tile) {
    load_tile(tile + 2);   // its slot's last tile was consumed before the last barrier
    load_stats(tile + 1);  // into a slot whose statistics were read before that barrier
    const uint32_t qs_addr = ring_addr + (tile % STAGES) * Cfg::STAGE * 2;
    const uint32_t dos_addr = qs_addr + BQ * QS * 2;
    const float* st = reinterpret_cast<const float*>(ring + (tile % STAGES) * Cfg::STAGE + 3 * BQ * QS);

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x BQ queries per warp
    float s[NJ][4], dp[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      uint32_t kf[4], vf[4];
      if constexpr (HOLD) {
#pragma unroll
        for (int i = 0; i < 4; ++i) kf[i] = ka[kk][i], vf[i] = va[kk][i];
      } else {
        fz::ldmatrix_x4(kf, ka_addr + kk * 32);
        fz::ldmatrix_x4(vf, va_addr + kk * 32);
      }
#pragma unroll
      for (int jp = 0; jp < NJ / 2; ++jp) {  // queries 16 jp .. 16 jp + 15
        uint32_t b[4];
        fz::ldmatrix_x4(b, qs_addr + b_lane + (jp * 16 * QS + kk * 16) * 2);
        mma_bf16(s[2 * jp], kf, b[0], b[1]);
        mma_bf16(s[2 * jp + 1], kf, b[2], b[3]);
        fz::ldmatrix_x4(b, dos_addr + b_lane + (jp * 16 * QS + kk * 16) * 2);
        mma_bf16(dp[2 * jp], vf, b[0], b[1]);
        mma_bf16(dp[2 * jp + 1], vf, b[2], b[3]);
      }
    }

    // P^T in s, dS^T in dp; a thread's columns are the queries 8j + 2t, + 1
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float2 nl = *reinterpret_cast<const float2*>(st + 8 * j + 2 * t);
      const float2 dl = *reinterpret_cast<const float2*>(st + BQ + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = fz::fast_exp2(fmaf(s[j][e], sl2, e & 1 ? nl.y : nl.x));
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - (e & 1 ? dl.y : dl.x));
      }
    }

    // dV += P^T dO and dK += dS^T Q, P and dS split into hi + lo bf16 terms,
    // dO and Q read [k = query][n = d]
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t hi[4], lo[4];
      fz::split_a_trunc(hi, lo, s[2 * kk], s[2 * kk + 1]);
      mma_rowmajor_b<DN, QS>(dva, hi, lo, dos_addr + t_lane, dos_addr + t_lane2, kk);
      fz::split_a_trunc(hi, lo, dp[2 * kk], dp[2 * kk + 1]);
      mma_rowmajor_b<DN, QS>(dka, hi, lo, qs_addr + t_lane, qs_addr + t_lane2, kk);
    }

    // tile + 2 has landed, tile + 1's statistics are in, and every warp is
    // done with this tile: the one barrier of the tile
    if constexpr (VEC) fz::cp_async_wait<0>();
    __syncthreads();
  }

  const int r0 = warp * 16 + g;  // this thread's key rows r0, r0 + 8 in the block
  store_rows<DN, VEC>(dka, scale, dk + koff, d, r0, kn, t);
  store_rows<DN, VEC>(dva, 1.f, dv + koff, d, r0, kn, t);
}

// What a call's dispatch chose (flash_fwd.cuh's Plan; K2's block_q are its own
// queries and block_kv its streamed keys, K3's the other way round).
using fz::fwd::Plan;

struct BwdArgs {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  void *dq, *dk, *dv;
  int rows, sq, skv, d;
  float scale;
  cudaStream_t stream;
  Plan* plan;
};

// The 16-byte loaders and paired stores need every operand on a 16-byte
// boundary and rows of whole 8-element chunks (the plan passes null outputs)
bool chunked(const BwdArgs& a) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
                         reinterpret_cast<uintptr_t>(a.v) | reinterpret_cast<uintptr_t>(a.o) |
                         reinterpret_cast<uintptr_t>(a.dout) | reinterpret_cast<uintptr_t>(a.dq) |
                         reinterpret_cast<uintptr_t>(a.dk) | reinterpret_cast<uintptr_t>(a.dv);
  return bits % 16 == 0 && a.d % 8 == 0;
}

template <int DK, int DN, bool VEC>
cudaError_t launch_dq_mma(const BwdArgs& a) {
  using Cfg = DqCfg<DK>;
  if (a.plan != nullptr) {
    *a.plan = {fz::fwd::PATH_MMA_SYNC, VEC ? fz::fwd::LOADER_ASYNC : fz::fwd::LOADER_ELEMENT, Cfg::BQ, Cfg::BK,
               Cfg::STAGES, Cfg::SMEM};
    return cudaSuccess;
  }
  auto kernel = flash_dq_mma_kernel<DK, DN, VEC>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.sq + Cfg::BQ - 1) / Cfg::BQ, a.rows);
  kernel<<<grid, Cfg::THREADS, Cfg::SMEM, a.stream>>>(
      static_cast<const B*>(a.q), static_cast<const B*>(a.k), static_cast<const B*>(a.v),
      static_cast<const B*>(a.o), static_cast<const B*>(a.dout), a.lse, static_cast<B*>(a.dq), a.sq, a.skv, a.d,
      a.scale);
  return cudaGetLastError();
}

template <int DK, int DN, bool VEC>
cudaError_t launch_dkv_mma(const BwdArgs& a) {
  using Cfg = DkvCfg<DK>;
  if (a.plan != nullptr) {
    *a.plan = {fz::fwd::PATH_MMA_SYNC, VEC ? fz::fwd::LOADER_ASYNC : fz::fwd::LOADER_ELEMENT, Cfg::BQ, Cfg::BK,
               Cfg::STAGES, Cfg::SMEM};
    return cudaSuccess;
  }
  auto kernel = flash_dkv_mma_kernel<DK, DN, VEC>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.skv + Cfg::BK - 1) / Cfg::BK, a.rows);
  kernel<<<grid, Cfg::THREADS, Cfg::SMEM, a.stream>>>(
      static_cast<const B*>(a.q), static_cast<const B*>(a.k), static_cast<const B*>(a.v),
      static_cast<const B*>(a.o), static_cast<const B*>(a.dout), a.lse, static_cast<B*>(a.dk),
      static_cast<B*>(a.dv), a.sq, a.skv, a.d, a.scale);
  return cudaGetLastError();
}

// K2 or K3 on the tensor cores: DK and DN from d, the loader by the alignment rule
template <bool DKV, int DK, int DN>
cudaError_t dispatch_loader(const BwdArgs& a) {
  // a rule, not a fallback: operands off 16-byte boundaries, or rows that do
  // not hold whole chunks, take the element loader
  if constexpr (DKV) {
    return chunked(a) ? launch_dkv_mma<DK, DN, true>(a) : launch_dkv_mma<DK, DN, false>(a);
  } else {
    return chunked(a) ? launch_dq_mma<DK, DN, true>(a) : launch_dq_mma<DK, DN, false>(a);
  }
}

template <bool DKV>
cudaError_t dispatch_mma(const BwdArgs& a) {
  if (a.d <= 40) return dispatch_loader<DKV, 3, 5>(a);
  if (a.d <= 80) return dispatch_loader<DKV, 5, 10>(a);
  return dispatch_loader<DKV, 10, 20>(a);
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

// dtype: 0 fp32, 1 bf16. With a.plan set, the dispatch fills it and launches nothing.
cudaError_t run_dq(const BwdArgs& a, int dtype) {
  if (bad_args(a.rows, a.sq, a.skv, a.d, dtype)) return cudaErrorInvalidValue;
  if (dtype == 1) return dispatch_mma<false>(a);
  if (a.plan != nullptr) {
    *a.plan = {fz::fwd::PATH_FMA, fz::fwd::LOADER_ELEMENT, F_ROWS, F_TILE, 1,
               (int)((2 * F_ROWS * (a.d + 1) + 2 * F_TILE * (a.d + 1) + F_ROWS * F_TILE) * sizeof(float))};
    return cudaSuccess;
  }
  if (a.d <= 40) return launch_dq<5>(a.q, a.k, a.v, a.o, a.dout, a.lse, a.dq, a.rows, a.sq, a.skv, a.d, a.scale, a.stream);
  if (a.d <= 80) return launch_dq<10>(a.q, a.k, a.v, a.o, a.dout, a.lse, a.dq, a.rows, a.sq, a.skv, a.d, a.scale, a.stream);
  return launch_dq<20>(a.q, a.k, a.v, a.o, a.dout, a.lse, a.dq, a.rows, a.sq, a.skv, a.d, a.scale, a.stream);
}

cudaError_t run_dkv(const BwdArgs& a, int dtype) {
  if (bad_args(a.rows, a.sq, a.skv, a.d, dtype)) return cudaErrorInvalidValue;
  if (dtype == 1) return dispatch_mma<true>(a);
  if (a.plan != nullptr) {
    *a.plan = {fz::fwd::PATH_FMA, fz::fwd::LOADER_ELEMENT, F_TILE, F_ROWS, 1,
               (int)((2 * F_ROWS * (a.d + 1) + 2 * F_TILE * (a.d + 1) + 2 * F_ROWS * F_TILE + 2 * F_TILE) *
                     sizeof(float))};
    return cudaSuccess;
  }
  if (a.d <= 40)
    return launch_dkv<5>(a.q, a.k, a.v, a.o, a.dout, a.lse, a.dk, a.dv, a.rows, a.sq, a.skv, a.d, a.scale, a.stream);
  if (a.d <= 80)
    return launch_dkv<10>(a.q, a.k, a.v, a.o, a.dout, a.lse, a.dk, a.dv, a.rows, a.sq, a.skv, a.d, a.scale, a.stream);
  return launch_dkv<20>(a.q, a.k, a.v, a.o, a.dout, a.lse, a.dk, a.dv, a.rows, a.sq, a.skv, a.d, a.scale, a.stream);
}

}  // namespace

// Both return cudaGetLastError() of the launch (0 on success). dtype: 0 fp32, 1 bf16.
extern "C" int fz_flash_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                               const void* dout, const float* lse, void* dq, int rows, int sq,
                               int skv, int d, float scale, int dtype, void* stream) {
  return (int)run_dq({q, k, v, o, dout, lse, dq, nullptr, nullptr, rows, sq, skv, d, scale,
                      static_cast<cudaStream_t>(stream), nullptr}, dtype);
}

extern "C" int fz_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* o,
                                const void* dout, const float* lse, void* dk, void* dv, int rows,
                                int sq, int skv, int d, float scale, int dtype, void* stream) {
  return (int)run_dkv({q, k, v, o, dout, lse, nullptr, dk, dv, rows, sq, skv, d, scale,
                       static_cast<cudaStream_t>(stream), nullptr}, dtype);
}

// What fz_flash_bwd_dq (kernel 0) or fz_flash_bwd_dkv (kernel 1) would launch
// for these operands, without launching it: plan[0..5] = path (0 CUDA cores,
// 1 mma.sync), loader (0 element, 2 cp.async), queries per block (K2) or per
// streamed tile (K3), keys per streamed tile (K2) or per block (K3), ring
// stages, dynamic shared bytes. The outputs, which the wrappers allocate on
// 16-byte boundaries, are taken as aligned. Returns 0, or the error the call
// would return.
extern "C" int fz_flash_bwd_plan(int kernel, const void* q, const void* k, const void* v, const void* o,
                                 const void* dout, int d, int dtype, int* plan) {
  if (kernel != 0 && kernel != 1) return (int)cudaErrorInvalidValue;
  Plan p{};
  const BwdArgs a{q, k, v, o, dout, nullptr, nullptr, nullptr, nullptr, 1, 1, 1, d, 1.f, nullptr, &p};
  const int err = (int)(kernel == 1 ? run_dkv(a, dtype) : run_dq(a, dtype));
  fz::fwd::export_plan(p, plan);
  return err;
}
