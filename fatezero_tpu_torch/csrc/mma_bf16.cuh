// bf16 tensor-core helpers shared by the flash-attention kernels (K1, K1b, K1c, K2, K3).
//
// mma.sync m16n8k16, bf16 in, fp32 accumulate. Fragment layouts (lane = 4g + t):
//   A (16x16, row): a0 = (g, 2t..2t+1), a1 = (g+8, 2t..), a2 = (g, 2t+8..), a3 = (g+8, 2t+8..)
//   B (16x8, col):  b0 = (k 2t..2t+1, n g), b1 = (k 2t+8..2t+9, n g)
//   C (16x8):       c0..c1 = (g, 2t..2t+1), c2..c3 = (g+8, 2t..2t+1)
// so the accumulators of two neighbouring n-tiles are the A operand of the next
// product without any shuffle (the FlashAttention-2 register layout).
//
// The flash kernels (flash_fwd.cuh, flash_bwd.cu) also take from here the
// pieces of their shared-memory pipeline: 16-byte cp.async copies with commit / wait groups,
// ldmatrix fragment loads (plain for row-major A and for B stored [n][k],
// .trans for B stored [k][n]) and the one-instruction exp2.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace fz {

constexpr float NEG_INF = -1e30f;  // as the TPU kernels: no inf - inf NaNs

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// (a, b) -> bf16 pairs hi and lo with hi + lo = (a, b) to ~16 mantissa bits:
// hi by truncation, lo = (a, b) - hi rounded, in one byte permute, two masks,
// two subtractions and one conversion, where rounding both terms takes four
// conversions (which run at a fraction of the rate). Exact for either sign:
// the truncated upper half keeps the sign and exponent, so a - hi is the
// dropped low mantissa bits, exact in fp32. The forward kernels' split of the
// probabilities, and the backward's of P and of the signed dS.
__device__ __forceinline__ void split_bf16_trunc(float a, float b, uint32_t& hi, uint32_t& lo) {
  const uint32_t ua = __float_as_uint(a), ub = __float_as_uint(b);
  hi = __byte_perm(ua, ub, 0x7632);  // the upper halves of a and b, a's in the low half
  lo = pack_bf16(a - __uint_as_float(ua & 0xffff0000u), b - __uint_as_float(ub & 0xffff0000u));
}

// the A operand of a k-step from the fp32 accumulators of two neighbouring
// n-tiles c0, c1, split so
__device__ __forceinline__ void split_a_trunc(uint32_t (&hi)[4], uint32_t (&lo)[4], const float (&c0)[4],
                                              const float (&c1)[4]) {
  split_bf16_trunc(c0[0], c0[1], hi[0], lo[0]);
  split_bf16_trunc(c0[2], c0[3], hi[1], lo[1]);
  split_bf16_trunc(c1[0], c1[1], hi[2], lo[2]);
  split_bf16_trunc(c1[2], c1[3], hi[3], lo[3]);
}

// the same A operand rounded to one bf16 term (K1b's P)
__device__ __forceinline__ void round_a(uint32_t (&a)[4], const float (&c0)[4], const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// ---- shared-memory pipeline pieces

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared; `bytes` (0 or 16) are read from
// `src` and the rest of the 16 is filled with zeros, so 0 writes a zero chunk
// without touching `src`
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 bf16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8, and receives of matrix i the pair (row lane / 4, columns 2 (lane % 4)..)
// in r[i]: the A and the [n][k]-stored B fragment layout of mma_bf16
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// the same with every matrix transposed: lane receives (rows 2 (lane % 4)..,
// column lane / 4), the B fragment of a tile stored [k][n]
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// two transposed matrices (addresses from lanes 0..15)
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// 2^x in one MUFU instruction (2 ulp; -1e30 gives 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace fz
