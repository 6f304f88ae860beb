// K1c: flash-attention forward over merged-head operands, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel scripts/bench_kernel_boundary.py::_fwd_call_merged:
// K1's function (fp32 arithmetic) read straight from the projection's output
// layout q [R, Sq, H*D], k and v [R, Skv, H*D], written to o [R, Sq, H*D]; head
// h is the column slice h*D .. (h+1)*D - 1 of every token's row. So the
// attention site needs no head-split transpose and no copy on either side.
//
// The TPU kernel loops over the heads inside each program because Mosaic could
// not cut a block out of the head axis; that loop is a TPU layout constraint
// and is not carried over. Here the grid runs over (R * H, query tiles), and a
// block reads its head's columns with a row stride of H*D (flash_fwd.cuh).
// A head slice starts h*D elements into a row: at D = 40 that is a multiple of
// 80 bytes in bf16 and 160 in fp32, so every slice start is 16-byte aligned.
//
// Layout: contiguous, fp32 or bf16 (o has the input dtype), D <= 160, Skv any
// (a ragged KV tail is padded in shared memory and masked, as in K1). No LSE
// (inference only) and no wide V.
//
// What bounds it on the H100: as K1. bf16 runs K1's mma.sync path with P split
// hi+lo (fp32 semantics), fp32 K1's CUDA-core path.
#include "flash_fwd.cuh"

// Returns cudaGetLastError() of the launch (0 on success). dtype: 0 fp32, 1 bf16.
extern "C" int fz_flash_fwd_merged(const void* q, const void* k, const void* v, void* o, int rows,
                                   int heads, int sq, int skv, int d, float scale, int dtype,
                                   void* stream) {
  using namespace fz::fwd;
  if (rows < 1 || heads < 1 || (long long)rows * heads > 65535 || sq < 1 || skv < 1 || d < 1 ||
      d > 160)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 1
      ? dispatch_mma<__nv_bfloat16, false, true>(q, k, v, o, nullptr, rows, heads, sq, skv, d, d, scale, s)
      : dispatch_fma<float, true>(q, k, v, o, nullptr, rows, heads, sq, skv, d, d, scale, s);
  return (int)err;
}
