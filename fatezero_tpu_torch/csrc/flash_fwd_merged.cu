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
// 80 bytes in bf16, so every slice start and every row is 16-byte aligned and
// the tiles are copied by 16-byte cp.async chunks, for which the stride costs
// nothing: K1c runs as fast as K1 on the same work folded.
//
// Layout: contiguous, fp32 or bf16 (o has the input dtype), D <= 160, Skv any
// (a ragged KV tail is zero-filled in shared memory and masked, as in K1). No
// LSE (inference only) and no wide V.
//
// What bounds it on the H100: as K1 (flash_fwd.cu). bf16 takes K1's wgmma
// kernel at D <= 80 and its mma.sync kernel above, both with P split hi+lo
// (fp32 semantics), or the element loader when an operand is misaligned or D
// is no multiple of 8; fp32 takes K1's CUDA-core kernel.
#include "flash_fwd.cuh"

namespace {

// dtype: 0 fp32, 1 bf16
cudaError_t run(const fz::fwd::FwdArgs& a, int dtype) {
  using namespace fz::fwd;
  if (a.rows < 1 || a.heads < 1 || (long long)a.rows * a.heads > 65535 || a.sq < 1 || a.skv < 1 ||
      a.d < 1 || a.d > 160)
    return cudaErrorInvalidValue;
  if (!(a.scale > 0.f)) return cudaErrorInvalidValue;  // the running max is taken before the scaling
  return dtype == 1 ? dispatch_mma<__nv_bfloat16, false, true>(a) : dispatch_fma<float, true>(a);
}

}  // namespace

// Returns cudaGetLastError() of the launch (0 on success). dtype: 0 fp32, 1 bf16.
extern "C" int fz_flash_fwd_merged(const void* q, const void* k, const void* v, void* o, int rows,
                                   int heads, int sq, int skv, int d, float scale, int dtype,
                                   void* stream) {
  return (int)run({q, k, v, o, nullptr, rows, heads, sq, skv, d, d, scale,
                   static_cast<cudaStream_t>(stream), nullptr}, dtype);
}

// What fz_flash_fwd_merged would launch for these operands (see fz_flash_fwd_plan).
extern "C" int fz_flash_fwd_merged_plan(const void* q, const void* k, const void* v, const void* o,
                                        int d, int dv, int dtype, int* plan) {
  fz::fwd::Plan p{};
  const int err = (int)run({q, k, v, const_cast<void*>(o), nullptr, 1, 1, 1, 1, d, d, 1.f, nullptr, &p},
                           dtype);
  fz::fwd::export_plan(p, plan);
  return err;
}
