// K1b: flash-attention forward with bf16 operands into both products, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel scripts/bench_flash_variants.py::_fwd_kernel_bf16
// (launched by flash_bf16): K1's online softmax with fp32 running max, sum and
// accumulator, but with the precision class of FlashAttention-2 and of
// scaled_dot_product_attention: q is rounded to bf16 after scaling, k and v are
// rounded to bf16, S = q k^T accumulates in fp32, and the probabilities
// P = exp(S - m_new) are rounded to one bf16 term before P V (l sums the
// unrounded fp32 P). Where K1 splits P into hi + lo and issues two P V
// products per tile, K1b issues one.
//
// P is rounded relative to the running max of its KV tile, so the output
// depends on the tile: this kernel's is MMA_BK = 64 keys
// (flash_variants.K1B_BLOCK_KV on the Python side), and its plain version
// emulates the same tiles.
//
// Layout: q [rows, Sq, d], k [rows, Skv, d], v [rows, Skv, dv], o [rows, Sq, dv],
// contiguous, fp32 or bf16 (cast to bf16 in the kernel as the tiles are staged;
// o has the input dtype); d <= 160, dv <= 160.
//
// What bounds it on the H100: as K1 (flash_fwd.cu), the softmax between the
// products more than the products. The kernels are K1's (flash_fwd.cuh,
// BF16_P = true) with one P V product per tile in place of two and one
// conversion per pair of probabilities in place of the hi/lo split: bf16 input
// takes the wgmma kernel at d, dv <= 80 and the mma.sync kernel above; fp32
// input takes the mma.sync kernel, its tiles read by 16-byte loads and rounded
// in registers (an asynchronous copy cannot convert).
#include "flash_fwd.cuh"

namespace {

// dtype: 0 fp32, 1 bf16
cudaError_t run(const fz::fwd::FwdArgs& a, int dtype) {
  using namespace fz::fwd;
  if (a.rows < 1 || a.rows > 65535 || a.sq < 1 || a.skv < 1 || a.d < 1 || a.d > 160 || a.dv < 1 ||
      a.dv > 160)
    return cudaErrorInvalidValue;
  return dtype == 1 ? dispatch_mma<__nv_bfloat16, true, false>(a) : dispatch_mma<float, true, false>(a);
}

}  // namespace

// Returns cudaGetLastError() of the launch (0 on success). dtype: 0 fp32, 1 bf16.
extern "C" int fz_flash_fwd_bf16(const void* q, const void* k, const void* v, void* o, int rows,
                                 int sq, int skv, int d, int dv, float scale, int dtype,
                                 void* stream) {
  return (int)run({q, k, v, o, nullptr, rows, 1, sq, skv, d, dv, scale,
                   static_cast<cudaStream_t>(stream), nullptr}, dtype);
}

// What fz_flash_fwd_bf16 would launch for these operands (see fz_flash_fwd_plan).
extern "C" int fz_flash_fwd_bf16_plan(const void* q, const void* k, const void* v, const void* o,
                                      int d, int dv, int dtype, int* plan) {
  fz::fwd::Plan p{};
  const int err = (int)run({q, k, v, const_cast<void*>(o), nullptr, 1, 1, 1, 1, d, dv, 1.f, nullptr, &p},
                           dtype);
  fz::fwd::export_plan(p, plan);
  return err;
}
