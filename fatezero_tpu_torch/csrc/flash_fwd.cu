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
// read, so memory is no limit, and at d = 40 neither are the products: with P
// split in two terms the kernel computes three products where the bound counts
// two, yet the softmax between them (an exponential, a max, a sum and the
// hi/lo split per score) takes most of the instruction slots. The design therefore
// keeps everything else out of the loop (flash_fwd.cuh, shared with K1b and
// K1c). K1 takes three of its paths, chosen by a rule in `run` and in
// dispatch_mma_loader and reported by fz_flash_fwd_plan:
//
// * bf16, d <= 80 and dv <= 80, operands on 16-byte boundaries (the 64^2 and
//   32^2 sites): the wgmma kernel, K and V copied by 16-byte cp.async into an
//   mbarrier ring and read by the tensor cores from shared memory;
// * other bf16 with dv <= 160 (d = 160, the 32^2 site's double-wide V,
//   misaligned or odd-width operands): the mma.sync kernel with a cp.async
//   ring and ldmatrix fragments, or its element loader;
// * fp32, or dv > 160 (the 16^2 site's double-wide V): fp32 CUDA-core FMAs.
//   Both tensor-core kernels keep fp32 accuracy (P split hi+lo).
#include "flash_fwd.cuh"

namespace {

// dtype: 0 fp32, 1 bf16
cudaError_t run(const fz::fwd::FwdArgs& a, int dtype) {
  using namespace fz::fwd;
  if (a.rows < 1 || a.rows > 65535 || a.sq < 1 || a.skv < 1 || a.d < 1 || a.d > 160 || a.dv < 1 ||
      a.dv > 320)
    return cudaErrorInvalidValue;
  if (!(a.scale > 0.f)) return cudaErrorInvalidValue;  // the running max is taken before the scaling
  if (dtype == 1 && a.dv <= 160) return dispatch_mma<__nv_bfloat16, false, false>(a);
  return dtype == 1 ? dispatch_fma<__nv_bfloat16, false>(a) : dispatch_fma<float, false>(a);
}

}  // namespace

// Returns cudaGetLastError() of the launch (0 on success). dtype: 0 fp32, 1 bf16.
// lse may be null (inference); else it receives [rows, sq] fp32 log-sum-exps.
extern "C" int fz_flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                            int rows, int sq, int skv, int d, int dv, float scale, int dtype,
                            void* stream) {
  return (int)run({q, k, v, o, lse, rows, 1, sq, skv, d, dv, scale,
                   static_cast<cudaStream_t>(stream), nullptr}, dtype);
}

// What fz_flash_fwd would launch for these operands, without launching it:
// plan[0..5] = path (0 CUDA cores, 1 mma.sync), loader (0 element, 1 staged
// through registers, 2 cp.async), queries per block, keys per tile, ring
// stages, dynamic shared bytes. Returns 0, or the error the call would return.
extern "C" int fz_flash_fwd_plan(const void* q, const void* k, const void* v, const void* o,
                                 int d, int dv, int dtype, int* plan) {
  fz::fwd::Plan p{};
  const int err = (int)run({q, k, v, const_cast<void*>(o), nullptr, 1, 1, 1, 1, d, dv, 1.f, nullptr, &p},
                           dtype);
  fz::fwd::export_plan(p, plan);
  return err;
}
