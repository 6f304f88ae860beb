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
// feeding it) is the limit. The kernels live in flash_fwd.cuh (shared with
// K1b and K1c); K1 takes two of their paths:
//
// * bf16 with dv <= 160, every call of the edit: mma.sync tensor cores with
//   fp32 accumulation, keeping fp32 accuracy (P split hi+lo);
// * fp32, or dv > 160: fp32 CUDA-core FMAs.
#include "flash_fwd.cuh"

// Returns cudaGetLastError() of the launch (0 on success). dtype: 0 fp32, 1 bf16.
// lse may be null (inference); else it receives [rows, sq] fp32 log-sum-exps.
extern "C" int fz_flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                            int rows, int sq, int skv, int d, int dv, float scale, int dtype,
                            void* stream) {
  using namespace fz::fwd;
  if (rows < 1 || rows > 65535 || sq < 1 || skv < 1 || d < 1 || d > 160 || dv < 1 || dv > 320)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && dv <= 160)
    return (int)dispatch_mma<__nv_bfloat16, false, false>(q, k, v, o, lse, rows, 1, sq, skv, d, dv, scale, s);
  cudaError_t err = dtype == 1
      ? dispatch_fma<__nv_bfloat16, false>(q, k, v, o, lse, rows, 1, sq, skv, d, dv, scale, s)
      : dispatch_fma<float, false>(q, k, v, o, lse, rows, 1, sq, skv, d, dv, scale, s);
  return (int)err;
}
