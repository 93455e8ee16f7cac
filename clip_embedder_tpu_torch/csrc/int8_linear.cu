// Fused W8A8 linear for Hopper (sm_90a).
//
// Replaces the TPU kernel clip_embedder_tpu/ops/int8_mlp.py `int8_linear_fused`
// (`_linear_kernel`, `_linear_res_kernel`):
//   x -> per-row int8 quantization -> int8 product with the int8 weight
//   (stored K-major, [out, in]) -> acc * (xs * s) + b [+ residual] in f32 ->
//   one rounding to x's type.
// Used for the attention out-projection with its residual and the map-pool
// k/v projections under quantize="int8_all".
//
// What bounds it on the H100: at the main-path shape (out-projection, rows =
// B*576, 1152 x 1152, bf16, residual) it does 2*rows*1152^2 int8 operations
// against x, the residual and the output (3 * rows * 1152 * 2 bytes) plus the
// 1.3 MB weight: about 380 operations per byte, under the int8 tensor cores'
// 590, so memory bounds it (0.039 ms at batch 32).
//
// What the design does about that: the row pass (int8.cuh
// `row_quant_kernel`) reads x once, the row held in a warp's registers, and
// writes its int8 codes (half of x's bf16 bytes) and one f32 scale per row;
// int8_wgmma.cuh's s8 TMA + wgmma product (epilogue kOut, one weight) reads
// the codes and the K-major weight and adds the bias and the residual in
// its epilogue (bf16 staged through shared memory, the residual read and
// the output written 16 bytes a thread), so the output is written once and
// no f32 intermediate reaches memory. The TPU kernel quantizes the row tile
// in VMEM instead; here the codes make one round trip (an extra rows *
// 1152 * 2 bytes) so that the product stays the shared one. Not yet done:
// quantizing inside the product's producer.

#include "int8_wgmma.cuh"

namespace i8 = clipk::i8;
namespace i8w = clipk::i8w;

namespace {

template <typename T>
int run(const void* x, void* xq, void* xs, const void* w, const void* s, const void* b,
        const void* res, void* out, int rows, int k_in, int k_out, cudaStream_t stream) {
  cudaError_t err = i8::launch_row_quant<T, i8::kRaw>(x, nullptr, nullptr, xq, xs, rows, k_in,
                                                      0.0f, stream);
  if (err != cudaSuccess) return (int)err;
  i8w::Args args{static_cast<const float*>(xs),
                 {{static_cast<const float*>(s), static_cast<const float*>(b), out}},
                 1, res, nullptr, rows, k_in, k_out, 0, 0};
  return (int)i8w::launch_gemm<T, i8w::kOut>(xq, &w, args, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, residual and out). w: [k_out, k_in]
// int8, 16-byte aligned (the K-major storage). xq: [rows, k_in]
// int8 scratch; xs: [rows] f32 scratch; s, b: [k_out] f32, 16-byte aligned;
// res: [rows, k_out] or null. k_in % 16 == 0, k_out % 16 == 0. Returns
// cudaGetLastError().
extern "C" int int8_linear_fused_launch(const void* x, void* xq, void* xs, const void* w,
                                        const void* s, const void* b, const void* res, void* out,
                                        int rows, int k_in, int k_out, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k_in % 16 != 0 || k_out % 16 != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 1) return run<clipk::bf16>(x, xq, xs, w, s, b, res, out, rows, k_in, k_out, st);
  if (dtype == 0) return run<float>(x, xq, xs, w, s, b, res, out, rows, k_in, k_out, st);
  return (int)cudaErrorInvalidValue;
}
