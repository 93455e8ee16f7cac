// Pre-attention LayerNorm + W8A8 q/k/v projections for Hopper (sm_90a).
//
// Replaces the TPU kernel clip_embedder_tpu/ops/qkv.py `ln_qkv_int8`
// (`_kernel_int8`):
//   x -> f32 LayerNorm -> one per-row int8 quantization of the f32 result
//   (no rounding to the activation type first), shared by q, k and v ->
//   three int8 products -> acc * (xs * s) + b -> one rounding each.
// Used by the attention blocks under quantize="int8_all".
//
// What bounds it on the H100: at the main-path shape (rows = B*576,
// W = 1152, bf16) it does 6*rows*W^2 int8 operations against x and the three
// outputs (4 * rows * W * 2 bytes) plus 3*W^2 weight bytes, about 850
// operations per byte, over the int8 tensor cores' 590: the tensor cores
// bound it (0.074 ms at batch 32).
//
// What the design does about that: two launches.
// 1. The row pass (int8.cuh `row_quant_kernel` with the LayerNorm) reads x
//    once, the row held in a warp's registers, normalizes it in f32 and
//    writes its int8 codes (21 MB at batch 32) and one f32 scale per row.
//    The TPU kernel keeps the row tile in VMEM; normalizing inside the
//    product's K loop would redo it once per column tile (27 times at W =
//    1152), which stalled the tensor cores in ln_qkv.cu's measured designs.
// 2. One launch of int8_wgmma.cuh's s8 TMA + wgmma product (epilogue kOut)
//    covers the three weights: its persistent blocks walk 3 * W / 128
//    column tiles x 256-row tiles, columns fastest across q, k and v, so
//    the tiles in flight share their rows of codes and the weights (4 MB at
//    W = 1152, 7 MB at 1536) stay in L2; the epilogue dequantizes, adds the
//    bias and writes each output once (bf16 through shared memory, 16
//    bytes a store).

#include "int8_wgmma.cuh"

namespace i8 = clipk::i8;
namespace i8w = clipk::i8w;

namespace {

template <typename T>
int run(const void* x, const void* gamma, const void* beta, void* xq, void* xs,
        const void* const* w, const void* const* s, const void* const* b, void* const* out,
        int rows, int width, float eps, cudaStream_t stream) {
  cudaError_t err =
      i8::launch_row_quant<T, i8::kNorm>(x, gamma, beta, xq, xs, rows, width, eps, stream);
  if (err != cudaSuccess) return (int)err;
  i8w::Args args{static_cast<const float*>(xs), {}, 3, nullptr, nullptr, rows, width, width,
                 0, 0};
  for (int i = 0; i < 3; ++i)
    args.o[i] = {static_cast<const float*>(s[i]), static_cast<const float*>(b[i]), out[i]};
  return (int)i8w::launch_gemm<T, i8w::kOut>(xq, w, args, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, q, k, v). wq, wk, wv: [width,
// width] int8, K-major ([out, in]), 16-byte aligned. gamma, beta, sq..sv,
// bq..bv: [width] f32, 16-byte aligned. xq: [rows, width] int8 scratch; xs:
// [rows] f32 scratch. width % 16 == 0. Returns cudaGetLastError().
extern "C" int ln_qkv_int8_launch(const void* x, const void* gamma, const void* beta, void* xq,
                                  void* xs, const void* wq, const void* wk, const void* wv,
                                  const void* sq, const void* sk, const void* sv, const void* bq,
                                  const void* bk, const void* bv, void* q, void* k, void* v,
                                  int rows, int width, float eps, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (width % 16 != 0) return (int)cudaErrorInvalidValue;
  const void* w[3] = {wq, wk, wv};
  const void* s[3] = {sq, sk, sv};
  const void* b[3] = {bq, bk, bv};
  void* out[3] = {q, k, v};
  if (dtype == 1)
    return run<clipk::bf16>(x, gamma, beta, xq, xs, w, s, b, out, rows, width, eps, st);
  if (dtype == 0) return run<float>(x, gamma, beta, xq, xs, w, s, b, out, rows, width, eps, st);
  return (int)cudaErrorInvalidValue;
}
