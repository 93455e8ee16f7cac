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
//
// Widths that are no multiple of 16 (EVA02's SwiGLU, 1024 -> 2730 -> 1024)
// take the same product: TMA needs row strides that are multiples of 16
// bytes, so the codes are written with their rows padded to one
// (`row_quant_ragged_kernel`, which reads x one value at a time: its rows
// are not 16-byte aligned), the weight comes stored with its rows padded
// likewise (ops/quant.py `kmajor` on the card), and TMA zero-fills K past
// its end in both. An output width N that is no multiple of 8 is written
// into rows of ldo (N rounded up to 8) elements, which the wrapper hands
// back as a view of the first N columns.

#include "int8_wgmma.cuh"

namespace i8 = clipk::i8;
namespace i8w = clipk::i8w;

namespace CLIPK_SOURCE {
namespace {

// The row pass of rows whose width is no multiple of 16: one warp a row,
// lane l takes values l, l + 32, ... one at a time, twice (the amax, then
// the codes, written a byte each into a row of lda bytes). The codes and
// the scale are those of int8.cuh's row pass: the max is exact in any
// order. The codes past the width are never read: TMA zero-fills them.
template <typename T>
__global__ void __launch_bounds__(i8::kThreads)
    row_quant_ragged_kernel(const T* __restrict__ x, int8_t* __restrict__ xq,
                            float* __restrict__ xs, int rows, int width, int lda) {
  const int row = blockIdx.x * i8::kWarps + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* xr = x + (size_t)row * width;
  float m = 0.0f;
  for (int i = lane; i < width; i += 32) m = fmaxf(m, fabsf(clipk::to_f(xr[i])));
  const float amax = clipk::warp_max(m);
  const float scale = amax == 0.0f ? 1.0f : __fdiv_rn(amax, 127.0f);
  if (lane == 0) xs[row] = scale;
  int8_t* qr = xq + (size_t)row * lda;
  for (int i = lane; i < width; i += 32)
    qr[i] = (int8_t)i8::quant_byte(clipk::to_f(xr[i]), scale, 0);
}

template <typename T>
int run(const void* x, void* xq, void* xs, const void* w, const void* s, const void* b,
        const void* res, void* out, int rows, int k_in, int k_out, int lda, int ldw, int ldo,
        cudaStream_t stream) {
  cudaError_t err;
  if (k_in % 16 == 0 && lda == k_in) {
    err = i8::launch_row_quant<T, i8::kRaw>(x, nullptr, nullptr, xq, xs, rows, k_in, 0.0f,
                                            stream);
  } else {
    row_quant_ragged_kernel<T><<<(rows + i8::kWarps - 1) / i8::kWarps, i8::kThreads, 0,
                                 stream>>>(static_cast<const T*>(x), static_cast<int8_t*>(xq),
                                           static_cast<float*>(xs), rows, k_in, lda);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return (int)err;
  i8w::Args args{static_cast<const float*>(xs),
                 {{static_cast<const float*>(s), static_cast<const float*>(b), out}},
                 1, res, nullptr, rows, k_in, k_out, 0, 0, lda, ldw, ldo};
  return (int)i8w::launch_gemm<T, i8w::kOut>(xq, &w, args, stream);
}

}  // namespace
}  // namespace CLIPK_SOURCE

using namespace CLIPK_SOURCE;

// dtype: 0 = float32, 1 = bfloat16 (x, residual and out). x: [rows, k_in],
// contiguous. w: [k_out, k_in] int8 (the K-major storage), rows ldw bytes
// apart. xq: [rows, lda] int8 scratch; xs: [rows] f32 scratch; s, b:
// [k_out] f32, 16-byte aligned; out and res (or null): [rows, k_out], rows
// ldo elements apart. lda and ldw: multiples of 16, at least k_in (lda ==
// k_in where k_in % 16 == 0); ldo: a multiple of 8, at least k_out. Returns
// cudaGetLastError().
extern "C" int int8_linear_fused_launch(const void* x, void* xq, void* xs, const void* w,
                                        const void* s, const void* b, const void* res, void* out,
                                        int rows, int k_in, int k_out, int lda, int ldw, int ldo,
                                        int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k_in <= 0 || k_out <= 0 || lda < k_in || lda % 16 || (k_in % 16 == 0 && lda != k_in))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return run<clipk::bf16>(x, xq, xs, w, s, b, res, out, rows, k_in, k_out, lda, ldw, ldo, st);
  if (dtype == 0)
    return run<float>(x, xq, xs, w, s, b, res, out, rows, k_in, k_out, lda, ldw, ldo, st);
  return (int)cudaErrorInvalidValue;
}
