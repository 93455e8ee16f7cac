// Fused W8A8 transformer MLP for Hopper (sm_90a).
//
// Replaces the TPU kernel clip_embedder_tpu/ops/int8_mlp.py `int8_mlp`
// (`_mlp_kernel`):
//   x -> [f32 LayerNorm] -> per-row int8 quantization -> int8 fc1 ->
//   acc * (xs * s1) + b1 -> activation in f32 (gelu_tanh, erf-gelu with the
//   Abramowitz-Stegun erf, quick_gelu or relu) -> per-row requantization with
//   the GLOBAL row amax over the whole hidden -> int8 fc2 -> acc * (hs * s2)
//   + b2 [+ x, the raw residual stream] in f32 -> one rounding to x's type.
// Used for every MLP block (and the map-pool head's MLP) under
// quantize="int8" and "int8_all".
//
// What bounds it on the H100: at the main-path shape (rows = B*576,
// 1152 -> 4304 -> 1152, bf16) it does 4*rows*1152*4304 int8 operations
// against x and the output (2 * rows * 1152 * 2 bytes) plus 9.9 MB of
// weights, about 3,800 operations per byte: the tensor cores bound it
// (0.185 ms at batch 32).
//
// What the design does about that. Both products run on int8_wgmma.cuh's
// s8 TMA + wgmma kernel, the only way to the card's int8 rate; the weights
// are stored K-major (`ops/quant.py`), the layout its B operand takes. The
// requantization needs each row's amax over all 4304 f32 hidden values
// before any of them is quantized. The TPU kernel holds the f32 [tile, 4304]
// hidden in VMEM; one row of it is 17 KB here, 16 rows already more than a
// block's 227 KB of shared memory. So the hidden makes one round trip
// through device memory, in four launches:
// 1. the row pass (int8.cuh `row_quant_kernel`, LayerNorm fused) writes x's
//    int8 codes and scales;
// 2. fc1 (epilogue kAct) writes act(acc * (xs * s1) + b1) as an f32
//    workspace [rows, hidden] and reduces each row's amax into hs (zeroed
//    first) with one atomicMax a row per 128-column tile;
// 3. the row pass (kGivenAmax) reads each workspace row once and writes its
//    int8 codes and its scale over the amax;
// 4. fc2 (epilogue kOut) adds the bias and the residual.
// The workspace costs rows * hidden * (4 + 4 + 1) bytes of traffic (0.71
// GB, about 0.21 ms at batch 32, as much as the whole kernel's bound) plus
// the codes' read by fc2. chip_smoke.py phase 3 times the four launches
// apart; PERF.md §6 keeps the readings: fc1 and fc2 take about a third
// each, the two row passes the rest, and the whole is about 5 times the
// bound, the products well below the card's int8 rate. Quantizing the
// hidden from f32 tiles inside fc2's producer (no int8 hidden in device
// memory), or a persistent grid that keeps a row tile's hidden in the
// shared memory of a cluster, are for a later PR.

#include "int8_wgmma.cuh"

namespace i8 = clipk::i8;
namespace i8w = clipk::i8w;

namespace {

template <typename T>
int run(const void* x, const void* gamma, const void* beta, void* xq, void* xs, const void* w1,
        const void* s1, const void* b1, void* h, void* hq, void* hs, const void* w2,
        const void* s2, const void* b2, void* out, int rows, int k_in, int hidden, int k_out,
        float eps, int act, bool ln, bool add_res, cudaStream_t stream) {
  cudaError_t err =
      ln ? i8::launch_row_quant<T, i8::kNorm>(x, gamma, beta, xq, xs, rows, k_in, eps, stream)
         : i8::launch_row_quant<T, i8::kRaw>(x, nullptr, nullptr, xq, xs, rows, k_in, eps,
                                              stream);
  if (err != cudaSuccess) return (int)err;
  // hs holds fc1's row amax (atomicMax from zero), then the row pass's scales
  if ((err = cudaMemsetAsync(hs, 0, (size_t)rows * sizeof(float), stream)) != cudaSuccess)
    return (int)err;
  i8w::Args fc1{static_cast<const float*>(xs),
                {{static_cast<const float*>(s1), static_cast<const float*>(b1), h}},
                1, nullptr, static_cast<float*>(hs), rows, k_in, hidden, hidden, act};
  err = i8w::launch_gemm<float, i8w::kAct>(xq, &w1, fc1, stream);
  if (err != cudaSuccess) return (int)err;
  err = i8::launch_row_quant<float, i8::kGivenAmax>(h, nullptr, nullptr, hq, hs, rows, hidden,
                                                    0.0f, stream);
  if (err != cudaSuccess) return (int)err;
  i8w::Args fc2{static_cast<const float*>(hs),
                {{static_cast<const float*>(s2), static_cast<const float*>(b2), out}},
                1, add_res ? x : nullptr, nullptr, rows, hidden, k_out, 0, 0};
  return (int)i8w::launch_gemm<T, i8w::kOut>(hq, &w2, fc2, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and out). act: 0 gelu_tanh, 1 gelu,
// 2 quick_gelu, 3 relu. ln: fuse the LayerNorm (gamma, beta: [k_in] f32);
// add_res: out = x + mlp(ln(x)) (needs k_out == k_in). w1: [hidden, k_in]
// and w2: [k_out, hidden] int8, K-major (the storage of the [in, out]
// weights), 16-byte aligned. Scratch: xq [rows, k_in] int8, xs [rows] f32, h
// [rows, hidden] f32, hq [rows, hidden] int8, hs [rows] f32. s1, b1:
// [hidden], s2, b2: [k_out] f32, 16-byte aligned. Every width % 16 == 0.
// Returns cudaGetLastError().
extern "C" int int8_mlp_launch(const void* x, const void* gamma, const void* beta, void* xq,
                               void* xs, const void* w1, const void* s1, const void* b1, void* h,
                               void* hq, void* hs, const void* w2, const void* s2, const void* b2,
                               void* out, int rows, int k_in, int hidden, int k_out, float eps,
                               int act, int ln, int add_res, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k_in % 16 != 0 || hidden % 16 != 0 || k_out % 16 != 0 || act < 0 || act > 3 ||
      (add_res && k_out != k_in))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return run<clipk::bf16>(x, gamma, beta, xq, xs, w1, s1, b1, h, hq, hs, w2, s2, b2, out, rows,
                            k_in, hidden, k_out, eps, act, ln != 0, add_res != 0, st);
  if (dtype == 0)
    return run<float>(x, gamma, beta, xq, xs, w1, s1, b1, h, hq, hs, w2, s2, b2, out, rows, k_in,
                      hidden, k_out, eps, act, ln != 0, add_res != 0, st);
  return (int)cudaErrorInvalidValue;
}
