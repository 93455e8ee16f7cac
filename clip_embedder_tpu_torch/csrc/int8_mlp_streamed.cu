// Fused W8A8 transformer MLP with per-slab requantization, for Hopper (sm_90a).
//
// Replaces the TPU kernel clip_embedder_tpu/ops/int8_mlp.py
// `int8_mlp_streamed` (`_mlp_streamed_kernel`), which the JAX package takes
// for MLPs whose int8 weights exceed 20 MB (PE-Core-bigG: 1536 -> 8960 ->
// 1536, 27.5 MB) at 512 rows or more:
//   x -> [f32 LayerNorm] -> per-row int8 quantization -> int8 fc1 ->
//   acc * (xs * s1) + b1 -> activation in f32 -> per hidden slab j of `chunk`
//   columns (the last may be ragged): row requantization with the slab's own
//   amax (aq_j, as_j) and acc += (aq_j . w2_j) * (as_j * s2) in f32, slab by
//   slab -> + b2 [+ x] in f32 -> one rounding to x's type.
// The slab is the unit of the activation requantization, so it is part of
// the numerics (the JAX package's default 1792), not a memory tile: on the
// TPU the slabs are also how the weights stream through VMEM; here the
// weights stream through shared memory in the product's own 128-byte K
// boxes, as for every other int8 product.
//
// What bounds it on the H100: at PE-Core-bigG's shape (rows = B*1025, 1536 ->
// 8960 -> 1536, bf16) it does 4*rows*1536*8960 int8 operations against x
// and the output (2 * rows * 1536 * 2 bytes) plus 27.5 MB of weights, about
// 4,000 operations per byte: the tensor cores bound it (0.91 ms at batch 32).
//
// What the design does about that: int8_mlp.cu's four launches on the s8
// TMA + wgmma product of int8_wgmma.cuh, with the requantization and fc2
// cut at the slab boundaries.
// 1. the row pass (int8.cuh `row_quant_kernel`, LayerNorm fused) writes x's
//    int8 codes and scales;
// 2. fc1 (epilogue kAct) writes act(acc * (xs * s1) + b1) as an f32
//    workspace [rows, hidden] and reduces each row's amax per slab into hs
//    [rows, slabs] (zeroed first; a 128-column tile lies in one slab);
// 3. the row pass in slab mode (grid y = slabs, kGivenAmax) reads the
//    workspace once and writes the codes and one scale per (row, slab);
// 4. fc2 (epilogue kSlab) runs its K boxes slab by slab (chunk is a
//    multiple of the 128-byte box), folds each slab's exact int32 sums into
//    an f32 accumulator as part * (as_j * s2) in slab order, restarts them
//    with wgmma's scale-d = 0, and adds the bias and the residual after the
//    last slab.
// The int32 sums are exact, so the result is the plain version's operation
// by operation, apart from the LayerNorm's row-sum order. The workspace
// costs rows * hidden * (4 + 4 + 1) bytes of traffic (2.6 GB at batch 32,
// ~0.8 ms); the f32 slab accumulator halves fc2's rows per tile (128, not
// 256). chip_smoke.py phase 3 times the four launches apart; PERF.md §6
// keeps the readings: fc1, with its erf-gelu epilogue, takes the most,
// then fc2, then the hidden's row pass (memory-bound), and the whole is
// about 3.5 times the bound.

#include "int8_wgmma.cuh"

namespace i8 = clipk::i8;
namespace i8w = clipk::i8w;

namespace {

template <typename T>
int run(const void* x, const void* gamma, const void* beta, void* xq, void* xs, const void* w1,
        const void* s1, const void* b1, void* h, void* hq, void* hs, const void* w2,
        const void* s2, const void* b2, void* out, int rows, int k_in, int hidden, int k_out,
        int chunk, float eps, int act, bool ln, bool add_res, cudaStream_t stream) {
  cudaError_t err =
      ln ? i8::launch_row_quant<T, i8::kNorm>(x, gamma, beta, xq, xs, rows, k_in, eps, stream)
         : i8::launch_row_quant<T, i8::kRaw>(x, nullptr, nullptr, xq, xs, rows, k_in, eps,
                                              stream);
  if (err != cudaSuccess) return (int)err;
  // hs holds fc1's amax per (row, slab) (atomicMax from zero), then the scales
  const int slabs = (hidden + chunk - 1) / chunk;
  if ((err = cudaMemsetAsync(hs, 0, (size_t)rows * slabs * sizeof(float), stream)) !=
      cudaSuccess)
    return (int)err;
  i8w::Args fc1{static_cast<const float*>(xs),
                {{static_cast<const float*>(s1), static_cast<const float*>(b1), h}},
                1, nullptr, static_cast<float*>(hs), rows, k_in, hidden, chunk, act};
  err = i8w::launch_gemm<float, i8w::kAct>(xq, &w1, fc1, stream);
  if (err != cudaSuccess) return (int)err;
  err = i8::launch_row_quant<float, i8::kGivenAmax>(h, nullptr, nullptr, hq, hs, rows, hidden,
                                                    0.0f, stream, chunk);
  if (err != cudaSuccess) return (int)err;
  i8w::Args fc2{static_cast<const float*>(hs),
                {{static_cast<const float*>(s2), static_cast<const float*>(b2), out}},
                1, add_res ? x : nullptr, nullptr, rows, hidden, k_out, chunk, 0};
  return (int)i8w::launch_gemm<T, i8w::kSlab>(hq, &w2, fc2, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and out). act: 0 gelu_tanh, 1 gelu,
// 2 quick_gelu, 3 relu. ln: fuse the LayerNorm (gamma, beta: [k_in] f32);
// add_res: out = x + mlp(ln(x)) (needs k_out == k_in). chunk: hidden columns
// per slab, a multiple of 128. w1: [hidden, k_in] and w2: [k_out, hidden]
// int8, K-major (the storage of the [in, out] weights), 16-byte aligned.
// Scratch: xq [rows, k_in] int8, xs [rows] f32, h [rows, hidden] f32, hq
// [rows, hidden] int8, hs [rows, ceil(hidden / chunk)] f32. s1, b1:
// [hidden], s2, b2: [k_out] f32, 16-byte aligned. Every width % 16 == 0.
// Returns cudaGetLastError().
extern "C" int int8_mlp_streamed_launch(const void* x, const void* gamma, const void* beta,
                                        void* xq, void* xs, const void* w1, const void* s1,
                                        const void* b1, void* h, void* hq, void* hs,
                                        const void* w2, const void* s2, const void* b2,
                                        void* out, int rows, int k_in, int hidden, int k_out,
                                        int chunk, float eps, int act, int ln, int add_res,
                                        int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k_in % 16 != 0 || hidden % 16 != 0 || k_out % 16 != 0 || act < 0 || act > 3 ||
      chunk <= 0 || chunk % i8w::kBK != 0 || (add_res && k_out != k_in))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return run<clipk::bf16>(x, gamma, beta, xq, xs, w1, s1, b1, h, hq, hs, w2, s2, b2, out, rows,
                            k_in, hidden, k_out, chunk, eps, act, ln != 0, add_res != 0, st);
  if (dtype == 0)
    return run<float>(x, gamma, beta, xq, xs, w1, s1, b1, h, hq, hs, w2, s2, b2, out, rows, k_in,
                      hidden, k_out, chunk, eps, act, ln != 0, add_res != 0, st);
  return (int)cudaErrorInvalidValue;
}
