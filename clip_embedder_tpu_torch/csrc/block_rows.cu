// A transformer block's LayerNorm and MLP activation, one pass each, for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves the block's second LayerNorm
// and its MLP's activation to XLA, which fuses each into one pass over the
// rows. Eager PyTorch runs the same functions (ops/layers.py `layer_norm`,
// `gelu`, `gelu_tanh`, `quick_gelu`) as separate kernels: a cast to f32,
// mean, subtract, square, mean, rsqrt-multiply, scale, shift and a cast
// back, about ten, and a cast, the activation and a cast back, three, each a
// round trip of the f32 tensor through device memory.
//   1. `norm_kernel`: x -> f32 LayerNorm (mean, then the variance about the
//      mean, eps inside the reciprocal square root) -> x_hat * gamma + beta,
//      rounded once to the activation dtype.
//   2. `act_kernel`: the activation of the MLP's fc product, computed in f32
//      and rounded once: gelu with the exact erff, gelu_tanh with tanhf,
//      quick_gelu as x * sigmoid(1.702 x), each as PyTorch's CUDA kernels
//      write it.
//
// What bounds it on the H100: memory. Each kernel reads every element once
// and writes it once, in the activation dtype (4 bytes an element in bf16,
// where the eager forms move about 68 and 20), and does a few dozen f32
// operations on it, far below the card's ridge.
//
// What the design does about that: 16-byte loads and stores, neighbouring
// lanes on neighbouring addresses, and each thread starting all its loads
// before it uses the first, so that enough bytes are in flight to fill the bus.
// `norm_kernel` gives a row to a warp and keeps the row in the warp's
// registers (up to 16 pieces of 16 bytes a lane: 4096 bf16 or 2048 f32
// values), so that the three passes over it (sum, squared deviations,
// normalization) read device memory once; the affine step rounds its product
// and its sum apart, as the plain function's two kernels do. `act_kernel`
// walks the tensor as one flat array, 4 pieces a thread, whatever its width,
// and its first block takes the elements past the last whole piece.

#include "common.cuh"

using clipk::bf16;

namespace CLIPK_SOURCE {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // 16-byte pieces a thread of act_kernel keeps in flight

// 16 bytes of T as f32 and back (round to nearest even).
template <typename T>
struct Vec16;
template <>
struct Vec16<bf16> {
  static constexpr int kN = 8;
  __device__ static void load(uint4 u, float (&f)[kN]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p = __bfloat1622float2(h[i]);
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
  __device__ static uint4 store(const float (&f)[kN]) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    return u;
  }
};
template <>
struct Vec16<float> {
  static constexpr int kN = 4;
  __device__ static void load(uint4 u, float (&f)[kN]) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 store(const float (&f)[kN]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};

// y[row] = round((x - mean) * rstd * gamma + beta); one warp a row, the row
// held in registers as kV pieces of 16 bytes a lane (the pieces past the row
// are never read).
template <typename T, int kV>
__global__ void __launch_bounds__(kThreads)
    norm_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                const float* __restrict__ beta, T* __restrict__ y, int rows, int width,
                float eps) {
  using V = Vec16<T>;
  const int row = blockIdx.x * kWarps + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * width);
  uint4* yr = reinterpret_cast<uint4*>(y + (size_t)row * width);
  const int nv = width / V::kN;
  uint4 u[kV];
#pragma unroll
  for (int j = 0; j < kV; ++j) {
    const int i = lane + 32 * j;
    u[j] = i < nv ? xr[i] : make_uint4(0, 0, 0, 0);
  }
  float f[V::kN];
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < kV; ++j) {
    if (lane + 32 * j >= nv) break;
    V::load(u[j], f);
#pragma unroll
    for (int k = 0; k < V::kN; ++k) s += f[k];
  }
  const float inv_w = 1.0f / (float)width;
  const float mean = clipk::warp_sum(s) * inv_w;
  float ss = 0.0f;
#pragma unroll
  for (int j = 0; j < kV; ++j) {
    if (lane + 32 * j >= nv) break;
    V::load(u[j], f);
#pragma unroll
    for (int k = 0; k < V::kN; ++k) ss += (f[k] - mean) * (f[k] - mean);
  }
  // rsqrtf is what torch.rsqrt runs on the card
  const float rstd = rsqrtf(clipk::warp_sum(ss) * inv_w + eps);
#pragma unroll
  for (int j = 0; j < kV; ++j) {
    const int i = lane + 32 * j;
    if (i >= nv) break;
    const int c = i * V::kN;
    float g[V::kN], b[V::kN];
#pragma unroll
    for (int k = 0; k < V::kN; k += 4) {
      *reinterpret_cast<float4*>(g + k) = __ldg(reinterpret_cast<const float4*>(gamma + c + k));
      *reinterpret_cast<float4*>(b + k) = __ldg(reinterpret_cast<const float4*>(beta + c + k));
    }
    V::load(u[j], f);
#pragma unroll
    for (int k = 0; k < V::kN; ++k)
      f[k] = __fadd_rn(__fmul_rn(__fmul_rn(f[k] - mean, rstd), g[k]), b[k]);
    yr[i] = V::store(f);
  }
}

enum Act : int { kGelu = 0, kGeluTanh = 1, kQuickGelu = 2 };

template <int A>
__device__ __forceinline__ float activate(float x) {
  if constexpr (A == kGelu) {
    constexpr float kAlpha = 0.70710678118654752440f;  // 1 / sqrt(2)
    return x * 0.5f * (1.0f + erff(x * kAlpha));
  } else if constexpr (A == kGeluTanh) {
    // sqrt(2 / pi), rounded to f32 from the double product, as PyTorch's kBeta
    constexpr float kBeta = (float)(1.41421356237309504880 * 1.12837916709551257390 * 0.5);
    constexpr float kKappa = 0.044715f;
    const float inner = kBeta * (x + kKappa * (x * x * x));
    return 0.5f * x * (1.0f + tanhf(inner));
  } else {
    return x * (1.0f / (1.0f + expf(-(1.702f * x))));
  }
}

// y = round(act(x)) over n elements: kUnroll pieces of 16 bytes a thread,
// the elements past the last whole piece by block 0.
template <typename T, int A>
__global__ void __launch_bounds__(kThreads)
    act_kernel(const T* __restrict__ x, T* __restrict__ y, long long n) {
  using V = Vec16<T>;
  const long long nv = n / V::kN;
  const long long base = (long long)blockIdx.x * (kThreads * kUnroll) + threadIdx.x;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* yv = reinterpret_cast<uint4*>(y);
  uint4 u[kUnroll];
#pragma unroll
  for (int j = 0; j < kUnroll; ++j) {
    const long long i = base + (long long)j * kThreads;
    u[j] = i < nv ? xv[i] : make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int j = 0; j < kUnroll; ++j) {
    const long long i = base + (long long)j * kThreads;
    if (i >= nv) break;
    float f[V::kN];
    V::load(u[j], f);
#pragma unroll
    for (int k = 0; k < V::kN; ++k) f[k] = activate<A>(f[k]);
    yv[i] = V::store(f);
  }
  if (blockIdx.x == 0)
    for (long long i = nv * V::kN + threadIdx.x; i < n; i += kThreads)
      y[i] = clipk::from_f<T>(activate<A>(clipk::to_f<T>(x[i])));
}

template <typename T, int kV>
int launch_norm(const void* x, const void* gamma, const void* beta, void* y, int rows,
                int width, float eps, cudaStream_t stream) {
  norm_kernel<T, kV><<<(rows + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<T*>(y), rows, width, eps);
  return (int)cudaGetLastError();
}

// The smallest register row that holds the row's pieces.
template <typename T>
int run_norm(const void* x, const void* gamma, const void* beta, void* y, int rows, int width,
         float eps, cudaStream_t s) {
  if (width <= 0 || width % Vec16<T>::kN) return (int)cudaErrorInvalidValue;
  const int per_lane = (width / Vec16<T>::kN + 31) / 32;
#define CLIPK_NORM(KV) \
  if (per_lane <= KV) return launch_norm<T, KV>(x, gamma, beta, y, rows, width, eps, s);
  CLIPK_NORM(1)
  CLIPK_NORM(2)
  CLIPK_NORM(4)
  CLIPK_NORM(6)
  CLIPK_NORM(8)
  CLIPK_NORM(12)
  CLIPK_NORM(16)
#undef CLIPK_NORM
  return (int)cudaErrorInvalidValue;
}

template <typename T, int A>
int launch_act(const void* x, void* y, long long n, cudaStream_t stream) {
  const long long per_block = (long long)kThreads * kUnroll * Vec16<T>::kN;
  const long long blocks = (n + per_block - 1) / per_block;
  act_kernel<T, A><<<(unsigned)blocks, kThreads, 0, stream>>>(static_cast<const T*>(x),
                                                              static_cast<T*>(y), n);
  return (int)cudaGetLastError();
}

template <typename T>
int run_act(const void* x, void* y, long long n, int a, cudaStream_t s) {
  if (a == kGelu) return launch_act<T, kGelu>(x, y, n, s);
  if (a == kGeluTanh) return launch_act<T, kGeluTanh>(x, y, n, s);
  if (a == kQuickGelu) return launch_act<T, kQuickGelu>(x, y, n, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace CLIPK_SOURCE

using namespace CLIPK_SOURCE;

// dtype: 0 = float32, 1 = bfloat16. x and y [rows, width], contiguous and
// 16-byte aligned, rows > 0, width a multiple of 16 bytes and at most 512
// pieces of 16 bytes; gamma and beta [width] f32, 16-byte aligned. Returns
// cudaGetLastError().
extern "C" int norm_rows_launch(const void* x, const void* gamma, const void* beta, void* y,
                                int rows, int width, float eps, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return run_norm<bf16>(x, gamma, beta, y, rows, width, eps, s);
  if (dtype == 0) return run_norm<float>(x, gamma, beta, y, rows, width, eps, s);
  return (int)cudaErrorInvalidValue;
}

// act: 0 = gelu, 1 = gelu_tanh, 2 = quick_gelu. x and y n > 0 elements,
// contiguous and 16-byte aligned. Returns cudaGetLastError().
extern "C" int act_rows_launch(const void* x, void* y, long long n, int act_code, int dtype,
                               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return run_act<bf16>(x, y, n, act_code, s);
  if (dtype == 0) return run_act<float>(x, y, n, act_code, s);
  return (int)cudaErrorInvalidValue;
}
