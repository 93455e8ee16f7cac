// Pre-attention LayerNorm + q/k/v projections for Hopper (sm_90a).
//
// Replaces the TPU kernel clip_embedder_tpu/ops/qkv.py `ln_qkv` (`_kernel`):
//   x -> f32 LayerNorm -> one rounding to the activation dtype ->
//   (x^ Wq + bq, x^ Wk + bk, x^ Wv + bv), f32 accumulation, f32 bias,
//   one rounding of each output to the activation dtype.
//
// What bounds it on the H100: at the main-path shape (rows = B*576,
// W = 1152, bf16) it does 6*rows*W^2 FLOP against rows*W*2*4 + 3*W^2*2 bytes,
// a few hundred FLOP per byte: the tensor cores bound it, not memory.
//
// What the design does about that: the LayerNorm is a small pass of its own
// and the products are a tiled matrix product fed by TMA.
// 1. `ln_kernel` normalizes each row in f32 (one warp per row; mean, then the
//    variance about the mean, eps inside the rsqrt) and writes
//    x^ = x_hat * gamma + beta rounded once to the activation dtype: one
//    read and one write of x.
//    The TPU kernel keeps x^ in VMEM; normalizing it inside the product's
//    K loop instead (an earlier design) redid the normalization once per
//    column tile, 27 times at W = 1152, on the path of the products.
// 2. bf16, widths that are multiples of 128 (every configuration the repo
//    runs): `tma::qkv_kernel`, warp-specialized, TMA loads through an
//    mbarrier ring into wgmma, on a persistent grid (the section below says
//    how).
// 3. Other widths (multiples of 64) and f32: `qkv_gemm_kernel`, a plain
//    tiled product: (column tiles over q|k|v) x (row tiles), K-slabs of x^
//    and the weight through a 4-deep cp.async ring with one barrier per
//    slab; bf16 on mma.sync m16n8k16 (ldmatrix operands, 64 x 64 warp
//    tiles), f32 on FMA staged through shared memory for the epilogue.
// Every route adds the f32 bias to the f32 accumulators and rounds each
// output once; the ragged last row tile is zero-filled and masked, not
// padded in device memory.

#include "hopper.cuh"

using clipk::align128;
using clipk::bf16;

namespace CLIPK_SOURCE {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 4;  // cp.async ring depth
constexpr int kBK = 64;     // K-slab depth

template <typename T, int BM, int BN>
struct Layout {
  static constexpr int kLda = kBK + 8;  // x^ slab row stride (T): no ldmatrix bank conflicts
  static constexpr int kLdw = BN + 8;   // weight slab row stride (T)
  static constexpr int kLdc = BN + 4;   // f32 epilogue staging row stride (f32 only)
  static constexpr size_t kA = align128(sizeof(T) * BM * kLda);
  static constexpr size_t kW = align128(sizeof(T) * kBK * kLdw);
  static constexpr size_t kCs = sizeof(T) == 4 ? align128(sizeof(float) * BM * kLdc) : 0;
  static constexpr size_t kBytes = kStages * (kA + kW) + kCs;
};

// The accumulators of one BM x BN output tile.
template <typename T, int BM, int BN>
struct Acc;

// bf16: the 8 warps tile the block as 4 (rows) x 2 (columns); a warp owns
// BM / 4 rows (kMI m16 tiles) and BN / 2 columns (kNJ n8 tiles).
template <int BM, int BN>
struct Acc<bf16, BM, BN> {
  static constexpr int kWM = 4, kWN = kWarps / kWM;
  static constexpr int kRows = BM / kWM, kCols = BN / kWN;  // per warp
  static constexpr int kMI = kRows / 16, kNJ = kCols / 8;
  static_assert(kRows % 16 == 0 && kNJ % 2 == 0, "tile/warp mismatch");
  float c[kMI][kNJ][4];

  __device__ void zero() {
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
      for (int nj = 0; nj < kNJ; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[mi][nj][e] = 0.0f;
  }
  // c += xs . ws over one K-slab
  __device__ void mma(const bf16* xs, const bf16* ws) {
    constexpr int kLda = Layout<bf16, BM, BN>::kLda, kLdw = Layout<bf16, BM, BN>::kLdw;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int m0 = (warp / kWN) * kRows, n0 = (warp % kWN) * kCols;
    // each k16 step loads all its fragments before its first mma, so the
    // loads' latencies overlap instead of each stalling its own mma
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[kMI][4], b[kNJ / 2][4];
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi)
        clipk::ldmatrix_x4(a[mi], xs + (m0 + mi * 16 + (lane & 15)) * kLda + kk + (lane >> 4) * 8);
      const int krow = kk + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int np = 0; np < kNJ / 2; ++np)
        clipk::ldmatrix_x4_trans(b[np], ws + krow * kLdw + n0 + np * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < kNJ / 2; ++np)
#pragma unroll
        for (int mi = 0; mi < kMI; ++mi) {
          clipk::mma_bf16(c[mi][2 * np], a[mi], b[np][0], b[np][1]);
          clipk::mma_bf16(c[mi][2 * np + 1], a[mi], b[np][2], b[np][3]);
        }
    }
  }
  // out[row, col0 + ...] = round(c + bias), two columns per store
  __device__ void finish(bf16* out, const float* bias, int row0, int col0, int rows, int width,
                         float*) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int m0 = row0 + (warp / kWN) * kRows, n0 = col0 + (warp % kWN) * kCols;
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
      for (int nj = 0; nj < kNJ; ++nj) {
        const int col = n0 + nj * 8 + 2 * t;
        const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = m0 + mi * 16 + g + half * 8;
          if (row < rows)
            *reinterpret_cast<uint32_t*>(out + (size_t)row * width + col) =
                clipk::pack_bf16(__float2bfloat16(c[mi][nj][2 * half] + b0),
                                 __float2bfloat16(c[mi][nj][2 * half + 1] + b1));
        }
      }
  }
};

// f32: thread (ty, tx) owns rows ty + 8i and columns tx + 32j.
template <int BM, int BN>
struct Acc<float, BM, BN> {
  static constexpr int kRi = BM / kWarps, kCj = BN / 32;
  float c[kRi][kCj];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < kRi; ++i)
#pragma unroll
      for (int j = 0; j < kCj; ++j) c[i][j] = 0.0f;
  }
  __device__ void mma(const float* xs, const float* ws) {
    constexpr int kLda = Layout<float, BM, BN>::kLda, kLdw = Layout<float, BM, BN>::kLdw;
    const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float b[kCj];
#pragma unroll
      for (int j = 0; j < kCj; ++j) b[j] = ws[kk * kLdw + tx + 32 * j];
#pragma unroll
      for (int i = 0; i < kRi; ++i) {
        const float a = xs[(ty + kWarps * i) * kLda + kk];
#pragma unroll
        for (int j = 0; j < kCj; ++j) c[i][j] = fmaf(a, b[j], c[i][j]);
      }
    }
  }
  // staged through shared memory so that the stores are coalesced
  __device__ void finish(float* out, const float* bias, int row0, int col0, int rows, int width,
                         float* cs) {
    constexpr int kLdc = Layout<float, BM, BN>::kLdc;
    const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
#pragma unroll
    for (int i = 0; i < kRi; ++i)
#pragma unroll
      for (int j = 0; j < kCj; ++j) cs[(ty + kWarps * i) * kLdc + tx + 32 * j] = c[i][j];
    __syncthreads();
    for (int i = threadIdx.x; i < BM * BN; i += kThreads) {
      const int r = i / BN, col = i % BN;
      if (row0 + r < rows)
        out[(size_t)(row0 + r) * width + col0 + col] = cs[r * kLdc + col] + bias[col0 + col];
    }
  }
};

// 16 bytes of T as f32 and back (round to nearest even, as JAX's astype).
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

// xn[row] = round((x - mean) * rstd * gamma + beta), the statistics in f32;
// one warp per row, the variance taken about the mean in a second pass and
// the row read a third time to normalize (both from L1).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ln_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
              const float* __restrict__ beta, T* __restrict__ xn, int rows, int width,
              float eps) {
  using V = Vec16<T>;
  const int row = blockIdx.x * kWarps + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * width);
  uint4* yr = reinterpret_cast<uint4*>(xn + (size_t)row * width);
  const int nv = width / V::kN;
  const float inv_w = 1.0f / (float)width;
  float f[V::kN];
  float s = 0.0f;
  for (int i = lane; i < nv; i += 32) {
    V::load(xr[i], f);
#pragma unroll
    for (int j = 0; j < V::kN; ++j) s += f[j];
  }
  const float mean = clipk::warp_sum(s) * inv_w;
  float ss = 0.0f;
  for (int i = lane; i < nv; i += 32) {
    V::load(xr[i], f);
#pragma unroll
    for (int j = 0; j < V::kN; ++j) ss += (f[j] - mean) * (f[j] - mean);
  }
  const float rstd = 1.0f / sqrtf(clipk::warp_sum(ss) * inv_w + eps);
  for (int i = lane; i < nv; i += 32) {
    const int c = i * V::kN;
    float g[V::kN], b[V::kN];
#pragma unroll
    for (int j = 0; j < V::kN; j += 4) {
      *reinterpret_cast<float4*>(g + j) = __ldg(reinterpret_cast<const float4*>(gamma + c + j));
      *reinterpret_cast<float4*>(b + j) = __ldg(reinterpret_cast<const float4*>(beta + c + j));
    }
    V::load(xr[i], f);
#pragma unroll
    for (int j = 0; j < V::kN; ++j) f[j] = (f[j] - mean) * rstd * g[j] + b[j];
    yr[i] = V::store(f);
  }
}

template <typename T, int BM, int BN>
__global__ void __launch_bounds__(kThreads, 1)
    qkv_gemm_kernel(const T* __restrict__ xn, const T* __restrict__ wq, const T* __restrict__ wk,
                    const T* __restrict__ wv, const float* __restrict__ bq,
                    const float* __restrict__ bk, const float* __restrict__ bv,
                    T* __restrict__ q, T* __restrict__ k, T* __restrict__ v, int rows,
                    int width) {
  using L = Layout<T, BM, BN>;
  constexpr int kPer = 16 / sizeof(T);  // elements in a 16-byte piece
  extern __shared__ __align__(128) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);                    // [kStages][BM][kLda]
  T* ws = reinterpret_cast<T*>(smem + kStages * L::kA);  // [kStages][kBK][kLdw]
  float* cs = reinterpret_cast<float*>(smem + kStages * (L::kA + L::kW));
  constexpr int kAStage = L::kA / sizeof(T), kWStage = L::kW / sizeof(T);
  constexpr int kAPieces = BM * kBK / kPer, kAPerRow = kBK / kPer;
  constexpr int kWPieces = kBK * BN / kPer, kWPerRow = BN / kPer;

  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * BM;
  const int tiles_per_mat = width / BN;
  const int mat = blockIdx.x / tiles_per_mat;
  const int col0 = (blockIdx.x % tiles_per_mat) * BN;
  const T* w = mat == 0 ? wq : (mat == 1 ? wk : wv);
  const int slabs = width / kBK;

  // slab s of x^ and of the weight into ring stage s % kStages; rows past
  // the end are zero-filled
  auto issue = [&](int s) {
    const int k0 = s * kBK;
    T* xd = xs + (s % kStages) * kAStage;
    for (int i = tid; i < kAPieces; i += kThreads) {
      const int r = i / kAPerRow, c = (i % kAPerRow) * kPer;
      if (row0 + r < rows)
        clipk::cp_async16(xd + r * L::kLda + c, xn + (size_t)(row0 + r) * width + k0 + c);
      else
        *reinterpret_cast<uint4*>(xd + r * L::kLda + c) = make_uint4(0, 0, 0, 0);
    }
    T* wd = ws + (s % kStages) * kWStage;
    for (int i = tid; i < kWPieces; i += kThreads) {
      const int r = i / kWPerRow, c = (i % kWPerRow) * kPer;
      clipk::cp_async16(wd + r * L::kLdw + c, w + (size_t)(k0 + r) * width + col0 + c);
    }
  };

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < slabs) issue(s);
    clipk::cp_async_commit();
  }
  Acc<T, BM, BN> acc;
  acc.zero();
  for (int s = 0; s < slabs; ++s) {
    clipk::cp_async_wait<kStages - 2>();  // this thread's pieces of slab s have landed
    __syncthreads();  // everyone's have; stage (s - 1) % kStages is free
    if (s + kStages - 1 < slabs) issue(s + kStages - 1);
    clipk::cp_async_commit();
    acc.mma(xs + (s % kStages) * kAStage, ws + (s % kStages) * kWStage);
  }
  const float* bias = mat == 0 ? bq : (mat == 1 ? bk : bv);
  T* out = mat == 0 ? q : (mat == 1 ? k : v);
  acc.finish(out, bias, row0, col0, rows, width, cs);
}

// -- bf16, widths that are multiples of 128: TMA + wgmma ------------------------
//
// A 256 x 128 output tile per block of three warpgroups, on a persistent
// grid (one block per SM, each walking tiles columns-fastest, so that the
// tiles in flight share their rows of x^ and the weights stay in L2).
// Warpgroup 2 is the producer: one thread keeps TMA loads of the K-slabs in
// flight through a kStages-deep ring (full/empty mbarriers), running ahead
// into the next tile while the consumers write one: the x^ slab [256 rows x
// 64] with the 128-byte swizzle, K-major, and the weight slab [64 x 128] as
// two [64 x 64] boxes, swizzled, MN-major (the weights are [in, out]
// row-major: wgmma reads them transposed, no copy). Warpgroups 0 and 1 each
// own 128 rows: per K-slab 2 x 4 wgmma m64n128k16 from shared memory into
// 128 f32 registers a thread, one group kept in flight, the slab released
// when the group before it completes. The epilogue adds the f32 bias, rounds
// once and stores bf16 pairs straight from the accumulators.

namespace tma {

using clipk::hopper::desc;
using clipk::hopper::kSwizzle128;

constexpr int kBM = 256, kBN = 128, kBK = 64;
constexpr int kStages = 4;
constexpr int kThreads = 384;
constexpr uint32_t kABytes = kBM * kBK * 2;  // 32 KB
constexpr uint32_t kBBytes = kBK * kBN * 2;  // 16 KB
constexpr size_t kSmem = 1024 + kStages * (kABytes + kBBytes) + 2 * kStages * sizeof(uint64_t);

__global__ void __launch_bounds__(kThreads, 1)
    qkv_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wqmap,
               const __grid_constant__ CUtensorMap wkmap, const __grid_constant__ CUtensorMap wvmap,
               const float* __restrict__ bq, const float* __restrict__ bk,
               const float* __restrict__ bv, bf16* __restrict__ q, bf16* __restrict__ k,
               bf16* __restrict__ v, int rows, int width) {
  namespace hp = clipk::hopper;
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: tiles start on such a boundary
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* as = smem;                       // [kStages][256][64] bf16, swizzled
  unsigned char* bs = smem + kStages * kABytes;   // [kStages][2][64][64] bf16, swizzled
  uint64_t* full = reinterpret_cast<uint64_t*>(bs + kStages * kBBytes);
  uint64_t* empty = full + kStages;

  const int tiles_per_mat = width / kBN;
  const int n_col = 3 * tiles_per_mat;
  const int n_tiles = n_col * ((rows + kBM - 1) / kBM);
  const int slabs = width / kBK;
  const int wg = threadIdx.x / 128;
  // tile -> (matrix, first column, first row): columns fastest
  auto tile_at = [&](int tile, int& mat, int& col0, int& row0) {
    const int c = tile % n_col;
    mat = c / tiles_per_mat;
    col0 = (c % tiles_per_mat) * kBN;
    row0 = tile / n_col * kBM;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    hp::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer
    hp::regs_dealloc<40>();
    if (threadIdx.x == 256) {
      hp::prefetch_map(&xmap);
      hp::prefetch_map(&wqmap);
      hp::prefetch_map(&wkmap);
      hp::prefetch_map(&wvmap);
      int it = 0;  // slabs issued so far, over every tile of this block
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        int mat, col0, row0;
        tile_at(tile, mat, col0, row0);
        const CUtensorMap* wmap = mat == 0 ? &wqmap : (mat == 1 ? &wkmap : &wvmap);
        for (int s = 0; s < slabs; ++s, ++it) {
          const int st = it % kStages;
          if (it >= kStages) hp::mbar_wait(&empty[st], ((it / kStages) - 1) & 1);
          hp::mbar_expect_tx(&full[st], kABytes + kBBytes);
          hp::tma_load_2d(as + st * kABytes, &xmap, &full[st], s * kBK, row0);
          hp::tma_load_2d(bs + st * kBBytes, wmap, &full[st], col0, s * kBK);
          hp::tma_load_2d(bs + st * kBBytes + kBBytes / 2, wmap, &full[st], col0 + 64,
                          s * kBK);
        }
      }
    }
  } else {  // consumers: rows wg * 128 + [0, 128) of each tile
    hp::regs_alloc<232>();
    const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
    const int g = lane / 4, t = lane % 4;
    float acc[2][64];
    int it = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      int mat, col0, row0;
      tile_at(tile, mat, col0, row0);
      for (int s = 0; s < slabs; ++s, ++it) {
        const int st = it % kStages;
        hp::mbar_wait(&full[st], (it / kStages) & 1);
        const unsigned char* a = as + st * kABytes + wg * 128 * 128;
        const unsigned char* b = bs + st * kBBytes;
        hp::fence_regs(acc[0]);
        hp::fence_regs(acc[1]);
        hp::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          // B: rows kk*16.. of the slab (2048 bytes on), the 64-column boxes 8 KB apart
          const uint64_t db = desc(b + kk * 2048, 8192, 1024, kSwizzle128);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)  // A: 64 rows (8 KB) on, 16 columns (32 bytes) on
            clipk::WgmmaSS<128, 1>::run(acc[mi],
                                        desc(a + mi * 8192 + kk * 32, 16, 1024, kSwizzle128),
                                        db, s > 0 || kk > 0);
        }
        hp::wgmma_commit();
        hp::fence_regs(acc[0]);
        hp::fence_regs(acc[1]);
        hp::wgmma_wait<1>();  // the previous slab's products are done: free its stage
        if (s > 0 && threadIdx.x % 128 == 0) hp::mbar_arrive(&empty[(it - 1) % kStages]);
      }
      hp::wgmma_wait<0>();
      hp::fence_regs(acc[0]);
      hp::fence_regs(acc[1]);
      if (threadIdx.x % 128 == 0) hp::mbar_arrive(&empty[(it - 1) % kStages]);

      const float* bias = mat == 0 ? bq : (mat == 1 ? bk : bv);
      bf16* out = mat == 0 ? q : (mat == 1 ? k : v);
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int col = col0 + j * 8 + 2 * t;
        const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = row0 + wg * 128 + mi * 64 + warp * 16 + g + half * 8;
            if (row < rows)
              *reinterpret_cast<uint32_t*>(out + (size_t)row * width + col) =
                  clipk::pack_bf16(__float2bfloat16(acc[mi][4 * j + 2 * half] + b0),
                                   __float2bfloat16(acc[mi][4 * j + 2 * half + 1] + b1));
          }
      }
    }
  }
}

// xn: [rows, width] bf16; the weights [width, width] bf16 row-major.
int launch(const void* xn, const void* wq, const void* wk, const void* wv, const void* bq,
           const void* bk, const void* bv, void* q, void* k, void* v, int rows, int width,
           cudaStream_t stream) {
  CUtensorMap xmap, wmaps[3];
  const cuuint64_t xdims[2] = {(cuuint64_t)width, (cuuint64_t)rows};
  const cuuint64_t wdims[2] = {(cuuint64_t)width, (cuuint64_t)width};
  const cuuint64_t stride[1] = {(cuuint64_t)width * 2};
  const cuuint32_t xbox[2] = {kBK, kBM}, wbox[2] = {64, kBK};
  if (!clipk::hopper::bf16_map(&xmap, xn, 2, xdims, stride, xbox, true))
    return (int)cudaErrorInvalidValue;
  const void* ws[3] = {wq, wk, wv};
  for (int i = 0; i < 3; ++i)
    if (!clipk::hopper::bf16_map(&wmaps[i], ws[i], 2, wdims, stride, wbox, true))
      return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(qkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const int tiles = 3 * (width / kBN) * ((rows + kBM - 1) / kBM);
  qkv_kernel<<<tiles < sms ? tiles : sms, kThreads, kSmem, stream>>>(
      xmap, wmaps[0], wmaps[1], wmaps[2], static_cast<const float*>(bq),
      static_cast<const float*>(bk), static_cast<const float*>(bv), static_cast<bf16*>(q),
      static_cast<bf16*>(k), static_cast<bf16*>(v), rows, width);
  return (int)cudaGetLastError();
}

}  // namespace tma

template <typename T>
int launch_ln(const void* x, void* xn, const void* gamma, const void* beta, int rows, int width,
              float eps, cudaStream_t stream) {
  ln_kernel<T><<<(rows + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<T*>(xn), rows, width, eps);
  return (int)cudaGetLastError();
}

template <typename T, int BM, int BN>
int launch(const void* x, void* xn, const void* gamma, const void* beta, const void* wq,
           const void* wk, const void* wv, const void* bq, const void* bk, const void* bv,
           void* q, void* k, void* v, int rows, int width, float eps, cudaStream_t stream) {
  cudaError_t err = (cudaError_t)launch_ln<T>(x, xn, gamma, beta, rows, width, eps, stream);
  if (err != cudaSuccess) return (int)err;
  if constexpr (std::is_same<T, bf16>::value && BM == tma::kBM && BN == tma::kBN) {
    return tma::launch(xn, wq, wk, wv, bq, bk, bv, q, k, v, rows, width, stream);
  } else {
    using L = Layout<T, BM, BN>;
    auto kern = qkv_gemm_kernel<T, BM, BN>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)L::kBytes);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(3 * (width / BN), (rows + BM - 1) / BM);
    kern<<<grid, kThreads, L::kBytes, stream>>>(
        static_cast<const T*>(xn), static_cast<const T*>(wq), static_cast<const T*>(wk),
        static_cast<const T*>(wv), static_cast<const float*>(bq), static_cast<const float*>(bk),
        static_cast<const float*>(bv), static_cast<T*>(q), static_cast<T*>(k),
        static_cast<T*>(v), rows, width);
    return (int)cudaGetLastError();
  }
}

}  // namespace
}  // namespace CLIPK_SOURCE

using namespace CLIPK_SOURCE;

// dtype: 0 = float32, 1 = bfloat16. Tiles (bm, bn): bf16 (256, 128), the
// TMA + wgmma kernel (x, xn and the weights 16-byte aligned), or (64, 64),
// the mma.sync one; f32 (64, 64). width % bn == 0. xn:
// scratch shaped like x, for the normalized rows. gamma and beta 16-byte
// aligned. Returns cudaGetLastError().
extern "C" int ln_qkv_launch(const void* x, void* xn, const void* gamma, const void* beta,
                             const void* wq, const void* wk, const void* wv, const void* bq,
                             const void* bk, const void* bv, void* q, void* k, void* v,
                             int rows, int width, float eps, int dtype, int bm, int bn,
                             void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (width % bn != 0) return (int)cudaErrorInvalidValue;
#define CLIPK_LNQKV(T, BM, BN)                                                                 \
  if (bm == BM && bn == BN)                                                                    \
    return launch<T, BM, BN>(x, xn, gamma, beta, wq, wk, wv, bq, bk, bv, q, k, v, rows, width, \
                             eps, s);
  if (dtype == 1) {
    CLIPK_LNQKV(bf16, 256, 128)
    CLIPK_LNQKV(bf16, 64, 64)
  } else if (dtype == 0) {
    CLIPK_LNQKV(float, 64, 64)
  }
#undef CLIPK_LNQKV
  return (int)cudaErrorInvalidValue;
}
