// The s8 TMA + wgmma product of the int8 kernels for Hopper (sm_90a), the
// port's one int8 product: int8_mlp.cu and int8_mlp_streamed.cu run both of
// their products on it, ln_qkv_int8.cu and int8_linear.cu their one.
//
// C[rows, N] = A[rows, K] · Wᵀ: A the row pass's int8 codes, W a quantized
// weight in its K-major storage ([N, K], each output column's K bytes
// contiguous, `ops/quant.py`). The integer wgmma takes both operands
// K-major from shared memory (it has no transpose), which is that layout as
// it is stored: no copy, no transposition in registers. kOut takes up to
// three weights over one A (ln_qkv_int8's q, k and v), each with its own
// tensor map, scales, bias and output.
//
// The block is three warpgroups on a persistent grid (one block per SM,
// walking output tiles columns-fastest across all the weights, so that the
// tiles in flight share their rows of A and the weights stay in L2).
// Warpgroup 2 is the producer: one thread keeps TMA loads in flight through
// a ring of 128-byte K boxes (full/empty mbarriers; 4 to 6 stages, 192 KB),
// running ahead into the next tile while the consumers finish one: A's box
// [kBM rows x 128 bytes] and W's [128 columns x 128 bytes], both with the
// 128-byte swizzle. TMA zero-fills rows, columns and K past the ends, so a
// ragged edge needs no code in the loop. Warpgroups 0 and 1 run per box 4
// k32 steps of wgmma m64n128k32 (s8 x s8 -> s32) for each of their m64
// tiles, the step advancing both descriptors by 32 bytes inside the swizzle
// row; one box's group stays in flight while the next is issued, and a
// box's stage is released when the group after it has been issued and its
// own completes. kOut and kSlab split each tile between the two warpgroups
// (256 and 128 rows); kAct runs them in ping-pong on 128-row tiles of their
// own, so that one's epilogue (the activation, the f32 hidden's stores)
// overlaps the other's products. Ping-pong measured slower for kOut (at K =
// 4304 and at K = 1152) and kSlab (smaller tiles, more operand traffic) and
// 3% faster for kAct.
//
// The int32 sums are exact, so the numerics live in the epilogues, which
// keep the TPU kernels' order of operations:
// - kAct (fc1): h = act(acc * (xs * s1) + b1) in f32, written as the f32
//   hidden; the same epilogue reduces each row's |h| over its 128 columns
//   and atomicMax-es it, as the int bits of a non-negative float (which
//   order like the floats), into amax[row, slab] (zeroed on the stream
//   before the launch; a 128-column tile never straddles a slab, whose
//   width is a multiple of 128). The requantization pass then reads the
//   hidden once, for its codes (int8.cuh kGivenAmax). Max is exact in any
//   order, so the scales are the plain version's. The activation is a
//   template argument and branch-free (int8.cuh `rcp_rn`): unrolled over a
//   thread's 128 values, a runtime switch or a branch per value cut the
//   epilogue into one basic block per value, and fc1 at PE-Core-bigG's
//   shape took 5.5 ms instead of 1.5.
// - kOut (the resident MLP's fc2, ln_qkv_int8, int8_linear_fused): acc *
//   (xs * s) + b [+ residual] in f32, one rounding to the output type.
// - kSlab (the streamed MLP's fc2): K runs in slabs of `chunk` (a multiple
//   of the 128-byte box); at each slab's end the s32 accumulators fold into
//   an f32 sum as part * (as_j * s2), in slab order, and the next slab's
//   first wgmma restarts them with scale-d = 0; after the last, + b2 [+ x]
//   and one rounding. The f32 sum doubles the accumulator registers, so a
//   kSlab warpgroup holds one m64 tile where kOut's and kAct's hold two.
// A thread's accumulators hold column pairs. f32 outputs (kAct's hidden,
// f32 activations) are stored from the registers, 8 bytes a pair. A bf16
// output would be 4-byte pieces, so kOut and kSlab stage it: each consumer
// warp writes its 16 rows x 128 columns of an m64 tile into 4 KB of its own
// shared memory (16-byte chunks XOR-swizzled by row, so the pair writes hit
// 32 banks), which it then stores with 16-byte writes, two rows of 256
// bytes a warp instruction. The residual comes in the same way first, a
// lane's 8 loads issued together into registers (the next m64 tile's while
// this one's epilogue runs), and the epilogue adds it in place. Against
// pair stores this took kernel 6 (int8_linear_fused) from 0.18 to 0.135 ms
// and kernel 4's fc2 from 0.31 to 0.26 on one H100 (PERF.md).

#pragma once

#include "hopper.cuh"
#include "int8.cuh"

namespace clipk {
inline namespace CLIPK_SOURCE {
namespace i8w {

using hopper::desc;
using hopper::kSwizzle128;

enum Mode { kOut = 0, kAct = 1, kSlab = 2 };

constexpr int kBK = 128;  // K box: 128 bytes, the swizzle's row
constexpr int kBN = 128;  // output columns per tile
constexpr int kThreads = 384;  // consumer warpgroups 0 and 1, producer 2
constexpr int kMaxMats = 3;    // weights over one A (kOut)

// kAct runs its two consumer warpgroups in ping-pong, each on its own tile,
// so that one's epilogue (the activation) overlaps the other's products;
// kOut and kSlab split each tile between them, and stage a bf16 output.
template <typename OutT, int kMode>
struct Tile {
  static constexpr bool kPingPong = kMode == kAct;
  static constexpr bool kStaged = kMode != kAct && sizeof(OutT) == 2;
  static_assert(kStaged || sizeof(OutT) == 4, "a bf16 output is staged; kAct writes f32");
  static constexpr int kMT = kMode == kSlab ? 1 : 2;  // m64 tiles per consumer warpgroup
  static constexpr int kBM = (kPingPong ? 1 : 2) * 64 * kMT;  // rows of a tile
  static constexpr uint32_t kABytes = kBM * kBK, kBBytes = kBN * kBK;
  static constexpr int kStages = 192 * 1024 / (kABytes + kBBytes);  // 4 (kOut), else 6
  static constexpr uint32_t kWarpStage = 16 * kBN * 2;  // a warp's 16 bf16 rows
  static constexpr uint32_t kStageBytes = kStaged ? 8 * kWarpStage : 0;
  static constexpr size_t kSmem =
      1024 + kStages * (kABytes + kBBytes) + kStageBytes + 2 * kStages * 8;
  static_assert(kSmem <= 232448, "over the 227 KB a block may use");
};

struct Out {        // one weight's epilogue operands
  const float* s;   // [N] weight scales
  const float* b;   // [N] bias
  void* out;        // [rows, N]: the output type, f32 for kAct
};

struct Args {
  const float* xs;     // A's row scales: [rows] (kOut, kAct) or [rows, slabs] (kSlab)
  Out o[kMaxMats];     // per weight: mats of them
  int mats;            // weights over A: up to kMaxMats for kOut, else 1
  const void* res;     // [rows, N] residual in the output type, or null (kOut, kSlab; one weight)
  float* amax;         // kAct: [rows, N / chunk rounded up], zeroed before the launch
  int rows, K, N;      // N: each weight's output columns
  int chunk;  // kSlab: K per slab; kAct: output columns per amax slab
  int act;    // kAct: 0 gelu_tanh, 1 gelu, 2 quick_gelu, 3 relu
  int lda, ldw;  // row strides in bytes of A and of the weights (0: K), multiples of 16
  int ldo;       // row stride in elements of the outputs and the residual (0: N)
};

// kActFn: kAct's activation (i8::activate), -1 for the other modes. wmap0..2:
// the weights' tensor maps (as many as args.mats; three parameters, selected,
// not indexed: a runtime index into a kernel parameter would copy it to
// local memory).
template <typename OutT, int kMode, int kActFn>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap amap,
                const __grid_constant__ CUtensorMap wmap0,
                const __grid_constant__ CUtensorMap wmap1,
                const __grid_constant__ CUtensorMap wmap2, const Args args) {
  namespace hp = clipk::hopper;
  using L = Tile<OutT, kMode>;
  constexpr int kMT = L::kMT, kBM = L::kBM, kStages = L::kStages;
  constexpr bool kPP = L::kPingPong;
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: boxes start on such a boundary
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* as = smem;                         // [kStages][kBM][128] s8, swizzled
  unsigned char* bs = smem + kStages * L::kABytes;  // [kStages][kBN][128] s8, swizzled
  unsigned char* stage = bs + kStages * L::kBBytes;  // kStaged: [8 warps][16][256 bytes]
  uint64_t* full = reinterpret_cast<uint64_t*>(stage + L::kStageBytes);
  uint64_t* empty = full + kStages;

  const int rows = args.rows, N = args.N;
  const int tiles_n = (N + kBN - 1) / kBN;
  const int n_col = args.mats * tiles_n;  // column tiles over all the weights
  const int n_tiles = n_col * ((rows + kBM - 1) / kBM);
  const int n_local = (n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int boxes = (args.K + kBK - 1) / kBK;
  // boxes per run of the accumulators: a slab's for kSlab, all of K otherwise
  const int per_run = kMode == kSlab ? args.chunk / kBK : boxes;
  const int wg = threadIdx.x / 128;
  // tile -> (weight, first column, first row): columns fastest
  auto tile_at = [&](int lt, int& mat, int& col0, int& row0) {
    const int tile = blockIdx.x + lt * gridDim.x, c = tile % n_col;
    mat = c / tiles_n;
    col0 = (c - mat * tiles_n) * kBN;
    row0 = tile / n_col * kBM;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], kPP ? 1 : 2);  // one arrival per warpgroup reading the box
    }
    hp::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer
    hp::regs_dealloc<40>();
    if (threadIdx.x == 256) {
      hp::prefetch_map(&amap);
      hp::prefetch_map(&wmap0);
      if (args.mats > 1) hp::prefetch_map(&wmap1);
      if (args.mats > 2) hp::prefetch_map(&wmap2);
      int it = 0;  // boxes issued so far, over every tile of this block
      for (int lt = 0; lt < n_local; ++lt) {
        int mat, col0, row0;
        tile_at(lt, mat, col0, row0);
        const CUtensorMap* wmap = mat == 0 ? &wmap0 : (mat == 1 ? &wmap1 : &wmap2);
        for (int s = 0; s < boxes; ++s, ++it) {
          const int st = it % kStages;
          if (it >= kStages) hp::mbar_wait(&empty[st], ((it / kStages) - 1) & 1);
          hp::mbar_expect_tx(&full[st], L::kABytes + L::kBBytes);
          hp::tma_load_2d(as + st * L::kABytes, &amap, &full[st], s * kBK, row0);
          hp::tma_load_2d(bs + st * L::kBBytes, wmap, &full[st], s * kBK, col0);
        }
      }
    }
    return;
  }

  // consumers: rows wg * kBM / 2 + [0, kBM / 2) of each of this block's
  // tiles lt; or, in ping-pong, all rows of tiles lt = wg, wg + 2, ..., whose
  // products start when those of tile lt - 1 (the other warpgroup's) have
  // finished (named barrier 1 + wg): one warpgroup's epilogue runs while the
  // other's products do, and neither waits on the ring more than one phase
  // ahead
  hp::regs_alloc<232>();
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  const int g = lane / 4, t = lane % 4;
  // acc[mi][4j + 2h + e]: row r0 + 64mi + 8h, column col0 + 8j + 2t + e
  int acc[kMT][kBN / 2];
  float facc[kMode == kSlab ? kMT : 1][kMode == kSlab ? kBN / 2 : 1];  // kSlab's f32 sum
  const int a_off = kPP ? 0 : wg * (kBM / 2);  // the warpgroup's first row in a tile
  for (int lt = kPP ? wg : 0; lt < n_local; lt += kPP ? 2 : 1) {
    int mat, col0, row0;
    tile_at(lt, mat, col0, row0);
    const int r0 = row0 + a_off + warp * 16 + g;
    int it = lt * boxes;
    if (kPP && lt > 0) hp::named_sync(1 + wg, 256);
    if constexpr (kMode == kSlab) {
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
        for (int i = 0; i < kBN / 2; ++i) facc[mi][i] = 0.0f;
    }
    for (int s0 = 0; s0 < boxes; s0 += per_run) {
      const int s1 = min(boxes, s0 + per_run);
      for (int s = s0; s < s1; ++s, ++it) {
        const int st = it % kStages;
        hp::mbar_wait(&full[st], (it / kStages) & 1);
        const unsigned char* a = as + st * L::kABytes + a_off * kBK;
        const unsigned char* b = bs + st * L::kBBytes;
#pragma unroll
        for (int mi = 0; mi < kMT; ++mi) hp::fence_regs(acc[mi]);
        hp::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 32; ++kk) {
          const uint64_t db = desc(b + kk * 32, 16, 1024, kSwizzle128);
#pragma unroll
          for (int mi = 0; mi < kMT; ++mi)  // A: 64 rows (8 KB) on, 32 bytes of K on
            clipk::WgmmaS8<kBN>::run(acc[mi], desc(a + mi * 8192 + kk * 32, 16, 1024, kSwizzle128),
                                     db, s > s0 || kk > 0);
        }
        hp::wgmma_commit();
#pragma unroll
        for (int mi = 0; mi < kMT; ++mi) hp::fence_regs(acc[mi]);
        hp::wgmma_wait<1>();  // the previous box's products are done: free its stage
        if (s > s0 && threadIdx.x % 128 == 0) hp::mbar_arrive(&empty[(it - 1) % kStages]);
      }
      hp::wgmma_wait<0>();
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi) hp::fence_regs(acc[mi]);
      if (threadIdx.x % 128 == 0) hp::mbar_arrive(&empty[(it - 1) % kStages]);

      if constexpr (kMode == kSlab) {  // fold slab j: facc += part * (as_j * s2)
        const int j = s0 / per_run, n_slabs = (boxes + per_run - 1) / per_run;
        float ar[kMT][2];
#pragma unroll
        for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = r0 + 64 * mi + 8 * h;
            ar[mi][h] = row < rows ? args.xs[(size_t)row * n_slabs + j] : 0.0f;
          }
#pragma unroll
        for (int jj = 0; jj < kBN / 8; ++jj) {
          const int col = col0 + 8 * jj + 2 * t;
          const float2 sc = col < N ? *reinterpret_cast<const float2*>(args.o[0].s + col)
                                    : make_float2(0.0f, 0.0f);
#pragma unroll
          for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                float& f = facc[mi][4 * jj + 2 * h + e];
                f = __fadd_rn(f, __fmul_rn(__int2float_rn(acc[mi][4 * jj + 2 * h + e]),
                                           __fmul_rn(ar[mi][h], e ? sc.y : sc.x)));
              }
        }
      }
    }

    if (kPP && lt + 1 < n_local) hp::named_arrive(1 + (wg ^ 1), 256);  // tile lt + 1's products

    // the epilogue
    const Out o = mat == 0 ? args.o[0] : (mat == 1 ? args.o[1] : args.o[2]);
    float xr[kMT][2];  // kOut, kAct: the rows' scales
    float am[kMT][2];  // kAct: the rows' |h| max over this thread's columns
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + 64 * mi + 8 * h;
        xr[mi][h] = kMode != kSlab && row < rows ? args.xs[row] : 0.0f;
        am[mi][h] = 0.0f;
      }
    // columns (col, col + 1) of a [N] scale or bias vector, col even: kOut
    // may take an odd N, whose last pair has one column (the other is 0)
    auto pair_of = [&](const float* v, int col) {
      if constexpr (kMode == kOut)
        return col + 1 < N ? *reinterpret_cast<const float2*>(v + col)
                           : make_float2(v[col], 0.0f);
      else
        return *reinterpret_cast<const float2*>(v + col);
    };
    // (v0, v1) = columns (col, col + 1) of accumulator row (mi, h), i = 4jj + 2h, before the residual
    auto dequant = [&](int mi, int h, int i, float2 sc, float2 bi, float& v0, float& v1) {
      if constexpr (kMode == kSlab) {
        v0 = facc[mi][i];
        v1 = facc[mi][i + 1];
      } else {
        v0 = __fmul_rn(__int2float_rn(acc[mi][i]), __fmul_rn(xr[mi][h], sc.x));
        v1 = __fmul_rn(__int2float_rn(acc[mi][i + 1]), __fmul_rn(xr[mi][h], sc.y));
      }
      v0 = __fadd_rn(v0, bi.x);
      v1 = __fadd_rn(v1, bi.y);
    };
    if constexpr (L::kStaged) {
      // this warp's 16 rows of m64 tile mi at a time: 16-byte chunk c (8
      // columns) of row r at r * 256 + (c ^ (r & 7)) * 16 of its 4 KB; lane
      // l moves chunks (2k + l / 16, l % 16), k = 0..7: two rows of 256
      // bytes a warp instruction
      unsigned char* ws = stage + (threadIdx.x / 32) * L::kWarpStage;
      auto chunk_at = [&](int r, int c) { return ws + r * 256 + ((c ^ (r & 7)) << 4); };
      const bf16* res = static_cast<const bf16*>(args.res);
      bf16* out = static_cast<bf16*>(o.out);
      const int c = lane % 16;
      // a chunk that starts before N is written whole: its columns past N
      // (an N that is no multiple of 8) land in the row's padding up to ldo
      const bool col_in = col0 + 8 * c < N;
      const size_t ldo = args.ldo;
      // the residual of tile mi, all 8 loads in flight at once (a load after
      // a store to shared memory, which might alias it, would wait for it)
      uint4 rv[8];
      auto load_res = [&](int mi) {
        const int wrow = row0 + a_off + warp * 16 + 64 * mi;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int row = wrow + 2 * k + lane / 16;
          rv[k] = row < rows && col_in
                      ? *reinterpret_cast<const uint4*>(res + row * ldo + col0 + 8 * c)
                      : make_uint4(0, 0, 0, 0);
        }
      };
      if (res != nullptr) load_res(0);
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi) {
        const int wrow = row0 + a_off + warp * 16 + 64 * mi;  // the warp's first row
        if (res != nullptr) {
#pragma unroll
          for (int k = 0; k < 8; ++k)
            *reinterpret_cast<uint4*>(chunk_at(2 * k + lane / 16, c)) = rv[k];
          __syncwarp();
          if (mi + 1 < kMT) load_res(mi + 1);  // in flight under this tile's epilogue
        }
#pragma unroll
        for (int jj = 0; jj < kBN / 8; ++jj) {
          const int col = col0 + 8 * jj + 2 * t;
          if (col >= N) continue;
          const float2 sc = pair_of(o.s, col), bi = pair_of(o.b, col);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float v0, v1;
            dequant(mi, h, 4 * jj + 2 * h, sc, bi, v0, v1);
            __nv_bfloat162* p =
                reinterpret_cast<__nv_bfloat162*>(chunk_at(g + 8 * h, jj) + 4 * t);
            if (res != nullptr) {
              const float2 r = __bfloat1622float2(*p);
              v0 = __fadd_rn(v0, r.x);
              v1 = __fadd_rn(v1, r.y);
            }
            *p = __floats2bfloat162_rn(v0, v1);
          }
        }
        __syncwarp();
        uint4 ov[8];
#pragma unroll
        for (int k = 0; k < 8; ++k)
          ov[k] = *reinterpret_cast<const uint4*>(chunk_at(2 * k + lane / 16, c));
        __syncwarp();  // read out before the next m64 tile's writes
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int row = wrow + 2 * k + lane / 16;
          if (row < rows && col_in)
            *reinterpret_cast<uint4*>(out + row * ldo + col0 + 8 * c) = ov[k];
        }
      }
    } else {  // f32 out: pairs straight from the registers
#pragma unroll
      for (int jj = 0; jj < kBN / 8; ++jj) {
        const int col = col0 + 8 * jj + 2 * t;
        if (col >= N) continue;  // an odd N's last pair writes its second column into the padding
        const float2 sc = pair_of(o.s, col), bi = pair_of(o.b, col);
#pragma unroll
        for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = r0 + 64 * mi + 8 * h;
            if (row >= rows) continue;
            float v0, v1;
            dequant(mi, h, 4 * jj + 2 * h, sc, bi, v0, v1);
            const size_t off = (size_t)row * args.ldo + col;
            if constexpr (kMode == kAct) {
              v0 = i8::activate<kActFn>(v0);
              v1 = i8::activate<kActFn>(v1);
              am[mi][h] = fmaxf(am[mi][h], fmaxf(fabsf(v0), fabsf(v1)));
            } else if (args.res != nullptr) {
              const float2 r = *reinterpret_cast<const float2*>(
                  static_cast<const float*>(args.res) + off);
              v0 = __fadd_rn(v0, r.x);
              v1 = __fadd_rn(v1, r.y);
            }
            *reinterpret_cast<float2*>(static_cast<float*>(o.out) + off) = make_float2(v0, v1);
          }
      }
    }
    if constexpr (kMode == kAct) {  // the 4 threads of a row pool their maxima, one atomic a row
      const int slabs = (N + args.chunk - 1) / args.chunk, slab = col0 / args.chunk;
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float m = am[mi][h];
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
          const int row = r0 + 64 * mi + 8 * h;
          if (t == 0 && row < rows)
            atomicMax(reinterpret_cast<int*>(args.amax) + (size_t)row * slabs + slab,
                      __float_as_int(m));
        }
    }
  }
}

// a: [rows, K] int8 codes, rows args.lda bytes apart; w[0 .. args.mats):
// [N, K] int8 (the K-major storage), rows args.ldw bytes apart; all 16-byte
// aligned, the strides multiples of 16 (TMA's rule; 0 takes K). K itself
// may be any width: TMA zero-fills the boxes past it. N % 16 == 0, except
// for kOut, which takes any N with outputs (and the residual) ldo elements
// apart, ldo >= N and a multiple of 8 (0 takes N), so that their 16-byte
// and pair stores stay aligned. A tensor map that fails to encode, or a
// refused launch, returns its error.
template <typename OutT, int kMode, int kActFn>
cudaError_t launch_gemm_act(const void* a, const void* const* w, const Args& args_in,
                            cudaStream_t stream) {
  using L = Tile<OutT, kMode>;
  Args args = args_in;
  if (args.lda == 0) args.lda = args.K;
  if (args.ldw == 0) args.ldw = args.K;
  if (args.ldo == 0) args.ldo = args.N;
  if (args.mats < 1 || args.mats > (kMode == kOut ? kMaxMats : 1) ||
      (args.mats > 1 && args.res != nullptr) || args.K <= 0 || args.N <= 0 ||
      args.lda < args.K || args.ldw < args.K || args.lda % 16 || args.ldw % 16 ||
      args.ldo < args.N || args.ldo % 8 || (kMode != kOut && args.N % 16))
    return cudaErrorInvalidValue;
  if (args.rows <= 0) return cudaSuccess;
  CUtensorMap amap, wmap[kMaxMats];
  const cuuint64_t adims[2] = {(cuuint64_t)args.K, (cuuint64_t)args.rows};
  const cuuint64_t wdims[2] = {(cuuint64_t)args.K, (cuuint64_t)args.N};
  const cuuint64_t astride[1] = {(cuuint64_t)args.lda}, wstride[1] = {(cuuint64_t)args.ldw};
  const cuuint32_t abox[2] = {kBK, L::kBM}, wbox[2] = {kBK, kBN};
  if (!hopper::tiled_map(&amap, CU_TENSOR_MAP_DATA_TYPE_UINT8, a, 2, adims, astride, abox, true))
    return cudaErrorInvalidValue;
  for (int i = 0; i < kMaxMats; ++i) {
    if (i >= args.mats)
      wmap[i] = wmap[0];  // not read
    else if (!hopper::tiled_map(&wmap[i], CU_TENSOR_MAP_DATA_TYPE_UINT8, w[i], 2, wdims,
                                wstride, wbox, true))
      return cudaErrorInvalidValue;
  }
  auto kern = gemm_kernel<OutT, kMode, kActFn>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kSmem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  const int tiles =
      args.mats * ((args.N + kBN - 1) / kBN) * ((args.rows + L::kBM - 1) / L::kBM);
  kern<<<tiles < sms ? tiles : sms, kThreads, L::kSmem, stream>>>(amap, wmap[0], wmap[1],
                                                                   wmap[2], args);
  return cudaGetLastError();
}

// kAct takes its activation as a template argument (args.act picks it).
template <typename OutT, int kMode>
cudaError_t launch_gemm(const void* a, const void* const* w, const Args& args,
                        cudaStream_t stream) {
  if constexpr (kMode != kAct) {
    return launch_gemm_act<OutT, kMode, -1>(a, w, args, stream);
  } else {
    switch (args.act) {
      case 0:
        return launch_gemm_act<OutT, kMode, 0>(a, w, args, stream);
      case 1:
        return launch_gemm_act<OutT, kMode, 1>(a, w, args, stream);
      case 2:
        return launch_gemm_act<OutT, kMode, 2>(a, w, args, stream);
      case 3:
        return launch_gemm_act<OutT, kMode, 3>(a, w, args, stream);
      default:
        return cudaErrorInvalidValue;
    }
  }
}

}  // namespace i8w
}  // namespace CLIPK_SOURCE
}  // namespace clipk
