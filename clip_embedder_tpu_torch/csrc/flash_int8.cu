// Packed-head self-attention with int8 products for Hopper (sm_90a): kernel
// 2's quant_qk and quant_pv options.
//
// Replaces the TPU kernel clip_embedder_tpu/ops/flash.py
// `flash_attention_packed` (`_packed_kernel`) called with `quant_qk` and/or
// `quant_pv`. Per head, on q/k/v in the [B, S, H*D] projection layout (after
// rope, where tables are given):
// - quant_qk: q*scale rounded to the input type, then per row int8 codes
//   round(x / s) clipped to +-127, s = amax/127 (1 where the amax is 0); k
//   with one such scale for the (batch, head) slab; q.k^T in int32. Without
//   a mask and without `fast` the row max is taken on the int32 products
//   and p = exp(f32(acc - max) * sq * sk); otherwise the logits are
//   f32(acc) * sq * sk (+ mask) and the softmax is flash.cuh's.
// - quant_pv: the denominator is the f32 sum of p; p per row with s =
//   rowmax(p)/127 and codes in [0, 127] (under exp_bf16 p, s and p/s are
//   bf16, as JAX's weak-typed scalars keep them), v per column over the
//   head's S rows; out = f32(pq.vq) * (s_p * s_v) / denominator.
// The half that is not quantized stays the input type's product, as in the
// JAX kernel: bf16 wgmma (f32 accumulators), or f32 FMA for f32 inputs.
//
// What bounds it on the H100: the same work as the exact kernel (4*S*D
// operations per query row per head, S*S exps per head), with the
// quantized product at the int8 tensor-core rate (twice bf16's), plus the
// codes: a pre-pass reads q, k and v once more and writes 1 byte an element
// of each operand it quantizes, which the attention reads back (the
// int8 scratch of q and k is read once per query tile, like K and V). At
// SO400M's shape (S = 576, D = 72) memory bounds it, as it bounds the exact
// kernel; the s8 product halves a bound that is not the binding one.
//
// What the design does about that: first a simple and exact design, to
// measure whether the card's s8 tensor cores pay at attention's sizes (the
// TPU kernel measured 2.2x slower for quant_pv and 0.64-0.81x for quant_qk,
// for reasons of the TPU's vector unit). A pre-pass of two launches over
// (batch*head, 64-row chunks) writes the codes with their scales into
// scratch: `quant_rows` q's codes (a row's scale is its own) and the k and v
// maxima (atomicMax), `quant_cols` the k and v codes from them; q and k as
// [S64][D32] rows (S and D zero-padded to 64 and 32), v transposed to
// [D32][S64], since Hopper's s8 wgmma reads both operands K-major only. The
// attention kernel (`attn_kernel`) gives one warpgroup of 128 threads a
// (batch*head, 64 query rows) tile; K and V tiles of 64 keys stream through
// a 2-stage cp.async ring into no-swizzle core-matrix layouts; q.k^T runs on
// wgmma m64n64k32 s8 (or bf16 m64n64k16, or FMA) into registers, the
// softmax runs there in the wgmma accumulator layout, and p.v runs on wgmma
// m64nDk32 s8 with the p codes staged through shared memory (the s32
// accumulator layout is not s8's A-fragment layout, and s8 has no
// transposed operand), or on bf16 wgmma with p straight from registers, or
// FMA. The exact softmax keeps its two passes; with quant_pv the first pass
// also gives the row max of p (p is monotone in the logit), so `fast` takes
// two passes there. Not yet done: TMA and warp specialisation, the products
// in flight during the softmax, and the code pass fused into the projection.

#include "flash.cuh"
#include "flash_int8.cuh"

namespace clipk {
inline namespace CLIPK_SOURCE {
namespace flash8 {

namespace hp = hopper;
using flash::Attn;

constexpr int kQ = 64;  // query rows a block
constexpr int kK = 64;  // keys a tile
constexpr int kThreads = 128;

// The scratch the pre-pass writes (s64 = S rounded up to 64, dp = D rounded
// up to 32; rows and columns past S and D are zero codes). The k and v
// maxima are f32 bits (>= 0, so they order as unsigned ints), zeroed by the
// caller and taken with atomicMax; a scale is scale_of(max).
struct Codes {
  int8_t* qc;          // [B*H][s64][dp]
  float* qsc;          // [B*H][s64]
  int8_t* kc;          // [B*H][s64][dp]
  unsigned int* kmax;  // [B*H]: |k| over the head's [S, D] slab
  int8_t* vt;          // [B*H][dp][s64]: v's codes transposed
  unsigned int* vmax;  // [B*H][dp]: |v| over each column's S rows
  int s64, dp;
};

// (code() and scale_of(), which make every code and scale: flash_int8.cuh)

// ---------------------------------------------------------------------------
// pre-pass: two launches over (batch*head, 64-row chunks), 256 threads
// ---------------------------------------------------------------------------

// 1: q's codes and row scales (a row's own), the k and v maxima of the
// chunk's rows into Codes' atomics.
template <typename T>
__global__ void __launch_bounds__(256)
    quant_rows(const T* __restrict__ qp, const T* __restrict__ kp, const T* __restrict__ vp,
               const Attn a, const Codes c, int quant_qk, int quant_pv) {
  __shared__ unsigned int colmax[flash::kMaxDP];
  __shared__ unsigned int kblock;
  const int bh = blockIdx.x, b = bh / a.heads, h = bh % a.heads, r0 = blockIdx.y * 64;
  const size_t base = (size_t)b * a.batch_stride + (size_t)h * a.head_stride;
  const size_t ld = a.row_stride;
  const int seq = a.seq, d = a.d, s64 = c.s64, dp = c.dp;
  const int rows = min(64, seq - r0);  // (>= 0: a chunk past S has none)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x < flash::kMaxDP) colmax[threadIdx.x] = 0u;
  if (threadIdx.x == 0) kblock = 0u;
  __syncthreads();
  if (quant_qk) {
    // q, a warp a row: the scale folded in and rounded to T, then the row's scale
    const T* q = qp + base;
    for (int r = r0 + warp; r < r0 + 64; r += 8) {
      float x[flash::kMaxDP / 32];
      float amax = 0.0f;
#pragma unroll
      for (int i = 0; i < flash::kMaxDP / 32; ++i) {
        const int j = lane + 32 * i;
        x[i] = r < seq && j < d ? to_f(from_f<T>(to_f(q[(size_t)r * ld + j]) * a.scale)) : 0.0f;
        amax = fmaxf(amax, fabsf(x[i]));
      }
      const float s = scale_of(warp_max(amax));
      if (lane == 0) c.qsc[(size_t)bh * s64 + r] = s;
      int8_t* dst = c.qc + ((size_t)bh * s64 + r) * dp;
#pragma unroll
      for (int i = 0; i < flash::kMaxDP / 32; ++i)
        if (lane + 32 * i < dp) dst[lane + 32 * i] = code(x[i], s, -127.0f);
    }
    const T* k = kp + base;
    float amax = 0.0f;
    for (int i = threadIdx.x; i < rows * d; i += 256)
      amax = fmaxf(amax, fabsf(to_f(k[(size_t)(r0 + i / d) * ld + i % d])));
    amax = warp_max(amax);
    if (lane == 0) atomicMax(&kblock, __float_as_uint(amax));
  }
  if (quant_pv) {
    const T* v = vp + base;
    for (int i = threadIdx.x; i < rows * d; i += 256)
      atomicMax(&colmax[i % d], __float_as_uint(fabsf(to_f(v[(size_t)(r0 + i / d) * ld + i % d]))));
  }
  __syncthreads();
  if (quant_qk && threadIdx.x == 0) atomicMax(c.kmax + bh, kblock);
  if (quant_pv && threadIdx.x < d) atomicMax(c.vmax + (size_t)bh * dp + threadIdx.x,
                                             colmax[threadIdx.x]);
}

// 2: the chunk's k codes and v codes (transposed), from the maxima.
template <typename T>
__global__ void __launch_bounds__(256)
    quant_cols(const T* __restrict__ kp, const T* __restrict__ vp, const Attn a, const Codes c,
               int quant_qk, int quant_pv) {
  __shared__ __align__(16) int8_t tile[flash::kMaxDP * 64];  // v's codes, transposed
  __shared__ float vs[flash::kMaxDP];
  const int bh = blockIdx.x, b = bh / a.heads, h = bh % a.heads, r0 = blockIdx.y * 64;
  const size_t base = (size_t)b * a.batch_stride + (size_t)h * a.head_stride;
  const size_t ld = a.row_stride;
  const int seq = a.seq, d = a.d, s64 = c.s64, dp = c.dp;
  if (quant_qk) {
    const T* k = kp + base;
    const float ks = scale_of(c.kmax[bh]);
    int8_t* dst = c.kc + ((size_t)bh * s64 + r0) * dp;
    for (int i = threadIdx.x; i < 64 * dp; i += 256) {
      const int r = r0 + i / dp, j = i % dp;
      dst[i] = r < seq && j < d ? code(to_f(k[(size_t)r * ld + j]), ks, -127.0f) : (int8_t)0;
    }
  }
  if (quant_pv) {
    const T* v = vp + base;
    if (threadIdx.x < dp) vs[threadIdx.x] = scale_of(c.vmax[(size_t)bh * dp + threadIdx.x]);
    __syncthreads();
    for (int i = threadIdx.x; i < 64 * dp; i += 256) {
      const int r = i / dp, j = i % dp;
      tile[j * 64 + r] = r0 + r < seq && j < d ? code(to_f(v[(size_t)(r0 + r) * ld + j]), vs[j],
                                                      -127.0f)
                                               : (int8_t)0;
    }
    __syncthreads();
    int8_t* dst = c.vt + (size_t)bh * dp * s64 + r0;
    for (int i = threadIdx.x; i < dp * 16; i += 256) {
      const int j = i / 16, w = i % 16;
      *reinterpret_cast<uint32_t*>(dst + (size_t)j * s64 + 4 * w) =
          *reinterpret_cast<const uint32_t*>(tile + j * 64 + 4 * w);
    }
  }
}

// ---------------------------------------------------------------------------
// attention
// ---------------------------------------------------------------------------

// Shared memory of one block (bytes). Codes and bf16 tiles are in the
// no-swizzle core-matrix layout [chunk of 16 bytes][rows][16 bytes]; f32
// tiles are [rows][DP + 1] (odd stride: no bank conflicts in the FMA loops).
template <typename T, bool QK, bool PV, int DP>
struct Smem {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int kLdF = DP + 1;
  static constexpr int kLdP = kK + 4;  // f32 p tile's row stride
  // q and a K tile: codes [DP/16][64][16], bf16 [DP/8][64][16], f32 [64][kLdF]
  static constexpr int kQKBytes = QK ? DP * 64 : kF32 ? 64 * kLdF * 4 : DP * 2 * 64;
  // a V tile: codes [4][DP][16] (its 64 keys along K), bf16 [DP/8][64][16], f32 [64][kLdF]
  static constexpr int kVBytes = PV ? DP * 64 : kF32 ? 64 * kLdF * 4 : DP * 2 * 64;
  // p: codes [4][64][16], f32 [64][kLdP]; bf16 p stays in registers
  static constexpr int kPBytes = PV ? 64 * 64 : kF32 ? 64 * kLdP * 4 : 0;
  static constexpr size_t kQOff = 0;
  static constexpr size_t kKOff = align128(kQOff + kQKBytes);
  static constexpr size_t kVOff = align128(kKOff + 2 * (size_t)kQKBytes);
  static constexpr size_t kPOff = align128(kVOff + 2 * (size_t)kVBytes);
  static constexpr size_t kBytes = kPOff + kPBytes;
  static_assert(kBytes <= 227 * 1024, "shared memory");
};

// 64 rows of int8 codes (row stride dp bytes, from row0) into [DP/16][64][16].
template <int DP>
__device__ __forceinline__ void load_code_rows(unsigned char* dst, const int8_t* src, int row0) {
  constexpr int kChunks = DP / 16;
  for (int i = threadIdx.x; i < 64 * kChunks; i += kThreads) {
    const int r = i / kChunks, ch = i % kChunks;
    cp_async16(dst + (ch * 64 + r) * 16, src + (size_t)(row0 + r) * DP + ch * 16);
  }
}

// Keys [key0, key0 + 64) of v's transposed codes (row stride s64) into
// [4][DP][16]: the K-major B operand of p.v.
template <int DP>
__device__ __forceinline__ void load_code_cols(unsigned char* dst, const int8_t* src, int key0,
                                               int s64) {
  for (int i = threadIdx.x; i < DP * 4; i += kThreads) {
    const int j = i / 4, ch = i % 4;
    cp_async16(dst + (ch * DP + j) * 16, src + (size_t)j * s64 + key0 + ch * 16);
  }
}

// Rows [row0, row0 + 64) of one head's [S, D] slice of T, scaled by `scale`
// and rounded to T where `scaled`, into dst: bf16 [DP/8][64][16] (16-byte
// cp.async pieces where `vec`), f32 [64][DP + 1]. Rows past S are left as
// they are (zero or an earlier tile's finite rows, which the softmax gives
// weight 0); columns past D stay zero.
template <typename T, int DP>
__device__ __forceinline__ void load_rows(unsigned char* dst, const T* src, int row0, int seq,
                                          int d, size_t ld, bool vec, bool scaled, float scale) {
  if constexpr (std::is_same<T, float>::value) {
    float* f = reinterpret_cast<float*>(dst);
    for (int i = threadIdx.x; i < 64 * d; i += kThreads) {
      const int r = i / d, j = i % d;
      if (row0 + r < seq) {
        const float x = src[(size_t)(row0 + r) * ld + j];
        f[r * (DP + 1) + j] = scaled ? x * scale : x;
      }
    }
  } else if (vec && !scaled) {
    for (int i = threadIdx.x; i < 64 * (d / 8); i += kThreads) {
      const int r = i / (d / 8), c8 = i % (d / 8);
      if (row0 + r < seq)
        cp_async16(dst + (c8 * 64 + r) * 16, src + (size_t)(row0 + r) * ld + c8 * 8);
    }
  } else {
    for (int i = threadIdx.x; i < 64 * d; i += kThreads) {
      const int r = i / d, j = i % d;
      if (row0 + r < seq) {
        const float x = to_f(src[(size_t)(row0 + r) * ld + j]);
        *reinterpret_cast<bf16*>(dst + ((j / 8) * 64 + r) * 16 + (j % 8) * 2) =
            from_f<bf16>(scaled ? x * scale : x);
      }
    }
  }
}

// p = exp(a) as the exact kernels compute it: bf16 inputs ex2 (flash.cuh's
// TMA kernel), f32 expf; exp_bf16 rounds argument and result to bf16.
template <bool kF32>
__device__ __forceinline__ float pexp(float a, bool exp_bf16) {
  if (exp_bf16) a = round_bf16(a);
  const float p = kF32 ? expf(a) : flash::ex2(a * flash::kLog2e);
  return exp_bf16 ? round_bf16(p) : p;
}

// A softmax flag (a tile's per-element checks, `fast`, `exp_bf16`): fixed
// at compile time on the bf16 kernels (flash::Yes / flash::No, their softmax
// compiled for each combination; read at run time, the selects made the
// p.v-quantizing kernels 15-18% slower on an H100, PERF.md), read at run
// time on the f32 ones (Dyn: a numerics path, compiled once).
struct Dyn {};
template <typename F>
__device__ __forceinline__ bool on(F, bool) {
  return F::value;
}
__device__ __forceinline__ bool on(Dyn, bool flag) { return flag; }

template <typename T, bool QK, bool PV, int DP>
__global__ void __launch_bounds__(kThreads)
    attn_kernel(const T* __restrict__ qp, const T* __restrict__ kp, const T* __restrict__ vp,
                const float* __restrict__ mask, T* __restrict__ op, const Attn a,
                const Codes c) {
  using L = Smem<T, QK, PV, DP>;
  constexpr bool kF32 = L::kF32;
  constexpr int kLdF = L::kLdF;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* qs = smem + L::kQOff;
  unsigned char* ks = smem + L::kKOff;
  unsigned char* vs = smem + L::kVOff;
  unsigned char* pt = smem + L::kPOff;  // p's tile

  const int seq = a.seq, d = a.d, s64 = c.s64;
  const int bh = blockIdx.x, b = bh / a.heads, h = bh % a.heads;
  const int q0 = blockIdx.y * kQ;
  const size_t base = (size_t)b * a.batch_stride + (size_t)h * a.head_stride;
  const size_t ld = a.row_stride;
  const T* q = qp + base;
  const T* k = kp + base;
  const T* v = vp + base;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int la = warp * 16 + g, lb = la + 8;  // this thread's rows in the tile
  const int row_a = q0 + la, row_b = q0 + lb;
  const float* mask_a = flash::mask_row(mask, a, b, row_a);
  const float* mask_b = flash::mask_row(mask, a, b, row_b);
  const int mask_last = flash::mask_last_key(mask, a);
  const int n_kt = (seq + kK - 1) / kK;
  const bool vec = d % 8 == 0 && ((reinterpret_cast<uintptr_t>(qp) |
                                   reinterpret_cast<uintptr_t>(kp) |
                                   reinterpret_cast<uintptr_t>(vp)) % 16) == 0;
  // the int32 row max (quant_qk, no mask, exact softmax): value = f32(acc),
  // arg = (value - max) * sq*sk; otherwise value = f32(acc) * sq*sk (+ mask),
  // arg = value - max (times 1, exactly)
  const bool int_max = QK && mask == nullptr && !a.fast;
  float vmul_a = 1.0f, vmul_b = 1.0f, amul_a = 1.0f, amul_b = 1.0f;
  if constexpr (QK) {
    const float ksc = scale_of(c.kmax[bh]);
    const float* qsc = c.qsc + (size_t)bh * s64;
    const float ra = qsc[min(row_a, s64 - 1)] * ksc, rb = qsc[min(row_b, s64 - 1)] * ksc;
    if (int_max) {
      amul_a = ra;
      amul_b = rb;
    } else {
      vmul_a = ra;
      vmul_b = rb;
    }
  }

  flash::zero_smem(smem, L::kBytes);  // padding columns and missing rows stay zero
  __syncthreads();
  if constexpr (QK) {
    load_code_rows<DP>(qs, c.qc + (size_t)bh * s64 * DP, q0);
  } else {  // q scaled and rounded to T, as the exact kernels fold the scale in
    load_rows<T, DP>(qs, q, q0, seq, d, ld, vec, true, a.scale);
  }
  auto load_k = [&](int st, int kt) {
    if constexpr (QK)
      load_code_rows<DP>(ks + st * L::kQKBytes, c.kc + (size_t)bh * s64 * DP, kt * kK);
    else
      load_rows<T, DP>(ks + st * L::kQKBytes, k, kt * kK, seq, d, ld, vec, false, 0.0f);
  };
  auto load_v = [&](int st, int kt) {
    if constexpr (PV)
      load_code_cols<DP>(vs + st * L::kVBytes, c.vt + (size_t)bh * DP * s64, kt * kK, s64);
    else
      load_rows<T, DP>(vs + st * L::kVBytes, v, kt * kK, seq, d, ld, vec, false, 0.0f);
  };
  // copies done (cp.async) and visible to the tensor cores (async proxy)
  auto arrived = [&]() {
    cp_async_wait<1>();
    hp::fence_proxy_async();
    __syncthreads();
  };

  // the values of one K tile: s[4*nt + e] at row e < 2 ? la : lb, key
  // nt*8 + 2t + (e & 1) (the wgmma accumulator layout); for quant_qk the
  // int32 products as f32 (exact: |acc| < 2^22)
  float s[32];
  auto scores = [&](const unsigned char* kt_tile) {
    if constexpr (QK) {
      int si[32];
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 32; ++kk)
        WgmmaS8<64>::run(si, hp::desc(qs + kk * 2 * 1024, 1024, 128, hp::kInterleave),
                         hp::desc(kt_tile + kk * 2 * 1024, 1024, 128, hp::kInterleave), kk > 0);
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_regs(si);
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = (float)si[i];
    } else if constexpr (!kF32) {
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        WgmmaSS<64, 0>::run(s, hp::desc(qs + kk * 2 * 1024, 1024, 128, hp::kInterleave),
                            hp::desc(kt_tile + kk * 2 * 1024, 1024, 128, hp::kInterleave),
                            kk > 0);
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_regs(s);
    } else {
      const float* qf = reinterpret_cast<const float*>(qs);
      const float* kf = reinterpret_cast<const float*>(kt_tile);
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.0f;
      for (int j = 0; j < d; ++j) {
        const float xa = qf[la * kLdF + j], xb = qf[lb * kLdF + j];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const float* kr = kf + (nt * 8 + 2 * t) * kLdF + j;
          const float k0 = kr[0], k1 = kr[kLdF];
          s[4 * nt] = fmaf(xa, k0, s[4 * nt]);
          s[4 * nt + 1] = fmaf(xa, k1, s[4 * nt + 1]);
          s[4 * nt + 2] = fmaf(xb, k0, s[4 * nt + 2]);
          s[4 * nt + 3] = fmaf(xb, k1, s[4 * nt + 3]);
        }
      }
    }
  };
  auto key_of = [&](int kt, int nt, int e) { return kt * kK + nt * 8 + 2 * t + (e & 1); };
  // the value of element (nt, e): a checked tile adds its mask entry (a key
  // past the end reads the last key's; the caller gives it no weight)
  auto value = [&](int kt, int nt, int e, bool checked) {
    const float x = s[4 * nt + e] * (e < 2 ? vmul_a : vmul_b);
    return checked ? flash::masked_logit(x, e < 2 ? mask_a : mask_b, key_of(kt, nt, e), mask_last)
                   : x;
  };
  auto plain_tile = [&](int kt) { return mask == nullptr && (kt + 1) * kK <= seq; };
  // fn(checked) for tile kt: the per-element checks resolved per tile at
  // compile time on the bf16 kernels
  auto by_tile = [&](int kt, auto fn) {
    if constexpr (kF32) fn(Dyn{});
    else if (plain_tile(kt)) fn(flash::No{});
    else fn(flash::Yes{});
  };

  // pass 1 (the exact softmax, and quant_pv for p's row max): the row max
  float m_a = neg_inf(), m_b = neg_inf();
  if (!a.fast || PV) {
    load_k(0, 0);
    cp_async_commit();
    for (int kt = 0; kt < n_kt; ++kt) {
      if (kt + 1 < n_kt) load_k((kt + 1) & 1, kt + 1);
      cp_async_commit();
      arrived();
      scores(ks + (kt & 1) * L::kQKBytes);
      by_tile(kt, [&](auto checked_c) {
        const bool checked = on(checked_c, !plain_tile(kt));
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = value(kt, nt, e, checked);
            if (checked && key_of(kt, nt, e) >= seq) x = neg_inf();
            if (e < 2) m_a = fmaxf(m_a, x); else m_b = fmaxf(m_b, x);
          }
        }
      });
      __syncthreads();  // stage kt is free for tile kt + 2
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {  // the 4 threads of a row
      m_a = fmaxf(m_a, __shfl_xor_sync(0xffffffffu, m_a, o));
      m_b = fmaxf(m_b, __shfl_xor_sync(0xffffffffu, m_b, o));
    }
  }
  const float top_a = m_a, top_b = m_b;  // the rows' largest values
  m_a = fmaxf(m_a, -1e30f);  // fully masked rows
  m_b = fmaxf(m_b, -1e30f);

  // quant_pv: p's row scale from p's row max, the weight of the largest
  // value (p is monotone in it)
  float ps_a = 1.0f, ps_b = 1.0f;
  auto arg = [&](float x, int half, bool fast) {  // exp's argument for value x
    return fast ? fminf(fmaxf(x, -60.0f), 60.0f)
                : (x - (half ? m_b : m_a)) * (half ? amul_b : amul_a);
  };
  // fn(fast, exp_bf16)
  auto with_flags = [&](auto fn) {
    if constexpr (kF32) {
      fn(Dyn{}, Dyn{});
    } else if (a.fast) {
      if (a.exp_bf16) fn(flash::Yes{}, flash::Yes{}); else fn(flash::Yes{}, flash::No{});
    } else {
      if (a.exp_bf16) fn(flash::No{}, flash::Yes{}); else fn(flash::No{}, flash::No{});
    }
  };
  if constexpr (PV) {
    const bool fast = a.fast != 0, ex = a.exp_bf16 != 0;
    ps_a = p_scale(pexp<kF32>(arg(top_a, 0, fast), ex), ex);
    ps_b = p_scale(pexp<kF32>(arg(top_b, 1, fast), ex), ex);
  }

  // pass 2: p, the denominator, p.v
  using Acc = typename std::conditional<PV, int, float>::type;
  Acc o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0;
  float l_a = 0.0f, l_b = 0.0f;
  uint32_t pa[4][4];  // bf16 p.v: p as the A operand of the 4 k16 steps
  load_k(0, 0);
  load_v(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) {
      load_k((kt + 1) & 1, kt + 1);
      load_v((kt + 1) & 1, kt + 1);
    }
    cp_async_commit();
    arrived();
    scores(ks + (kt & 1) * L::kQKBytes);
    auto weights = [&](auto checked_c, auto fast_c, auto exp_c) {
      const bool checked = on(checked_c, !plain_tile(kt)), fast = on(fast_c, a.fast != 0);
      const bool ex = on(exp_c, a.exp_bf16 != 0);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float p[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int e = 2 * half + j;
            p[j] = pexp<kF32>(arg(value(kt, nt, e, checked), half, fast), ex);
            if (checked && key_of(kt, nt, e) >= seq) p[j] = 0.0f;  // keys past the end
          }
          [[maybe_unused]] const int lr = half ? lb : la, key = nt * 8 + 2 * t;
          if constexpr (PV) {
            const float sc = half ? ps_b : ps_a;
            int8_t cd[2];
#pragma unroll
            for (int j = 0; j < 2; ++j) cd[j] = (int8_t)p_code(p[j], sc, ex);
            *reinterpret_cast<uint16_t*>(pt + ((key / 16) * 64 + lr) * 16 + key % 16) =
                (uint16_t)((uint8_t)cd[0] | ((uint16_t)(uint8_t)cd[1] << 8));
            if (half) l_b += p[0] + p[1]; else l_a += p[0] + p[1];
          } else if constexpr (kF32) {
            float* pf = reinterpret_cast<float*>(pt);
            pf[lr * L::kLdP + key] = p[0];
            pf[lr * L::kLdP + key + 1] = p[1];
            if (half) l_b += p[0] + p[1]; else l_a += p[0] + p[1];
          } else {
            const __nv_bfloat162 pb2 = __floats2bfloat162_rn(p[0], p[1]);
            const float2 r = a.denom_rounded ? __bfloat1622float2(pb2) : make_float2(p[0], p[1]);
            if (half) l_b += r.x + r.y; else l_a += r.x + r.y;
            pa[nt / 2][(nt & 1) * 2 + half] = *reinterpret_cast<const uint32_t*>(&pb2);
          }
        }
      }
    };
    by_tile(kt, [&](auto checked_c) {
      with_flags([&](auto fast_c, auto exp_c) { weights(checked_c, fast_c, exp_c); });
    });

    const unsigned char* vt_tile = vs + (kt & 1) * L::kVBytes;
    if constexpr (PV) {  // the p codes through shared memory, then s8 wgmma
      hp::fence_proxy_async();
      __syncthreads();
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        WgmmaS8<DP>::run(o, hp::desc(pt + kk * 2 * 1024, 1024, 128, hp::kInterleave),
                         hp::desc(vt_tile + kk * 2 * DP * 16, DP * 16, 128, hp::kInterleave), 1);
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_regs(o);
    } else if constexpr (!kF32) {  // p from registers, V MN-major
      hp::fence_regs(pa);
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        WgmmaRS<DP, 1>::run(o, pa[kk],
                            hp::desc(vt_tile + kk * 256, 128, 64 * 16, hp::kInterleave), 1);
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_regs(o);
    } else {  // a warp's rows of p are its own
      __syncwarp();
      const float* pf = reinterpret_cast<const float*>(pt);
      const float* vf = reinterpret_cast<const float*>(vt_tile);
      for (int j = 0; j < kK; ++j) {
        const float xa = pf[la * L::kLdP + j], xb = pf[lb * L::kLdP + j];
#pragma unroll
        for (int nc = 0; nc < DP / 8; ++nc) {
          const float v0 = vf[j * kLdF + nc * 8 + 2 * t], v1 = vf[j * kLdF + nc * 8 + 2 * t + 1];
          o[4 * nc] = fmaf(xa, v0, o[4 * nc]);
          o[4 * nc + 1] = fmaf(xa, v1, o[4 * nc + 1]);
          o[4 * nc + 2] = fmaf(xb, v0, o[4 * nc + 2]);
          o[4 * nc + 3] = fmaf(xb, v1, o[4 * nc + 3]);
        }
      }
      __syncwarp();
    }
    __syncthreads();  // stage kt is free for tile kt + 2
  }
#pragma unroll
  for (int o2 = 1; o2 <= 2; o2 <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, o2);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, o2);
  }
  const float inv_a = 1.0f / l_a, inv_b = 1.0f / l_b;
  T* out = op + base;
#pragma unroll
  for (int nc = 0; nc < DP / 8; ++nc) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = e < 2 ? row_a : row_b, col = nc * 8 + 2 * t + (e & 1);
      if (row < seq && col < d) {
        float y;
        if constexpr (PV)  // f32(acc) * (s_p * s_v), then / denominator
          y = (float)o[4 * nc + e] *
              ((e < 2 ? ps_a : ps_b) * scale_of(c.vmax[(size_t)bh * DP + col]));
        else
          y = o[4 * nc + e];
        out[(size_t)row * ld + col] = from_f<T>(y * (e < 2 ? inv_a : inv_b));
      }
    }
  }
}

template <typename T, bool QK, bool PV, int DP>
int launch_attn(const Attn& a, const Codes& c, cudaStream_t stream) {
  using L = Smem<T, QK, PV, DP>;
  auto kern = attn_kernel<T, QK, PV, DP>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.batch * a.heads, (a.seq + kQ - 1) / kQ);
  kern<<<grid, kThreads, L::kBytes, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v), a.mask,
      static_cast<T*>(a.out), a, c);
  return (int)cudaGetLastError();
}

template <typename T, bool QK, bool PV>
int launch_dp(const Attn& a, const Codes& c, cudaStream_t stream) {
  switch (c.dp) {
    case 32: return launch_attn<T, QK, PV, 32>(a, c, stream);
    case 64: return launch_attn<T, QK, PV, 64>(a, c, stream);
    case 96: return launch_attn<T, QK, PV, 96>(a, c, stream);
    case 128: return launch_attn<T, QK, PV, 128>(a, c, stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_typed(const Attn& a, const Codes& c, int quant_qk, int quant_pv, cudaStream_t stream) {
  const dim3 grid(a.batch * a.heads, c.s64 / 64);
  const T *q = static_cast<const T*>(a.q), *k = static_cast<const T*>(a.k),
          *v = static_cast<const T*>(a.v);
  quant_rows<T><<<grid, 256, 0, stream>>>(q, k, v, a, c, quant_qk, quant_pv);
  quant_cols<T><<<grid, 256, 0, stream>>>(k, v, a, c, quant_qk, quant_pv);
  const int err = (int)cudaGetLastError();
  if (err != 0 || a.out == nullptr) return err;
  if (quant_qk && quant_pv) return launch_dp<T, true, true>(a, c, stream);
  if (quant_qk) return launch_dp<T, true, false>(a, c, stream);
  return launch_dp<T, false, true>(a, c, stream);
}

}  // namespace flash8
}  // namespace CLIPK_SOURCE
}  // namespace clipk

// q/k/v/out: [batch, seq, heads*d] contiguous; mask, its strides, sin/cos
// and qr/kr: as flash_packed_launch (flash_packed.cu) takes them. The
// scratch the wrapper allocates (s64 = seq rounded up to 64, dp = d rounded
// up to 32), each needed only for the half it quantizes: qc, kc int8
// [batch*heads, s64, dp] with qsc f32 [batch*heads, s64] and kmax u32
// [batch*heads] zeroed; vt int8 [batch*heads, dp, s64] with vmax u32
// [batch*heads, dp] zeroed (Codes has the layouts). out null: the pre-pass
// alone (its codes read back for inspection). d <= 128; quant_qk or
// quant_pv (or both) set; denom_rounded: as flash_packed_launch's, for the
// unquantized p.v. dtype: 0 = float32, 1 = bfloat16. Returns
// cudaGetLastError().
extern "C" int flash_int8_launch(const void* q, const void* k, const void* v, const void* mask,
                                 long long mask_batch_stride, long long mask_row_stride,
                                 const void* sin, const void* cos, void* qr, void* kr, void* qc,
                                 void* qsc, void* kc, void* kmax, void* vt, void* vmax, void* out,
                                 int batch, int seq, int heads, int d, float scale, int fast,
                                 int exp_bf16, int denom_rounded, int quant_qk, int quant_pv,
                                 int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!(quant_qk || quant_pv) || d < 1 || d > clipk::flash::kMaxDP ||
      (quant_qk && (qc == nullptr || qsc == nullptr || kc == nullptr || kmax == nullptr)) ||
      (quant_pv && (vt == nullptr || vmax == nullptr)))
    return (int)cudaErrorInvalidValue;
  clipk::flash::Attn a;
  const int err = clipk::flash::packed_call(&a, q, k, v, mask, mask_batch_stride,
                                            mask_row_stride, sin, cos, qr, kr, out, batch, seq,
                                            heads, d, dtype, st);
  if (err != 0) return err;
  a.scale = scale;
  a.fast = fast;
  a.exp_bf16 = exp_bf16;
  a.denom_rounded = denom_rounded;
  clipk::flash8::Codes c{};
  c.qc = static_cast<int8_t*>(qc);
  c.qsc = static_cast<float*>(qsc);
  c.kc = static_cast<int8_t*>(kc);
  c.kmax = static_cast<unsigned int*>(kmax);
  c.vt = static_cast<int8_t*>(vt);
  c.vmax = static_cast<unsigned int*>(vmax);
  c.s64 = (seq + 63) / 64 * 64;
  c.dp = (d + 31) / 32 * 32;
  return dtype == 1 ? clipk::flash8::launch_typed<clipk::bf16>(a, c, quant_qk, quant_pv, st)
                    : clipk::flash8::launch_typed<float>(a, c, quant_qk, quant_pv, st);
}
