// Fused attention for Hopper (sm_90a), shared by flash_packed.cu (the
// [B, S, H*D] projection layout) and flash_bhsd.cu (the [B, H, S, D]
// layout). Both layouts are one set of element strides: the kernels read and
// write a head's [S, D] slice at b * batch_stride + h * head_stride with rows
// row_stride apart.
//
// Per head: softmax(q*scale*k^T + mask) v. The scale folds into q, rounded
// to the input type; logits, row max and denominator are f32; `fast` clamps
// the logits to +-60 in place of the max pass; `exp_bf16` rounds the exp's
// argument and result to bf16; with `denom_rounded` (D not a multiple of
// 128) the denominator sums p as rounded to v's type, as the TPU kernels'
// spare-lane matmul does.
//
// The design. The grid is (batch*head) x (query tiles of 64 rows); 4 warps
// each own 16 query rows. A block reads its head's slice straight from the
// strided layout (no transposes) into shared memory, zero-padding D up to a
// multiple of 16 there (72 -> 80, 96 stays) for the tensor-core tiles.
// Key/value tiles of 64 rows stream through a 2-stage cp.async ring
// (16-byte copies where the head's row slice allows), so a tile's loads
// overlap the previous tile's work. bf16 runs on mma.sync m16n8k16 with
// ldmatrix operands: the scaled q fragments stay in registers for the whole
// block, the logits come out of q.k^T in registers, the softmax runs there,
// and the rounded p goes straight back in as the A operand of p.v (the f32
// accumulator layout of two n8 tiles is the A layout of one k16 step), so
// the [S, S] logits never leave registers. The exact softmax takes two
// passes over the key tiles, the first for the whole-row max, the second for
// exp, denominator and p.v, which reproduces the TPU kernels' rounding (they
// subtract the whole-row max before the exp); `fast` takes one pass. The
// per-element softmax code is compiled for each combination of the flags,
// and without the key-bound and mask checks for the tiles that need neither
// (every tile but a ragged last one, without a mask), chosen once per tile.
// f32 (kept for f32 towers and numerics checks) uses a plain FMA kernel with
// the logits staged in shared memory. Not yet done: online rescaling, TMA and
// wgmma.

#pragma once

#include "common.cuh"

namespace clipk {
namespace flash {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = kBQ / kWarps;  // query rows per warp
constexpr int kMaxDP = 128;

// One attention call: q/k/v/out share the strides (elements).
struct Attn {
  const void* q;
  const void* k;
  const void* v;
  const float* mask;  // [seq, seq] additive, or null
  void* out;
  long long batch_stride, head_stride, row_stride;
  int batch, seq, heads, d;
  float scale;
  int fast, exp_bf16, denom_rounded;
};

// Rows [row0, row0 + n) of one head's [S, D] slice into an [n, *] shared
// tile whose padding (columns >= d) is already zero. With `vec`, 16-byte
// cp.async copies (issued, not waited for); otherwise element copies. Rows
// past the end are left as they are: zero or an earlier tile's (finite)
// rows, which the softmax gives weight 0.
template <typename T>
__device__ void load_tile_async(T* __restrict__ dst, const T* __restrict__ src, int row0,
                                int n, int seq, int d, int ld, size_t row_stride, bool vec) {
  if (vec) {
    constexpr int kVec = 16 / sizeof(T);
    const int per_row = d / kVec;
    for (int i = threadIdx.x; i < n * per_row; i += kThreads) {
      const int r = i / per_row, c = (i % per_row) * kVec;
      if (row0 + r < seq)
        cp_async16(dst + r * ld + c, src + (size_t)(row0 + r) * row_stride + c);
    }
  } else {
    for (int i = threadIdx.x; i < n * d; i += kThreads) {
      const int r = i / d, c = i % d;
      if (row0 + r < seq) dst[r * ld + c] = src[(size_t)(row0 + r) * row_stride + c];
    }
  }
}

// The query tile, scaled by `scale` and rounded to T (the scale folded
// into q, as the TPU kernels do).
template <typename T>
__device__ void load_q(T* __restrict__ dst, const T* __restrict__ src, int row0, int seq, int d,
                       int ld, size_t row_stride, float scale) {
  for (int i = threadIdx.x; i < kBQ * d; i += kThreads) {
    const int r = i / d, c = i % d;
    if (row0 + r < seq)
      dst[r * ld + c] = from_f<T>(to_f(src[(size_t)(row0 + r) * row_stride + c]) * scale);
  }
}

__device__ __forceinline__ void zero_smem(unsigned char* smem, size_t bytes) {
  for (size_t i = threadIdx.x * 16; i < bytes; i += kThreads * 16)
    *reinterpret_cast<uint4*>(smem + i) = make_uint4(0, 0, 0, 0);
}

// p = exp(.) of one logit, as the TPU kernels compute it.
template <bool kFast, bool kExpBf16>
__device__ __forceinline__ float softmax_weight(float l, float m) {
  const float a = kFast ? fminf(fmaxf(l, -60.0f), 60.0f) : l - m;
  return kExpBf16 ? round_bf16(expf(round_bf16(a))) : expf(a);
}

__device__ __forceinline__ float softmax_weight(float l, float m, bool fast, bool exp_bf16) {
  if (fast)
    return exp_bf16 ? softmax_weight<true, true>(l, m) : softmax_weight<true, false>(l, m);
  return exp_bf16 ? softmax_weight<false, true>(l, m) : softmax_weight<false, false>(l, m);
}

using Yes = std::true_type;
using No = std::false_type;

// ---------------------------------------------------------------------------
// bf16: mma.sync with the softmax in registers
// ---------------------------------------------------------------------------

template <int DP>
struct Bf16Tiles {
  static constexpr int kLd = DP + 8;  // row stride (elements): 16-byte rows, no bank conflicts
  static constexpr int kTile = kBK * kLd;
  static constexpr size_t kBytes = sizeof(bf16) * (kBQ * kLd + 4 * kTile);  // q, 2 k, 2 v
};

// A thread's accumulator element e of n8 tile nt sits at row g (e < 2) or
// g + 8 (e >= 2) of the warp's 16 rows, column nt*8 + 2t + (e & 1), where
// g = lane / 4 and t = lane % 4.
// The pointers come as restrict-qualified parameters (read-only loads, no
// aliasing with the output), the strides and flags in `a`.
template <int DP>
__global__ void __launch_bounds__(kThreads)
    flash_bf16_kernel(const bf16* __restrict__ qp, const bf16* __restrict__ kp,
                      const bf16* __restrict__ vp, const float* __restrict__ mask,
                      bf16* __restrict__ op, const Attn a) {
  using Tl = Bf16Tiles<DP>;
  constexpr int kLd = Tl::kLd;
  constexpr int kKs = DP / 16;  // k16 steps over the head dim
  constexpr int kNo = DP / 8;   // n8 tiles of the output
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + kBQ * kLd;      // [2][kBK][kLd]
  bf16* vs = ks + 2 * Tl::kTile;  // [2][kBK][kLd]

  const int seq = a.seq, d = a.d;
  const int b = blockIdx.x / a.heads, h = blockIdx.x % a.heads;
  const int q0 = blockIdx.y * kBQ;
  const size_t base = (size_t)b * a.batch_stride + (size_t)h * a.head_stride;
  const size_t ld = a.row_stride;
  const bf16* q = qp + base;
  const bf16* k = kp + base;
  const bf16* v = vp + base;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = warp * kRows;
  const int row_a = q0 + r0 + g, row_b = row_a + 8;
  const int n_kt = (seq + kBK - 1) / kBK;
  const bool vec = d % 8 == 0 && ((reinterpret_cast<uintptr_t>(qp) |
                                   reinterpret_cast<uintptr_t>(kp) |
                                   reinterpret_cast<uintptr_t>(vp)) % 16) == 0;

  zero_smem(smem, Tl::kBytes);  // padding columns and missing rows stay zero
  __syncthreads();
  if (vec) {  // copy q in 16-byte pieces, then each thread scales its own pieces
    load_tile_async<bf16>(qs, q, q0, kBQ, seq, d, kLd, ld, true);
    cp_async_commit();
    cp_async_wait<0>();
    for (int i = threadIdx.x; i < kBQ * (d / 8); i += kThreads) {
      const int r = i / (d / 8), c = (i % (d / 8)) * 8;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        qs[r * kLd + c + j] = __float2bfloat16(__bfloat162float(qs[r * kLd + c + j]) * a.scale);
    }
  } else {
    load_q<bf16>(qs, q, q0, seq, d, kLd, ld, a.scale);
  }
  __syncthreads();
  uint32_t qf[kKs][4];
#pragma unroll
  for (int kk = 0; kk < kKs; ++kk)
    ldmatrix_x4(qf[kk], qs + (r0 + (lane & 15)) * kLd + kk * 16 + (lane >> 4) * 8);

  // logits of this warp's 16 rows against the 64 keys of one K tile
  auto scores = [&](const bf16* kt_tile, float (&s)[kBK / 8][4]) {
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
#pragma unroll
    for (int np = 0; np < kBK / 16; ++np) {  // the 16 keys' fragments first, then their mma
      uint32_t bk4[kKs][4];
      const int key = np * 16 + (lane & 7) + ((lane >> 4) << 3);
#pragma unroll
      for (int kk = 0; kk < kKs; ++kk)
        ldmatrix_x4(bk4[kk], kt_tile + key * kLd + kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int kk = 0; kk < kKs; ++kk) {
        mma_bf16(s[2 * np], qf[kk], bk4[kk][0], bk4[kk][1]);
        mma_bf16(s[2 * np + 1], qf[kk], bk4[kk][2], bk4[kk][3]);
      }
    }
  };
  // the key of element (nt, e), and its logit with the mask added
  auto key_of = [&](int kt, int nt, int e) { return kt * kBK + nt * 8 + 2 * t + (e & 1); };
  auto logit = [&](const float (&s)[kBK / 8][4], int kt, int nt, int e) {
    const int row = e < 2 ? row_a : row_b;
    float l = s[nt][e];
    if (mask != nullptr && row < seq) l += mask[(size_t)row * seq + key_of(kt, nt, e)];
    return l;
  };
  // A tile whose keys all exist and that has no mask takes its logits as
  // they are: the per-element checks and runtime flags, resolved per tile
  // at compile time below, otherwise cost about a quarter of the kernel.
  auto plain_tile = [&](int kt) { return mask == nullptr && (kt + 1) * kBK <= seq; };

  // pass 1 (exact softmax): the whole-row max over every key tile
  float m_a = neg_inf(), m_b = neg_inf();
  if (!a.fast) {
    load_tile_async<bf16>(ks, k, 0, kBK, seq, d, kLd, ld, vec);
    cp_async_commit();
    for (int kt = 0; kt < n_kt; ++kt) {
      if (kt + 1 < n_kt)
        load_tile_async<bf16>(ks + ((kt + 1) & 1) * Tl::kTile, k, (kt + 1) * kBK, kBK, seq, d,
                              kLd, ld, vec);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      float s[kBK / 8][4];
      scores(ks + (kt & 1) * Tl::kTile, s);
      auto tile_max = [&](auto checked) {
        constexpr bool kChecked = decltype(checked)::value;
#pragma unroll
        for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (kChecked && key_of(kt, nt, e) >= seq) continue;
            const float l = kChecked ? logit(s, kt, nt, e) : s[nt][e];
            if (e < 2) m_a = fmaxf(m_a, l); else m_b = fmaxf(m_b, l);
          }
        }
      };
      if (plain_tile(kt)) tile_max(No{}); else tile_max(Yes{});
      __syncthreads();  // stage kt is free for tile kt + 2
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {  // the 4 threads of a row
      m_a = fmaxf(m_a, __shfl_xor_sync(0xffffffffu, m_a, o));
      m_b = fmaxf(m_b, __shfl_xor_sync(0xffffffffu, m_b, o));
    }
    m_a = fmaxf(m_a, -1e30f);  // fully masked rows
    m_b = fmaxf(m_b, -1e30f);
  }

  // pass 2: p = exp(.), denominator, p.v
  float acc[kNo][4];
#pragma unroll
  for (int nt = 0; nt < kNo; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
  float l_a = 0.0f, l_b = 0.0f;
  load_tile_async<bf16>(ks, k, 0, kBK, seq, d, kLd, ld, vec);
  load_tile_async<bf16>(vs, v, 0, kBK, seq, d, kLd, ld, vec);
  cp_async_commit();
  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) {
      const int nxt = ((kt + 1) & 1) * Tl::kTile;
      load_tile_async<bf16>(ks + nxt, k, (kt + 1) * kBK, kBK, seq, d, kLd, ld, vec);
      load_tile_async<bf16>(vs + nxt, v, (kt + 1) * kBK, kBK, seq, d, kLd, ld, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    float s[kBK / 8][4];
    scores(ks + (kt & 1) * Tl::kTile, s);
    uint32_t pa[kBK / 16][4];  // p as the A operand of the 4 k16 steps of p.v
    auto weights = [&](auto checked, auto fast_c, auto exp_c) {
      constexpr bool kChecked = decltype(checked)::value;
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt) {
        bf16 pt[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // keys past the end weigh nothing (a clamped -inf would not be 0)
          float p = 0.0f;
          if (!kChecked || key_of(kt, nt, e) < seq)
            p = softmax_weight<decltype(fast_c)::value, decltype(exp_c)::value>(
                kChecked ? logit(s, kt, nt, e) : s[nt][e], e < 2 ? m_a : m_b);
          pt[e] = __float2bfloat16(p);
          const float add = a.denom_rounded ? __bfloat162float(pt[e]) : p;
          if (e < 2) l_a += add; else l_b += add;
        }
        pa[nt / 2][(nt & 1) * 2] = pack_bf16(pt[0], pt[1]);
        pa[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(pt[2], pt[3]);
      }
    };
    auto with_flags = [&](auto checked) {
      if (a.fast) {
        if (a.exp_bf16) weights(checked, Yes{}, Yes{}); else weights(checked, Yes{}, No{});
      } else {
        if (a.exp_bf16) weights(checked, No{}, Yes{}); else weights(checked, No{}, No{});
      }
    };
    if (plain_tile(kt)) with_flags(No{}); else with_flags(Yes{});
    const bf16* vt = vs + (kt & 1) * Tl::kTile;
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {  // the 16 keys' v fragments first, then their mma
      uint32_t bv4[kNo / 2][4];
      const int key = j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int dp = 0; dp < kNo / 2; ++dp)
        ldmatrix_x4_trans(bv4[dp], vt + key * kLd + dp * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int dp = 0; dp < kNo / 2; ++dp) {
        mma_bf16(acc[2 * dp], pa[j], bv4[dp][0], bv4[dp][1]);
        mma_bf16(acc[2 * dp + 1], pa[j], bv4[dp][2], bv4[dp][3]);
      }
    }
    __syncthreads();  // stage kt is free for tile kt + 2
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, o);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, o);
  }
  const float inv_a = 1.0f / l_a, inv_b = 1.0f / l_b;
  bf16* out = op + base;
#pragma unroll
  for (int nt = 0; nt < kNo; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = e < 2 ? row_a : row_b;
      const int c = nt * 8 + 2 * t + (e & 1);
      if (row < seq && c < d)
        out[(size_t)row * ld + c] = __float2bfloat16(acc[nt][e] * (e < 2 ? inv_a : inv_b));
    }
  }
}

// ---------------------------------------------------------------------------
// f32: plain FMA, logits staged in shared memory
// ---------------------------------------------------------------------------

struct F32Layout {
  int dp, ldq, ldl, ldp;
  size_t qs, ks, vs, lg, pb, total;
  __host__ __device__ explicit F32Layout(int d) {
    dp = (d + 15) / 16 * 16;
    ldq = dp + 1;  // odd stride: no bank conflicts in the per-lane key reads
    ldl = kBK + 4;
    ldp = kBK + 8;
    qs = 0;
    ks = qs + align128(sizeof(float) * kBQ * ldq);
    vs = ks + stage();
    lg = vs + stage();
    pb = lg + align128(sizeof(float) * kBQ * ldl);
    total = pb + align128(sizeof(float) * kBQ * ldp);
  }
  __host__ __device__ size_t stage() const { return align128(sizeof(float) * kBK * ldq); }
};

// logits[r0:r0+16, 0:kBK] (stride ldl) = qs[r0:r0+16] . ks^T, per warp:
// lane owns key columns lane and lane + 32.
__device__ inline void f32_logits(const float* __restrict__ qs, const float* __restrict__ ks,
                                  float* __restrict__ lg, const F32Layout& L, int r0, int d) {
  const int lane = threadIdx.x % 32;
  float acc[kRows][2];
#pragma unroll
  for (int i = 0; i < kRows; ++i) acc[i][0] = acc[i][1] = 0.0f;
  for (int c = 0; c < d; ++c) {
    const float k0 = ks[lane * L.ldq + c];
    const float k1 = ks[(lane + 32) * L.ldq + c];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float qv = qs[(r0 + i) * L.ldq + c];
      acc[i][0] = fmaf(qv, k0, acc[i][0]);
      acc[i][1] = fmaf(qv, k1, acc[i][1]);
    }
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    lg[(r0 + i) * L.ldl + lane] = acc[i][0];
    lg[(r0 + i) * L.ldl + lane + 32] = acc[i][1];
  }
}

__global__ void __launch_bounds__(kThreads)
    flash_f32_kernel(const float* __restrict__ qp, const float* __restrict__ kp,
                     const float* __restrict__ vp, const float* __restrict__ mask,
                     float* __restrict__ op, const Attn a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int seq = a.seq, d = a.d;
  const F32Layout L(d);
  float* qs = reinterpret_cast<float*>(smem + L.qs);
  float* ks = reinterpret_cast<float*>(smem + L.ks);
  float* vs = reinterpret_cast<float*>(smem + L.vs);
  float* lg = reinterpret_cast<float*>(smem + L.lg);
  float* pb = reinterpret_cast<float*>(smem + L.pb);
  const int b = blockIdx.x / a.heads, h = blockIdx.x % a.heads;
  const int q0 = blockIdx.y * kBQ;
  const size_t base = (size_t)b * a.batch_stride + (size_t)h * a.head_stride;
  const size_t ld = a.row_stride;
  const float* q = qp + base;
  const float* k = kp + base;
  const float* v = vp + base;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * kRows;
  const int n_kt = (seq + kBK - 1) / kBK;

  zero_smem(smem, L.lg);
  __syncthreads();
  load_q<float>(qs, q, q0, seq, d, L.ldq, ld, a.scale);

  float m[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) m[i] = neg_inf();
  if (!a.fast) {
    for (int kt = 0; kt < n_kt; ++kt) {
      __syncthreads();
      load_tile_async<float>(ks, k, kt * kBK, kBK, seq, d, L.ldq, ld, false);
      __syncthreads();
      f32_logits(qs, ks, lg, L, r0, d);
      __syncwarp();
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int row = q0 + r0 + i;
        float mx = neg_inf();
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int c = lane + 32 * half;
          const int key = kt * kBK + c;
          if (key < seq) {
            float l = lg[(r0 + i) * L.ldl + c];
            if (mask != nullptr && row < seq) l += mask[(size_t)row * seq + key];
            mx = fmaxf(mx, l);
          }
        }
        m[i] = fmaxf(m[i], warp_max(mx));
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) m[i] = fmaxf(m[i], -1e30f);  // fully masked rows
  }

  float acc[kRows][kMaxDP / 32];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kMaxDP / 32; ++j) acc[i][j] = 0.0f;
  float dsum[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) dsum[i] = 0.0f;
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();
    load_tile_async<float>(ks, k, kt * kBK, kBK, seq, d, L.ldq, ld, false);
    load_tile_async<float>(vs, v, kt * kBK, kBK, seq, d, L.ldq, ld, false);
    __syncthreads();
    f32_logits(qs, ks, lg, L, r0, d);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = q0 + r0 + i;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = lane + 32 * half;
        const int key = kt * kBK + c;
        float p = 0.0f;  // keys past the end weigh nothing
        if (key < seq) {
          float l = lg[(r0 + i) * L.ldl + c];
          if (mask != nullptr && row < seq) l += mask[(size_t)row * seq + key];
          p = softmax_weight(l, m[i], a.fast, a.exp_bf16);
        }
        pb[(r0 + i) * L.ldp + c] = p;
        dsum[i] += p;
      }
    }
    __syncwarp();
    for (int kk = 0; kk < kBK; ++kk) {
      float vv[kMaxDP / 32];
#pragma unroll
      for (int j = 0; j < kMaxDP / 32; ++j) {
        const int c = lane + 32 * j;
        vv[j] = c < L.dp ? vs[kk * L.ldq + c] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float p = pb[(r0 + i) * L.ldp + kk];
#pragma unroll
        for (int j = 0; j < kMaxDP / 32; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }
  float* out = op + base;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const float inv = 1.0f / warp_sum(dsum[i]);
    const int row = q0 + r0 + i;
    if (row < seq) {
#pragma unroll
      for (int j = 0; j < kMaxDP / 32; ++j) {
        const int c = lane + 32 * j;
        if (c < d) out[(size_t)row * ld + c] = acc[i][j] * inv;
      }
    }
  }
}

template <int DP>
int launch_bf16(const Attn& a, cudaStream_t stream) {
  auto kern = flash_bf16_kernel<DP>;
  const int bytes = (int)Bf16Tiles<DP>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.batch * a.heads, (a.seq + kBQ - 1) / kBQ);
  kern<<<grid, kThreads, bytes, stream>>>(static_cast<const bf16*>(a.q),
                                          static_cast<const bf16*>(a.k),
                                          static_cast<const bf16*>(a.v), a.mask,
                                          static_cast<bf16*>(a.out), a);
  return (int)cudaGetLastError();
}

inline int launch_f32(const Attn& a, cudaStream_t stream) {
  const F32Layout L(a.d);
  cudaError_t err = cudaFuncSetAttribute(flash_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.batch * a.heads, (a.seq + kBQ - 1) / kBQ);
  flash_f32_kernel<<<grid, kThreads, L.total, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.mask, static_cast<float*>(a.out), a);
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError().
inline int launch(const Attn& a, int dtype, cudaStream_t stream) {
  if (a.d < 1 || a.d > kMaxDP) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch_f32(a, stream);  // f32: p rounded to v's type is p itself
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  switch ((a.d + 15) / 16) {
#define CLIPK_FLASH(N) \
  case N:              \
    return launch_bf16<16 * N>(a, stream);
    CLIPK_FLASH(1)
    CLIPK_FLASH(2)
    CLIPK_FLASH(3)
    CLIPK_FLASH(4)
    CLIPK_FLASH(5)
    CLIPK_FLASH(6)
    CLIPK_FLASH(7)
    CLIPK_FLASH(8)
#undef CLIPK_FLASH
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace flash
}  // namespace clipk
