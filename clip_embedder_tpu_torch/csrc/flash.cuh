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
// Three kernels, chosen by shape in `launch` (the wrappers' kernel_route
// mirrors it):
// - bf16 with D a multiple of 8 (every head layout the repo's towers use):
//   `flash_tma_kernel`, warp-specialized: a producer warp feeds K/V tiles by
//   TMA through an mbarrier ring to up to three consumer warpgroups of 64
//   query rows, which run q.k^T and p.v on wgmma with the softmax in
//   registers between them (the section below has the layouts).
// - bf16 with any other D <= 128 (rows TMA cannot move: D*2 bytes not a
//   multiple of 16): `flash_bf16_kernel`, the first design. The grid is
//   (batch*head) x (query tiles of 64 rows); 4 warps each own 16 query rows;
//   K/V tiles of 64 rows stream through a 2-stage cp.async ring; mma.sync
//   m16n8k16 with ldmatrix operands, the scaled q fragments in registers,
//   the logits and softmax in registers, the rounded p straight back in as
//   the A operand of p.v (the f32 accumulator layout of two n8 tiles is the
//   A layout of one k16 step).
// - f32 (f32 towers and numerics checks, the golden fixtures): a plain FMA
//   kernel with the logits staged in shared memory.
// All three take the exact softmax in two passes over the keys, the first
// for the whole-row max, the second for exp, denominator and p.v, which
// reproduces the TPU kernels' rounding (they subtract the whole-row max
// before the exp); `fast` takes one pass. The per-element softmax code is
// compiled for each combination of the flags, and without the key-bound and
// mask checks for the tiles that need neither (every tile but a ragged last
// one, without a mask), chosen once per tile. Not yet done: online
// rescaling (one pass for the exact softmax; it changes the rounding).

#pragma once

#include <algorithm>

#include "hopper.cuh"

namespace clipk {
inline namespace CLIPK_SOURCE {
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
  // additive f32 mask, or null: the logit of (batch b, query row r, key j)
  // adds mask[b * mask_batch_stride + r * mask_row_stride + j]. Shared
  // [seq, seq]: strides (0, seq); one shared key row [seq]: (0, 0); a key
  // row per batch element [batch, seq]: (seq, 0); a full [seq, seq] block
  // per batch element [batch, seq, seq]: (seq * seq, seq).
  const float* mask;
  long long mask_batch_stride, mask_row_stride;
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

// What the checked tiles of a call without a mask read as their mask.
__device__ const float kNoMask[1] = {0.0f};

// The mask row a thread reads for query row `row` of batch element `b` (a
// row past the end reads the last one: its output is never written), and
// the last key index it may read there.
__device__ __forceinline__ const float* mask_row(const float* mask, const Attn& a, int b,
                                                 int row) {
  if (mask == nullptr) return kNoMask;
  return mask + (size_t)b * a.mask_batch_stride + (size_t)min(row, a.seq - 1) * a.mask_row_stride;
}

__device__ __forceinline__ int mask_last_key(const float* mask, const Attn& a) {
  return mask == nullptr ? 0 : a.seq - 1;
}

// A logit of a checked tile with its mask entry added. A key past the end
// reads the last key's entry (the caller gives that key no weight), so the
// read needs no branch, and a tile's mask loads can go out together: with
// a branch around each read, BERT-base's key-mask attention (batch 32) took
// 0.19 ms against 0.078 (H100 SXM at 700 W; PERF.md).
__device__ __forceinline__ float masked_logit(float l, const float* mrow, int key, int last) {
  return l + __ldg(mrow + min(key, last));
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
  const float* mask_a = mask_row(mask, a, b, row_a);
  const float* mask_b = mask_row(mask, a, b, row_b);
  const int mask_last = mask_last_key(mask, a);
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
    return masked_logit(s[nt][e], e < 2 ? mask_a : mask_b, key_of(kt, nt, e), mask_last);
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
            float l = s[nt][e];
            if (kChecked) {  // (read, then select: no branch)
              const float lm = logit(s, kt, nt, e);
              l = key_of(kt, nt, e) < seq ? lm : neg_inf();
            }
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
          float p = softmax_weight<decltype(fast_c)::value, decltype(exp_c)::value>(
              kChecked ? logit(s, kt, nt, e) : s[nt][e], e < 2 ? m_a : m_b);
          // keys past the end weigh nothing (a clamped -inf would not be 0)
          if (kChecked && key_of(kt, nt, e) >= seq) p = 0.0f;
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
// bf16, D a multiple of 8: TMA + wgmma, warp-specialized
// ---------------------------------------------------------------------------
//
// A block owns one head and nwg x 64 query rows (nwg consumer warpgroups,
// up to Tma<DC>::kMaxWG, chosen per launch so that the query tiles cover S
// with the least waste); one more warpgroup is the producer. Its first
// thread loads the query tile once and then streams the key (and, in the
// second pass, value) tiles of 64 rows through a ring of Tma<DC>::kStages
// stages with full/empty mbarriers: pass 1 (exact softmax only) K alone,
// pass 2 K and V.
//
// Layouts. A head's row slice is D bf16 at a row stride of H*D (72 -> 144
// bytes at SO400M), which no single swizzled box takes. So a tile comes in
// two parts. Its first 64 (D = 64..120) or 128 (D = 128) columns arrive as
// [64 rows x 128 bytes] boxes with the 128-byte swizzle, from a 4-D view
// (D, rows, heads, batch): 128-byte row reads, and the layout wgmma reads
// K-major (q.k^T's B, K-major: 32 bytes on per k16 step, SBO = 8 rows) and
// MN-major (p.v's B, the transpose bit: 8 rows on per 8 keys, LBO = the next
// 64 columns). The rest, D % 64 columns in chunks of 8 (and all of D below
// 64), arrives as one box of [chunk][row][8 elements] from a 5-D view (8
// elements, rows, D/8 chunks, heads, batch) whose chunk dimension sits
// outside the row dimension: each 8 rows x 16 bytes are one contiguous
// no-swizzle core matrix (K-major: LBO = one chunk block, SBO = 8 rows;
// MN-major: LBO = 8 keys, SBO = one chunk block). Chunks past D (up to a
// multiple of 16 columns for q.k^T's depth) and rows past S are outside the
// views and arrive as zeros. q comes once, all of it in the chunk layout.
//
// Consumers: q's fragments come from shared memory once (ldmatrix), are
// scaled and rounded to bf16 in registers and stay there as the A operand
// of q.k^T (wgmma m64n64k16). The f32 logits come back in registers in the
// mma.sync accumulator layout; the softmax turns them into bf16 p, which is
// already the A operand layout of p.v (wgmma m64nNk16 over the swizzled
// part, and one over the chunk part). The exact softmax keeps its two
// passes (pass 1: q.k^T and the row max only).
//
// Overlap: wgmma runs asynchronously, so each warpgroup issues the next
// tile's q.k^T before it works on the current one (pass 1: the row max,
// from a second logit buffer; pass 2: q.k^T of tile j+1, then p.v of tile
// j, then the softmax of tile j+1 while p.v runs). Every issue and wait sits
// on a path without branches (the last tile is peeled off): ptxas keeps the
// products asynchronous only where it can count the groups in flight. The
// exp is ex2 of the f32 logit times log2(e) (ex2.approx); pairs of values
// round to bf16 in one conversion. Where the denominator sums p as rounded
// to bf16 (D not a multiple of 128), V's tile carries one more 8-column
// chunk of ones, as the TPU kernel's spare lane: p.v also yields the
// denominator.
template <int DC>
struct Tma {
  static constexpr int kMain = DC / 8;            // swizzled 64-column blocks
  static constexpr int kRC = DC - 8 * kMain;      // chunks of the rest
  static constexpr bool kOnes = DC < 16;          // D % 128 != 0: the ones chunk
  static constexpr int kKRest = (kRC + 1) / 2 * 2;  // K rest chunks, to q.k^T's depth
  static constexpr int kVRest = kRC + (kOnes ? 1 : 0);
  static constexpr int kDKC = 8 * kMain + kKRest;  // q chunks
  static constexpr int kKs = kDKC / 2;            // k16 steps of q.k^T
  static constexpr int kKT = 64;  // keys per tile
  static constexpr int kS = kKT / 2;  // logits a thread holds
  static constexpr int kMaxWG = 3;
  static constexpr int kConsumerRegs = 160, kProducerRegs = 32;
  static constexpr int kThreads = (kMaxWG + 1) * 128;
  static constexpr int kMainBytes = kKT * 128;   // one swizzled block of a tile
  static constexpr int kKBytes = kMain * kMainBytes + kKRest * kKT * 16;
  static constexpr int kVBytes = kMain * kMainBytes + kVRest * kKT * 16;
  static constexpr int kQMax = kDKC * kMaxWG * 64 * 16;
  // (stages start on 1024-byte boundaries: the swizzled blocks need them)
  static constexpr int kStageBytes = (kKBytes + kVBytes + 1023) / 1024 * 1024;
  static constexpr int kStages = (200 * 1024 - kQMax) / kStageBytes < 6
                                     ? (200 * 1024 - kQMax) / kStageBytes
                                     : 6;
  // + 1024: the swizzled boxes need a 1024-byte aligned base
  static constexpr size_t kSmem =
      1024 + kQMax + (size_t)kStages * kStageBytes + (2 * kStages + 1) * sizeof(uint64_t);
  static_assert(kStages >= 2, "ring too shallow");
  static_assert(kQMax % 1024 == 0 && kStageBytes % 1024 == 0 &&
                    (kMain == 0 || kKBytes % 1024 == 0),
                "1024-byte sections");
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;

template <int DC>
__global__ void __launch_bounds__(Tma<DC>::kThreads, 1)
    flash_tma_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmain,
                     const __grid_constant__ CUtensorMap vmain,
                     const __grid_constant__ CUtensorMap krest,
                     const __grid_constant__ CUtensorMap vrest, const float* __restrict__ mask,
                     bf16* __restrict__ op, const Attn a) {
  namespace hp = hopper;
  using L = Tma<DC>;
  constexpr int kKs = L::kKs, kMain = L::kMain, kRC = L::kRC, kVRest = L::kVRest;
  constexpr int kStages = L::kStages, kKT = L::kKT;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int nwg = blockDim.x / 128 - 1;
  const int qrows = nwg * 64;
  unsigned char* qs = smem;  // [kDKC][qrows][16 B]
  // stage: K [kMain][64][128 B] swizzled, [kKRest][64][16 B]; V the same
  // with kVRest chunks (the last one the ones)
  unsigned char* ring = smem + L::kQMax;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * L::kStageBytes);
  uint64_t* empty = full + kStages;
  uint64_t* qfull = empty + kStages;
  constexpr int kKRestOff = kMain * L::kMainBytes;
  constexpr int kVOff = L::kKBytes, kVRestOff = L::kKBytes + kMain * L::kMainBytes;

  const int seq = a.seq;
  const int b = blockIdx.x / a.heads, h = blockIdx.x % a.heads;
  const int q0 = blockIdx.y * qrows;
  const int n_kt = (seq + kKT - 1) / kKT;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], nwg);  // one arrival per consumer warpgroup
    }
    hp::mbar_init(qfull, 1);
    hp::mbar_fence_init();
  }
  if (L::kOnes) {  // every stage's V ones chunk (the TMA never writes it)
    for (int i = threadIdx.x; i < kStages * kKT; i += blockDim.x)
      *reinterpret_cast<uint4*>(ring + (i / kKT) * L::kStageBytes + kVRestOff +
                                kRC * kKT * 16 + (i % kKT) * 16) =
          make_uint4(0x3F803F80u, 0x3F803F80u, 0x3F803F80u, 0x3F803F80u);  // bf16 1.0
    hp::fence_proxy_async();
  }
  __syncthreads();

  if (wg == nwg) {  // producer
    hp::regs_dealloc<L::kProducerRegs>();
    if (threadIdx.x == nwg * 128) {
      hp::prefetch_map(&qmap);
      if (kMain) {
        hp::prefetch_map(&kmain);
        hp::prefetch_map(&vmain);
      }
      if (kRC) {
        hp::prefetch_map(&krest);
        hp::prefetch_map(&vrest);
      }
      hp::mbar_expect_tx(qfull, L::kDKC * qrows * 16);
      hp::tma_load_5d(qs, &qmap, qfull, 0, q0, 0, h, b);
      int it = 0;
      auto push = [&](int kt, bool with_v) {
        const int st = it % kStages;
        if (it >= kStages) hp::mbar_wait(&empty[st], ((it / kStages) - 1) & 1);
        unsigned char* dst = ring + st * L::kStageBytes;
        const int row = kt * kKT;
        hp::mbar_expect_tx(&full[st], (kMain * L::kMainBytes + L::kKRest * kKT * 16) +
                                          (with_v ? kMain * L::kMainBytes + kRC * kKT * 16 : 0));
        for (int m = 0; m < kMain; ++m)
          hp::tma_load_4d(dst + m * L::kMainBytes, &kmain, &full[st], 64 * m, row, h, b);
        if (kRC) hp::tma_load_5d(dst + kKRestOff, &krest, &full[st], 0, row, 8 * kMain, h, b);
        if (with_v) {
          for (int m = 0; m < kMain; ++m)
            hp::tma_load_4d(dst + kVOff + m * L::kMainBytes, &vmain, &full[st], 64 * m, row, h,
                            b);
          if (kRC)
            hp::tma_load_5d(dst + kVRestOff, &vrest, &full[st], 0, row, 8 * kMain, h, b);
        }
        ++it;
      };
      if (!a.fast)
        for (int kt = 0; kt < n_kt; ++kt) push(kt, false);
      for (int kt = 0; kt < n_kt; ++kt) push(kt, true);
    }
    return;
  }

  hp::regs_alloc<L::kConsumerRegs>();
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row_a = q0 + wg * 64 + warp * 16 + g, row_b = row_a + 8;
  const float* mask_a = mask_row(mask, a, b, row_a);
  const float* mask_b = mask_row(mask, a, b, row_b);
  const int mask_last = mask_last_key(mask, a);

  // q: this warpgroup's 64 rows scaled and rounded in place (zeros past D),
  // then read by q.k^T straight from shared memory
  hp::mbar_wait(qfull, 0);
  for (int i = threadIdx.x % 128; i < L::kDKC * 64; i += 128) {
    uint4* p = reinterpret_cast<uint4*>(qs + ((size_t)(i / 64) * qrows + wg * 64 + i % 64) * 16);
    uint4 u = *p;
    __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      h2[j] = __halves2bfloat162(__float2bfloat16(__low2float(h2[j]) * a.scale),
                                 __float2bfloat16(__high2float(h2[j]) * a.scale));
    *p = u;
  }
  hp::fence_proxy_async();
  hp::named_sync(1 + wg, 128);

  int it = 0;  // position in the producer's sequence of tiles
  auto stage_of = [&](int i) { return ring + (i % kStages) * L::kStageBytes; };
  auto wait_full = [&](int i) { hp::mbar_wait(&full[i % kStages], (i / kStages) & 1); };
  auto release = [&](int i) {
    if (threadIdx.x % 128 == 0) hp::mbar_arrive(&empty[i % kStages]);
  };
  // issue (not wait for) the logits of this warpgroup's 64 rows against the
  // kKT keys of one K tile; s[4*nt + e] sits at row e < 2 ? row_a : row_b,
  // key nt*8 + 2t + (e & 1)
  // (q: K-major, no swizzle: LBO = one chunk block of qrows rows, SBO = 8 rows)
  const unsigned char* qa = qs + wg * 64 * 16;
  auto issue_scores = [&](const unsigned char* ktile, float (&s)[L::kS]) {
    hp::fence_regs(s);
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKs; ++kk) {
      const uint64_t d =
          kk < 4 * kMain
              ? hp::desc(ktile + (kk / 4) * L::kMainBytes + (kk % 4) * 32, 16, 1024,
                         hp::kSwizzle128)
              : hp::desc(ktile + kKRestOff + (kk - 4 * kMain) * 2 * kKT * 16, kKT * 16, 128,
                         hp::kInterleave);
      const uint64_t dq = hp::desc(qa + kk * 2 * qrows * 16, qrows * 16, 128, hp::kInterleave);
      WgmmaSS<kKT, 0>::run(s, dq, d, kk > 0);
    }
    hp::wgmma_commit();
  };
  auto key_of = [&](int kt, int nt, int e) { return kt * kKT + nt * 8 + 2 * t + (e & 1); };
  auto logit = [&](const float (&s)[L::kS], int kt, int nt, int e) {
    return masked_logit(s[4 * nt + e], e < 2 ? mask_a : mask_b, key_of(kt, nt, e), mask_last);
  };
  // A tile whose keys all exist and that has no mask takes its logits as
  // they are: the per-element checks, resolved per tile at compile time.
  auto plain_tile = [&](int kt) { return mask == nullptr && (kt + 1) * kKT <= seq; };

  // pass 1 (exact softmax): the whole-row max over every key tile, tile
  // kt + 1's q.k^T in flight while tile kt's max is taken
  float m_a = neg_inf(), m_b = neg_inf();
  if (!a.fast) {
    auto tile_max = [&](const float (&s)[L::kS], int kt) {
      auto body = [&](auto checked) {
        constexpr bool kChecked = decltype(checked)::value;
#pragma unroll
        for (int nt = 0; nt < kKT / 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float l = s[4 * nt + e];
            if (kChecked) {  // (read, then select: no branch)
              const float lm = logit(s, kt, nt, e);
              l = key_of(kt, nt, e) < seq ? lm : neg_inf();
            }
            if (e < 2) m_a = fmaxf(m_a, l); else m_b = fmaxf(m_b, l);
          }
        }
      };
      if (plain_tile(kt)) body(No{}); else body(Yes{});
    };
    // cur holds tile kt's logits: start tile kt + 1's into nxt, take kt's max
    auto step = [&](int kt, float (&cur)[L::kS], float (&nxt)[L::kS]) {
      release(it++);
      wait_full(it);
      issue_scores(stage_of(it), nxt);
      tile_max(cur, kt);
      hp::wgmma_wait<0>();
      hp::fence_regs(nxt);
    };
    float s0[L::kS], s1[L::kS];
    wait_full(it);
    issue_scores(stage_of(it), s0);
    hp::wgmma_wait<0>();
    hp::fence_regs(s0);
    int kt = 0;
    for (; kt + 2 < n_kt; kt += 2) {
      step(kt, s0, s1);
      step(kt + 1, s1, s0);
    }
    if (kt + 1 < n_kt) {  // two tiles left
      step(kt, s0, s1);
      release(it++);
      tile_max(s1, kt + 1);
    } else {
      release(it++);
      tile_max(s0, kt);
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
  constexpr int kAM = kMain ? 32 * kMain : 1, kAR = kVRest ? 4 * kVRest : 1;
  float acc_m[kAM], acc_r[kAR];  // p.v over the swizzled columns, over the chunks
#pragma unroll
  for (int i = 0; i < kAM; ++i) acc_m[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < kAR; ++i) acc_r[i] = 0.0f;
  float l_a = 0.0f, l_b = 0.0f;  // the denominator where V has no ones chunk
  // p of one tile as the A operand of the 4 k16 steps of p.v: pairs of keys
  // of one row, each pair rounded to bf16 in one conversion
  auto weights = [&](const float (&s)[L::kS], uint32_t (&pa)[L::kKT / 16][4], int kt, auto checked,
                     auto fast_c, auto exp_c) {
    constexpr bool kChecked = decltype(checked)::value;
    constexpr bool kFast = decltype(fast_c)::value, kExpBf16 = decltype(exp_c)::value;
#pragma unroll
    for (int nt = 0; nt < kKT / 8; ++nt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {  // row_a, then row_b
        float p[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int e = 2 * half + j;
          // (keys past the end: their weight is set to 0 below)
          const float l = kChecked ? logit(s, kt, nt, e) : s[4 * nt + e];
          // (the exact softmax subtracts the max before scaling by log2(e):
          // in a row whose every key is masked, l = m = -1e30, and only the
          // difference is exactly 0)
          if (kFast) p[j] = fminf(fmaxf(l, -60.0f), 60.0f);
          else p[j] = l - (half ? m_b : m_a);
        }
        if (kExpBf16) {  // the exp's argument rounded to bf16
          const float2 r = __bfloat1622float2(__floats2bfloat162_rn(p[0], p[1]));
          p[0] = ex2(r.x * kLog2e);
          p[1] = ex2(r.y * kLog2e);
        } else {
          p[0] = ex2(p[0] * kLog2e);
          p[1] = ex2(p[1] * kLog2e);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j)  // keys past the end weigh nothing
          if (kChecked && key_of(kt, nt, 2 * half + j) >= seq) p[j] = 0.0f;
        __nv_bfloat162 pb = __floats2bfloat162_rn(p[0], p[1]);
        if (!L::kOnes) {  // under exp_bf16, p is the rounded value
          const float2 r = kExpBf16 ? __bfloat1622float2(pb) : make_float2(p[0], p[1]);
          if (half) l_b += r.x + r.y; else l_a += r.x + r.y;
        }
        pa[nt / 2][(nt & 1) * 2 + half] = *reinterpret_cast<uint32_t*>(&pb);
      }
    }
  };
  auto softmax = [&](const float (&s)[L::kS], uint32_t (&pa)[L::kKT / 16][4], int kt) {
    auto with_flags = [&](auto checked) {
      if (a.fast) {
        if (a.exp_bf16) weights(s, pa, kt, checked, Yes{}, Yes{});
        else weights(s, pa, kt, checked, Yes{}, No{});
      } else {
        if (a.exp_bf16) weights(s, pa, kt, checked, No{}, Yes{});
        else weights(s, pa, kt, checked, No{}, No{});
      }
    };
    if (plain_tile(kt)) with_flags(No{}); else with_flags(Yes{});
  };
  // (the caller has put p's and the accumulators' registers in place)
  auto issue_pv = [&](const unsigned char* tile, const uint32_t (&pa)[L::kKT / 16][4]) {
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKT / 16; ++kk) {
      if constexpr (kMain > 0)
        WgmmaRS<64 * kMain, 1>::run(
            acc_m, pa[kk],
            hp::desc(tile + kVOff + kk * 2048, L::kMainBytes, 1024, hp::kSwizzle128), 1);
      if constexpr (kVRest > 0)
        WgmmaRS<8 * kVRest, 1>::run(
            acc_r, pa[kk], hp::desc(tile + kVRestOff + kk * 256, 128, kKT * 16, hp::kInterleave),
            1);
    }
    hp::wgmma_commit();
  };

  // Registers a product reads are settled (fenced) before anything is in
  // flight: ptxas serializes the products if an instruction defines them
  // while one runs.
  auto settle = [&](uint32_t (&pa)[L::kKT / 16][4]) {
    hp::fence_regs(pa);
    hp::fence_regs(acc_m);
    hp::fence_regs(acc_r);
  };
  // p of tile kt in `cur`: tile kt + 1's q.k^T first, then tile kt's p.v,
  // and tile kt + 1's softmax into `nxt` while p.v runs
  float s[L::kS];
  auto step = [&](int kt, uint32_t (&cur)[L::kKT / 16][4], uint32_t (&nxt)[L::kKT / 16][4]) {
    settle(cur);
    wait_full(it + 1);
    issue_scores(stage_of(it + 1), s);
    issue_pv(stage_of(it), cur);
    hp::wgmma_wait<1>();
    hp::fence_regs(s);
    softmax(s, nxt, kt + 1);
    hp::wgmma_wait<0>();
    settle(cur);
    release(it++);
  };
  auto last = [&](uint32_t (&cur)[L::kKT / 16][4]) {
    settle(cur);
    issue_pv(stage_of(it), cur);
    hp::wgmma_wait<0>();
    settle(cur);
    release(it++);
  };
  uint32_t pa[L::kKT / 16][4], pn[L::kKT / 16][4];
  wait_full(it);
  issue_scores(stage_of(it), s);
  hp::wgmma_wait<0>();
  hp::fence_regs(s);
  softmax(s, pa, 0);
  {
    int kt = 0;
    for (; kt + 2 < n_kt; kt += 2) {
      step(kt, pa, pn);
      step(kt + 1, pn, pa);
    }
    if (kt + 1 < n_kt) {  // two tiles left
      step(kt, pa, pn);
      last(pn);
    } else {
      last(pa);
    }
  }

  if (L::kOnes) {  // column 8*DC (and the 7 beside it) of p.v: the sum of the rounded p
    l_a = acc_r[4 * kRC];
    l_b = acc_r[4 * kRC + 2];
  } else {
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      l_a += __shfl_xor_sync(0xffffffffu, l_a, o);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, o);
    }
  }
  const float inv_a = 1.0f / l_a, inv_b = 1.0f / l_b;
  bf16* out = op + (size_t)b * a.batch_stride + (size_t)h * a.head_stride;
#pragma unroll
  for (int nc = 0; nc < DC; ++nc) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = half ? row_b : row_a;
      const float inv = half ? inv_b : inv_a;
      // (nc is a constant here: each value comes from its register)
      const int im = (4 * nc + 2 * half) % kAM, ir = (4 * (nc - 8 * kMain) + 2 * half) % kAR;
      const bool swz = nc < 8 * kMain;
      const float o0 = swz ? acc_m[im] : acc_r[ir], o1 = swz ? acc_m[im + 1] : acc_r[ir + 1];
      if (row < seq)
        *reinterpret_cast<uint32_t*>(out + (size_t)row * a.row_stride + nc * 8 + 2 * t) =
            pack_bf16(__float2bfloat16(o0 * inv), __float2bfloat16(o1 * inv));
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
  const float* mrow = mask + (size_t)b * a.mask_batch_stride;  // (unused without a mask)
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
            if (mask != nullptr && row < seq) l += mrow[(size_t)row * a.mask_row_stride + key];
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
          if (mask != nullptr && row < seq) l += mrow[(size_t)row * a.mask_row_stride + key];
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

// Consumer warpgroups per block for `seq` query rows: 3, fewer where that
// leaves fewer idle 64-row tiles (or the sequence needs fewer).
inline int tma_warpgroups(int seq) {
  const int n64 = (seq + 63) / 64;
  if (n64 <= 2) return n64;
  const int waste3 = (n64 + 2) / 3 * 3 - n64, waste2 = (n64 + 1) / 2 * 2 - n64;
  return waste3 <= waste2 ? 3 : 2;
}

// The 5-D view (8 elements, rows, chunks of 8, heads, batch) of one of q, k,
// v, loaded in boxes of [chunks][rows][8].
inline bool tma_chunk_map(CUtensorMap* map, const void* base, const Attn& a, int rows,
                          int chunks) {
  const cuuint64_t dims[5] = {8, (cuuint64_t)a.seq, (cuuint64_t)(a.d / 8), (cuuint64_t)a.heads,
                              (cuuint64_t)a.batch};
  const cuuint64_t strides[4] = {(cuuint64_t)a.row_stride * 2, 16, (cuuint64_t)a.head_stride * 2,
                                 (cuuint64_t)a.batch_stride * 2};
  const cuuint32_t box[5] = {8, (cuuint32_t)rows, (cuuint32_t)chunks, 1, 1};
  return hopper::bf16_map(map, base, 5, dims, strides, box, false);
}

// The 4-D view (D, rows, heads, batch) of k or v, loaded in swizzled boxes
// of [rows][64 columns].
inline bool tma_swizzled_map(CUtensorMap* map, const void* base, const Attn& a, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)a.d, (cuuint64_t)a.seq, (cuuint64_t)a.heads,
                              (cuuint64_t)a.batch};
  const cuuint64_t strides[3] = {(cuuint64_t)a.row_stride * 2, (cuuint64_t)a.head_stride * 2,
                                 (cuuint64_t)a.batch_stride * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  return hopper::bf16_map(map, base, 4, dims, strides, box, true);
}

template <int DC>
int launch_tma(const Attn& a, cudaStream_t stream) {
  using L = Tma<DC>;
  if (((reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
        reinterpret_cast<uintptr_t>(a.v)) % 16) != 0)
    return (int)cudaErrorInvalidValue;  // TMA reads 16-byte aligned tensors
  if (a.denom_rounded != (L::kOnes ? 1 : 0)) return (int)cudaErrorInvalidValue;
  const int nwg = tma_warpgroups(a.seq);
  // the parts a head dim has no use for get q's map (never loaded)
  CUtensorMap qmap, kmain, vmain, krest, vrest;
  bool ok = tma_chunk_map(&qmap, a.q, a, nwg * 64, L::kDKC);
  kmain = vmain = krest = vrest = qmap;
  if (L::kMain > 0)
    ok = ok && tma_swizzled_map(&kmain, a.k, a, L::kKT) &&
         tma_swizzled_map(&vmain, a.v, a, L::kKT);
  if (L::kRC > 0)
    ok = ok && tma_chunk_map(&krest, a.k, a, L::kKT, L::kKRest) &&
         tma_chunk_map(&vrest, a.v, a, L::kKT, L::kRC);
  if (!ok) return (int)cudaErrorInvalidValue;
  auto kern = flash_tma_kernel<DC>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.batch * a.heads, (a.seq + nwg * 64 - 1) / (nwg * 64));
  kern<<<grid, (nwg + 1) * 128, L::kSmem, stream>>>(qmap, kmain, vmain, krest, vrest, a.mask,
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

// dtype: 0 = float32, 1 = bfloat16. The route is the shape's: f32 takes the
// FMA kernel; bf16 with D a multiple of 8 (16-byte rows, as TMA needs) the
// TMA + wgmma kernel, which then needs 16-byte aligned q, k and v, where the
// denominator is the one its ones chunk gives (denom_rounded exactly when D
// is not a multiple of 128); bf16 otherwise the mma.sync kernel. Returns
// cudaGetLastError().
inline int launch(const Attn& a, int dtype, cudaStream_t stream) {
  if (a.d < 1 || a.d > kMaxDP) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch_f32(a, stream);  // f32: p rounded to v's type is p itself
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (a.d % 8 == 0 && a.denom_rounded == (a.d % 128 != 0 ? 1 : 0)) {
    switch (a.d / 8) {
#define CLIPK_FLASH_TMA(N) \
  case N:                  \
    return launch_tma<N>(a, stream);
      CLIPK_FLASH_TMA(1)
      CLIPK_FLASH_TMA(2)
      CLIPK_FLASH_TMA(3)
      CLIPK_FLASH_TMA(4)
      CLIPK_FLASH_TMA(5)
      CLIPK_FLASH_TMA(6)
      CLIPK_FLASH_TMA(7)
      CLIPK_FLASH_TMA(8)
      CLIPK_FLASH_TMA(9)
      CLIPK_FLASH_TMA(10)
      CLIPK_FLASH_TMA(11)
      CLIPK_FLASH_TMA(12)
      CLIPK_FLASH_TMA(13)
      CLIPK_FLASH_TMA(14)
      CLIPK_FLASH_TMA(15)
      CLIPK_FLASH_TMA(16)
#undef CLIPK_FLASH_TMA
    }
  }
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

// ---------------------------------------------------------------------------
// rope pre-pass (kernel 2: flash_packed.cu, flash_int8.cu)
// ---------------------------------------------------------------------------

// (x0, x1) -> (x0 cos0 - x1 sin0, x1 cos1 + x0 sin1): x*cos + rot(x)*sin on
// one lane pair in f32, each product and sum rounded as the plain version
// rounds them (no fma contraction).
__device__ __forceinline__ void rope_pair(float& x0, float& x1, float2 sn, float2 cs) {
  const float y0 = __fadd_rn(__fmul_rn(x0, cs.x), __fmul_rn(-x1, sn.x));
  const float y1 = __fadd_rn(__fmul_rn(x1, cs.y), __fmul_rn(x0, sn.y));
  x0 = y0;
  x1 = y1;
}

// qr/kr = rope(q)/rope(k), each rounded to T: one thread per lane pair of
// the [rows = B*S, width = H*D] tensors, table row = token % seq.
template <typename T>
__global__ void __launch_bounds__(256)
    rope_kernel(const T* __restrict__ q, const T* __restrict__ k, const float* __restrict__ sin,
                const float* __restrict__ cos, T* __restrict__ qr, T* __restrict__ kr,
                long long pairs, int seq, int width) {
  const int half = width / 2;
  for (long long i = blockIdx.x * 256ll + threadIdx.x; i < pairs; i += 256ll * gridDim.x) {
    const long long row = i / half;
    const int c = 2 * (int)(i % half);
    const size_t t = (size_t)(row % seq) * width + c, e = (size_t)row * width + c;
    const float2 sn = *reinterpret_cast<const float2*>(sin + t);
    const float2 cs = *reinterpret_cast<const float2*>(cos + t);
    float x0 = to_f(q[e]), x1 = to_f(q[e + 1]);
    rope_pair(x0, x1, sn, cs);
    qr[e] = from_f<T>(x0);
    qr[e + 1] = from_f<T>(x1);
    x0 = to_f(k[e]);
    x1 = to_f(k[e + 1]);
    rope_pair(x0, x1, sn, cs);
    kr[e] = from_f<T>(x0);
    kr[e + 1] = from_f<T>(x1);
  }
}

// The rope pre-pass of [batch, seq, width] q and k into qr and kr. dtype: 0
// = float32, 1 = bfloat16. Returns cudaGetLastError().
inline int launch_rope(const void* q, const void* k, const void* sin, const void* cos, void* qr,
                       void* kr, int batch, int seq, int width, int dtype, cudaStream_t stream) {
  const long long pairs = (long long)batch * seq * width / 2;
  const int blocks = (int)std::min<long long>((pairs + 255) / 256, 132ll * 16);
  if (dtype == 1)
    rope_kernel<bf16><<<blocks, 256, 0, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const float*>(sin),
        static_cast<const float*>(cos), static_cast<bf16*>(qr), static_cast<bf16*>(kr), pairs,
        seq, width);
  else
    rope_kernel<float><<<blocks, 256, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(sin), static_cast<const float*>(cos), static_cast<float*>(qr),
        static_cast<float*>(kr), pairs, seq, width);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// kernel 2's calls (flash_packed.cu, flash_int8.cu)
// ---------------------------------------------------------------------------

// The Attn of a call on [batch, seq, heads*d] q/k/v/out with an additive f32
// mask given by its element strides (flash_packed_launch has the forms);
// with rope tables the pre-pass first rotates q and k into qr and kr, which
// the Attn then reads. The caller sets the softmax's fields. Returns 0, or a
// cudaError: a stride pair of no form, another dtype, rope with a mask or
// an odd d or without its scratch, the pre-pass's launch error.
inline int packed_call(Attn* a, const void* q, const void* k, const void* v, const void* mask,
                       long long mask_batch_stride, long long mask_row_stride, const void* sin,
                       const void* cos, void* qr, void* kr, void* out, int batch, int seq,
                       int heads, int d, int dtype, cudaStream_t stream) {
  const long long sb = mask_batch_stride, sr = mask_row_stride, s = seq;
  const bool form_ok = mask == nullptr ? sb == 0 && sr == 0
                                       : (sb == 0 && (sr == s || sr == 0)) ||
                                             (sb == s && sr == 0) || (sb == s * s && sr == s);
  if (!form_ok || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  *a = Attn{};
  a->q = q;
  a->k = k;
  a->v = v;
  a->mask = static_cast<const float*>(mask);
  a->mask_batch_stride = sb;
  a->mask_row_stride = sr;
  a->out = out;
  a->batch_stride = (long long)seq * heads * d;
  a->head_stride = d;
  a->row_stride = (long long)heads * d;
  a->batch = batch;
  a->seq = seq;
  a->heads = heads;
  a->d = d;
  if (sin == nullptr && cos == nullptr) return 0;
  if (sin == nullptr || cos == nullptr || qr == nullptr || kr == nullptr || d % 2 != 0 ||
      mask != nullptr)
    return (int)cudaErrorInvalidValue;
  const int err = launch_rope(q, k, sin, cos, qr, kr, batch, seq, heads * d, dtype, stream);
  a->q = qr;
  a->k = kr;
  return err;
}

}  // namespace flash
}  // namespace CLIPK_SOURCE
}  // namespace clipk
