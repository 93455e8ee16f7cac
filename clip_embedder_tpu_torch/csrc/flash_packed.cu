// Packed-head self-attention for Hopper (sm_90a), with optional 2-D rope.
//
// Replaces the TPU kernel clip_embedder_tpu/ops/flash.py
// `flash_attention_packed` (`_packed_kernel`): per head,
// softmax(q*scale*k^T + mask) v on q/k/v in the [B, S, H*D] projection
// layout, output in the same layout; with rope tables ([S, H*D] f32 sin and
// cos, as ops/rope.py builds them for PE-Core), q and k are first rotated
// in f32, x*cos + rot(x)*sin with rot = (-x1, x0, -x3, x2, ...) within each
// head, and rounded to the input type (`_rope_rotate`); the scale then
// folds into q. The attention's arithmetic is flash.cuh's (shared with
// flash_bhsd.cu, kernel 3).
//
// Masks: the JAX kernel's four forms (one shared [S, S] mask, and per batch
// element a key row [B, 1, 1, S] or a full [B, 1, S, S] block) are one
// additive f32 array read through a batch stride and a row stride
// (flash.cuh `Attn`): the block of batch element b reads its own rows, and
// a key row is read with row stride 0 by every query row.
//
// What bounds it on the H100: at the SO400M shape (S = 576, D = 72) it does
// 4*S*D FLOP per query row against 4*D*2 bytes of q/k/v/out per row: S/2 =
// 288 FLOP per byte, at the card's ridge (~295), so by the data-sheet peaks
// memory and the tensor cores bound it about equally; at PE-Core's (S =
// 1025, D = 96) the products bound it (512 FLOP per byte). The exp of the
// S*S logits per head (one special-function op each) is a third limit of
// the same size. Rope adds one read of each [S, H*D] f32 table.
//
// What the design does about that: a block per (batch*head, up to 192
// query rows) reads its head's columns straight from the packed layout
// (column offset h*D, row stride H*D; no transposes) through TMA views of
// those strides: a producer warp streams key/value tiles into an mbarrier
// ring, three consumer warpgroups run q.k^T and p.v on wgmma with the
// logits and the softmax in registers between them, the next tile's q.k^T
// in flight during the softmax (flash.cuh has the layouts; head dims that
// are not a multiple of 8 keep the first mma.sync kernel).
// Rope runs as a pre-pass (`rope_kernel`): one thread per lane pair rotates
// q and k once into scratch copies, which the attention kernel then reads.
// The TPU kernel rotates inside the attention kernel because its block holds
// a whole head; here a head's keys pass through every one of its 17 query
// tiles' blocks, twice for the exact softmax. Rotating them there, with the
// table reads, took 11.10 ms at PE-Core's shape (batch 32) against 2.49 ms
// for the pre-pass and the attention together (chip_smoke.py, H100 SXM,
// one run; PERF.md). The pre-pass moves 4 * B*S*H*D * 2 bytes plus the
// tables (~0.13 ms at batch 32 by the bytes).

#include <algorithm>

#include "flash.cuh"

namespace {

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
    float x0 = clipk::to_f(q[e]), x1 = clipk::to_f(q[e + 1]);
    rope_pair(x0, x1, sn, cs);
    qr[e] = clipk::from_f<T>(x0);
    qr[e + 1] = clipk::from_f<T>(x1);
    x0 = clipk::to_f(k[e]);
    x1 = clipk::to_f(k[e + 1]);
    rope_pair(x0, x1, sn, cs);
    kr[e] = clipk::from_f<T>(x0);
    kr[e + 1] = clipk::from_f<T>(x1);
  }
}

template <typename T>
int launch_rope(const void* q, const void* k, const void* sin, const void* cos, void* qr,
                void* kr, int batch, int seq, int width, cudaStream_t stream) {
  const long long pairs = (long long)batch * seq * width / 2;
  const int blocks = (int)std::min<long long>((pairs + 255) / 256, 132ll * 16);
  rope_kernel<T><<<blocks, 256, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const float*>(sin),
      static_cast<const float*>(cos), static_cast<T*>(qr), static_cast<T*>(kr), pairs, seq,
      width);
  return (int)cudaGetLastError();
}

}  // namespace

// q/k/v/out: [batch, seq, heads*d] contiguous; mask: null or an additive
// f32 mask in one of the forms of the JAX kernel, given by its element
// strides (mask_batch_stride, mask_row_stride): shared [seq, seq] (0, seq),
// one shared key row [seq] (0, 0), a key row per batch element [batch, seq]
// (seq, 0; the BERT text towers' padding mask), a full block per batch
// element [batch, seq, seq] (seq*seq, seq; CoCa's causal + cls mask); any
// other pair is refused, and both are 0 without a mask. sin/cos: null or
// [seq, heads*d] f32 rope tables (d even; not with a mask), with qr/kr:
// scratch like q for the rotated q and k. d <= 128. dtype: 0 = float32,
// 1 = bfloat16. Returns cudaGetLastError().
extern "C" int flash_packed_launch(const void* q, const void* k, const void* v,
                                   const void* mask, long long mask_batch_stride,
                                   long long mask_row_stride, const void* sin, const void* cos,
                                   void* qr, void* kr, void* out, int batch, int seq, int heads,
                                   int d, float scale, int fast, int exp_bf16, int denom_rounded,
                                   int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long sb = mask_batch_stride, sr = mask_row_stride, s = seq;
  const bool form_ok = mask == nullptr ? sb == 0 && sr == 0
                                       : (sb == 0 && (sr == s || sr == 0)) ||
                                             (sb == s && sr == 0) || (sb == s * s && sr == s);
  if (!form_ok) return (int)cudaErrorInvalidValue;
  clipk::flash::Attn a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.mask = static_cast<const float*>(mask);
  a.mask_batch_stride = sb;
  a.mask_row_stride = sr;
  a.out = out;
  a.batch_stride = (long long)seq * heads * d;
  a.head_stride = d;
  a.row_stride = (long long)heads * d;
  a.batch = batch;
  a.seq = seq;
  a.heads = heads;
  a.d = d;
  a.scale = scale;
  a.fast = fast;
  a.exp_bf16 = exp_bf16;
  a.denom_rounded = denom_rounded;
  if (sin != nullptr || cos != nullptr) {
    if (sin == nullptr || cos == nullptr || qr == nullptr || kr == nullptr || d % 2 != 0 ||
        mask != nullptr || (dtype != 0 && dtype != 1))
      return (int)cudaErrorInvalidValue;
    const int w = heads * d;
    const int err = dtype == 1 ? launch_rope<clipk::bf16>(q, k, sin, cos, qr, kr, batch, seq, w, st)
                               : launch_rope<float>(q, k, sin, cos, qr, kr, batch, seq, w, st);
    if (err != 0) return err;
    a.q = qr;
    a.k = kr;
  }
  return clipk::flash::launch(a, dtype, st);
}
