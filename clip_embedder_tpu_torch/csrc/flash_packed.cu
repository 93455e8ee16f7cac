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
// The JAX kernel's int8 options, quant_qk and quant_pv, are flash_int8.cu's.

#include "flash.cuh"

// q/k/v/out: [batch, seq, heads*d] contiguous; mask: null or an additive
// f32 mask in one of the forms of the JAX kernel, given by its element
// strides (mask_batch_stride, mask_row_stride): shared [seq, seq] (0, seq),
// one shared key row [seq] (0, 0), a key row per batch element [batch, seq]
// (seq, 0; the BERT text towers' padding mask), a full block per batch
// element [batch, seq, seq] (seq*seq, seq; CoCa's causal + cls mask); any
// other pair is refused, and both are 0 without a mask. sin/cos: null or
// [seq, heads*d] f32 rope tables (d even; not with a mask), with qr/kr:
// scratch like q for the rotated q and k. d <= 128. denom_rounded: the
// denominator sums p rounded to the input type (the JAX kernel's mxu_denom
// where d is not a multiple of 128). dtype: 0 = float32, 1 = bfloat16.
// Returns cudaGetLastError(). The int8 options take flash_int8.cu's entry.
extern "C" int flash_packed_launch(const void* q, const void* k, const void* v,
                                   const void* mask, long long mask_batch_stride,
                                   long long mask_row_stride, const void* sin, const void* cos,
                                   void* qr, void* kr, void* out, int batch, int seq, int heads,
                                   int d, float scale, int fast, int exp_bf16, int denom_rounded,
                                   int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  clipk::flash::Attn a;
  const int err = clipk::flash::packed_call(&a, q, k, v, mask, mask_batch_stride,
                                            mask_row_stride, sin, cos, qr, kr, out, batch, seq,
                                            heads, d, dtype, st);
  if (err != 0) return err;
  a.scale = scale;
  a.fast = fast;
  a.exp_bf16 = exp_bf16;
  a.denom_rounded = denom_rounded;
  return clipk::flash::launch(a, dtype, st);
}
