// Attention on the [B, H, S, D] layout for Hopper (sm_90a).
//
// Replaces the TPU kernel clip_embedder_tpu/ops/flash.py `flash_attention`
// (`_attn_kernel`): per (batch, head), softmax(q*scale*k^T + mask) v with
// one additive [S, S] mask shared by every batch row and head (the causal
// mask) or none; `fast` clamps the logits to +-60; the exp is always f32.
// When D is not a multiple of 128 the TPU kernel pads v to the 128-lane
// width and sets a spare lane to 1, so the p.v matmul also emits the
// denominator: a sum of p as rounded to v's type. This kernel sums the
// same rounded p. The TPU kernel also pads S to a multiple of 8 with
// masked keys, a layout detail of its (8, 128) tiles: this one works on the
// logical S (with `fast`, each padded key added exp(-60) ~ 9e-27 to the
// denominator there). The JAX package sends every self-attention whose
// heads form no 128-lane group here (the golden fixtures' 4 heads x 16).
//
// What bounds it on the H100: the same work as the packed kernel, 4*S*D
// FLOP per query row against 4*D*2 bytes per row of q/k/v/out, so bytes
// for short sequences and narrow heads (the fixtures' S = 16, D = 16) and
// the tensor cores from S*D/2 ~ 295 FLOP per byte up.
//
// What the design does about that: it is flash.cuh's kernels, reading each
// head's [S, D] slice at head stride S*D and row stride D instead of the
// packed layout's strides. Its main path, the golden fixtures in f32, takes
// the FMA kernel; bf16 takes the TMA + wgmma kernel where D is a multiple
// of 8 (TMA views of the same strides), else the mma.sync one. No padding
// of S or D goes through device memory.

#include "flash.cuh"

// q/k/v/out: [batch, heads, seq, d] contiguous; mask: null or a shared
// additive [seq, seq] f32 mask. d <= 128. dtype: 0 = float32, 1 = bfloat16.
// Returns cudaGetLastError().
extern "C" int flash_bhsd_launch(const void* q, const void* k, const void* v, const void* mask,
                                 void* out, int batch, int heads, int seq, int d, float scale,
                                 int fast, int denom_rounded, int dtype, void* stream) {
  clipk::flash::Attn a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.mask = static_cast<const float*>(mask);
  a.mask_row_stride = mask == nullptr ? 0 : seq;
  a.out = out;
  a.batch_stride = (long long)heads * seq * d;
  a.head_stride = (long long)seq * d;
  a.row_stride = d;
  a.batch = batch;
  a.seq = seq;
  a.heads = heads;
  a.d = d;
  a.scale = scale;
  a.fast = fast;
  a.denom_rounded = denom_rounded;
  return clipk::flash::launch(a, dtype, static_cast<cudaStream_t>(stream));
}
