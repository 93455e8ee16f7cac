// Packed-head self-attention with int8 products for Hopper (sm_90a), bf16
// with D a multiple of 8: kernel 2's quant_qk and quant_pv options on the
// shape of flash.cuh's `flash_tma_kernel` (TMA, warp specialisation, the
// next tile's q.k^T in flight during the softmax).
//
// Replaces the TPU kernel clip_embedder_tpu/ops/flash.py:308
// `flash_attention_packed` (`_packed_kernel`, flash.py:188-281) called with
// `quant_qk` and/or `quant_pv`, for the shapes its TMA route takes; f32 and
// the other head dims stay on flash_int8.cu. The function (after rope,
// where tables are given):
// - quant_qk: q*scale rounded to bf16, then per row int8 codes round(x / s)
//   clipped to +-127, s = amax/127 (1 where the amax is 0); k with one such
//   scale for the (batch, head) slab; q.k^T in int32. Without a mask and
//   without `fast` the row max is taken on the int32 products and p =
//   exp(f32(acc - max) * sq * sk); otherwise the logits are f32(acc) * sq *
//   sk (+ mask) and the softmax is flash.cuh's.
// - quant_pv: the denominator is the f32 sum of p; p per row with s =
//   rowmax(p)/127 and codes in [0, 127] (under exp_bf16 p, s and p/s are
//   bf16), v per column over the head's S rows; out = f32(pq.vq) * (s_p *
//   s_v) / denominator.
// The half that is not quantized is bf16 wgmma into f32, as in the exact
// kernel. Every code and scale is made by flash_int8.cuh's code() /
// scale_of() / p_code() / p_scale(), as on the other route.
//
// What bounds it on the H100: the exact kernel's work (4*S*D operations per
// query row per head, S*S exps per head), a quantized product at the int8
// rate (twice bf16's); q, k, v read and out written once, and for quant_pv
// one more read of v, whose column scales span every row before its first
// code exists. At SO400M's [32, 576, 16x72] memory bounds it (0.0507 /
// 0.0634 ms); in practice, as for the exact kernel, the latency between a
// tile's products and its softmax does, and the softmax here does more an
// element (the int32 conversion; under quant_pv p's code and its sum).
//
// What the design does about that:
// 1. Scales before codes, in one launch (`prep_kernel`, one block per
//    (batch*head, operand)): k's slab |max| and v's column |max| need every
//    row before any code exists, so the block reads its [S, D] slab once
//    (kept in shared memory up to 100 KB, else read a second time, mostly
//    from L2), writes the scales (B*H and B*H*D floats) and then the codes,
//    1 byte an element, each 64-key tile in the layout wgmma reads it: k
//    [D32/16][64 keys][16 B] (K-major B of q.k^T), v transposed, [4 key
//    chunks][D32][16 B] (K-major B of p.v: s8 wgmma reads no MN-major
//    operand), zero past S and D. The attention kernel takes a tile of codes
//    in one bulk copy. Chosen over a converter warpgroup that would turn
//    the bf16 tiles into codes inside the attention kernel (not built):
//    that repeats an IEEE division per element once per block of query rows
//    (three times at S = 576), on the SM whose issue slots the softmax
//    needs; made once, the codes also halve the tiles' bytes.
// 2. q's codes in the kernel: the consumer warpgroup loads its bf16 rows by
//    TMA once, scales and rounds them as flash_tma_kernel does, takes each
//    row's |max| (two threads a row) and writes the codes into shared memory
//    beside them, where q.k^T reads them; no q scratch in device memory.
// 3. Warp specialisation as in flash_tma_kernel: a producer warp streams the
//    K (and, in the second pass, V) tiles of 64 keys, codes or bf16, through
//    an mbarrier ring to up to three consumer warpgroups of 64 query rows
//    (setmaxnreg). q.k^T runs on wgmma m64n64k32 s8 (D zero-padded to 32:
//    72 -> 96, the codes past D are 0) or bf16 m64n64k16; tile j+1's q.k^T
//    is issued before tile j's softmax, and p.v of tile j runs while tile
//    j+1's softmax does. Every issue and wait sits on a path without
//    branches (the last tile is peeled off). The kernel is compiled for D
//    rounded up to 32 (4 kernels a variant), its bf16 tiles in 8-column
//    chunks with zeros past D: flash_tma_kernel's 128-byte swizzled boxes
//    tie a kernel to each D, 12 times the kernels and about that much more
//    build time. The exact softmax keeps its two passes (they give the JAX
//    rounding), and quant_pv takes the first one under `fast` too, for the
//    row max of p (p is monotone in the logit).
// 4. p.v with p from registers, no shared-memory staging: the s32/f32
//    accumulator of q.k^T holds keys nt*8 + 2t, nt*8 + 2t + 1 of each n8
//    tile in thread t of a quad, and s8 wgmma's A fragment wants keys 4t ..
//    4t+3 and 16+4t .. 16+4t+3 of each 32. Instead of shuffles inside the
//    quad, the prep pass stores v's codes with the keys of each 32 in the
//    accumulator's order (`frag_pos`): the dot product over the keys is the
//    same in any order, so each thread packs its own codes into the A
//    registers with two byte permutes for four. bf16 p (quant_pv off) goes
//    in as in flash_tma_kernel.
// 5. No instruction at a quarter of the FP32 rate an element beyond the
//    exp: the int32 logits become f32 by integer and f32 adds
//    (`small_int_to_f32`; the row max on the int32 products is taken in
//    integers), p's quotient by its row scale comes from the row's
//    reciprocal by a Newton step (`p_quotient`), and its code is rounded by
//    an f32 add (`p_code_bits`), each equal to the division and rounding of
//    the other route (tools/pcode_check.py holds the codes on the card).
//    `fast` and `exp_bf16` are compile-time in the softmax (the four
//    combinations, each with and without the per-tile key and mask checks,
//    chosen once per tile), as in flash_tma_kernel; the denominator sums p
//    in registers (rounded to bf16 where the plain version rounds it).

#include "flash.cuh"
#include "flash_int8.cuh"

namespace clipk {
inline namespace CLIPK_SOURCE {
namespace flash8t {

namespace hp = hopper;
using flash::Attn;
using flash::No;
using flash::Yes;
using flash8::code;
using flash8::scale_of;

// The prep pass's output (s64 = S rounded up to 64, dp = D rounded up to 32),
// each needed only for the half it quantizes, and q's codes and row scales
// written back from the attention kernel where `qc` is set (quant_codes).
struct Codes {
  int8_t* kc;   // [B*H][s64/64][dp/16][64 keys][16 B]: each 64-key tile as q.k^T reads it
  float* ksc;   // [B*H]
  int8_t* vt;   // [B*H][s64/64][4][dp][16 B]: transposed, each 64-key tile as p.v reads it,
                // the keys of each 32 in frag_pos order
  float* vsc;   // [B*H][dp]
  int8_t* qc;   // [B*H][s64][dp] or null
  float* qsc;   // [B*H][s64]
  int s64, dp;
};

// Where v's codes keep key `key` of its 64-key tile: the keys of each 32
// in the order a thread's q.k^T accumulator holds them, so that p's codes
// need no shuffle to become s8 wgmma's A fragment (thread t of a quad holds
// keys 8m + 2t + (0, 1) of tile m; A wants its 4 codes a register at 4t and
// 16 + 4t).
__host__ __device__ constexpr int frag_pos(int key) {
  return (key & ~15) + 4 * ((key & 7) >> 1) + 2 * ((key >> 3) & 1) + (key & 1);
}

// ---------------------------------------------------------------------------
// prep: the scales, then the codes, of k and/or v
// ---------------------------------------------------------------------------

constexpr int kPrepThreads = 512;
// the largest [S, D] bf16 slab a block keeps in shared memory: two blocks
// an SM. A larger one (PE-Core-bigG's 197 KB) is read twice, the second
// time mostly from L2, with two blocks an SM as well, which read faster on
// the H100 than keeping it at one block an SM.
constexpr int kResidentBytes = 100 * 1024;

__device__ __forceinline__ void codes8(const uint4& u, float s, uint32_t& lo, uint32_t& hi) {
  const bf16* x = reinterpret_cast<const bf16*>(&u);
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int j = 0; j < 8; ++j)
    w[j / 4] |= (uint32_t)(uint8_t)code(__bfloat162float(x[j]), s, -127.0f) << (8 * (j % 4));
  lo = w[0];
  hi = w[1];
}

// grid (B*H, quant_qk + quant_pv): blockIdx.y 0 is k where quant_qk is set,
// the other v. kResident: the slab stays in shared memory between the |max|
// and the codes (dynamic shared memory, S*D*2 bytes).
template <bool kResident>
__global__ void __launch_bounds__(kPrepThreads)
    prep_kernel(const bf16* __restrict__ kp, const bf16* __restrict__ vp, const Attn a,
                const Codes c, int quant_qk) {
  extern __shared__ uint4 slab_raw[];
  uint4* const slab = slab_raw;  // [seq][d / 8]
  __shared__ unsigned int colmax[flash::kMaxDP];
  __shared__ float scales[flash::kMaxDP];
  __shared__ __align__(16) int8_t tile[flash::kMaxDP * 64];  // v's codes of 64 keys, [dp][64]
  const int bh = blockIdx.x, b = bh / a.heads, h = bh % a.heads;
  const bool is_k = quant_qk && blockIdx.y == 0;
  const bf16* src = (is_k ? kp : vp) + (size_t)b * a.batch_stride + (size_t)h * a.head_stride;
  const size_t ld = a.row_stride;
  const int seq = a.seq, d = a.d, nch = d / 8, dp = c.dp, s64 = c.s64;
  const int tid = threadIdx.x;
  for (int i = tid; i < flash::kMaxDP; i += kPrepThreads) colmax[i] = 0u;
  __syncthreads();
  auto from_global = [&](int r, int ch) {
    return __ldg(reinterpret_cast<const uint4*>(src + (size_t)r * ld + ch * 8));
  };
  auto load = [&](int r, int ch) { return kResident ? slab[r * nch + ch] : from_global(r, ch); };

  // 1: |max|. A resident slab first comes in whole, every copy in flight at
  // once (cp.async), and is read from shared memory; otherwise four rows'
  // loads at a time. A thread takes a fixed 8-column chunk of every
  // `step`-th row.
  if (kResident) {
    for (int i = tid; i < seq * nch; i += kPrepThreads)
      cp_async16(slab + i, src + (size_t)(i / nch) * ld + (i % nch) * 8);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }
  {
    const int step = kPrepThreads / nch, ch = tid % nch;
    const bool active = tid < step * nch;
    float m[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) m[j] = 0.0f;
    auto take = [&](const uint4& u) {
      const bf16* x = reinterpret_cast<const bf16*>(&u);
#pragma unroll
      for (int j = 0; j < 8; ++j) m[j] = fmaxf(m[j], fabsf(__bfloat162float(x[j])));
    };
    if (active && kResident) {
      for (int r = tid / nch; r < seq; r += step) take(slab[r * nch + ch]);
    } else if (active) {
      int r = tid / nch;
      for (; r + 3 * step < seq; r += 4 * step) {
        uint4 u[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) u[i] = from_global(r + i * step, ch);
#pragma unroll
        for (int i = 0; i < 4; ++i) take(u[i]);
      }
      for (; r < seq; r += step) take(from_global(r, ch));
    }
    if (is_k) {
      float mm = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) mm = fmaxf(mm, m[j]);
      mm = warp_max(mm);
      if (tid % 32 == 0) atomicMax(&colmax[0], __float_as_uint(mm));
    } else if (active) {
#pragma unroll
      for (int j = 0; j < 8; ++j) atomicMax(&colmax[ch * 8 + j], __float_as_uint(m[j]));
    }
  }
  __syncthreads();

  // 2: the scales, then the codes
  if (is_k) {
    const float ks = scale_of(colmax[0]);
    if (tid == 0) c.ksc[bh] = ks;
    int8_t* dst = c.kc + (size_t)bh * s64 * dp;
    const int per_row = dp / 16;
    // a thread 16 codes of a row, rows fastest: each tile's 16-byte rows in turn
    for (int i = tid; i < s64 * per_row; i += kPrepThreads) {
      const int tile_i = i / (64 * per_row), oc = i / 64 % per_row, r = tile_i * 64 + i % 64;
      uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int ch = 2 * oc + half;
        if (r < seq && ch < nch) codes8(load(r, ch), ks, w[2 * half], w[2 * half + 1]);
      }
      *reinterpret_cast<uint4*>(dst + (size_t)i * 16) = make_uint4(w[0], w[1], w[2], w[3]);
    }
    return;
  }
  for (int i = tid; i < dp; i += kPrepThreads) {
    const float s = i < d ? scale_of(colmax[i]) : 1.0f;
    scales[i] = s;
    c.vsc[(size_t)bh * dp + i] = s;
  }
  for (int i = tid; i < dp * 4; i += kPrepThreads)  // the rows past D stay zero codes
    reinterpret_cast<uint4*>(tile)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  int8_t* dst = c.vt + (size_t)bh * dp * s64;
  for (int k0 = 0; k0 < s64; k0 += 64) {
    // a thread a key (keys fastest: the byte stores of a warp fall in few words)
    for (int i = tid; i < 64 * nch; i += kPrepThreads) {
      const int kr = i % 64, ch = i / 64, key = k0 + kr, pos = frag_pos(kr);
      const uint4 u = key < seq ? load(key, ch) : make_uint4(0u, 0u, 0u, 0u);
      const bf16* x = reinterpret_cast<const bf16*>(&u);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        tile[(ch * 8 + j) * 64 + pos] = code(__bfloat162float(x[j]), scales[ch * 8 + j], -127.0f);
    }
    __syncthreads();
    for (int i = tid; i < dp * 4; i += kPrepThreads) {  // [4 key chunks][dp][16 B]
      const int w = i / dp, j = i % dp;
      *reinterpret_cast<uint4*>(dst + (size_t)k0 * dp + i * 16) =
          *reinterpret_cast<const uint4*>(tile + j * 64 + w * 16);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// attention: TMA + wgmma, warp-specialized
// ---------------------------------------------------------------------------

// Shared memory and tiles, for head dims up to DP (D rounded up to 32: the
// codes' depth; the kernel is compiled for each DP, not each D). Every tile
// is in the no-swizzle core-matrix layout, columns past D zero (outside
// the TMA views, or zero codes): codes K [DP/16][64 keys][16 B], V [4 key
// chunks][DP][16 B]; bf16 q, K, V [DP/8][rows][16 B] (8-column chunks;
// q.k^T reads K K-major, p.v V MN-major). V has no ones chunk: the
// denominator is summed in registers.
template <int DP, bool QK, bool PV>
struct Tma8 {
  static constexpr int kQC = DP / 8;    // q's bf16 chunks a row
  static constexpr int kKT = 64;        // keys per tile
  static constexpr int kS = kKT / 2;    // logits a thread holds
  static constexpr int kAcc = DP / 2;   // p.v's accumulators a thread
  static constexpr int kPK = PV ? 2 : kKT / 16;  // p's A steps: two k32 (codes), four k16
  static constexpr int kMaxWG = 3;
  static constexpr int kConsumerRegs = 160, kProducerRegs = 32;
  static constexpr int kThreads = (kMaxWG + 1) * 128;
  static constexpr int kKBytes = QK ? DP * kKT : DP * kKT * 2;
  static constexpr int kVBytes = PV ? DP * kKT : DP * kKT * 2;
  static constexpr int kQBytes = kQC * kMaxWG * 64 * 16;
  static constexpr int kQCodeBytes = QK ? DP * kMaxWG * 64 : 0;
  static constexpr int kStageBytes = kKBytes + kVBytes;
  static constexpr int kRoom = 200 * 1024 - kQBytes - kQCodeBytes;
  static constexpr int kStages = kRoom / kStageBytes < 6 ? kRoom / kStageBytes : 6;
  static constexpr size_t kSmem = 128 + kQBytes + kQCodeBytes + (size_t)kStages * kStageBytes +
                                  (2 * kStages + 1) * 8;
  static_assert(kStages >= 2, "ring too shallow");
};

template <int DP, bool QK, bool PV>
__global__ void __launch_bounds__(Tma8<DP, QK, PV>::kThreads, 1)
    attn_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap, const float* __restrict__ mask,
                bf16* __restrict__ op, const Attn a, const Codes c) {
  using L = Tma8<DP, QK, PV>;
  constexpr int kStages = L::kStages, kKT = L::kKT;
  extern __shared__ unsigned char smem_raw[];
  __shared__ float qred[L::kMaxWG][2][64];  // quant_qk: the two halves of a row's |max|
  __shared__ float qscale[L::kMaxWG * 64];  // quant_qk: q's row scales
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  const int nwg = blockDim.x / 128 - 1;
  const int qrows = nwg * 64;
  unsigned char* qs = smem;                // bf16 [DP/8][qrows][16 B]
  unsigned char* qcs = smem + L::kQBytes;  // codes [DP/16][qrows][16 B]
  unsigned char* ring = qcs + L::kQCodeBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * L::kStageBytes);
  uint64_t* empty = full + kStages;
  uint64_t* qfull = empty + kStages;
  constexpr int kVOff = L::kKBytes;

  const int seq = a.seq;
  const int bh = blockIdx.x, b = bh / a.heads, h = bh % a.heads;
  const int q0 = blockIdx.y * qrows;
  const int n_kt = (seq + kKT - 1) / kKT;
  const int wg = threadIdx.x / 128;
  // pass 1: the exact softmax's row max, and quant_pv's row max of p
  const bool two_pass = !a.fast || PV;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], nwg);  // one arrival per consumer warpgroup
    }
    hp::mbar_init(qfull, 1);
    hp::mbar_fence_init();
  }
  __syncthreads();

  if (wg == nwg) {  // producer
    hp::regs_dealloc<L::kProducerRegs>();
    if (threadIdx.x == nwg * 128) {
      hp::prefetch_map(&qmap);
      if (!QK) hp::prefetch_map(&kmap);
      if (!PV) hp::prefetch_map(&vmap);
      hp::mbar_expect_tx(qfull, L::kQC * qrows * 16);
      hp::tma_load_5d(qs, &qmap, qfull, 0, q0, 0, h, b);
      int it = 0;
      auto push = [&](int kt, bool with_v) {
        const int st = it % kStages;
        if (it >= kStages) hp::mbar_wait(&empty[st], ((it / kStages) - 1) & 1);
        unsigned char* dst = ring + st * L::kStageBytes;
        const int row = kt * kKT;
        hp::mbar_expect_tx(&full[st], L::kKBytes + (with_v ? L::kVBytes : 0));
        // (a tile of codes is one contiguous block: one bulk copy)
        const size_t tile = ((size_t)bh * c.s64 + row) * DP;
        if (QK) hp::bulk_load(dst, c.kc + tile, L::kKBytes, &full[st]);
        else hp::tma_load_5d(dst, &kmap, &full[st], 0, row, 0, h, b);
        if (with_v) {
          if (PV) hp::bulk_load(dst + kVOff, c.vt + tile, L::kVBytes, &full[st]);
          else hp::tma_load_5d(dst + kVOff, &vmap, &full[st], 0, row, 0, h, b);
        }
        ++it;
      };
      if (two_pass)
        for (int kt = 0; kt < n_kt; ++kt) push(kt, false);
      for (int kt = 0; kt < n_kt; ++kt) push(kt, true);
    }
    return;
  }

  hp::regs_alloc<L::kConsumerRegs>();
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row_a = q0 + wg * 64 + warp * 16 + g, row_b = row_a + 8;
  const float* mask_a = flash::mask_row(mask, a, b, row_a);
  const float* mask_b = flash::mask_row(mask, a, b, row_b);
  const int mask_last = flash::mask_last_key(mask, a);

  // q: this warpgroup's 64 rows scaled and rounded to bf16; under quant_qk
  // their codes, two threads a row (each half of the row's chunks)
  hp::mbar_wait(qfull, 0);
  // quant_qk: a logit's value is f32(acc) * vmul (+ mask), the exp's
  // argument (value - max) * amul. The int32 row max (no mask, exact
  // softmax) takes vmul 1 and amul the row's q scale times k's, otherwise
  // vmul is that and amul 1: exactly the plain version's products.
  float vmul_a = 1.0f, vmul_b = 1.0f, amul_a = 1.0f, amul_b = 1.0f;
  const bool int_max = QK && mask == nullptr && !a.fast;
  if constexpr (QK) {
    const int i = threadIdx.x % 128, r = i % 64, half = i / 64, row = wg * 64 + r;
    constexpr int kPer = DP / 16;  // bf16 chunks a thread
    auto chunk = [&](int cc, float (&x)[8]) {
      const uint4 u = *reinterpret_cast<const uint4*>(qs + ((size_t)(half * kPer + cc) * qrows +
                                                            row) * 16);
      const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
      for (int j = 0; j < 8; ++j) x[j] = round_bf16(__bfloat162float(e[j]) * a.scale);
    };
    float amax = 0.0f;
#pragma unroll
    for (int cc = 0; cc < kPer; ++cc) {
      float x[8];
      chunk(cc, x);
#pragma unroll
      for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(x[j]));
    }
    qred[wg][half][r] = amax;
    hp::named_sync(1 + wg, 128);
    const float s = scale_of(fmaxf(qred[wg][0][r], qred[wg][1][r]));
    const int grow = q0 + row;  // the row in the head
    int8_t* dump = c.qc != nullptr && grow < seq
                       ? c.qc + ((size_t)bh * c.s64 + grow) * c.dp
                       : nullptr;
#pragma unroll
    for (int cc = 0; cc < kPer; ++cc) {
      const int ch = half * kPer + cc;
      float x[8];
      chunk(cc, x);
      uint32_t w[2] = {0u, 0u};
#pragma unroll
      for (int j = 0; j < 8; ++j)
        w[j / 4] |= (uint32_t)(uint8_t)code(x[j], s, -127.0f) << (8 * (j % 4));
      *reinterpret_cast<uint2*>(qcs + ((size_t)(ch / 2) * qrows + row) * 16 + (ch % 2) * 8) =
          make_uint2(w[0], w[1]);
      if (dump != nullptr) *reinterpret_cast<uint2*>(dump + ch * 8) = make_uint2(w[0], w[1]);
    }
    if (half == 0) {
      qscale[row] = s;
      if (dump != nullptr) c.qsc[(size_t)bh * c.s64 + grow] = s;
    }
    hp::fence_proxy_async();
    hp::named_sync(1 + wg, 128);
    const float ksc = c.ksc[bh];
    const float ra = qscale[wg * 64 + warp * 16 + g] * ksc;
    const float rb = qscale[wg * 64 + warp * 16 + g + 8] * ksc;
    if (int_max) {
      amul_a = ra;
      amul_b = rb;
    } else {
      vmul_a = ra;
      vmul_b = rb;
    }
  } else {  // scaled and rounded in place, read by q.k^T straight from shared memory
    for (int i = threadIdx.x % 128; i < L::kQC * 64; i += 128) {
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
  }
  // the exp's argument times log2(e) in one product where exp_bf16 does not
  // round the argument first
  const float al2e_a = amul_a * flash::kLog2e, al2e_b = amul_b * flash::kLog2e;

  int it = 0;  // position in the producer's sequence of tiles
  auto stage_of = [&](int i) { return ring + (i % kStages) * L::kStageBytes; };
  auto wait_full = [&](int i) { hp::mbar_wait(&full[i % kStages], (i / kStages) & 1); };
  auto release = [&](int i) {
    if (threadIdx.x % 128 == 0) hp::mbar_arrive(&empty[i % kStages]);
  };
  // q.k^T's accumulators: s[4*nt + e] at row e < 2 ? row_a : row_b, key
  // nt*8 + 2t + (e & 1); int32 under quant_qk
  using Sc = typename std::conditional<QK, int, float>::type;
  // issue (not wait for) the logits of this warpgroup's 64 rows against one
  // K tile (q: LBO one chunk block of qrows rows; K: of 64 keys)
  auto issue_scores = [&](const unsigned char* ktile, Sc (&s)[L::kS]) {
    hp::fence_regs(s);
    hp::wgmma_fence();
    if constexpr (QK) {
      const unsigned char* qa = qcs + wg * 64 * 16;
#pragma unroll
      for (int kk = 0; kk < DP / 32; ++kk)
        WgmmaS8<kKT>::run(s, hp::desc(qa + kk * 2 * qrows * 16, qrows * 16, 128, hp::kInterleave),
                          hp::desc(ktile + kk * 2 * kKT * 16, kKT * 16, 128, hp::kInterleave),
                          kk > 0);
    } else {
      const unsigned char* qa = qs + wg * 64 * 16;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        WgmmaSS<kKT, 0>::run(
            s, hp::desc(qa + kk * 2 * qrows * 16, qrows * 16, 128, hp::kInterleave),
            hp::desc(ktile + kk * 2 * kKT * 16, kKT * 16, 128, hp::kInterleave), kk > 0);
    }
    hp::wgmma_commit();
  };
  auto key_of = [&](int kt, int nt, int e) { return kt * kKT + nt * 8 + 2 * t + (e & 1); };
  // a q.k^T accumulator as f32 (quant_qk: |acc| <= 127^2 * 128 < 2^22)
  auto as_f32 = [](Sc x) { return QK ? flash8::small_int_to_f32((int)x) : (float)x; };
  // the value of element (nt, e): `scaled` multiplies quant_qk's int32
  // product by vmul (an unchecked tile of the exact softmax has no mask, so
  // vmul is 1 there and is skipped); a checked tile adds its mask entry (a
  // key past the end reads the last key's; the caller gives it no weight)
  auto value = [&](const Sc (&s)[L::kS], int kt, int nt, int e, auto checked, auto scaled) {
    const float x = QK && decltype(scaled)::value
                        ? __fmul_rn(as_f32(s[4 * nt + e]), e < 2 ? vmul_a : vmul_b)
                        : as_f32(s[4 * nt + e]);
    return decltype(checked)::value
               ? flash::masked_logit(x, e < 2 ? mask_a : mask_b, key_of(kt, nt, e), mask_last)
               : x;
  };
  // A tile whose keys all exist and that has no mask takes its logits as
  // they are: the per-element checks, resolved per tile at compile time.
  auto plain_tile = [&](int kt) { return mask == nullptr && (kt + 1) * kKT <= seq; };

  // pass 1: the whole-row max over every key tile, tile kt + 1's q.k^T in
  // flight while tile kt's max is taken
  float m_a = neg_inf(), m_b = neg_inf();
  // quant_qk's int32 row max over the unchecked tiles (-2^22: below any product)
  int mi_a = -(1 << 22), mi_b = -(1 << 22);
  if (two_pass) {
    auto tile_max = [&](const Sc (&s)[L::kS], int kt) {
      auto body = [&](auto checked, auto scaled) {
#pragma unroll
        for (int nt = 0; nt < kKT / 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float l = value(s, kt, nt, e, checked, scaled);
            if (decltype(checked)::value && key_of(kt, nt, e) >= seq) l = neg_inf();
            if (e < 2) m_a = fmaxf(m_a, l); else m_b = fmaxf(m_b, l);
          }
        }
      };
      if (!plain_tile(kt)) {
        body(Yes{}, Yes{});
      } else if (int_max) {
#pragma unroll
        for (int i = 0; i < L::kS; ++i) {
          if (i % 4 < 2) mi_a = max(mi_a, (int)s[i]); else mi_b = max(mi_b, (int)s[i]);
        }
      } else {
        body(No{}, Yes{});
      }
    };
    auto step = [&](int kt, Sc (&cur)[L::kS], Sc (&nxt)[L::kS]) {
      release(it++);
      wait_full(it);
      issue_scores(stage_of(it), nxt);
      tile_max(cur, kt);
      hp::wgmma_wait<0>();
      hp::fence_regs(nxt);
    };
    Sc s0[L::kS], s1[L::kS];
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
    if (int_max) {
      m_a = fmaxf(m_a, flash8::small_int_to_f32(mi_a));
      m_b = fmaxf(m_b, flash8::small_int_to_f32(mi_b));
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

  // p of value x in row half (0: row_a), as the exact kernels take the exp
  // (ex2 of the argument times log2(e)): `fast` clamps the value to +-60,
  // else the argument is (x - max) * amul; exp_bf16 rounds the argument and
  // the result to bf16
  // (dm: the clamped value, or value - max)
  auto exp_of = [&](float dm, int half, auto fast_c, auto exp_c) {
    constexpr bool kFast = decltype(fast_c)::value, kExpBf16 = decltype(exp_c)::value;
    const float arg = !kFast && QK ? __fmul_rn(dm, half ? amul_b : amul_a) : dm;
    const float p = kExpBf16 ? flash::ex2(round_bf16(arg) * flash::kLog2e)
                    : kFast  ? flash::ex2(dm * flash::kLog2e)
                             : flash::ex2(dm * (half ? al2e_b : al2e_a));
    return kExpBf16 ? round_bf16(p) : p;
  };
  auto weight = [&](float x, int half, auto fast_c, auto exp_c) {
    return exp_of(decltype(fast_c)::value ? fminf(fmaxf(x, -60.0f), 60.0f)
                                          : x - (half ? m_b : m_a),
                  half, fast_c, exp_c);
  };
  // quant_qk's int32 row max: acc - max exactly, as (acc + 1.5 * 2^23) -
  // (max + 1.5 * 2^23), both in [2^23, 2^24) (one add fewer an element)
  const float mm_a = __fadd_rn(m_a, 12582912.0f), mm_b = __fadd_rn(m_b, 12582912.0f);
  auto minus_max = [&](Sc acc, int half) {
    return __fsub_rn(__int_as_float((int)acc + 0x4B400000), half ? mm_b : mm_a);
  };
  // quant_pv: p's row scales from the weight of the rows' largest values
  float ps_a = 1.0f, ps_b = 1.0f;
  if constexpr (PV) {
    auto both = [&](auto fast_c, auto exp_c) {
      ps_a = flash8::p_scale(weight(top_a, 0, fast_c, exp_c), decltype(exp_c)::value);
      ps_b = flash8::p_scale(weight(top_b, 1, fast_c, exp_c), decltype(exp_c)::value);
    };
    if (a.fast) {
      if (a.exp_bf16) both(Yes{}, Yes{}); else both(Yes{}, No{});
    } else {
      if (a.exp_bf16) both(No{}, Yes{}); else both(No{}, No{});
    }
  }
  const float prc_a = __frcp_rn(ps_a), prc_b = __frcp_rn(ps_b);

  // pass 2: p, the denominator, p.v
  using Acc = typename std::conditional<PV, int, float>::type;
  Acc acc[L::kAcc];  // p.v: acc[4*nc + e] at row e < 2 ? row_a : row_b, column nc*8 + 2t + (e & 1)
#pragma unroll
  for (int i = 0; i < L::kAcc; ++i) acc[i] = 0;
  float l_a = 0.0f, l_b = 0.0f;
  const bool denom_rounded = a.denom_rounded != 0;
  // p of one tile as the A operand of p.v: codes, two k32 steps of 4
  // registers (4 codes each, keys in frag_pos order); bf16, the 4 k16 steps
  auto weights = [&](const Sc (&s)[L::kS], uint32_t (&pa)[L::kPK][4], int kt, auto checked,
                     auto fast_c, auto exp_c) {
    constexpr bool kChecked = decltype(checked)::value, kExpBf16 = decltype(exp_c)::value;
    // (an unchecked tile of the exact softmax has no mask: the int32 row max)
    constexpr bool kScaled = kChecked || decltype(fast_c)::value;
    using Scaled = std::integral_constant<bool, kScaled>;
    [[maybe_unused]] uint32_t pairs[L::kKT / 8][2];  // quant_pv: a (tile, row)'s two codes
#pragma unroll
    for (int nt = 0; nt < kKT / 8; ++nt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {  // row_a, then row_b
        float p[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int e = 2 * half + j;
          p[j] = QK && !kScaled  // (the int32 row max: no mask, exact softmax)
                     ? exp_of(minus_max(s[4 * nt + e], half), half, fast_c, exp_c)
                     : weight(value(s, kt, nt, e, checked, Scaled{}), half, fast_c, exp_c);
          if (kChecked && key_of(kt, nt, e) >= seq) p[j] = 0.0f;  // keys past the end
        }
        if constexpr (PV) {
          const float sc = half ? ps_b : ps_a, rc = half ? prc_b : prc_a;
          pairs[nt][half] =
              __byte_perm(flash8::p_code_bits(flash8::p_quotient(p[0], sc, rc), kExpBf16),
                          flash8::p_code_bits(flash8::p_quotient(p[1], sc, rc), kExpBf16),
                          0x0040);
          if (half) l_b += p[0] + p[1]; else l_a += p[0] + p[1];
        } else {
          __nv_bfloat162 pb = __floats2bfloat162_rn(p[0], p[1]);
          const float2 r = __bfloat1622float2(pb);
          if (kExpBf16 || denom_rounded) {
            if (half) l_b += r.x + r.y; else l_a += r.x + r.y;
          } else {
            if (half) l_b += p[0] + p[1]; else l_a += p[0] + p[1];
          }
          pa[nt / 2][(nt & 1) * 2 + half] = *reinterpret_cast<uint32_t*>(&pb);
        }
      }
    }
    if constexpr (PV) {
      // tiles 4j + 2m and 4j + 2m + 1 (m = 0, 1) fill register 2m + half of
      // k32 step j, two bytes each
#pragma unroll
      for (int j = 0; j < L::kPK; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[j][r] = __byte_perm(pairs[4 * j + (r / 2) * 2][r % 2],
                                 pairs[4 * j + (r / 2) * 2 + 1][r % 2], 0x5410);
    }
  };
  auto softmax = [&](const Sc (&s)[L::kS], uint32_t (&pa)[L::kPK][4], int kt) {
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
  auto issue_pv = [&](const unsigned char* tile, const uint32_t (&pa)[L::kPK][4]) {
    hp::wgmma_fence();
    if constexpr (PV) {  // V: [4 key chunks][DP][16 B], K-major
#pragma unroll
      for (int j = 0; j < L::kPK; ++j)
        WgmmaS8RS<DP>::run(
            acc, pa[j], hp::desc(tile + kVOff + j * 2 * DP * 16, DP * 16, 128, hp::kInterleave),
            1);
    } else {  // V: [DP/8 chunks][64 keys][16 B], MN-major
#pragma unroll
      for (int kk = 0; kk < L::kPK; ++kk)
        WgmmaRS<DP, 1>::run(acc, pa[kk],
                            hp::desc(tile + kVOff + kk * 256, 128, kKT * 16, hp::kInterleave), 1);
    }
    hp::wgmma_commit();
  };
  // Registers a product reads are settled (fenced) before anything is in
  // flight: ptxas serializes the products if an instruction defines them
  // while one runs.
  auto settle = [&](uint32_t (&pa)[L::kPK][4]) {
    hp::fence_regs(pa);
    hp::fence_regs(acc);
  };
  // p of tile kt in `cur`: tile kt + 1's q.k^T first, then tile kt's p.v,
  // and tile kt + 1's softmax into `nxt` while p.v runs
  Sc s[L::kS];
  auto step = [&](int kt, uint32_t (&cur)[L::kPK][4], uint32_t (&nxt)[L::kPK][4]) {
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
  auto last = [&](uint32_t (&cur)[L::kPK][4]) {
    settle(cur);
    issue_pv(stage_of(it), cur);
    hp::wgmma_wait<0>();
    settle(cur);
    release(it++);
  };
  uint32_t pa[L::kPK][4], pn[L::kPK][4];
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

#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, o);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, o);
  }
  const float inv_a = 1.0f / l_a, inv_b = 1.0f / l_b;
  bf16* out = op + (size_t)b * a.batch_stride + (size_t)h * a.head_stride;
  const float* vsc = PV ? c.vsc + (size_t)bh * DP : nullptr;
#pragma unroll
  for (int nc = 0; nc < DP / 8; ++nc) {
    if (nc * 8 >= a.d) break;  // (the columns past D)
    float2 vs = make_float2(1.0f, 1.0f);
    if constexpr (PV) vs = *reinterpret_cast<const float2*>(vsc + nc * 8 + 2 * t);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = half ? row_b : row_a;
      const float inv = half ? inv_b : inv_a;
      float o0 = (float)acc[4 * nc + 2 * half], o1 = (float)acc[4 * nc + 2 * half + 1];
      if constexpr (PV) {  // f32(acc) * (s_p * s_v), then / denominator
        const float ps = half ? ps_b : ps_a;
        o0 *= ps * vs.x;
        o1 *= ps * vs.y;
      }
      if (row < seq)
        *reinterpret_cast<uint32_t*>(out + (size_t)row * a.row_stride + nc * 8 + 2 * t) =
            pack_bf16(__float2bfloat16(o0 * inv), __float2bfloat16(o1 * inv));
    }
  }
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

template <int DP, bool QK, bool PV>
int launch_attn(const Attn& a, const Codes& c, cudaStream_t stream) {
  using L = Tma8<DP, QK, PV>;
  const int nwg = flash::tma_warpgroups(a.seq);
  const int bh = a.batch * a.heads;
  if (c.dp != DP) return (int)cudaErrorInvalidValue;
  // bf16 operands in 8-column chunks of DP / 8 (zeros past D); a quantized
  // one's map is q's, never loaded (its code tiles come by bulk copies)
  CUtensorMap qmap, kmap, vmap;
  bool ok = flash::tma_chunk_map(&qmap, a.q, a, nwg * 64, L::kQC);
  kmap = vmap = qmap;
  if (!QK) ok = ok && flash::tma_chunk_map(&kmap, a.k, a, L::kKT, DP / 8);
  if (!PV) ok = ok && flash::tma_chunk_map(&vmap, a.v, a, L::kKT, DP / 8);
  if (!ok) return (int)cudaErrorInvalidValue;
  auto kern = attn_kernel<DP, QK, PV>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bh, (a.seq + nwg * 64 - 1) / (nwg * 64));
  kern<<<grid, (nwg + 1) * 128, L::kSmem, stream>>>(qmap, kmap, vmap, a.mask,
                                                     static_cast<bf16*>(a.out), a, c);
  return (int)cudaGetLastError();
}

template <bool QK, bool PV>
int launch_dp(const Attn& a, const Codes& c, cudaStream_t stream) {
  switch (c.dp) {
    case 32: return launch_attn<32, QK, PV>(a, c, stream);
    case 64: return launch_attn<64, QK, PV>(a, c, stream);
    case 96: return launch_attn<96, QK, PV>(a, c, stream);
    case 128: return launch_attn<128, QK, PV>(a, c, stream);
  }
  return (int)cudaErrorInvalidValue;
}

inline int launch_prep(const Attn& a, const Codes& c, int quant_qk, int quant_pv,
                       cudaStream_t stream) {
  const size_t slab = (size_t)a.seq * a.d * 2;
  const dim3 grid(a.batch * a.heads, quant_qk + quant_pv);
  const bf16 *k = static_cast<const bf16*>(a.k), *v = static_cast<const bf16*>(a.v);
  if (slab <= (size_t)kResidentBytes) {
    cudaError_t err = cudaFuncSetAttribute(
        prep_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)slab);
    if (err != cudaSuccess) return (int)err;
    prep_kernel<true><<<grid, kPrepThreads, slab, stream>>>(k, v, a, c, quant_qk);
  } else {
    prep_kernel<false><<<grid, kPrepThreads, 0, stream>>>(k, v, a, c, quant_qk);
  }
  return (int)cudaGetLastError();
}

}  // namespace flash8t
}  // namespace CLIPK_SOURCE
}  // namespace clipk

// q/k/v/out: [batch, seq, heads*d] bf16, contiguous and 16-byte aligned, d
// a multiple of 8 (<= 128); mask, its strides, sin/cos and qr/kr: as
// flash_packed_launch (flash_packed.cu) takes them. The scratch the wrapper
// allocates (s64 = seq rounded up to 64, dp = d rounded up to 32), each
// needed only for the half it quantizes: kc int8 [batch*heads, s64, dp] with
// ksc f32 [batch*heads]; vt int8 [batch*heads, dp, s64] with vsc f32
// [batch*heads, dp] (Codes has the layouts). qc int8 [batch*heads, s64, dp]
// and qsc f32 [batch*heads, s64]: null, or (quant_qk) where the attention
// kernel writes q's codes and row scales too. quant_qk or quant_pv (or
// both) set; denom_rounded: as flash_packed_launch's, for the unquantized
// p.v. Returns cudaGetLastError().
extern "C" int flash_int8_tma_launch(const void* q, const void* k, const void* v,
                                     const void* mask, long long mask_batch_stride,
                                     long long mask_row_stride, const void* sin, const void* cos,
                                     void* qr, void* kr, void* kc, void* ksc, void* vt, void* vsc,
                                     void* qc, void* qsc, void* out, int batch, int seq,
                                     int heads, int d, float scale, int fast, int exp_bf16,
                                     int denom_rounded, int quant_qk, int quant_pv,
                                     void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!(quant_qk || quant_pv) || d < 8 || d > clipk::flash::kMaxDP || d % 8 != 0 ||
      out == nullptr || (quant_qk && (kc == nullptr || ksc == nullptr)) ||
      (quant_pv && (vt == nullptr || vsc == nullptr)) || ((qc == nullptr) != (qsc == nullptr)) ||
      (qc != nullptr && !quant_qk) ||
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v)) % 16) != 0)
    return (int)cudaErrorInvalidValue;
  clipk::flash::Attn a;
  int err = clipk::flash::packed_call(&a, q, k, v, mask, mask_batch_stride, mask_row_stride, sin,
                                      cos, qr, kr, out, batch, seq, heads, d, 1, st);
  if (err != 0) return err;
  a.scale = scale;
  a.fast = fast;
  a.exp_bf16 = exp_bf16;
  a.denom_rounded = denom_rounded;
  clipk::flash8t::Codes c{};
  c.kc = static_cast<int8_t*>(kc);
  c.ksc = static_cast<float*>(ksc);
  c.vt = static_cast<int8_t*>(vt);
  c.vsc = static_cast<float*>(vsc);
  c.qc = static_cast<int8_t*>(qc);
  c.qsc = static_cast<float*>(qsc);
  c.s64 = (seq + 63) / 64 * 64;
  c.dp = (d + 31) / 32 * 32;
  err = clipk::flash8t::launch_prep(a, c, quant_qk, quant_pv, st);
  if (err != 0) return err;
  using namespace clipk::flash8t;
  if (quant_qk && quant_pv) return launch_dp<true, true>(a, c, st);
  if (quant_qk) return launch_dp<true, false>(a, c, st);
  return launch_dp<false, true>(a, c, st);
}
