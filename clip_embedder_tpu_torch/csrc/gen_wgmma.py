"""Write ``wgmma.cuh``: the ``wgmma.mma_async`` shapes the kernels use.

PTX lists every accumulator register of a warpgroup product by name, so
each shape is its own asm statement; this script writes them out.

    python clip_embedder_tpu_torch/csrc/gen_wgmma.py

* ``WgmmaRS<N, TRANS_B>``: m64nNk16, bf16 in, f32 accumulators, A (64 x 16)
  in registers (the ``mma.sync`` m16n8k16 A fragment of each warp's 16
  rows), B (16 x N) in shared memory through a matrix descriptor; N = 8,
  16, ..., 64, 96 and 128. The attention kernels' p.v (flash.cuh: 64 or 128
  swizzled columns, then the rest of the head dim in 8-column chunks;
  flash_int8.cu: the head dim rounded up to 32).
* ``WgmmaSS<N, TRANS_B>``: m64nNk16 with A and B both in shared memory, A
  K-major; N = 64 (the attention's q.k^T, B K-major) and 128 (the q/k/v
  projection, B MN-major).
* ``WgmmaS8<N>``: m64nNk32, s8 x s8 -> s32 accumulators (N / 2 registers a
  thread), A and B both K-major in shared memory (the integer forms have no
  transpose); N = 128 (the int8 MLPs' products, ``int8_wgmma.cuh``) and
  32, 64, 96 (``flash_int8.cu``: q.k^T over 64 keys, p.v over the head dim
  rounded up to 32).
* ``WgmmaS8RS<N>``: m64nNk32, s8 x s8 -> s32, A (64 x 32) in registers (the
  ``mma.sync`` m16n8k32 A fragment of each warp's 16 rows: 4 codes a
  register), B K-major in shared memory; N = 32, 64, 96, 128
  (``flash_int8_tma.cu``: p.v over the head dim rounded up to 32, p's codes
  straight from the softmax's registers).
"""

from pathlib import Path

HEAD = """\
// Generated by gen_wgmma.py: warpgroup matrix multiplies (sm_90a). Do not edit.
//
// WgmmaRS<N, TRANS_B>::run(d, a, desc_b, scale_d): d (64 x N f32, N / 2
// registers a thread) = a (64 x 16 bf16 in registers) . B (16 x N bf16,
// shared memory) + (scale_d ? d : 0). TRANS_B = 1: B is MN-major.
// WgmmaSS<N, TRANS_B>::run(d, desc_a, desc_b, scale_d): the same with A
// K-major in shared memory.
// WgmmaS8<N>::run(d, desc_a, desc_b, scale_d): d (64 x N s32) = A (64 x 32
// s8) . B (32 x N s8) + (scale_d ? d : 0), A and B K-major in shared memory.
// WgmmaS8RS<N>::run(d, a, desc_b, scale_d): the same with A (64 x 32 s8) in
// registers, 4 codes a register.
#pragma once

#include <cstdint>

namespace clipk {

template <int N, int TRANS_B>
struct WgmmaRS;

template <int N, int TRANS_B>
struct WgmmaSS;

template <int N>
struct WgmmaS8;

template <int N>
struct WgmmaS8RS;
"""


def regs(n: int, start: int) -> str:
    return ", ".join(f"%{start + i}" for i in range(n))


def outs(n: int, kind: str = "f") -> str:
    lines = (", ".join(f'"+{kind}"(d[{i}])' for i in range(j, min(n, j + 8)))
             for j in range(0, n, 8))
    return ",\n          ".join(lines)


def rs(n: int) -> str:
    nd = n // 2
    a0, desc, scale = nd, nd + 4, nd + 5
    return f"""
template <int TRANS_B>
struct WgmmaRS<{n}, TRANS_B> {{
  __device__ __forceinline__ static void run(float (&d)[{nd}], const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {{
    asm volatile(
        "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{scale}, 0;\\n"
        "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "
        "{{{regs(nd, 0)}}}, {{{regs(4, a0)}}}, %{desc}, p, 1, 1, %{scale + 1};\\n}}\\n"
        : {outs(nd)}
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d),
          "n"(TRANS_B));
  }}
}};
"""


def ss(n: int) -> str:
    nd = n // 2
    da, db, scale = nd, nd + 1, nd + 2
    return f"""
template <int TRANS_B>
struct WgmmaSS<{n}, TRANS_B> {{
  __device__ __forceinline__ static void run(float (&d)[{nd}], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {{
    asm volatile(
        "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{scale}, 0;\\n"
        "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "
        "{{{regs(nd, 0)}}}, %{da}, %{db}, p, 1, 1, 0, %{scale + 1};\\n}}\\n"
        : {outs(nd)}
        : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
  }}
}};
"""


def s8(n: int) -> str:
    nd = n // 2
    da, db, scale = nd, nd + 1, nd + 2
    return f"""
template <>
struct WgmmaS8<{n}> {{
  __device__ __forceinline__ static void run(int (&d)[{nd}], uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {{
    asm volatile(
        "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{scale}, 0;\\n"
        "wgmma.mma_async.sync.aligned.m64n{n}k32.s32.s8.s8 "
        "{{{regs(nd, 0)}}}, %{da}, %{db}, p;\\n}}\\n"
        : {outs(nd, "r")}
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }}
}};
"""


def s8rs(n: int) -> str:
    nd = n // 2
    a0, desc, scale = nd, nd + 4, nd + 5
    return f"""
template <>
struct WgmmaS8RS<{n}> {{
  __device__ __forceinline__ static void run(int (&d)[{nd}], const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {{
    asm volatile(
        "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{scale}, 0;\\n"
        "wgmma.mma_async.sync.aligned.m64n{n}k32.s32.s8.s8 "
        "{{{regs(nd, 0)}}}, {{{regs(4, a0)}}}, %{desc}, p;\\n}}\\n"
        : {outs(nd, "r")}
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  }}
}};
"""


def main() -> None:
    body = HEAD + "".join(rs(n) for n in (*range(8, 65, 8), 96, 128)) + "".join(
        ss(n) for n in (64, 128)) + "".join(s8(n) for n in (32, 64, 96, 128)) + "".join(
        s8rs(n) for n in (32, 64, 96, 128))
    body += "\n}  // namespace clipk\n"
    (Path(__file__).resolve().parent / "wgmma.cuh").write_text(body)


if __name__ == "__main__":
    main()
