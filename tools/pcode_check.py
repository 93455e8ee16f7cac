"""Check on the card that the int8 TMA attention kernel's p codes are the
ones IEEE division gives.

``csrc/flash_int8_tma.cu`` makes quant_pv's p codes without a division
(``flash_int8.cuh`` ``p_quotient``: a Newton step from the row's reciprocal,
and ``p_code_bits``: the rounding by an f32 add), where the first int8
route and the plain version divide (``p_code``: ``__fdiv_rn``, ``rintf``).
This compiles a small CUDA program against that header and counts, over
random (p, row scale) pairs in three families, how many quotients and how
many codes differ between the two:

    python tools/pcode_check.py

0. the row's largest weight anywhere in [2^-90, 2^91), its scale max/127,
   p up to 40 binades below the max;
1. the same with p and the scale rounded to bf16 (``exp_bf16``);
2. p on a grid of 2^16 steps between 0 and the max (ties near x.5 codes).

It needs nvcc and one card; it prints one line a family.
"""

from __future__ import annotations

import subprocess
import sys
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "clip_embedder_tpu_torch" / "csrc"

SOURCE = r"""
#include <cstdio>
#include "flash_int8.cuh"
using namespace clipk;

__device__ __forceinline__ uint32_t mix(uint64_t x) {
  x ^= x >> 33; x *= 0xff51afd7ed558ccdull; x ^= x >> 33; x *= 0xc4ceb9fe1a85ec53ull;
  x ^= x >> 33;
  return (uint32_t)x;
}

__global__ void check(unsigned long long* quot, unsigned long long* codes, uint64_t seed,
                      int family) {
  const uint64_t i = blockIdx.x * (uint64_t)blockDim.x + threadIdx.x;
  unsigned long long nq = 0, nc = 0;
  const bool ex = family == 1;
  for (int k = 0; k < 64; ++k) {
    const uint64_t id = (i * 64 + k) ^ (seed << 40);
    const uint32_t a = mix(id * 2 + 1), b = mix(id * 2 + 7), c = mix(id * 3 + 11);
    const float pmax = __uint_as_float(((uint32_t)(37 + a % 181) << 23) | (b & 0x7fffff));
    float p;
    if (family == 2) {
      p = pmax * ((float)(c & 0xffff) / 65536.0f);
    } else {
      const int e = max(0, (int)(__float_as_uint(pmax) >> 23) - (int)(c % 40));
      p = fminf(__uint_as_float(((uint32_t)e << 23) | (mix(id * 5 + 3) & 0x7fffff)), pmax);
    }
    if (ex) p = round_bf16(p);
    const float s = flash8::p_scale(ex ? round_bf16(pmax) : pmax, ex);
    const float q = flash8::p_quotient(p, s, __frcp_rn(s));
    if (__float_as_uint(q) != __float_as_uint(__fdiv_rn(p, s))) ++nq;
    if ((int)(flash8::p_code_bits(q, ex) & 0xff) != flash8::p_code(p, s, ex)) ++nc;
  }
  if (nq) atomicAdd(quot, nq);
  if (nc) atomicAdd(codes, nc);
}

int main() {
  unsigned long long *dev, host[2];
  cudaMalloc(&dev, 16);
  const char* names[3] = {"max in [2^-90, 2^91), p up to 40 binades below",
                          "the same in bf16 (exp_bf16)", "p on a 2^16-step grid below the max"};
  for (int family = 0; family < 3; ++family) {
    cudaMemset(dev, 0, 16);
    for (int rep = 0; rep < 16; ++rep)
      check<<<65536, 256>>>(dev, dev + 1, rep + 100 * family, family);
    cudaMemcpy(host, dev, 16, cudaMemcpyDeviceToHost);
    printf("family %d (%s): %llu pairs, quotients differing %llu, codes differing %llu (%s)\n",
           family, names[family], 16ull * 65536 * 256 * 64, host[0], host[1],
           cudaGetErrorString(cudaGetLastError()));
  }
  return 0;
}
"""


def main() -> int:
    sys.path.insert(0, str(CSRC.parents[1]))
    from clip_embedder_tpu_torch.ops.cuda import find_nvcc

    with tempfile.TemporaryDirectory() as tmp:
        src, exe = Path(tmp) / "pcode_check.cu", Path(tmp) / "pcode_check"
        src.write_text(SOURCE)
        subprocess.run([find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                        "-O3", "-I", str(CSRC), "-o", str(exe), str(src)], check=True)
        return subprocess.run([str(exe)]).returncode


if __name__ == "__main__":
    sys.exit(main())
