# PEAKS, peaks_for and nvidia_smi are frozen copies of chip_smoke.py's at commit
# 4365e722da82de69a44f96d71d1126ef91d02509; attention_work is its attn_bound's
# count (FLOP and bytes, rope terms added) and bound_s its bound.
"""The yardstick's arithmetic: published peaks, and the operations and bytes
of each measured piece of work, counted from shapes alone.

Each input byte is counted read once and each output byte written once,
whatever a kernel reads again; the counts do not depend on which kernel
does the work, so a later change to a kernel cannot make them stale."""

from __future__ import annotations

import subprocess

# Published dense peaks (NVIDIA data sheets): bf16 tensor-core FLOP/s, f32
# (non-tensor) FLOP/s, device-memory bytes/s. Rates assume the full power
# limit (700 W SXM, 350 W PCIe).
PEAKS = {
    "sxm": {"bf16": 989e12, "int8": 1979e12, "f32": 67e12, "bytes": 3.35e12},
    "pcie": {"bf16": 756e12, "int8": 1513e12, "f32": 51e12, "bytes": 2.0e12},
}
BF16 = 2  # bytes


def peaks_for(name: str) -> dict:
    return PEAKS["pcie" if "pcie" in name.lower() else "sxm"]


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError) as err:
        return f"nvidia-smi unavailable ({err})"
    return out.strip().splitlines()[0]


def bound_s(flop: float, nbytes: float, peaks: dict, rate: str = "bf16") -> float:
    """The least time: operations at the peak rate or bytes at the peak
    bandwidth, whichever is longer."""
    return max(flop / peaks[rate], nbytes / peaks["bytes"])


def ln_qkv_work(rows: int, width: int) -> tuple[float, float]:
    """(FLOP, bytes) of LayerNorm + the q/k/v product over [rows, width]
    bf16: x, the LayerNorm's scale and shift, the [width, 3·width] weights
    and their bias read once; q, k and v written once."""
    flop = 2.0 * rows * width * 3 * width
    nbytes = BF16 * (rows * width + 2 * width + 3 * width * width + 3 * width
                     + 3 * rows * width)
    return flop, nbytes


def attention_work(b: int, h: int, s: int, d: int, *, rope: bool = False) -> tuple[float, float]:
    """(FLOP, bytes) of softmax attention over [b, s, h·d] bf16: q, k, v
    read once and the output written once, 4·S²·D FLOP a head; with
    ``rope``, the rotation of q and k (3 FLOP an element) and its f32 sin
    and cos tables [s, h·d] read once."""
    flop = 4.0 * b * h * s * s * d
    nbytes = 4.0 * BF16 * b * s * h * d
    if rope:
        flop += 3.0 * 2 * b * s * h * d
        nbytes += 2 * 4 * s * h * d
    return flop, nbytes
