"""Axial 2-D rotary position embedding (PE-Core's ``rope_2d``).

Counterpart of ``clip_embedder_tpu.ops.rope``, in the convention both timm's
``RotaryEmbeddingCat`` (EVA02) and Meta's ``compute_axial_cis`` (Perception
Encoder) share:

* per axis ``head_dim/4`` inverse-frequency bands ``1/temperature**(i/bands)``;
* each band duplicated into adjacent lanes, the rotation over even/odd lane
  pairs ``rot(x) = (-x1, x0, -x3, x2, …)``;
* the two axes concatenated along the head dim, y bands first (``order="yx"``,
  timm) or x bands first (``order="xy"``, PE);
* ``prefix`` identity rows (angle 0) for the class/register tokens.

The tables are built in numpy, once per tower, and moved to the device; the
rotation runs in f32 and rounds back to the input dtype.
"""

from __future__ import annotations

import numpy as np
import torch


def axial_rope_table(
    grid: int,
    head_dim: int,
    temperature: float = 10000.0,
    *,
    order: str = "yx",
    ref_grid: int | None = None,
    prefix: int = 0,
) -> np.ndarray:
    """Angle table [prefix + grid², head_dim] (f64) for a square patch grid
    in row-major order. ``ref_grid`` rescales the integer coordinates to a
    pretraining grid (timm ``ref_feat_shape``); ``prefix`` zero rows come
    first."""
    if order not in ("yx", "xy"):
        raise ValueError(f"Unknown axial rope order '{order}'")
    bands = head_dim // 4
    inv_freq = 1.0 / (temperature ** (np.arange(bands) / bands))
    coords = np.arange(grid, dtype=np.float64)
    if ref_grid is not None:
        coords = coords / grid * ref_grid
    ang = np.einsum("g,f->gf", coords, inv_freq)      # [grid, bands]
    yy = np.repeat(ang[:, None, :], grid, axis=1)     # [gy, gx, bands]
    xx = np.repeat(ang[None, :, :], grid, axis=0)
    halves = [yy, xx] if order == "yx" else [xx, yy]
    full = np.repeat(np.concatenate(halves, axis=-1), 2, axis=-1)  # adjacent-lane pairs
    full = full.reshape(grid * grid, head_dim)
    if prefix:
        full = np.concatenate([np.zeros((prefix, head_dim), full.dtype), full], axis=0)
    return full


def rotate_pairs(x: torch.Tensor) -> torch.Tensor:
    """(x0, x1, x2, x3, …) → (-x1, x0, -x3, x2, …): two single-lane rolls and
    a parity select (the wrapped lanes land only where the parity never
    selects them)."""
    even = torch.arange(x.shape[-1], device=x.device) % 2 == 0
    return torch.where(even, -torch.roll(x, -1, dims=-1), torch.roll(x, 1, dims=-1))


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """``x·cos + rot(x)·sin`` in f32, rounded back to x's dtype. x: [B, H, N,
    D] with [N, D] tables, or the packed [B, N, H·D] projection layout with
    head-tiled [N, H·D] tables (pairs stay within a head: head offsets are
    even)."""
    x32 = x.to(torch.float32)
    return (x32 * cos + rotate_pairs(x32) * sin).to(x.dtype)


def head_tiled_tables(ang: np.ndarray, heads: int) -> tuple[torch.Tensor, torch.Tensor]:
    """[N, D] angle table → (sin, cos), f32 [N, H·D] CPU tensors for the
    packed projection layout: the sine and cosine of the f32-rounded angle,
    taken in f64 and rounded once, so every device reads the same table."""
    a = ang.astype(np.float32).astype(np.float64)
    return tuple(torch.from_numpy(np.tile(f(a), (1, heads)).astype(np.float32))
                 for f in (np.sin, np.cos))
