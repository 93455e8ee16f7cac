"""L2 normalization — the final op of every tower (embeddings come out
unit-length, so a dot product is a cosine; reference: src/clip.rs:102)."""

from __future__ import annotations

import torch

from .layers import promote


def l2_normalize(x: torch.Tensor, *, dim: int = -1, eps: float = 0.0) -> torch.Tensor:
    """x / ||x||₂ along ``dim``, computed in ≥f32. ``eps`` clamps the norm
    for synthetic zero inputs."""
    x32 = x.to(promote(x.dtype))
    norm = x32.square().sum(dim=dim, keepdim=True).sqrt()
    if eps:
        norm = norm.clamp_min(eps)
    return (x32 / norm).to(x.dtype)
