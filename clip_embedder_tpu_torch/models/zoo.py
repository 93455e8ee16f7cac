"""Canonical tower configs for the reference's benchmark models.

Counterpart of ``clip_embedder_tpu.models.zoo``: the flagship shape defined
once (reference model list: benches/model_bench.rs:8-13). ``chip_smoke.py``
phase 5 builds its vision tower from it.
"""

from __future__ import annotations

from .vit import ViTCfg


def so400m_siglip2_384() -> ViTCfg:
    """ViT-SO400M-16-SigLIP2-384 vision tower (the headline benchmark
    model — reference: README.md:110)."""
    return ViTCfg(
        image_size=384, patch_size=16, width=1152, layers=27, heads=16,
        mlp_hidden=4304, embed_dim=1152, activation="gelu_tanh",
        use_class_token=False, use_ln_pre=False, pool="map", use_proj=False,
        ln_eps=1e-6, pos_embed_cls=False,
    )
