"""The system under test: ``clip_embedder_tpu_torch``'s ``VisionEmbedder``
built over the benchmark's weight tree, through the program's own config
resolution, so a cell runs the path a loaded model dir runs.

Before it builds, the program's resolved tower config is held to the
configuration file's published widths: a resolution that departs from them
stops the run rather than measure another model."""

from __future__ import annotations

from pathlib import Path

import torch

# the program's resolved field for each published width of the config file
RESOLVED = {
    "image_size": "image_size", "patch_size": "patch_size", "width": "width",
    "layers": "layers", "heads": "heads", "mlp_hidden": "mlp_hidden",
    "embed_dim": "embed_dim", "activation": "activation", "class_token": "use_class_token",
    "ln_pre": "use_ln_pre", "pool": "pool", "proj": "use_proj", "ln_eps": "ln_eps",
    "rope_2d": "rope_2d", "tokens": "seq_len", "layer_scale": "use_layer_scale",
}


def resolved_widths(cfg) -> dict:
    got = {k: getattr(cfg, attr) for k, attr in RESOLVED.items()}
    got["pool_heads"] = cfg.pool_heads or cfg.heads
    got["pool_mlp_hidden"] = cfg.pool_mlp_hidden or cfg.mlp_hidden
    return got


def check_resolved(v: dict, cfg) -> None:
    got = resolved_widths(cfg)
    wrong = {k: (v[k], got[k]) for k in got if v.get(k) != got[k]}
    if wrong:
        raise SystemExit("the program resolves another tower than the configuration states "
                         f"(key: (stated, resolved)): {wrong}")


def build(config: dict, tree: dict, device, quantize: str | None = None):
    """A ``VisionEmbedder`` over ``tree``, in the configuration's ``dtype``,
    with the program's ``quantize`` mode (None: the weights as given)."""
    from clip_embedder_tpu_torch import VisionEmbedder
    from clip_embedder_tpu_torch.config import ModelConfig, OpenClipConfig
    from clip_embedder_tpu_torch.models.build import resolve_vision
    from clip_embedder_tpu_torch.vision import build_tower, quantize_params
    from clip_embedder_tpu_torch.weights import validate_tower_pytree

    oc = OpenClipConfig.from_dict({"model_cfg": config["open_clip"],
                                   "preprocess_cfg": config["preprocess"]})
    spec = resolve_vision(oc.model_cfg)
    check_resolved(config["vision"], spec.cfg)
    validate_tower_pytree(tree, spec, source="the benchmark's weight tree")
    dtype = getattr(torch, config["dtype"])
    tower = build_tower(spec, quantize_params(tree, spec, quantize, device, dtype))
    return VisionEmbedder(tower=tower, spec=spec, config=oc, model_config=ModelConfig(),
                          model_dir=Path(__file__).resolve().parent, device=device,
                          dtype=dtype, quantize=quantize)
