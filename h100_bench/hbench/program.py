"""The system under test: ``clip_embedder_tpu_torch``'s ``VisionEmbedder``
built over the benchmark's weight tree, through the program's own config
resolution, so a cell runs the path a loaded model dir runs.

Before it builds, the program's resolved tower config is held to the
configuration file's published widths: a resolution that departs from them
stops the run rather than measure another model."""

from __future__ import annotations

from pathlib import Path

import torch

from . import layouts


def check_resolved(config: dict, cfg) -> None:
    """Stop the run where the program's resolved tower (``cfg``) departs
    from a width the configuration's ``vision`` states, by the keys that
    its layout's ``resolved`` reads."""
    v, got = config["vision"], layouts.of(config).resolved(cfg)
    wrong = {k: (v.get(k), got[k]) for k in got if v.get(k) != got[k]}
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
    check_resolved(config, spec.cfg)
    validate_tower_pytree(tree, spec, source="the benchmark's weight tree")
    dtype = getattr(torch, config["dtype"])
    tower = build_tower(spec, quantize_params(tree, spec, quantize, device, dtype))
    return VisionEmbedder(tower=tower, spec=spec, config=oc, model_config=ModelConfig(),
                          model_dir=Path(__file__).resolve().parent, device=device,
                          dtype=dtype, quantize=quantize)
