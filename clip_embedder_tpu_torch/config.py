"""Config schemas for the two JSON files every model dir carries.

Mirrors the reference's config surface (reference: src/config.rs:6-71):

* ``ModelConfig`` — the framework-specific ``model_config.json`` written at
  export time (scoring + tokenizer quirks): logit scale/bias, activation
  (softmax|sigmoid), pad id, lowercasing (reference: src/config.rs:6-21,
  pull_onnx.py:128-150).
* ``OpenClipConfig`` — the upstream ``open_clip_config.json`` (model shapes +
  preprocessing): embed dim, vision/text tower cfg, mean/std/interpolation/
  resize-mode with the same serde defaults "bicubic"/"shortest"
  (reference: src/config.rs:23-64).

Beyond the reference, ``VisionCfg``/``TextCfg`` here retain the *full*
architecture fields from open_clip_config (patch size, heads, pooling, …)
because this framework owns the model math instead of delegating it to an
opaque ONNX graph — the config drives the tower construction.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

from .errors import ConfigError, IoError, JsonError


def update_config_json(cfg_path: Path, updater) -> None:
    """Atomically apply ``updater(raw_dict)`` (mutating in place) to a
    config JSON on disk via write-temp + rename, so concurrent loaders of
    the same dir never observe a half-written file; swallow OSError
    (read-only dirs stay functional — the in-memory config already carries
    the update). The temp file is unlinked when the replace didn't happen,
    so failed rewrites can't accumulate stray files."""
    import os

    try:
        raw = json.loads(cfg_path.read_text())
        updater(raw)
        tmp = cfg_path.with_name(f".{cfg_path.name}.{os.getpid()}.tmp")
        replaced = False
        try:
            tmp.write_text(json.dumps(raw, indent=2))
            os.replace(tmp, cfg_path)
            replaced = True
        finally:
            if not replaced:
                tmp.unlink(missing_ok=True)
    except OSError:
        pass


def _load_json(path: Path | str) -> dict[str, Any]:
    path = Path(path)
    try:
        text = path.read_text(encoding="utf-8")
    except OSError as e:  # noqa: PERF203
        raise IoError(f"IO error: {e}") from e
    try:
        return json.loads(text)
    except json.JSONDecodeError as e:
        raise JsonError(f"JSON error in {path}: {e}") from e


@dataclass
class ModelConfig:
    """Scoring/tokenizer metadata (reference: src/config.rs:6-21).

    All fields optional with the same semantics as the reference's serde
    defaults; ``pad_id`` falls back to the tokenizer's ``<pad>`` entry at
    TextEmbedder construction (reference: src/text.rs:70-73).
    """

    tokenizer_needs_lowercase: bool = False
    activation_function: str | None = None
    logit_scale: float | None = None
    logit_bias: float | None = None
    pad_id: int | None = None
    vocab_size: int | None = None

    @classmethod
    def from_file(cls, path: Path | str) -> "ModelConfig":
        raw = _load_json(path)
        return cls.from_dict(raw)

    @classmethod
    def from_dict(cls, raw: dict[str, Any]) -> "ModelConfig":
        return cls(
            tokenizer_needs_lowercase=bool(raw.get("tokenizer_needs_lowercase", False)),
            activation_function=raw.get("activation_function"),
            logit_scale=raw.get("logit_scale"),
            logit_bias=raw.get("logit_bias"),
            pad_id=raw.get("pad_id"),
            vocab_size=raw.get("vocab_size"),
        )

    def to_dict(self) -> dict[str, Any]:
        return {
            "tokenizer_needs_lowercase": self.tokenizer_needs_lowercase,
            "activation_function": self.activation_function,
            "logit_scale": self.logit_scale,
            "logit_bias": self.logit_bias,
            "pad_id": self.pad_id,
            "vocab_size": self.vocab_size,
        }


@dataclass
class VisionCfg:
    """Vision tower shape config (reference: src/config.rs:36-41, extended).

    The reference only reads ``image_size`` (preprocessing target); we keep
    the architecture fields open_clip publishes so the tower can be built
    from config alone.
    """

    image_size: int = 224
    layers: int | list[int] | None = None
    width: int | None = None
    patch_size: int | None = None
    head_width: int | None = None
    mlp_ratio: float | None = None
    # timm-backed towers (SigLIP/SigLIP2, MobileCLIP) name a timm model here.
    timm_model_name: str | None = None
    timm_pool: str | None = None
    timm_proj: str | None = None
    # Everything else open_clip may carry, preserved verbatim.
    extra: dict[str, Any] = field(default_factory=dict)

    _KNOWN = (
        "image_size", "layers", "width", "patch_size", "head_width",
        "mlp_ratio", "timm_model_name", "timm_pool", "timm_proj",
    )

    @classmethod
    def from_dict(cls, raw: dict[str, Any]) -> "VisionCfg":
        image_size = raw.get("image_size", 224)
        if isinstance(image_size, (list, tuple)):
            # open_clip publishes list-valued sizes for some timm towers;
            # square [S, S] collapses to S, non-square is unsupported and
            # must be rejected (silently cropping to size[0] would run the
            # tower at the wrong resolution)
            if len(set(image_size)) != 1:
                from .errors import ConfigError

                raise ConfigError(
                    f"Non-square image_size {list(image_size)} is not "
                    "supported")
            image_size = image_size[0]
        known = {k: raw[k] for k in cls._KNOWN if k in raw}
        known["image_size"] = int(image_size)
        extra = {k: v for k, v in raw.items() if k not in cls._KNOWN}
        return cls(**known, extra=extra)


@dataclass
class TextCfg:
    """Text tower shape config (reference: src/config.rs:43-47, extended)."""

    context_length: int = 77
    hf_tokenizer_name: str | None = None
    vocab_size: int | None = None
    width: int | None = None
    heads: int | None = None
    layers: int | None = None
    # HF text towers (e.g. BiomedCLIP) name a HF model here.
    hf_model_name: str | None = None
    extra: dict[str, Any] = field(default_factory=dict)

    _KNOWN = (
        "context_length", "hf_tokenizer_name", "vocab_size", "width",
        "heads", "layers", "hf_model_name",
    )

    @classmethod
    def from_dict(cls, raw: dict[str, Any]) -> "TextCfg":
        known = {k: raw[k] for k in cls._KNOWN if k in raw}
        extra = {k: v for k, v in raw.items() if k not in cls._KNOWN}
        return cls(**known, extra=extra)


@dataclass
class ModelCfg:
    """(reference: src/config.rs:29-34)"""

    embed_dim: int
    vision_cfg: VisionCfg
    text_cfg: TextCfg
    # SigLIP models declare an initial logit bias here; its presence is the
    # sigmoid-head detection signal (reference: pull_onnx.py:133).
    init_logit_bias: float | None = None
    custom_text: bool = False
    quick_gelu: bool = False
    extra: dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, raw: dict[str, Any]) -> "ModelCfg":
        if "embed_dim" not in raw:
            raise ConfigError("model_cfg missing 'embed_dim'")
        known_keys = {
            "embed_dim", "vision_cfg", "text_cfg", "init_logit_bias",
            "custom_text", "quick_gelu",
        }
        return cls(
            embed_dim=int(raw["embed_dim"]),
            vision_cfg=VisionCfg.from_dict(raw.get("vision_cfg", {})),
            text_cfg=TextCfg.from_dict(raw.get("text_cfg", {})),
            init_logit_bias=raw.get("init_logit_bias"),
            custom_text=bool(raw.get("custom_text", False)),
            quick_gelu=bool(raw.get("quick_gelu", False)),
            extra={k: v for k, v in raw.items() if k not in known_keys},
        )


@dataclass
class PreprocessCfg:
    """Preprocessing config with the reference's serde defaults
    (reference: src/config.rs:49-64)."""

    mean: tuple[float, float, float] = (0.48145466, 0.4578275, 0.40821073)
    std: tuple[float, float, float] = (0.26862954, 0.26130258, 0.27577711)
    interpolation: str = "bicubic"
    resize_mode: str = "shortest"
    extra: dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, raw: dict[str, Any]) -> "PreprocessCfg":
        known_keys = {"mean", "std", "interpolation", "resize_mode", "size"}
        mean = raw.get("mean")
        std = raw.get("std")
        if mean is None or std is None:
            raise ConfigError("preprocess_cfg requires 'mean' and 'std'")
        return cls(
            mean=tuple(float(x) for x in mean),
            std=tuple(float(x) for x in std),
            interpolation=raw.get("interpolation", "bicubic"),
            resize_mode=raw.get("resize_mode", "shortest"),
            extra={k: v for k, v in raw.items() if k not in known_keys},
        )


@dataclass
class OpenClipConfig:
    """(reference: src/config.rs:23-27)"""

    model_cfg: ModelCfg
    preprocess_cfg: PreprocessCfg

    @classmethod
    def from_file(cls, path: Path | str) -> "OpenClipConfig":
        raw = _load_json(path)
        return cls.from_dict(raw)

    @classmethod
    def from_dict(cls, raw: dict[str, Any]) -> "OpenClipConfig":
        if "model_cfg" not in raw or "preprocess_cfg" not in raw:
            raise ConfigError(
                "open_clip_config.json requires 'model_cfg' and 'preprocess_cfg'"
            )
        return cls(
            model_cfg=ModelCfg.from_dict(raw["model_cfg"]),
            preprocess_cfg=PreprocessCfg.from_dict(raw["preprocess_cfg"]),
        )
