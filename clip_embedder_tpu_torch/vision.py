"""VisionEmbedder: image → L2-normalized embedding.

Counterpart of ``clip_embedder_tpu.vision`` (reference: src/vision.rs:20-140):
``from_local_dir`` / ``from_local_id`` / ``from_hf``, ``embed_image(s)``,
``preprocess_batch``, ``duplicate``. Preprocessing is the two-matmul resize
of ``ops.preprocess`` on the device; the tower is ``models.vit.ViT``.

The device is explicit: ``device=None`` means ``"cuda"``, which raises
``DeviceError`` when CUDA is missing — the embedders never drop to the CPU
on their own; ask for ``device="cpu"`` to run there.

``quantize="int8"`` (MLP blocks) or ``"int8_all"`` (MLP blocks and
attention projections) converts the loaded weights to W8A8
(``ops.quant``), as the JAX package's ``quantize=`` does.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Sequence

import numpy as np
import torch
from torch import nn

from .config import ModelConfig, OpenClipConfig, update_config_json
from .errors import ConfigError, DeviceError, InferenceError, WeightError
from .model_manager import (
    NATIVE_VISUAL,
    get_default_base_folder,
    get_hf_model,
    verify_model_dir,
)
from .models.build import TowerSpec, resolve_vision
from .models.vit import ViT
from .ops.attention import ATTN_IMPLS
from .ops.preprocess import Preprocessor
from .ops.quant import check_quantize_mode, quantize_tree_checked
from .utils.images import to_rgb_array
from .weights import load_pytree, to_device_tree, validate_tower_pytree


def resolve_device(device: torch.device | str | None) -> torch.device:
    """``None`` → ``"cuda"``. A CUDA device must exist (``DeviceError``
    otherwise); on it, TF32 is turned off for matmuls and convolutions, so
    f32 products run in full f32 (the preprocess resize needs that for
    Pillow pixel parity)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise DeviceError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise DeviceError(f"Unsupported device '{dev}' (cuda or cpu)")
    return dev


def resolve_attn_impl(attn_impl: str, device: torch.device) -> str:
    """``"auto"`` → ``"kernel"`` on CUDA and ``"eager"`` on the CPU;
    explicit names are validated and kept (on the CPU the kernel impls run
    the kernels' plain PyTorch versions)."""
    if attn_impl == "auto":
        return "kernel" if device.type == "cuda" else "eager"
    if attn_impl not in ATTN_IMPLS:
        raise ConfigError(f"Unknown attn_impl '{attn_impl}' (choices: auto, "
                          f"{', '.join(ATTN_IMPLS)})")
    return attn_impl


def quantize_params(params: dict, spec: TowerSpec, quantize: str | None, device,
                    dtype) -> dict:
    """The loaded (and validated) tree as the ``quantize`` mode asks: as it
    is for None, else W8A8 (``ops.quant.quantize_tree_checked``, from the
    weights in the working dtype, as the JAX package quantizes them)."""
    check_quantize_mode(quantize)
    if quantize is None:
        return params
    return to_device_tree(quantize_tree_checked(params, spec.family, mode=quantize),
                          device=device, dtype=dtype)


def derive_vision_dims_from_sd(model_dir: Path, config: OpenClipConfig,
                               visual_sd: dict) -> None:
    """At conversion (``pull_weights.convert_checkpoint``), for PE-Core,
    whose per-size dims are a reconstructed table: derive the dims from the
    checkpoint's shapes and persist them under ``vision_cfg.pe_cfg``, so the
    table is used only when no checkpoint exists. Every other family is left
    as it is (FastViT and EVA02, whose dims the JAX package also derives
    here, are not ported: resolving them raises)."""
    v = config.model_cfg.vision_cfg
    if "pe_core" not in (v.timm_model_name or "").lower() or v.extra.get("pe_cfg"):
        return
    from .weights import derive_pe_cfg_from_sd

    try:
        derived = derive_pe_cfg_from_sd(visual_sd)
    except WeightError:
        return
    v.extra["pe_cfg"] = derived
    update_config_json(
        model_dir / "open_clip_config.json",
        lambda raw: raw.setdefault("model_cfg", {}).setdefault(
            "vision_cfg", {}).__setitem__("pe_cfg", derived))


def _load_visual(model_dir: Path, spec: TowerSpec, device, dtype) -> dict:
    native = model_dir / NATIVE_VISUAL
    if not native.is_file():
        # the ONNX conversion / executor fallback is not yet ported
        raise ConfigError(f"No native vision weights ({NATIVE_VISUAL}) in "
                          f"{model_dir}; the ONNX path is not yet ported")
    params = load_pytree(native, device=device, dtype=dtype)
    validate_tower_pytree(params, spec, source=native)
    return params


class VisionEmbedder:
    """Image tower + preprocessing (reference: src/vision.rs:20-27)."""

    def __init__(
        self,
        *,
        tower: nn.Module,
        spec: TowerSpec,
        config: OpenClipConfig,
        model_config: ModelConfig,
        model_dir: Path | str,
        device: torch.device | str | None = None,
        dtype: torch.dtype = torch.float32,
        attn_impl: str = "auto",
        quantize: str | None = None,
    ):
        """``tower`` holds weights already in the ``quantize`` mode's form
        (``from_local_dir`` converts them)."""
        check_quantize_mode(quantize)
        self.device = resolve_device(device)
        self.attn_impl = resolve_attn_impl(attn_impl, self.device)
        self.quantize = quantize
        self.tower = tower.to(self.device)
        self.spec = spec
        self.config = config
        self.model_config = model_config
        self.model_dir = Path(model_dir)
        self.dtype = dtype
        pp = config.preprocess_cfg
        self.preprocessor = Preprocessor(
            image_size=config.model_cfg.vision_cfg.image_size,
            mean=pp.mean,
            std=pp.std,
            interpolation=pp.interpolation,
            resize_mode=pp.resize_mode,
            device=self.device,
            out_dtype=dtype,
            layout="nchw",  # the ViT's patchify reads channels-first
        )

    # -- construction (reference: src/vision.rs:31-84) ---------------------

    @classmethod
    def from_local_dir(
        cls, model_dir: Path | str, *, device: torch.device | str | None = None,
        dtype: torch.dtype = torch.float32, attn_impl: str = "auto",
        quantize: str | None = None,
    ) -> "VisionEmbedder":
        model_dir = Path(model_dir)
        dev = resolve_device(device)
        verify_model_dir(model_dir)
        config = OpenClipConfig.from_file(model_dir / "open_clip_config.json")
        model_config = ModelConfig.from_file(model_dir / "model_config.json")
        spec = resolve_vision(config.model_cfg)
        params = quantize_params(_load_visual(model_dir, spec, dev, dtype), spec, quantize,
                                 dev, dtype)
        return cls(tower=ViT(spec.cfg, params), spec=spec, config=config,
                   model_config=model_config, model_dir=model_dir, device=dev,
                   dtype=dtype, attn_impl=attn_impl, quantize=quantize)

    @classmethod
    def from_local_id(
        cls, model_id: str, *, base_folder: Path | str | None = None, **kw
    ) -> "VisionEmbedder":
        base = Path(base_folder) if base_folder else get_default_base_folder()
        return cls.from_local_dir(base / model_id, **kw)

    @classmethod
    def from_hf(cls, model_id: str, **kw) -> "VisionEmbedder":
        return cls.from_local_dir(get_hf_model(model_id), **kw)

    def duplicate(self) -> "VisionEmbedder":
        """A fresh instance sharing this one's weights
        (reference: src/vision.rs:87-91)."""
        return VisionEmbedder(
            tower=self.tower, spec=self.spec, config=self.config,
            model_config=self.model_config, model_dir=self.model_dir,
            device=self.device, dtype=self.dtype, attn_impl=self.attn_impl,
            quantize=self.quantize,
        )

    # -- embedding (reference: src/vision.rs:94-117) -----------------------

    def embed_image(self, image: Any) -> np.ndarray:
        return self.embed_images([image])[0]

    def embed_images(self, images: Sequence[Any]) -> np.ndarray:
        """[N, embed_dim] f32 embeddings, L2-normalized."""
        if len(images) == 0:
            raise InferenceError("Empty batch")
        arrays = [to_rgb_array(img) for img in images]
        with torch.inference_mode():
            pixels = self.preprocessor(arrays)  # [bucket, 3, S, S]
            embs = self.tower(pixels, attn_impl=self.attn_impl, channels_first=True)
            return embs[: len(arrays)].float().cpu().numpy()

    # -- preprocessing only (reference: src/vision.rs:120-138) -------------

    def preprocess(self, image: Any) -> np.ndarray:
        return self.preprocess_batch([image])

    def preprocess_batch(self, images: Sequence[Any]) -> np.ndarray:
        """The preprocessed tensor in the reference's NCHW f32 layout
        ([B, 3, S, S] — reference: src/vision.rs:120-135)."""
        arrays = [to_rgb_array(img) for img in images]
        with torch.inference_mode():
            pixels = self.preprocessor(arrays)[: len(images)]
            return pixels.float().cpu().numpy()
