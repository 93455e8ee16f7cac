"""VisionEmbedder: image → L2-normalized embedding.

Counterpart of ``clip_embedder_tpu.vision`` (reference: src/vision.rs:20-140):
``from_local_dir`` / ``from_local_id`` / ``from_hf``, ``embed_image(s)``,
``preprocess_batch``, ``duplicate``. Preprocessing is the two-matmul resize
of ``ops.preprocess`` on the device, NCHW out for every family; the tower is
the family's module (``build_tower``): ``models.vit.ViT``,
``models.eva02.Eva02``, ``models.fastvit.FastViT``,
``models.convnext.ConvNeXt`` or ``models.resnet.ResNet``. The convolutional
ones see the pixels as channels-last NHWC.

A reference-format dir (``visual.onnx``, no ``visual.npz``) is converted in
place on first load (``onnx_reader.extract_tower_params``, self-checked
against the graph) and the tree cached as ``visual.npz`` (skipped on a
read-only dir). Where no native family fits the graph, the tower is the
graph itself, run by ``onnx_exec`` (``OnnxVisual``), with a warning; a
present ``visual.npz`` that fails to load raises instead.

The device is explicit: ``device=None`` means ``"cuda"``, which raises
``DeviceError`` when CUDA is missing — the embedders never drop to the CPU
on their own; ask for ``device="cpu"`` to run there.

``quantize="int8"`` (MLP blocks) or ``"int8_all"`` (MLP blocks and
attention projections) converts the loaded weights to W8A8
(``ops.quant``), as the JAX package's ``quantize=`` does.

On the card the tower forward is captured once per batch bucket, and the
preprocess resize once per padded shape, as CUDA graphs and replayed
(``utils.captured``), as the JAX package jits them once per shape;
``duplicate()`` shares the tower and so its graphs.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Sequence

import numpy as np
import torch
from torch import nn

from .config import ModelConfig, OpenClipConfig, update_config_json
from .errors import ConfigError, DeviceError, InferenceError, WeightError
from .onnx_exec import OnnxTower, fallback_cfg, load_tower
from .model_manager import (
    NATIVE_TEXT,
    NATIVE_VISUAL,
    get_default_base_folder,
    get_hf_model,
    verify_model_dir,
)
from .models.build import TowerSpec, resolve_vision
from .models.convnext import ConvNeXt
from .models.eva02 import Eva02
from .models.fastvit import FastViT
from .models.resnet import ResNet
from .models.vit import ViT
from .ops.attention import ATTN_IMPLS
from .ops.normalize import l2_normalize
from .ops.preprocess import Preprocessor
from .ops.quant import check_quantize_mode, quantize_tree_checked
from .utils import captured
from .utils.images import to_rgb_array
from .utils.logging import warn_once
from .weights import (load_pytree, params_from_numpy, save_pytree, to_device_tree,
                      validate_tower_pytree)


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


# the families whose forward takes attn_impl; the others run their
# attention on the plain core, as the JAX package runs it on XLA's
ATTN_IMPL_FAMILIES = frozenset({"vit", "eva02", "text_transformer", "hf_bert", "mct"})


def resolve_attn_impl(attn_impl: str, device: torch.device, family: str) -> str:
    """``"auto"`` → ``"kernel"`` on CUDA for the families in
    ``ATTN_IMPL_FAMILIES`` and ``"eager"`` otherwise; explicit names are
    validated and kept (on the CPU the kernel impls run the kernels' plain
    PyTorch versions). A kernel impl for a family outside
    ``ATTN_IMPL_FAMILIES`` raises ``ConfigError``, as the JAX package's
    ``check_attn_impl`` does: it would report a kernel that never runs."""
    if attn_impl == "auto":
        return "kernel" if device.type == "cuda" and family in ATTN_IMPL_FAMILIES else "eager"
    if attn_impl not in ATTN_IMPLS:
        raise ConfigError(f"Unknown attn_impl '{attn_impl}' (choices: auto, "
                          f"{', '.join(ATTN_IMPLS)})")
    if attn_impl != "eager" and family not in ATTN_IMPL_FAMILIES:
        raise ConfigError(
            f"attn_impl='{attn_impl}' is not supported for the '{family}' family "
            f"(supported families: {sorted(ATTN_IMPL_FAMILIES)}); use attn_impl='eager'")
    return attn_impl


# the vision tower module of each family
TOWERS = {"vit": ViT, "eva02": Eva02, "fastvit": FastViT, "convnext": ConvNeXt,
          "resnet": ResNet}


def build_tower(spec: TowerSpec, params: dict) -> nn.Module:
    """The vision tower of ``spec``'s family over ``params``."""
    return TOWERS[spec.family](spec.cfg, params)


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


class OnnxVisual(nn.Module):
    """The executor family's vision tower: the graph (``onnx_exec``) on NCHW
    f32 pixels, its output L2-normalized (exported graphs bake the
    normalize in; doing it again keeps the unit-norm contract for graphs
    that don't)."""

    def __init__(self, graph: OnnxTower):
        super().__init__()
        self.graph = graph
        self.input_name = next((n for n in ("pixel_values", "input") if n in graph.input_names),
                               graph.input_names[0])

    def forward(self, pixels: torch.Tensor, *, attn_impl: str = "eager",
                channels_first: bool = True) -> torch.Tensor:
        return l2_normalize(self.graph({self.input_name: pixels.float()}))


def persist_cfg(model_dir: Path, tower_cfg: str, key: str, value) -> None:
    """Write ``model_cfg.{tower_cfg}.{key} = value`` into the dir's
    open_clip_config.json (atomically; a read-only dir keeps the update in
    memory only), so later loads resolve from the config alone."""
    update_config_json(
        model_dir / "open_clip_config.json",
        lambda raw: raw.setdefault("model_cfg", {}).setdefault(
            tower_cfg, {}).__setitem__(key, value))


def maybe_derive_vision_dims(model_dir: Path, config: OpenClipConfig) -> None:
    """For the families whose per-size dims are a reconstructed table
    (PE-Core, EVA02, FastViT MCi3/MCi4) or that the config describes only in
    part (ConvNeXt, ModifiedResNet's attnpool heads): a dir that arrived as a
    reference ONNX export carries the ground truth in ``visual.onnx`` —
    derive the dims from the graph and persist them under
    ``vision_cfg.{pe_cfg,eva02_cfg,fastvit_cfg,convnext_cfg,resnet_cfg}``.
    A graph the derivation does not recognize leaves the config as it is
    (the table, and a loud failure at weight load)."""
    from . import onnx_reader

    v = config.model_cfg.vision_cfg
    name = (v.timm_model_name or "").lower()
    if "pe_core" in name:
        derive, key = onnx_reader.derive_pe_cfg, "pe_cfg"
    elif name.startswith("eva02_"):
        derive, key = onnx_reader.derive_eva02_cfg, "eva02_cfg"
    elif "fastvit" in name or "mci" in name or "mobileclip" in name:
        derive, key = onnx_reader.derive_fastvit_cfg, "fastvit_cfg"
    elif name.startswith("convnext"):
        derive, key = onnx_reader.derive_convnext_cfg, "convnext_cfg"
    elif not name and isinstance(v.layers, (list, tuple)):
        derive, key = onnx_reader.derive_resnet_cfg, "resnet_cfg"
    else:
        return
    if v.extra.get(key):
        return
    onnx_path = model_dir / "visual.onnx"
    if not onnx_path.is_file():
        return
    try:
        derived = derive(onnx_path)
    except WeightError:
        return
    v.extra[key] = derived
    persist_cfg(model_dir, "vision_cfg", key, derived)


def derive_vision_dims_from_sd(model_dir: Path, config: OpenClipConfig,
                               visual_sd: dict) -> None:
    """At conversion (``pull_weights.convert_checkpoint``), for the families
    whose per-size dims are a reconstructed table (PE-Core, FastViT
    MCi3/MCi4, EVA02): derive the dims from the checkpoint's shapes and
    persist them under ``vision_cfg.{pe_cfg,fastvit_cfg,eva02_cfg}``, so the
    table is used only when no checkpoint exists. A dict the derivation
    does not recognize leaves the config as it is."""
    v = config.model_cfg.vision_cfg
    name = (v.timm_model_name or "").lower()
    if "pe_core" in name:
        from .weights import derive_pe_cfg_from_sd as derive
        key = "pe_cfg"
    elif "fastvit" in name or "mci" in name or "mobileclip" in name:
        from .models.fastvit import derive_fastvit_cfg_from_sd as derive
        key = "fastvit_cfg"
    elif name.startswith("eva02_"):
        from .models.eva02 import derive_eva02_cfg_from_sd as derive
        key = "eva02_cfg"
    else:
        return
    if v.extra.get(key):
        return
    try:
        derived = derive(visual_sd)
    except WeightError:
        return
    v.extra[key] = derived
    persist_cfg(model_dir, "vision_cfg", key, derived)


# the native weight file of each tower ("visual", "text")
NATIVE = {"visual": NATIVE_VISUAL, "text": NATIVE_TEXT}


def cache_converted(model_dir: Path, tower: str, tree: dict, device, dtype) -> dict:
    """A tree converted from ``{tower}.onnx``, saved as the native npz (not
    on a read-only dir) and returned as tensors on ``device``."""
    try:
        save_pytree(model_dir / NATIVE[tower], tree)
    except OSError:
        pass  # read-only model dir: skip the cache, stay functional
    return params_from_numpy(tree, device=device, dtype=dtype)


def load_or_convert(model_dir: Path, spec: TowerSpec, tower: str, device, dtype) -> dict:
    """The tower's weight tree on ``device``: from its native npz
    (validated) or, where that is absent, converted from ``{tower}.onnx``
    (``onnx_reader.extract_tower_params``, self-checked on ``device``) and
    cached (``cache_converted``)."""
    from .onnx_reader import extract_tower_params

    native = model_dir / NATIVE[tower]
    if native.is_file():
        params = load_pytree(native, device=device, dtype=dtype)
        validate_tower_pytree(params, spec, source=native)
        return params
    tree = extract_tower_params(model_dir / f"{tower}.onnx", spec, tower=tower, device=device)
    return cache_converted(model_dir, tower, tree, device, dtype)


def executor_fallback(model_dir: Path, tower: str, err: Exception, device, dtype,
                      quantize: str | None) -> TowerSpec:
    """After the native route failed with ``err``: the executor family's
    spec over ``{tower}.onnx``, with a warning — unless the native npz is
    present (then it is broken, and ``err`` is raised) or there is no graph
    to run."""
    onnx_path = model_dir / f"{tower}.onnx"
    if (model_dir / NATIVE[tower]).is_file() or not onnx_path.is_file():
        raise err
    what = "text" if tower == "text" else "vision"
    warn_once(f"{what}_fallback:{model_dir}",
              "no native %s tower for %s — serving the graph via the ONNX executor "
              "instead (%s)", what, str(model_dir), err)
    return TowerSpec("onnx", fallback_cfg(onnx_path, dtype=dtype, quantize=quantize))


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
        self.attn_impl = resolve_attn_impl(attn_impl, self.device, spec.family)
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
            layout="nchw",  # every tower takes channels-first pixels
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
        check_quantize_mode(quantize)
        maybe_derive_vision_dims(model_dir, config)
        try:
            spec = resolve_vision(config.model_cfg)
            params = load_or_convert(model_dir, spec, "visual", dev, dtype)
        except (ConfigError, WeightError) as err:
            spec = executor_fallback(model_dir, "visual", err, dev, dtype, quantize)
        if spec.family == "onnx":  # the executor quantizes at load
            tower = OnnxVisual(load_tower(spec.cfg, dev))
        else:
            tower = build_tower(spec, quantize_params(params, spec, quantize, dev, dtype))
        return cls(tower=tower, spec=spec, config=config, model_config=model_config,
                   model_dir=model_dir, device=dev, dtype=dtype, attn_impl=attn_impl,
                   quantize=quantize)

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
        """A fresh instance sharing this one's weights, and so their
        captured graphs, under one lock (``utils.captured``; reference:
        src/vision.rs:87-91)."""
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
        embs, n = self.embed_images_device(images)
        return embs[:n].float().cpu().numpy()

    def embed_images_device(self, images: Sequence[Any]) -> tuple[torch.Tensor, int]:
        """Asynchronous variant: launches the forward and returns
        ``(embeddings [bucket, embed_dim] on the embedder's device, n)``
        without a host sync (nothing is read back), so a caller
        (``parallel.pipeline.EmbedPipeline``) can keep a batch in flight
        while the previous one reads back. Rows past ``n`` are padding. On
        the card the rows are a copy of the bucket's graph output
        (``utils.captured``), so they outlive the next call."""
        if len(images) == 0:
            raise InferenceError("Empty batch")
        arrays = [to_rgb_array(img) for img in images]
        with torch.inference_mode():
            pixels = self.preprocessor(arrays)  # [bucket, 3, S, S]
            return captured.forward(self.tower, pixels,
                                    attn_impl=self.attn_impl, channels_first=True), len(arrays)

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
