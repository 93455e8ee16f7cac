"""TextEmbedder: text → L2-normalized embedding.

Counterpart of ``clip_embedder_tpu.text`` (reference: src/text.rs:13-169):
same pad-id resolution (``model_config.pad_id``, else the tokenizer's
``<pad>`` entry — src/text.rs:70-73), same fixed pad/truncate to
``context_length`` (src/text.rs:76-85), same SigLIP pre-lowercasing
(src/text.rs:115-121), batch padded to a power-of-two bucket. The tower is
``models.text_transformer.TextTransformer`` or, for ``hf_model_name`` configs,
``models.hf_text.HFText``, which takes the tokenizer's attention mask;
devices as in ``vision``.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Mapping, Sequence

import numpy as np
import torch
from torch import nn

from .config import ModelConfig, OpenClipConfig
from .errors import ConfigError, InferenceError
from .model_manager import (
    NATIVE_TEXT,
    get_default_base_folder,
    get_hf_model,
    verify_model_dir,
)
from .models.build import TowerSpec, resolve_text
from .models.hf_text import HFText
from .models.text_transformer import TextTransformer
from .ops.preprocess import bucket_batch
from .tokenizer import Tokenizer
from .ops.quant import check_quantize_mode
from .vision import quantize_params, resolve_attn_impl, resolve_device
from .weights import load_pytree, validate_tower_pytree


def configure_tokenizer(tokenizer: Tokenizer, model_config: ModelConfig,
                        context_length: int) -> int:
    """Pad-id resolution, exactly the reference's chain (src/text.rs:70-73):
    the explicit config value, else the '<pad>' vocab id. Sets fixed padding
    and truncation to ``context_length``; returns the pad id."""
    pad_id = model_config.pad_id
    if pad_id is None:
        pad_id = tokenizer.get_vocab(True).get("<pad>")
    if pad_id is None:
        raise ConfigError("No pad token found in tokenizer")
    tokenizer.with_padding(length=context_length, pad_id=int(pad_id))
    tokenizer.with_truncation(max_length=context_length)
    return int(pad_id)


def text_tower(spec: TowerSpec, params: Mapping) -> nn.Module:
    """The text tower of ``spec``'s family over ``params``."""
    if spec.family == "hf_bert":
        return HFText(spec.cfg, params)
    return TextTransformer(spec.cfg, params)


def with_tokenizer_pad_id(spec: TowerSpec, pad_id: int) -> TowerSpec:
    """CoCa's cls mask is built from the ids inside the forward, so it
    takes the id the tokenizer pads with (``configure_tokenizer``'s chain),
    not text_cfg's default 0, as the JAX package does."""
    if getattr(spec.cfg, "embed_cls", False) and spec.cfg.pad_id != pad_id:
        return TowerSpec(spec.family, dataclasses.replace(spec.cfg, pad_id=pad_id))
    return spec


def _load_text(model_dir: Path, spec: TowerSpec, device, dtype) -> dict:
    native = model_dir / NATIVE_TEXT
    if not native.is_file():
        # the ONNX conversion / executor fallback is not yet ported
        raise ConfigError(f"No native text weights ({NATIVE_TEXT}) in "
                          f"{model_dir}; the ONNX path is not yet ported")
    params = load_pytree(native, device=device, dtype=dtype)
    validate_tower_pytree(params, spec, source=native)
    return params


class TextEmbedder:
    """Text tower + tokenizer (reference: src/text.rs:13-22)."""

    def __init__(
        self,
        *,
        tower: nn.Module,
        spec: TowerSpec,
        config: OpenClipConfig,
        model_config: ModelConfig,
        tokenizer: Tokenizer,
        model_dir: Path | str,
        device: torch.device | str | None = None,
        dtype: torch.dtype = torch.float32,
        attn_impl: str = "auto",
        quantize: str | None = None,
    ):
        """``tokenizer`` must already pad and truncate to the context length
        (``configure_tokenizer``); ``tower`` holds weights already in the
        ``quantize`` mode's form (``from_local_dir`` converts them)."""
        check_quantize_mode(quantize)
        self.device = resolve_device(device)
        self.attn_impl = resolve_attn_impl(attn_impl, self.device, spec.family)
        self.quantize = quantize
        self.tower = tower.to(self.device)
        self.spec = spec
        self.config = config
        self.model_config = model_config
        self.tokenizer = tokenizer
        self.model_dir = Path(model_dir)
        self.dtype = dtype
        self.pad_id = tokenizer.pad_id

    # -- construction (reference: src/text.rs:27-101) ----------------------

    @classmethod
    def from_local_dir(
        cls, model_dir: Path | str, *, device: torch.device | str | None = None,
        dtype: torch.dtype = torch.float32, attn_impl: str = "auto",
        quantize: str | None = None,
    ) -> "TextEmbedder":
        model_dir = Path(model_dir)
        dev = resolve_device(device)
        verify_model_dir(model_dir)
        config = OpenClipConfig.from_file(model_dir / "open_clip_config.json")
        model_config = ModelConfig.from_file(model_dir / "model_config.json")
        tokenizer = Tokenizer.from_file(model_dir / "tokenizer.json")
        pad_id = configure_tokenizer(tokenizer, model_config,
                                     config.model_cfg.text_cfg.context_length)
        spec = with_tokenizer_pad_id(resolve_text(config.model_cfg), pad_id)
        params = quantize_params(_load_text(model_dir, spec, dev, dtype), spec, quantize,
                                 dev, dtype)
        return cls(tower=text_tower(spec, params), spec=spec, config=config,
                   model_config=model_config, tokenizer=tokenizer, model_dir=model_dir,
                   device=dev, dtype=dtype, attn_impl=attn_impl, quantize=quantize)

    @classmethod
    def from_local_id(
        cls, model_id: str, *, base_folder: Path | str | None = None, **kw
    ) -> "TextEmbedder":
        base = Path(base_folder) if base_folder else get_default_base_folder()
        return cls.from_local_dir(base / model_id, **kw)

    @classmethod
    def from_hf(cls, model_id: str, **kw) -> "TextEmbedder":
        return cls.from_local_dir(get_hf_model(model_id), **kw)

    def duplicate(self) -> "TextEmbedder":
        """(reference: src/text.rs:104-108) — weights are shared; the
        tokenizer is cloned (stateful pre-tokenizers carry per-call
        state)."""
        return TextEmbedder(
            tower=self.tower, spec=self.spec, config=self.config,
            model_config=self.model_config, tokenizer=self.tokenizer.clone(),
            model_dir=self.model_dir, device=self.device, dtype=self.dtype,
            attn_impl=self.attn_impl, quantize=self.quantize,
        )

    # -- tokenization (reference: src/text.rs:111-139) ---------------------

    def tokenize(self, texts: Sequence[str]) -> tuple[np.ndarray, np.ndarray]:
        """Texts → fixed-shape int32 (ids, attention_mask) arrays of shape
        [batch, context_length]. SigLIP models lowercase first."""
        if self.model_config.tokenizer_needs_lowercase:
            texts = [t.lower() for t in texts]
        return self.tokenizer.encode_batch(list(texts))

    # -- embedding (reference: src/text.rs:142-169) ------------------------

    def embed_text(self, text: str) -> np.ndarray:
        return self.embed_texts([text])[0]

    def embed_texts(self, texts: Sequence[str]) -> np.ndarray:
        if len(texts) == 0:
            raise InferenceError("Empty batch")
        ids, mask = self.tokenize(texts)
        bb = bucket_batch(len(texts))
        if bb != ids.shape[0]:  # the bucket's rows: pad ids, no key attended
            pad = np.full((bb - ids.shape[0], ids.shape[1]), self.pad_id, np.int32)
            ids = np.concatenate([ids, pad], axis=0)
            mask = np.concatenate([mask, np.zeros_like(pad)], axis=0)
        kw = {}
        if self.spec.family == "hf_bert":  # the tokenizer's mask is authoritative
            kw["attention_mask"] = torch.from_numpy(mask).to(self.device)
        with torch.inference_mode():
            embs = self.tower(torch.from_numpy(ids).to(self.device),
                              attn_impl=self.attn_impl, **kw)
            return embs[: len(texts)].float().cpu().numpy()
