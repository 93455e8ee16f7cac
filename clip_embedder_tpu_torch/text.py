"""TextEmbedder: text → L2-normalized embedding.

Counterpart of ``clip_embedder_tpu.text`` (reference: src/text.rs:13-169):
same pad-id resolution (``model_config.pad_id``, else the tokenizer's
``<pad>`` entry — src/text.rs:70-73), same fixed pad/truncate to
``context_length`` (src/text.rs:76-85), same SigLIP pre-lowercasing
(src/text.rs:115-121), batch padded to a power-of-two bucket. The tower is
``models.text_transformer.TextTransformer``, for ``hf_model_name`` configs
``models.hf_text.HFText`` (which takes the tokenizer's attention mask), or
``models.mct.Mct``; devices, and the captured forward on the card
(``utils.captured``), as in ``vision``.

A reference-format dir (``text.onnx``, no ``text.npz``) is converted in place
as the vision tower is (``vision.load_or_convert``). Two derivations come
first, each persisted into open_clip_config.json: a BERT/RoBERTa dir without
``text_cfg.hf_config`` gets it from the graph, and a graph that no configured
family fits but that lifts to the MCT hybrid tower (MobileCLIP-S0) gets
``text_cfg.mct_cfg``. Otherwise the graph itself is the tower
(``OnnxText``), with a warning.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Mapping, Sequence

import numpy as np
import torch
from torch import nn

from .config import ModelConfig, OpenClipConfig
from .errors import ConfigError, InferenceError, WeightError
from .model_manager import (
    NATIVE_TEXT,
    get_default_base_folder,
    get_hf_model,
    verify_model_dir,
)
from .models.build import TowerSpec, resolve_text
from .models.hf_text import HFText
from .models.mct import Mct, MctCfg
from .models.text_transformer import TextTransformer
from .onnx_exec import OnnxTower, load_tower
from .ops.normalize import l2_normalize
from .ops.preprocess import bucket_batch
from .ops.quant import check_quantize_mode
from .tokenizer import Tokenizer
from .utils import captured
from .vision import (cache_converted, executor_fallback, load_or_convert, persist_cfg,
                     quantize_params, resolve_attn_impl, resolve_device)


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
    if spec.family == "mct":
        return Mct(spec.cfg, params)
    return TextTransformer(spec.cfg, params)


class OnnxText(nn.Module):
    """The executor family's text tower: the graph (``onnx_exec``) on the
    token ids, and the attention mask where the graph declares one
    (reference: src/text.rs:90,156-161); its output L2-normalized."""

    def __init__(self, graph: OnnxTower):
        super().__init__()
        self.graph = graph
        self.input_name = next((n for n in ("input_ids", "input") if n in graph.input_names),
                               graph.input_names[0])

    def forward(self, input_ids: torch.Tensor, *, attn_impl: str = "eager",
                attention_mask: torch.Tensor | None = None) -> torch.Tensor:
        feeds = {self.input_name: input_ids}
        if attention_mask is not None and "attention_mask" in self.graph.input_names:
            feeds["attention_mask"] = attention_mask
        return l2_normalize(self.graph(feeds))


def maybe_derive_hf_config(model_dir: Path, config: OpenClipConfig) -> None:
    """For ``hf_model_name`` (BERT/RoBERTa) dirs that arrived as reference
    ONNX exports (the dir contract carries no HF config.json): recover the
    architecture from ``text.onnx`` and persist it as ``text_cfg.hf_config``,
    so the BiomedCLIP class (reference README.md:143) takes the native
    tower. A graph the derivation does not recognize leaves the config as
    it is (then the executor serves it)."""
    from .onnx_reader import derive_bert_hf_config

    tcfg = config.model_cfg.text_cfg
    if not (tcfg.hf_model_name or tcfg.extra.get("hf_model_name")) \
            or tcfg.extra.get("hf_config"):
        return
    onnx_path = model_dir / "text.onnx"
    if not onnx_path.is_file():
        return
    try:
        hf_cfg = derive_bert_hf_config(onnx_path)
    except WeightError:
        return
    tcfg.extra["hf_config"] = hf_cfg
    persist_cfg(model_dir, "text_cfg", "hf_config", hf_cfg)


def maybe_native_hybrid(model_dir: Path, onnx_path: Path,
                        device) -> tuple[TowerSpec, dict] | None:
    """MCT-class hybrid text (MobileCLIP-S0), tried when the configured
    family fails: derive the architecture from the graph
    (``onnx_reader.derive_mct_cfg``), recover the weights and check the
    tower against the graph executor (``extract_tower_params``). On success
    the derived cfg is persisted as ``text_cfg.mct_cfg`` (later loads
    resolve natively) and the spec and numpy tree are returned; a misread
    gives None (the executor then serves the graph), never wrong
    embeddings."""
    from .onnx_reader import derive_mct_cfg, extract_tower_params

    try:
        raw = derive_mct_cfg(onnx_path)
        spec = TowerSpec("mct", MctCfg(**raw))
        params = extract_tower_params(onnx_path, spec, tower="text", device=device)
    except WeightError:
        return None
    persist_cfg(model_dir, "text_cfg", "mct_cfg",
                dict(raw, conv_blocks=[list(b) for b in raw["conv_blocks"]]))
    return spec, params


def pad_batch(ids: np.ndarray, mask: np.ndarray, rows: int,
              pad_id: int) -> tuple[np.ndarray, np.ndarray]:
    """ids and mask padded to ``rows`` rows (the batch bucket): pad ids, no
    key attended."""
    if rows == ids.shape[0]:
        return ids, mask
    pad = np.full((rows - ids.shape[0], ids.shape[1]), pad_id, np.int32)
    return np.concatenate([ids, pad], axis=0), np.concatenate([mask, np.zeros_like(pad)], axis=0)


def tower_kwargs(spec: TowerSpec, mask: np.ndarray, device) -> dict:
    """The tokenizer's attention mask, for the towers that take one (BERT,
    the executor's graphs): there it is authoritative."""
    if spec.family in ("hf_bert", "onnx"):
        return {"attention_mask": torch.from_numpy(mask).to(device)}
    return {}


def with_tokenizer_pad_id(spec: TowerSpec, pad_id: int) -> TowerSpec:
    """CoCa's cls mask is built from the ids inside the forward, so it
    takes the id the tokenizer pads with (``configure_tokenizer``'s chain),
    not text_cfg's default 0, as the JAX package does."""
    if getattr(spec.cfg, "embed_cls", False) and spec.cfg.pad_id != pad_id:
        return TowerSpec(spec.family, dataclasses.replace(spec.cfg, pad_id=pad_id))
    return spec


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
        check_quantize_mode(quantize)
        maybe_derive_hf_config(model_dir, config)
        try:
            spec = with_tokenizer_pad_id(resolve_text(config.model_cfg), pad_id)
            params = load_or_convert(model_dir, spec, "text", dev, dtype)
        except (ConfigError, WeightError) as err:
            onnx_path = model_dir / "text.onnx"
            hybrid = (None if (model_dir / NATIVE_TEXT).is_file() or not onnx_path.is_file()
                      else maybe_native_hybrid(model_dir, onnx_path, dev))
            if hybrid is None:
                spec = executor_fallback(model_dir, "text", err, dev, dtype, quantize)
            else:
                spec, tree = hybrid
                params = cache_converted(model_dir, "text", tree, dev, dtype)
        if spec.family == "onnx":  # the executor quantizes at load
            tower = OnnxText(load_tower(spec.cfg, dev))
        else:
            tower = text_tower(spec, quantize_params(params, spec, quantize, dev, dtype))
        return cls(tower=tower, spec=spec, config=config, model_config=model_config,
                   tokenizer=tokenizer, model_dir=model_dir, device=dev, dtype=dtype,
                   attn_impl=attn_impl, quantize=quantize)

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
        """(reference: src/text.rs:104-108) — weights are shared, and so
        their captured graphs (``utils.captured``); the tokenizer is cloned
        (stateful pre-tokenizers carry per-call state)."""
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
        ids, mask = pad_batch(ids, mask, bucket_batch(len(texts)), self.pad_id)
        embs = captured.forward(self.tower, torch.from_numpy(ids).to(self.device),
                                attn_impl=self.attn_impl,
                                **tower_kwargs(self.spec, mask, self.device))
        return embs[: len(texts)].float().cpu().numpy()
