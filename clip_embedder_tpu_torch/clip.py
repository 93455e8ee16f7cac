"""Clip: the combined task API.

Counterpart of ``clip_embedder_tpu.clip``; scoring runs in numpy on the
embeddings the towers return. Mirrors the reference's ``Clip``
(reference: src/clip.rs:14-186) — ``from_hf`` / ``from_local_id`` / ``from_local_dir`` construction,
``duplicate``, ``get_model_config``, ``compare``, ``classify``,
``rank_images``, ``softmax``, ``sigmoid`` — with identical scoring
semantics: embeddings are already L2-normalized, so dot product is cosine;
logits are ``sim·logit_scale + logit_bias``; probabilities via softmax or
sigmoid per ``model_config.activation_function``; results sorted by
probability descending (reference: src/clip.rs:94-170).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Sequence

import numpy as np

from .config import ModelConfig
from .model_manager import get_default_base_folder, get_hf_model, verify_model_dir
from .text import TextEmbedder
from .vision import VisionEmbedder


class Clip:
    """Vision + text embedders (reference: src/clip.rs:14-18)."""

    def __init__(self, *, vision: VisionEmbedder, text: TextEmbedder,
                 model_dir: Path):
        self.vision = vision
        self.text = text
        self.model_dir = Path(model_dir)

    # -- construction (reference: src/clip.rs:25-66) -----------------------

    @classmethod
    def from_local_dir(cls, model_dir: Path | str, **kw) -> "Clip":
        """Both embedders from one model dir; ``kw`` (``device``, ``dtype``,
        ``attn_impl``, ``quantize``) passes to each."""
        model_dir = Path(model_dir)
        verify_model_dir(model_dir)
        vision = VisionEmbedder.from_local_dir(model_dir, **kw)
        text = TextEmbedder.from_local_dir(model_dir, **kw)
        return cls(vision=vision, text=text, model_dir=model_dir)

    @classmethod
    def from_local_id(
        cls, model_id: str, *, base_folder: Path | str | None = None, **kw
    ) -> "Clip":
        base = Path(base_folder) if base_folder else get_default_base_folder()
        return cls.from_local_dir(base / model_id, **kw)

    @classmethod
    def from_hf(cls, model_id: str, **kw) -> "Clip":
        return cls.from_local_dir(get_hf_model(model_id), **kw)

    def duplicate(self) -> "Clip":
        """(reference: src/clip.rs:69-73)"""
        return Clip(
            vision=self.vision.duplicate(), text=self.text.duplicate(),
            model_dir=self.model_dir,
        )

    def get_model_config(self) -> ModelConfig:
        """(reference: src/clip.rs:75-77)"""
        return self.text.model_config

    # -- scoring helpers ---------------------------------------------------

    def _scale_bias(self) -> tuple[float, float]:
        mc = self.text.model_config
        return (
            mc.logit_scale if mc.logit_scale is not None else 1.0,
            mc.logit_bias if mc.logit_bias is not None else 0.0,
        )

    def _activate(self, logits: np.ndarray) -> np.ndarray:
        activation = self.text.model_config.activation_function or "softmax"
        if activation == "sigmoid":
            return self.sigmoid(logits)
        return self.softmax(logits)

    # -- tasks (reference: src/clip.rs:81-170) -----------------------------

    def compare(self, image: Any, text: str) -> float:
        """Raw logit between one image and one text
        (reference: src/clip.rs:81-90)."""
        vision_emb = self.vision.embed_image(image)
        text_emb = self.text.embed_text(text)
        sim = float(np.dot(vision_emb, text_emb))
        scale, bias = self._scale_bias()
        return sim * scale + bias

    def classify(
        self, image: Any, labels: Sequence[str]
    ) -> list[tuple[str, float]]:
        """Zero-shot classification, sorted (label, prob) descending
        (reference: src/clip.rs:94-132)."""
        vision_emb = self.vision.embed_image(image)
        text_embs = self.text.embed_texts(labels)
        scale, bias = self._scale_bias()
        logits = text_embs @ vision_emb * scale + bias
        probs = self._activate(logits)
        results = sorted(
            zip([str(l) for l in labels], probs.tolist()),
            key=lambda kv: kv[1], reverse=True,
        )
        return results

    def rank_images(
        self, images: Sequence[Any], text: str
    ) -> list[tuple[int, float]]:
        """Rank a batch of images against one text query, sorted
        (image_index, prob) descending (reference: src/clip.rs:136-170)."""
        img_embs = self.vision.embed_images(images)
        text_emb = self.text.embed_text(text)
        scale, bias = self._scale_bias()
        logits = img_embs @ text_emb * scale + bias
        probs = self._activate(logits)
        return sorted(enumerate(probs.tolist()), key=lambda kv: kv[1], reverse=True)

    # -- activations (reference: src/clip.rs:174-185) ----------------------

    @staticmethod
    def softmax(logits: np.ndarray) -> np.ndarray:
        logits = np.asarray(logits, dtype=np.float32)
        exps = np.exp(logits - logits.max())
        return exps / exps.sum()

    @staticmethod
    def sigmoid(logits: np.ndarray | float) -> np.ndarray:
        logits = np.asarray(logits, dtype=np.float32)
        return 1.0 / (1.0 + np.exp(-logits))
