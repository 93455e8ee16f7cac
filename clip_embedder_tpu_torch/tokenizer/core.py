"""The tokenizer: a from-scratch loader/encoder for HF ``tokenizer.json``.

From-scratch replacement for the HF `tokenizers` Rust crate the reference
depends on (reference: src/text.rs:11, Cargo.toml:16). Pipeline per the file
format: added-token splitting → normalizer → pre-tokenizer → model
(BPE/WordPiece/Unigram) → post-processor → truncation/padding.

Padding/truncation semantics match the reference exactly
(reference: src/text.rs:76-85): fixed padding to ``context_length`` with a
configurable ``pad_id``, truncation reserving room for the post-processor's
special tokens. Output is the fixed-shape int32 ``[batch, context_length]``
id/mask arrays the text tower consumes — static shapes, XLA-friendly.

Parity is tested against the `tokenizers` reference library in
tests/test_tokenizer.py.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import regex

from ..errors import IoError, JsonError, TokenizerError
from .models import build_model
from .normalizers import build_normalizer
from .postprocessors import build_postprocessor
from .pretokenizers import build_pretokenizer


class AddedToken:
    __slots__ = ("id", "content", "single_word", "lstrip", "rstrip",
                 "normalized", "special")

    def __init__(self, spec: dict):
        self.id = spec["id"]
        self.content = spec["content"]
        self.single_word = spec.get("single_word", False)
        self.lstrip = spec.get("lstrip", False)
        self.rstrip = spec.get("rstrip", False)
        self.normalized = spec.get("normalized", False)
        self.special = spec.get("special", False)


class Tokenizer:
    """Host-side tokenizer with the reference's fixed-pad/truncate contract."""

    def __init__(self, spec: dict):
        self.spec = spec
        self.normalizer = build_normalizer(spec.get("normalizer"))
        self.pretokenizer = build_pretokenizer(spec.get("pre_tokenizer"))
        self.model = build_model(spec["model"])
        self.postprocessor, self.num_special = build_postprocessor(
            spec.get("post_processor")
        )
        self.added_tokens = [AddedToken(t) for t in spec.get("added_tokens", [])]
        # Two matchers, HF semantics: non-normalized added tokens match the
        # raw text; normalized ones match after the normalizer runs.
        self._added_rx = self._compile_added(
            [t for t in self.added_tokens if not t.normalized])
        self._added_norm_rx = self._compile_added(
            [t for t in self.added_tokens if t.normalized])

        # Fixed padding/truncation (configured via with_padding/with_truncation,
        # mirroring reference src/text.rs:76-85).
        self.pad_id: int = 0
        self.pad_to: int | None = None
        self.max_length: int | None = None

    # -- construction -----------------------------------------------------

    @classmethod
    def from_file(cls, path: Path | str) -> "Tokenizer":
        path = Path(path)
        try:
            text = path.read_text(encoding="utf-8")
        except OSError as e:
            raise IoError(f"IO error reading tokenizer: {e}") from e
        try:
            spec = json.loads(text)
        except json.JSONDecodeError as e:
            raise JsonError(f"JSON error in {path}: {e}") from e
        try:
            return cls(spec)
        except (KeyError, TypeError, ValueError) as e:
            # Valid JSON, invalid tokenizer schema (e.g. a model section
            # missing its vocab). HF `tokenizers` raises a typed error here
            # ("data did not match any variant ..."); a raw KeyError must not
            # escape the load path (reference: src/error.rs Tokenizer variant).
            raise TokenizerError(
                f"Invalid tokenizer spec in {path}: {e!r}") from e

    def clone(self) -> "Tokenizer":
        """Independent copy (same spec, same padding/truncation config).
        Stateful pre-tokenizers (Metaspace prepend "first") carry per-call
        mutable state, so replicas meant for concurrent use — the
        reference's ``duplicate()`` pattern — need their own instance."""
        out = Tokenizer(self.spec)
        out.pad_id = self.pad_id
        out.pad_to = self.pad_to
        out.max_length = self.max_length
        return out

    def with_padding(self, *, length: int, pad_id: int) -> "Tokenizer":
        self.pad_to = length
        self.pad_id = pad_id
        return self

    def with_truncation(self, *, max_length: int) -> "Tokenizer":
        self.max_length = max_length
        return self

    # -- vocab ------------------------------------------------------------

    def get_vocab(self, with_added_tokens: bool = True) -> dict[str, int]:
        vocab = dict(self.model.vocab)
        if with_added_tokens:
            for tok in self.added_tokens:
                vocab.setdefault(tok.content, tok.id)
        return vocab

    def token_to_id(self, token: str) -> int | None:
        return self.get_vocab(True).get(token)

    # -- encoding ---------------------------------------------------------

    @staticmethod
    def _compile_added(tokens: list[AddedToken]):
        if not tokens:
            return None
        parts = []
        for tok in sorted(tokens, key=lambda t: -len(t.content)):
            pat = regex.escape(tok.content)
            if tok.lstrip:
                pat = r"\s*" + pat
            if tok.rstrip:
                pat = pat + r"\s*"
            if tok.single_word:
                pat = r"(?<!\S)" + pat + r"(?!\S)"
            parts.append(pat)
        return regex.compile("|".join(parts))

    def _match_added(self, piece: str) -> int | None:
        stripped = piece.strip()
        for tok in self.added_tokens:
            if tok.content == stripped or tok.content == piece:
                return tok.id
        return None

    def _split_on(self, rx, text: str, encode_segment) -> list[int]:
        ids: list[int] = []
        last = 0
        for m in rx.finditer(text):
            if m.start() > last:
                ids.extend(encode_segment(text[last : m.start()]))
            token_id = self._match_added(m.group(0))
            if token_id is not None:
                ids.append(token_id)
                # the added token occupies a split slot: stateful
                # pre-tokenizers (Metaspace "first") must see it
                note = getattr(self.pretokenizer, "note_piece", None)
                if note is not None:
                    note()
            else:  # defensive: treat as plain text
                ids.extend(encode_segment(m.group(0)))
            last = m.end()
        if last < len(text):
            ids.extend(encode_segment(text[last:]))
        return ids

    def _encode_text_segment(self, text: str) -> list[int]:
        """Normalize, then match normalized added tokens, then pre-tokenize
        and run the model on the remaining spans."""
        text = self.normalizer(text)

        def model_span(span: str) -> list[int]:
            ids: list[int] = []
            for pretoken in self.pretokenizer(span):
                ids.extend(self.model.tokenize(pretoken))
            return ids

        if self._added_norm_rx is not None:
            return self._split_on(self._added_norm_rx, text, model_span)
        return model_span(text)

    def encode(self, text: str, add_special_tokens: bool = True,
               max_length: int | None = None) -> list[int]:
        """Text → token ids (with specials, truncated to ``max_length``,
        defaulting to the configured ``with_truncation`` length)."""
        reset = getattr(self.pretokenizer, "reset", None)
        if reset is not None:  # per-call state (Metaspace prepend "first")
            reset()
        if self._added_rx is None:
            ids = self._encode_text_segment(text)
        else:
            ids = self._split_on(self._added_rx, text, self._encode_text_segment)

        limit = self.max_length if max_length is None else max_length
        if limit is not None:
            budget = limit - (self.num_special if add_special_tokens else 0)
            ids = ids[: max(budget, 0)]
        if add_special_tokens:
            ids = self.postprocessor(ids)
        return ids

    def encode_batch(
        self, texts: list[str], add_special_tokens: bool = True
    ) -> tuple[np.ndarray, np.ndarray]:
        """Batch encode to fixed-shape int32 ``(ids, attention_mask)`` arrays
        of shape [batch, pad_to] (reference: src/text.rs:111-139 produces the
        same fixed [batch, context_length] layout)."""
        if self.pad_to is None:
            raise TokenizerError("encode_batch requires with_padding(...)")
        batch = len(texts)
        # padding implies a hard [batch, pad_to] layout: truncate content
        # tokens BEFORE post-processing (so suffix specials like CLIP's EOT
        # survive) even when with_truncation was never configured — a blind
        # tail slice would drop the EOT that argmax pooling depends on
        eff = (self.pad_to if self.max_length is None
               else min(self.max_length, self.pad_to))
        ids_arr = np.full((batch, self.pad_to), self.pad_id, dtype=np.int32)
        mask_arr = np.zeros((batch, self.pad_to), dtype=np.int32)
        for i, text in enumerate(texts):
            ids = self.encode(text, add_special_tokens,
                              max_length=eff)[: self.pad_to]
            ids_arr[i, : len(ids)] = ids
            mask_arr[i, : len(ids)] = 1
        return ids_arr, mask_arr
