"""tokenizer.json model stage: BPE, WordPiece, Unigram — from scratch.

The segmentation cores behind every open_clip tokenizer: CLIP's byte-level
BPE with ``</w>`` end-of-word suffix, Gemma/SigLIP2-style SentencePiece BPE
with byte-fallback, T5/SigLIP's Unigram (Viterbi), and BERT's WordPiece
(BiomedCLIP). The reference gets all of this from the HF `tokenizers` crate
(reference: src/text.rs:11); here it is ~250 lines of plain Python — the
host-side cost is trivial next to a tower forward, and parity is tested
against the `tokenizers` library in tests/test_tokenizer.py.
"""

from __future__ import annotations

import math
from typing import Callable

from ..errors import TokenizerError

Model = Callable[[str], list[int]]


class BPE:
    def __init__(self, spec: dict):
        self.vocab: dict[str, int] = spec["vocab"]
        merges = spec.get("merges", [])
        self.merge_ranks: dict[tuple[str, str], int] = {}
        for i, merge in enumerate(merges):
            if isinstance(merge, str):
                a, b = merge.split(" ", 1)
            else:
                a, b = merge
            self.merge_ranks[(a, b)] = i
        self.unk_token: str | None = spec.get("unk_token")
        self.continuing_subword_prefix: str = spec.get("continuing_subword_prefix") or ""
        self.end_of_word_suffix: str = spec.get("end_of_word_suffix") or ""
        self.fuse_unk: bool = spec.get("fuse_unk", False)
        self.byte_fallback: bool = spec.get("byte_fallback", False)
        self.ignore_merges: bool = spec.get("ignore_merges", False)
        self._cache: dict[str, list[str]] = {}

    def _merge_word(self, word: str) -> list[str]:
        cached = self._cache.get(word)
        if cached is not None:
            return cached
        prefix = self.continuing_subword_prefix
        suffix = self.end_of_word_suffix
        chars = list(word)
        # Build the initial symbol sequence the way HF does: symbols that
        # can't be represented (not in vocab, no byte fallback, no unk) are
        # dropped *before* merging, so merges apply across the gap.
        parts: list[str] = []
        for i, c in enumerate(chars):
            piece = c
            if i > 0 and prefix:
                piece = prefix + piece
            if i == len(chars) - 1 and suffix:
                piece = piece + suffix
            if piece in self.vocab:
                parts.append(piece)
                continue
            if self.byte_fallback:
                byte_tokens = [f"<0x{b:02X}>" for b in c.encode("utf-8")]
                if all(t in self.vocab for t in byte_tokens):
                    parts.extend(byte_tokens)
                    continue
            if self.unk_token is not None:
                if self.fuse_unk and parts and parts[-1] == self.unk_token:
                    continue
                parts.append(self.unk_token)
            # else: drop the symbol entirely (HF behavior with unk=None)

        while len(parts) > 1:
            best_rank = None
            best_i = -1
            for i in range(len(parts) - 1):
                rank = self.merge_ranks.get((parts[i], parts[i + 1]))
                if rank is not None and (best_rank is None or rank < best_rank):
                    best_rank = rank
                    best_i = i
            if best_rank is None:
                break
            right = parts[best_i + 1]
            # HF semantics: the merged token is left + right with right's
            # continuing-subword prefix stripped (end-of-word suffixes stay,
            # the merges table stores pairs with markers included).
            if prefix and right.startswith(prefix):
                right = right[len(prefix):]
            parts = parts[:best_i] + [parts[best_i] + right] + parts[best_i + 2:]
        if len(self._cache) < 32768:
            self._cache[word] = parts
        return parts

    def tokenize(self, word: str) -> list[int]:
        if not word:
            return []
        if self.ignore_merges and word in self.vocab:
            return [self.vocab[word]]
        # All parts are representable by construction (_merge_word filtered
        # or substituted the rest), and merged pairs exist in the vocab.
        return [
            self.vocab[part]
            for part in self._merge_word(word)
            if part in self.vocab
        ]


class WordPiece:
    def __init__(self, spec: dict):
        self.vocab: dict[str, int] = spec["vocab"]
        self.unk_token: str = spec.get("unk_token", "[UNK]")
        self.prefix: str = spec.get("continuing_subword_prefix", "##")
        self.max_chars: int = spec.get("max_input_chars_per_word", 100)

    def _unk(self) -> int:
        unk = self.vocab.get(self.unk_token)
        if unk is None:
            # HF errors loudly here; silently dropping the word would
            # compute embeddings from mutilated text
            from ..errors import TokenizerError

            raise TokenizerError(
                f"Missing '{self.unk_token}' token from the vocabulary")
        return unk

    def tokenize(self, word: str) -> list[int]:
        if not word:
            return []
        if len(word) > self.max_chars:
            return [self._unk()]
        ids: list[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                piece = word[start:end]
                if start > 0:
                    piece = self.prefix + piece
                if piece in self.vocab:
                    cur = self.vocab[piece]
                    break
                end -= 1
            if cur is None:
                return [self._unk()]
            ids.append(cur)
            start = end
        return ids


class Unigram:
    """SentencePiece Unigram segmentation via Viterbi over log-probs."""

    def __init__(self, spec: dict):
        entries = spec["vocab"]  # list of [piece, logprob]
        self.pieces: dict[str, tuple[int, float]] = {
            piece: (i, float(lp)) for i, (piece, lp) in enumerate(entries)
        }
        self.vocab: dict[str, int] = {p: i for p, (i, _) in self.pieces.items()}
        self.unk_id: int | None = spec.get("unk_id")
        self.byte_fallback: bool = spec.get("byte_fallback", False)
        self.max_piece_len = max((len(p) for p in self.pieces), default=1)
        # SentencePiece/HF unknown-char score: min vocab score - 10, so real
        # pieces with very low log-probs still beat the unk path.
        min_score = min((lp for _, lp in self.pieces.values()), default=0.0)
        self.unk_penalty = min_score - 10.0

    def tokenize(self, word: str) -> list[int]:
        if not word:
            return []
        n = len(word)
        NEG = -math.inf
        best = [NEG] * (n + 1)
        back: list[tuple[int, int | None]] = [(0, None)] * (n + 1)
        best[0] = 0.0
        unk_penalty = self.unk_penalty
        for end in range(1, n + 1):
            lo = max(0, end - self.max_piece_len)
            for start in range(lo, end):
                if best[start] == NEG:
                    continue
                entry = self.pieces.get(word[start:end])
                if entry is not None:
                    score = best[start] + entry[1]
                    if score > best[end]:
                        best[end] = score
                        back[end] = (start, entry[0])
            if best[end] == NEG:
                # single unknown char fallback
                start = end - 1
                if best[start] != NEG:
                    best[end] = best[start] + unk_penalty
                    back[end] = (start, None)
        # trace back (consecutive unknowns fuse into one <unk>, matching
        # HF/SentencePiece behavior)
        ids_rev: list[int] = []
        pos = n
        while pos > 0:
            start, token_id = back[pos]
            if token_id is None:
                ch = word[start:pos]
                handled = False
                if self.byte_fallback:
                    byte_ids = [
                        self.vocab.get(f"<0x{b:02X}>") for b in ch.encode("utf-8")
                    ]
                    if all(b is not None for b in byte_ids):
                        ids_rev.extend(reversed(byte_ids))
                        handled = True
                if not handled and self.unk_id is not None:
                    if not (ids_rev and ids_rev[-1] == self.unk_id):
                        ids_rev.append(self.unk_id)
            else:
                ids_rev.append(token_id)
            pos = start
        return list(reversed(ids_rev))


def build_model(spec: dict):
    mtype = spec.get("type")
    if mtype == "BPE":
        return BPE(spec)
    if mtype == "WordPiece":
        return WordPiece(spec)
    if mtype == "Unigram":
        return Unigram(spec)
    raise TokenizerError(f"Unsupported tokenizer model type '{mtype}'")
