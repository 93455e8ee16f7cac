"""tokenizer.json normalizers, from scratch.

Covers the normalizer configs used by the open_clip model zoo's tokenizers
(the reference delegates all of this to the HF `tokenizers` Rust crate —
reference: src/text.rs:11,68): CLIP (NFC → whitespace-collapse → lowercase),
BERT-style (BertNormalizer), and SentencePiece exports (Precompiled,
approximated — see note there).
"""

from __future__ import annotations

import unicodedata
from typing import Any, Callable

import regex

from ..errors import TokenizerError

Normalizer = Callable[[str], str]


def _compile_pattern(pattern: Any) -> "regex.Pattern":
    if isinstance(pattern, dict):
        if "Regex" in pattern:
            return regex.compile(pattern["Regex"])
        if "String" in pattern:
            return regex.compile(regex.escape(pattern["String"]))
    if isinstance(pattern, str):
        return regex.compile(regex.escape(pattern))
    raise TokenizerError(f"Unsupported pattern spec: {pattern!r}")


def build_normalizer(spec: dict | None) -> Normalizer:
    if spec is None:
        return lambda s: s
    ntype = spec.get("type")

    if ntype == "Sequence":
        fns = [build_normalizer(sub) for sub in spec["normalizers"]]

        def seq(s: str) -> str:
            for fn in fns:
                s = fn(s)
            return s

        return seq
    if ntype in ("NFC", "NFD", "NFKC", "NFKD"):
        return lambda s, f=ntype: unicodedata.normalize(f, s)
    if ntype == "Lowercase":
        return lambda s: s.lower()
    if ntype == "Replace":
        rx = _compile_pattern(spec["pattern"])
        content = spec["content"]
        # HF tokenizers inserts content LITERALLY; Python's re.sub would
        # interpret backslashes/group refs in it as a template (raising
        # "bad escape" or substituting groups) — use a callable instead
        return lambda s: rx.sub(lambda m: content, s)
    if ntype == "Strip":
        left = spec.get("strip_left", spec.get("left", True))
        right = spec.get("strip_right", spec.get("right", True))

        def strip(s: str) -> str:
            if left and right:
                return s.strip()
            if left:
                return s.lstrip()
            if right:
                return s.rstrip()
            return s

        return strip
    if ntype == "StripAccents":
        return _strip_accents
    if ntype == "Prepend":
        prefix = spec["prepend"]
        return lambda s: (prefix + s) if s else s
    if ntype == "BertNormalizer":
        return _bert_normalizer(
            clean_text=spec.get("clean_text", True),
            handle_chinese_chars=spec.get("handle_chinese_chars", True),
            strip_accents=spec.get("strip_accents"),
            lowercase=spec.get("lowercase", True),
        )
    if ntype == "Precompiled":
        # SentencePiece precompiled charsmaps encode (approximately) NFKC plus
        # a few space rules. Exact replay of the binary trie is out of scope;
        # NFKC matches it for the text domains these models tokenize.
        return lambda s: unicodedata.normalize("NFKC", s)
    if ntype == "Nmt":
        return _nmt_normalize
    raise TokenizerError(f"Unsupported normalizer type '{ntype}'")


def _strip_accents(s: str) -> str:
    return "".join(
        c for c in unicodedata.normalize("NFD", s)
        if unicodedata.category(c) != "Mn"
    )


def _is_chinese_char(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F
    )


def _bert_normalizer(clean_text, handle_chinese_chars, strip_accents, lowercase):
    def norm(s: str) -> str:
        if clean_text:
            out = []
            for c in s:
                cp = ord(c)
                if (cp == 0 or cp == 0xFFFD
                        or unicodedata.category(c).startswith("C")
                        and c not in "\t\n\r"):
                    continue
                out.append(" " if c in "\t\n\r" or unicodedata.category(c) == "Zs" else c)
            s = "".join(out)
        if handle_chinese_chars:
            s = "".join(
                f" {c} " if _is_chinese_char(ord(c)) else c for c in s
            )
        if lowercase:
            s = s.lower()
        if strip_accents or (strip_accents is None and lowercase):
            s = _strip_accents(s)
        return s

    return norm


def _nmt_normalize(s: str) -> str:
    out = []
    for c in s:
        cp = ord(c)
        if cp in (0x0001, 0x0002, 0x0003, 0x0004, 0x0005, 0x0006, 0x0007,
                  0x0008, 0x000B, 0x000E, 0x000F, 0x0010, 0x0011, 0x0012,
                  0x0013, 0x0014, 0x0015, 0x0016, 0x0017, 0x0018, 0x0019,
                  0x001A, 0x001B, 0x001C, 0x001D, 0x001E, 0x001F, 0x007F,
                  0x008F, 0x009F):
            continue
        if cp in (0x0009, 0x000A, 0x000C, 0x000D, 0x1680, 0x200B, 0x200C,
                  0x200D, 0x200E, 0x200F, 0x2028, 0x2029, 0x2581, 0xFEFF,
                  0xFFFD) or 0x2000 <= cp <= 0x200A:
            out.append(" ")
        else:
            out.append(c)
    return "".join(out)
