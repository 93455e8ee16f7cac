"""tokenizer.json pre-tokenizers, from scratch.

Splits normalized text into pre-tokens ahead of the model stage. Covers the
configs the open_clip zoo uses: CLIP's Split(regex, invert) + ByteLevel,
SentencePiece's Metaspace, BERT's whitespace/punctuation splitting.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Callable

import regex

from ..errors import TokenizerError
from .normalizers import _compile_pattern

PreTokenizer = Callable[[str], list[str]]


@lru_cache(maxsize=1)
def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's reversible byte→printable-unicode table (the basis of
    byte-level BPE alphabets)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


# HF is_punc: unicode category P OR the ASCII punctuation/symbol ranges
# (!-/ :-@ [-` {-~) — \p{P} alone misses $ + < = > ^ ` | ~. One constant,
# shared by BertPreTokenizer and Punctuation (they must agree).
_PUNC_CLASS = r"[\p{P}!-/:-@\[-`{-~]"

_GPT2_SPLIT = regex.compile(
    r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""
)


def _byte_level(add_prefix_space: bool, use_regex: bool) -> PreTokenizer:
    table = bytes_to_unicode()

    def pretok(s: str) -> list[str]:
        if add_prefix_space and s and not s.startswith(" "):
            s = " " + s
        pieces = _GPT2_SPLIT.findall(s) if use_regex else ([s] if s else [])
        return [
            "".join(table[b] for b in piece.encode("utf-8")) for piece in pieces
        ]

    return pretok


def _apply_split(s: str, rx: "regex.Pattern", behavior: str, invert: bool) -> list[str]:
    """HF tokenizers' Split semantics: the pattern defines the *delimiter*
    (``invert`` swaps the roles — matches become content and the text
    between them the delimiter), and ``behavior`` says what happens to
    delimiter runs: Removed | Isolated | Contiguous (adjacent delimiter
    pieces merge) | MergedWithPrevious | MergedWithNext."""
    if behavior not in ("Removed", "Isolated", "Contiguous",
                       "MergedWithPrevious", "MergedWithNext"):
        raise TokenizerError(f"Unsupported split behavior '{behavior}'")
    # alternating (text, is_match) segments in order
    segs: list[tuple[str, bool]] = []
    last = 0
    for m in rx.finditer(s):
        if m.start() == m.end():
            continue
        if m.start() > last:
            segs.append((s[last:m.start()], False))
        segs.append((m.group(0), True))
        last = m.end()
    if last < len(s):
        segs.append((s[last:], False))

    out: list[str] = []
    pending = ""       # MergedWithNext carry (at most one delimiter)
    prev_delim = False
    for text, is_match in segs:
        if is_match == invert:  # content
            out.append(pending + text)
            pending = ""
            prev_delim = False
            continue
        if behavior == "Removed":
            prev_delim = False
        elif behavior in ("Isolated", "Contiguous"):
            if behavior == "Contiguous" and prev_delim and out:
                out[-1] += text
            else:
                out.append(text)
            prev_delim = True
        elif behavior == "MergedWithPrevious":
            # HF merges a delimiter only into a CONTENT predecessor; a
            # delimiter following another delimiter stands alone
            if out and not prev_delim:
                out[-1] += text
            else:
                out.append(text)
            prev_delim = True
        else:  # MergedWithNext
            # symmetric: only the delimiter directly adjacent to the next
            # content merges; earlier delimiters in a run stand alone
            if pending:
                out.append(pending)
            pending = text
            prev_delim = True
    if pending:
        out.append(pending)
    return out


def build_pretokenizer(spec: dict | None) -> PreTokenizer:
    if spec is None:
        return lambda s: [s] if s else []
    ptype = spec.get("type")

    if ptype == "Sequence":
        fns = [build_pretokenizer(sub) for sub in spec["pretokenizers"]]

        def seq(s: str) -> list[str]:
            pieces = [s]
            for fn in fns:
                pieces = [p for piece in pieces for p in fn(piece)]
            return pieces

        resets = [r for fn in fns if (r := getattr(fn, "reset", None))]
        if resets:
            seq.reset = lambda: [r() for r in resets]
        notes = [n for fn in fns if (n := getattr(fn, "note_piece", None))]
        if notes:
            seq.note_piece = lambda: [n() for n in notes]
        return seq
    if ptype == "ByteLevel":
        return _byte_level(
            spec.get("add_prefix_space", True), spec.get("use_regex", True)
        )
    if ptype == "Whitespace":
        rx = regex.compile(r"\w+|[^\w\s]+")
        return lambda s: rx.findall(s)
    if ptype == "WhitespaceSplit":
        return lambda s: s.split()
    if ptype == "Split":
        rx = _compile_pattern(spec["pattern"])
        behavior = spec.get("behavior", "Removed")
        invert = spec.get("invert", False)
        return lambda s: _apply_split(s, rx, behavior, invert)
    if ptype == "Metaspace":
        replacement = spec.get("replacement", "▁")
        scheme = spec.get("prepend_scheme")
        if scheme is None:
            scheme = "always" if spec.get("add_prefix_space", True) else "never"
        split = spec.get("split", True)

        # "first" applies the prefix only to the FIRST piece of each
        # encode() call, not every piece this closure sees — per-call state
        # reset via the .reset hook (wired through Sequence; called by
        # Tokenizer.encode at the start of each text)
        state = {"first": True}

        def metaspace(s: str) -> list[str]:
            if not s:
                return []
            is_first = state["first"]
            state["first"] = False
            prepend = (scheme == "always"
                       or (scheme == "first" and is_first))
            if prepend and not s.startswith((" ", replacement)):
                s = " " + s
            s = s.replace(" ", replacement)
            if not split:
                return [s] if s else []
            # HF splits on the replacement with MergedWithNext semantics:
            # every replacement char starts a new piece, so consecutive
            # spaces yield standalone replacement pieces.
            starts = [i for i, c in enumerate(s) if c == replacement]
            if not starts:
                return [s] if s else []
            pieces = []
            if starts[0] > 0:
                pieces.append(s[: starts[0]])
            for a, b in zip(starts, starts[1:] + [len(s)]):
                pieces.append(s[a:b])
            return pieces

        metaspace.reset = lambda: state.update(first=True)
        # an added token emitted before any model span consumes "first"
        # (HF counts added-token splits in the global split index)
        metaspace.note_piece = lambda: state.update(first=False)
        return metaspace
    if ptype == "BertPreTokenizer":
        # whitespace split, then punctuation isolated (shared _PUNC_CLASS;
        # emoji/other symbols are NOT split off)
        prx = regex.compile(rf"({_PUNC_CLASS})")

        def bert_pretok(s: str) -> list[str]:
            out: list[str] = []
            for word in s.split():
                for piece in prx.split(word):
                    if piece:
                        out.append(piece)
            return out

        return bert_pretok
    if ptype == "Punctuation":
        behavior = spec.get("behavior", "Isolated")
        # per-char matching for every behavior: HF treats each punctuation
        # char as its own delimiter match (a '+' run-match diverges for the
        # Merged* behaviors)
        rx = regex.compile(_PUNC_CLASS)
        return lambda s: _apply_split(s, rx, behavior, False)
    if ptype == "Digits":
        individual = spec.get("individual_digits", False)
        rx = regex.compile(r"\p{N}" if individual else r"\p{N}+")
        return lambda s: _apply_split(s, rx, "Isolated", False)
    raise TokenizerError(f"Unsupported pre-tokenizer type '{ptype}'")
