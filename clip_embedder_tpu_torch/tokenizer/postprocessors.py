"""tokenizer.json post-processors: add special tokens around the sequence.

Covers TemplateProcessing (CLIP's <|startoftext|> … <|endoftext|>, T5/SigLIP's
… </s>), Roberta/Bert processing, and ByteLevel (identity on ids).
"""

from __future__ import annotations

from typing import Callable

from ..errors import TokenizerError

# A processor maps (ids, type) -> ids given a vocab for special lookups.
PostProcessor = Callable[[list[int]], list[int]]


def _template_single(spec: dict) -> tuple[list, dict]:
    template = spec.get("single", [])
    specials = spec.get("special_tokens", {})
    return template, specials


def build_postprocessor(spec: dict | None) -> tuple[PostProcessor, int]:
    """Returns (process_fn, num_added_tokens_for_single_sequence)."""
    if spec is None:
        return (lambda ids: ids), 0
    ptype = spec.get("type")

    if ptype == "ByteLevel":
        return (lambda ids: ids), 0

    if ptype == "TemplateProcessing":
        template, specials = _template_single(spec)
        prefix: list[int] = []
        suffix: list[int] = []
        seen_seq = False
        for item in template:
            if "Sequence" in item:
                if item["Sequence"].get("id") == "A":
                    seen_seq = True
                continue
            if "SpecialToken" in item:
                name = item["SpecialToken"]["id"]
                entry = specials.get(name)
                if entry is None:
                    raise TokenizerError(f"Template special '{name}' not declared")
                ids = entry["ids"]
                (suffix if seen_seq else prefix).extend(ids)
        n_added = len(prefix) + len(suffix)
        return (lambda ids: prefix + ids + suffix), n_added

    if ptype == "RobertaProcessing":
        cls_id = spec["cls"][1]
        sep_id = spec["sep"][1]
        return (lambda ids: [cls_id] + ids + [sep_id]), 2

    if ptype == "BertProcessing":
        cls_id = spec["cls"][1]
        sep_id = spec["sep"][1]
        return (lambda ids: [cls_id] + ids + [sep_id]), 2

    if ptype == "Sequence":
        fns: list[PostProcessor] = []
        total = 0
        for sub in spec["processors"]:
            fn, n = build_postprocessor(sub)
            fns.append(fn)
            total += n

        def seq(ids: list[int]) -> list[int]:
            for fn in fns:
                ids = fn(ids)
            return ids

        return seq, total

    raise TokenizerError(f"Unsupported post-processor type '{ptype}'")
