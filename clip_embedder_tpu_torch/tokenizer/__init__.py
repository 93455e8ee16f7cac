"""From-scratch host-side tokenization (tokenizer.json loader/encoder).

Replaces the reference's dependency on the HF `tokenizers` Rust crate
(reference: src/text.rs:11) with a pure-Python pipeline feeding fixed-shape
id arrays to the text tower.
"""

from .core import Tokenizer

__all__ = ["Tokenizer"]
