"""Tower families ported so far: ``vit`` and ``text_transformer``."""
