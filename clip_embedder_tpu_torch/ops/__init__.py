"""Ops: plain functions on tensors, and the wrappers of the CUDA kernels
(``qkv.ln_qkv``, ``flash.flash_attention_packed``)."""
