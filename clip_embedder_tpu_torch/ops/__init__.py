"""Ops: plain functions on tensors, and the wrappers of the CUDA kernels
(``qkv.ln_qkv``, ``flash.flash_attention_packed``, and for the int8 modes
``int8_mlp.int8_mlp``, ``qkv.ln_qkv_int8``, ``int8_mlp.int8_linear_fused``;
``quant`` converts weights to int8)."""
