"""Running a configuration's plain reference over a set of images.

The reference is plain PyTorch in float32 with TF32 off and attention on
the math route: independent of the program, it imports nothing of it and
reads only the benchmark's own weight tree and images. It runs layer by
layer over all the images, in blocks of rows, so that it fits beside
nothing: it runs once the program's state is freed."""

from __future__ import annotations

import contextlib
import importlib

import numpy as np
import torch

from .resize import preprocess


@contextlib.contextmanager
def full_f32():
    """f32 products in full precision and attention on the math route."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        from torch.nn.attention import SDPBackend, sdpa_kernel
        math_only = sdpa_kernel(SDPBackend.MATH)
    except ImportError:  # older torch
        math_only = torch.backends.cuda.sdp_kernel(
            enable_flash=False, enable_math=True, enable_mem_efficient=False)
    try:
        with math_only, torch.no_grad():
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def reference_rows(config: dict, tree: dict, images: list[np.ndarray], device, *,
                   block_rows: int = 8) -> np.ndarray:
    """[len(images), embed_dim] f32 L2-normalised rows of the reference
    named by ``config["reference"]`` (a module of this package with
    ``stages(vision, tree, device)``)."""
    module = importlib.import_module(f"{__package__}.{config['reference']}")
    v = config["vision"]
    with full_f32():
        acts = [preprocess(images[i:i + block_rows], config["preprocess"], v["image_size"],
                           device) for i in range(0, len(images), block_rows)]
        for make in module.stages(v, tree, device):
            stage = make()
            acts = [stage(a) for a in acts]
            del stage
        return torch.cat(acts).cpu().numpy()
