"""clip_embedder_tpu_torch — the PyTorch/CUDA port of ``clip_embedder_tpu``.

Same public surface and model-dir contract as the JAX package (``Clip`` /
``VisionEmbedder`` / ``TextEmbedder``, ``classify`` / ``rank_images`` /
``compare`` / ``embed_*``, native ``visual.npz`` / ``text.npz`` weights), run
by PyTorch, with hand-written CUDA kernels for Hopper (``csrc/``) where the
JAX package has Pallas kernels. Imports neither ``jax`` nor the JAX package.

    from clip_embedder_tpu_torch import Clip
    clip = Clip.from_local_dir(model_dir)                 # on the card
    clip = Clip.from_local_dir(model_dir, device="cpu")   # on the CPU
    clip = Clip.from_local_dir(model_dir, quantize="int8_all")  # W8A8 on the card
    results = clip.classify("cat.jpg", ["a cat", "a dog"])
"""

from .clip import Clip
from .config import ModelConfig, OpenClipConfig
from .errors import ClipError
from .text import TextEmbedder
from .vision import VisionEmbedder

__version__ = "0.1.0"

__all__ = [
    "Clip",
    "ClipError",
    "ModelConfig",
    "OpenClipConfig",
    "TextEmbedder",
    "VisionEmbedder",
]
