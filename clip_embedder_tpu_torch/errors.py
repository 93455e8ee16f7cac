"""Typed exception hierarchy for the framework.

Mirrors the error surface of the reference's ``ClipError`` enum
(reference: src/error.rs:8-41) — every failure mode a caller could match on
there has a corresponding exception type here. Unlike the Rust enum, these are
Python exceptions arranged under a single base class so ``except ClipError``
catches everything the framework raises.
"""

from __future__ import annotations

from pathlib import Path


class ClipError(Exception):
    """Base class for all framework errors (reference: src/error.rs:8)."""


class IoError(ClipError):
    """Filesystem-level failure (reference: src/error.rs:10-11)."""


class JsonError(ClipError):
    """Malformed JSON in a config file (reference: src/error.rs:12-13)."""


class ImageError(ClipError):
    """Image decode/convert failure (reference: src/error.rs:16-17)."""


class TokenizerError(ClipError):
    """Tokenizer load or encode failure (reference: src/error.rs:18-19)."""


class ConfigError(ClipError):
    """Invalid or missing configuration value (reference: src/error.rs:20-21)."""


class InferenceError(ClipError):
    """Runtime failure in the compute path (reference: src/error.rs:22-23)."""


class ShapeError(ClipError):
    """Tensor shape mismatch (reference: src/error.rs:24-25)."""


class ModelFolderNotFoundError(ClipError):
    """Model directory does not exist (reference: src/error.rs:26-27)."""

    def __init__(self, model_dir: Path | str):
        self.model_dir = Path(model_dir)
        super().__init__(
            f"Model folder not found, generate it with `python pull_weights.py -h`. "
            f"'{self.model_dir}'"
        )


class HfHubError(ClipError):
    """HuggingFace Hub download failure (reference: src/error.rs:28-30)."""


class MissingModelFileError(ClipError):
    """A required file from the model-dir contract is absent
    (reference: src/error.rs:31-32)."""

    def __init__(self, model_dir: Path | str, file: str):
        self.model_dir = Path(model_dir)
        self.file = file
        super().__init__(
            f"Missing model file '{file}' in folder '{self.model_dir}'"
        )


class ResizeError(ClipError):
    """Image resize failure (reference: src/error.rs:35-40)."""


class WeightError(ClipError):
    """Weight ingestion / conversion failure.

    New to this framework: raised when an ONNX graph or safetensors checkpoint
    cannot be mapped onto a known architecture's parameter tree. The reference
    has no analog because ONNX Runtime owns its own weights.
    """


class DeviceError(ClipError):
    """Device/mesh selection failure.

    Analog of the reference's execution-provider fallback errors
    (reference: src/lib.rs:90-93): raised when a requested device is
    unavailable (e.g. ``device="cuda"`` on a machine without CUDA).
    """
