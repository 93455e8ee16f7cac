"""Model acquisition, cache layout, and the model-dir contract.

Mirrors the reference's model manager (reference: src/model_manager.rs:8-68):
the same 9-file directory contract produced by the exporter, the same default
cache location ``~/.cache/open_clip_rs`` (so dirs exported for the reference
work here unchanged), HF-hub download of all contract files, and strict
directory validation with typed errors.

Extension over the reference: the towers run native weights (``visual.npz``
/ ``text.npz``, written by the converters, or converted from the ONNX graphs
on first load; a graph no native family fits runs on ``onnx_exec``), and a
dir that carries *only* the native weights (no ONNX) is also accepted. The
contract check therefore requires the config/tokenizer files plus, per
tower, either the ONNX file or the converted native file.
"""

from __future__ import annotations

import os
from pathlib import Path

from .errors import HfHubError, MissingModelFileError, ModelFolderNotFoundError

# The reference's full download list (reference: src/model_manager.rs:8-18).
MODEL_FILES: tuple[str, ...] = (
    "model_config.json",
    "open_clip_config.json",
    "special_tokens_map.json",
    "text.onnx",
    "tokenizer.json",
    "tokenizer_config.json",
    "visual.onnx",
    "text.onnx.data",
    "visual.onnx.data",
)

# Files every valid dir must have regardless of weight format.
REQUIRED_CONFIG_FILES: tuple[str, ...] = (
    "model_config.json",
    "open_clip_config.json",
    "tokenizer.json",
)

# Native weight files (the npz contract of weights.save_pytree).
NATIVE_VISUAL = "visual.npz"
NATIVE_TEXT = "text.npz"


def get_default_base_folder() -> Path:
    """Default model cache, shared with the reference and its exporter
    (reference: src/model_manager.rs:44-49, pull_onnx.py:307)."""
    override = os.environ.get("CLIP_TPU_CACHE")
    if override:
        return Path(override)
    home = Path.home()
    if str(home) in ("", "/"):  # no usable home dir
        return Path(".open_clip_cache")
    return home / ".cache" / "open_clip_rs"


def _tower_weights_present(model_dir: Path, onnx_name: str, native_name: str) -> bool:
    return (model_dir / onnx_name).is_file() or (model_dir / native_name).is_file()


def verify_model_dir(model_dir: Path | str) -> None:
    """Validate a model dir against the contract
    (reference: src/model_manager.rs:52-68).

    Raises ``ModelFolderNotFoundError`` or ``MissingModelFileError`` exactly
    as the reference does, but accepts native-weight dirs as well as ONNX
    dirs (see module docstring).
    """
    model_dir = Path(model_dir)
    if not model_dir.exists():
        raise ModelFolderNotFoundError(model_dir)

    for file in REQUIRED_CONFIG_FILES:
        if not (model_dir / file).is_file():
            raise MissingModelFileError(model_dir, file)

    if not _tower_weights_present(model_dir, "visual.onnx", NATIVE_VISUAL):
        raise MissingModelFileError(model_dir, "visual.onnx")
    if not _tower_weights_present(model_dir, "text.onnx", NATIVE_TEXT):
        raise MissingModelFileError(model_dir, "text.onnx")


def get_hf_model(model_id: str, *, base_folder: Path | str | None = None) -> Path:
    """Ensure the model files for ``model_id`` are present locally, downloading
    from HuggingFace Hub if needed (reference: src/model_manager.rs:22-40).

    Unlike the reference (which hard-fails if any of the 9 files is absent in
    the repo, including ``*.onnx.data``), optional files that the repo does
    not carry are skipped — small models have no external-data files.
    Returns the local model directory.
    """
    base = Path(base_folder) if base_folder else get_default_base_folder()
    local_dir = base / model_id
    try:
        verify_model_dir(local_dir)
        return local_dir
    except (ModelFolderNotFoundError, MissingModelFileError):
        pass

    try:
        from huggingface_hub import hf_hub_download  # deferred import
    except ImportError as e:
        raise HfHubError(
            f"huggingface_hub is unavailable and '{local_dir}' is not a valid "
            f"model dir; convert a model locally with pull_weights.py"
        ) from e

    local_dir.mkdir(parents=True, exist_ok=True)
    errors: list[str] = []
    for file in MODEL_FILES:
        try:
            hf_hub_download(
                repo_id=model_id, filename=file, local_dir=str(local_dir)
            )
        except Exception as e:  # noqa: BLE001 — collect and report below
            errors.append(f"{file}: {type(e).__name__}")

    try:
        verify_model_dir(local_dir)
    except (ModelFolderNotFoundError, MissingModelFileError) as e:
        detail = "; ".join(errors) if errors else "unknown"
        raise HfHubError(
            f"Hugging Face Hub error: could not fetch a complete model dir for "
            f"'{model_id}' ({detail})"
        ) from e
    return local_dir
