"""Convert an open_clip checkpoint into a native model dir (the offline
half of the repository's ``pull_weights.py``, kept here so the port needs
neither the JAX package nor the network).

The model dir is the same contract both packages load
(``open_clip_config.json``, ``model_config.json``, tokenizer files, native
``visual.npz`` / ``text.npz``). Given a dir that already holds the
checkpoint's ``open_clip_config.json`` and tokenizer files, and the
checkpoint itself::

    from clip_embedder_tpu_torch.pull_weights import (
        convert_checkpoint, derive_model_config, load_checkpoint,
        write_model_readme)

    sd = load_checkpoint(ckpt_path)           # .bin (torch.save) or .safetensors
    occ = json.loads((model_dir / "open_clip_config.json").read_text())
    (model_dir / "model_config.json").write_text(
        json.dumps(derive_model_config(repo_id, occ, sd), indent=2))
    convert_checkpoint(model_dir, sd)          # visual.npz + text.npz
    write_model_readme(model_dir, repo_id)

A reference-format ONNX dir (``visual.onnx`` / ``text.onnx`` with its
configs) converts in place, through the same derivations and self-checks
as ``Clip.from_local_dir``::

    python -m clip_embedder_tpu_torch.pull_weights --dir MODEL_DIR [--device cpu]

Fetching a repo from the hub and an HF text tower's ``config.json`` are not
part of the port (each needs the network).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

CONFIG_FILES = (
    "open_clip_config.json",
    "tokenizer.json",
    "tokenizer_config.json",
    "special_tokens_map.json",
    # carried over from the source repo, as the reference exporter does
    # (reference: pull_onnx.py:43-50); the model card is rewritten with the
    # usage header below, keeping its frontmatter and content
    "README.md",
    ".gitattributes",
)
CHECKPOINT_CANDIDATES = (
    "open_clip_model.safetensors",
    "open_clip_pytorch_model.safetensors",
    "open_clip_pytorch_model.bin",
    "model.safetensors",
    "pytorch_model.bin",
)


def load_checkpoint(path: Path) -> dict[str, np.ndarray]:
    """A checkpoint file → its state dict as numpy arrays (f32 and f16
    checkpoints, as open_clip publishes them)."""
    path = Path(path)
    if path.suffix == ".safetensors":
        from safetensors.numpy import load_file

        return load_file(str(path))
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: v.numpy() for k, v in sd.items()}


def derive_model_config(repo_id: str, open_clip_config: dict,
                        sd: dict[str, np.ndarray]) -> dict:
    """Scoring metadata from the checkpoint, the reference exporter's
    get_model_config (reference: pull_onnx.py:128-150): SigLIP detection
    (repo name or init_logit_bias), the exp'd logit scale, the sigmoid or
    softmax head, lowercasing, and the SigLIP-v1 pad-id quirk."""
    model_cfg = open_clip_config.get("model_cfg", {})
    is_siglip = "siglip" in repo_id.lower() or "init_logit_bias" in model_cfg
    is_siglip2 = "siglip2" in repo_id.lower()

    logit_scale = float(np.exp(np.asarray(sd.get("logit_scale", 0.0)).item()))
    logit_bias = float(np.asarray(sd.get("logit_bias", 0.0)).item()) if "logit_bias" in sd \
        else 0.0

    vocab_size = None
    for key in ("token_embedding.weight", "text.token_embedding.weight"):
        if key in sd:
            vocab_size = int(sd[key].shape[0])
            break
    if vocab_size is None:
        vocab_size = model_cfg.get("text_cfg", {}).get("vocab_size")

    return {
        "logit_scale": logit_scale,
        "logit_bias": logit_bias,
        "activation_function": "sigmoid" if is_siglip else "softmax",
        "tokenizer_needs_lowercase": is_siglip,
        "pad_id": 1 if (is_siglip and not is_siglip2) else 0,
        "vocab_size": vocab_size,
    }


def convert_checkpoint(model_dir: Path, sd: dict[str, np.ndarray]) -> None:
    """Map a whole open_clip state dict into ``visual.npz`` / ``text.npz``
    under ``model_dir``, which holds its ``open_clip_config.json``. Both
    mapped trees are checked against the architecture that config resolves
    to before anything is written: a checkpoint paired with the wrong
    config raises WeightError here, naming the paths, not at first load."""
    from .config import OpenClipConfig
    from .models.build import resolve_text, resolve_vision
    from .vision import derive_vision_dims_from_sd
    from .weights import map_state_dict, save_pytree, validate_tower_pytree

    model_dir = Path(model_dir)
    cfg = OpenClipConfig.from_file(model_dir / "open_clip_config.json")
    visual_sd = {k: v for k, v in sd.items() if k.startswith("visual.")}
    text_sd = {k: v for k, v in sd.items()
               if not k.startswith("visual.") and k not in ("logit_scale", "logit_bias")}
    # the checkpoint, not the size table, fixes PE-Core's dims
    derive_vision_dims_from_sd(model_dir, cfg, visual_sd)
    vspec = resolve_vision(cfg.model_cfg)
    tspec = resolve_text(cfg.model_cfg)
    vparams = map_state_dict(visual_sd, tower="visual", family=vspec.family)
    tparams = map_state_dict(text_sd, tower="text", family=tspec.family)
    validate_tower_pytree(vparams, vspec, source="mapped checkpoint (visual)")
    validate_tower_pytree(tparams, tspec, source="mapped checkpoint (text)")
    save_pytree(model_dir / "visual.npz", vparams)
    save_pytree(model_dir / "text.npz", tparams)


def convert_onnx_dir(model_dir: Path, *, device="cuda") -> None:
    """Convert a reference-style ONNX model dir's weights in place into
    ``visual.npz`` / ``text.npz``, taking the derivations
    ``Clip.from_local_dir`` takes (graph-derived vision dims, a BERT
    ``hf_config``, the MCT hybrid text tower; each persisted into
    open_clip_config.json), so both routes write the same dir. Each tower
    is self-checked against the graph executor on ``device``; a graph that
    no native family fits raises ``WeightError`` (``from_local_dir`` would
    serve it through the executor instead)."""
    from .config import OpenClipConfig
    from .errors import ConfigError, WeightError
    from .models.build import resolve_text, resolve_vision
    from .onnx_reader import extract_tower_params
    from .text import maybe_derive_hf_config, maybe_native_hybrid
    from .vision import maybe_derive_vision_dims, resolve_device
    from .weights import save_pytree

    model_dir = Path(model_dir)
    dev = resolve_device(device)
    cfg = OpenClipConfig.from_file(model_dir / "open_clip_config.json")
    maybe_derive_hf_config(model_dir, cfg)
    maybe_derive_vision_dims(model_dir, cfg)
    vparams = extract_tower_params(model_dir / "visual.onnx", resolve_vision(cfg.model_cfg),
                                   tower="visual", device=dev)
    try:
        tparams = extract_tower_params(model_dir / "text.onnx", resolve_text(cfg.model_cfg),
                                       tower="text", device=dev)
    except (ConfigError, WeightError):
        hybrid = maybe_native_hybrid(model_dir, model_dir / "text.onnx", dev)
        if hybrid is None:
            raise
        tparams = hybrid[1]
    save_pytree(model_dir / "visual.npz", vparams)
    save_pytree(model_dir / "text.npz", tparams)


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(
        description="Convert a reference-format ONNX model dir in place to native weights.")
    parser.add_argument("--dir", type=Path, required=True,
                        help="existing ONNX model dir to convert in place")
    parser.add_argument("--device", default="cuda",
                        help="where the conversion's self-check runs (default: cuda)")
    args = parser.parse_args(argv)
    convert_onnx_dir(args.dir, device=args.device)
    print(f"Converted ONNX weights in {args.dir}")


def _usage_header(model_dir: Path, repo_id: str) -> str:
    name = repo_id.split("/", 1)[-1]
    return f"""# {name} — clip_embedder_tpu model dir

Converted from [`{repo_id}`](https://huggingface.co/{repo_id}) by
`clip_embedder_tpu_torch.pull_weights`. Serve it with the PyTorch/CUDA
package:

```python
from clip_embedder_tpu_torch import Clip

clip = Clip.from_local_dir("{model_dir}")  # on the card; device="cpu" for the CPU
results = clip.classify("cat.jpg", [
    "A photo of a cat",
    "A photo of a dog",
    "A photo of a beignet",
])
for label, prob in results:
    print(f"{{label}}: {{prob*100:.1f}}%")
```

Contents follow the reference model-dir contract
(`open_clip_config.json`, `model_config.json`, `tokenizer.json`, …) plus
native `visual.npz`/`text.npz` weight trees.

---
"""


def write_model_readme(model_dir: Path, repo_id: str) -> None:
    """Write or rewrite the model dir's README (the reference exporter's
    _modify_readme, reference: pull_onnx.py:184-248): keep the upstream
    card's YAML frontmatter (minus ``library_name:``) and body, with the
    usage header between them; with no upstream card, the header alone."""
    model_dir = Path(model_dir)
    readme = model_dir / "README.md"
    header = _usage_header(model_dir, repo_id)
    if not readme.is_file():
        readme.write_text(header)
        return
    content = readme.read_text(encoding="utf-8")
    if "— clip_embedder_tpu model dir" in content:
        return  # already rewritten: a second header would stack on the card
    if content.startswith("---"):
        parts = content.split("---", 2)
        if len(parts) >= 3:
            frontmatter = "\n".join(
                line for line in parts[1].splitlines()
                if not line.strip().startswith("library_name:")).strip("\n")
            readme.write_text(f"---\n{frontmatter}\n---\n\n{header}\n{parts[2].lstrip()}")
            return
    readme.write_text(header + "\n" + content)


if __name__ == "__main__":
    main()
