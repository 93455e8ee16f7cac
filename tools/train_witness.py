"""Training losses of one seeded ViT-SO400M-16-SigLIP2-384 tree at two
learning rates, through the torch port and through the JAX package.

chip_smoke.py phase 13 trains at lr 1e-5: at TrainConfig's default 1e-4 the
loss of its random full-depth towers rises and falls from step to step on
its one batch. This script asks whether that is AdamW on random weights or
a fault of the port: it trains the same tree (SO400M at full width, its
depth and vocabulary cut by ``--layers`` / ``--vocab``) on phase 13's
seeded batch of 16 (f32, SigLIP loss, remat) for ``--steps`` steps at each
learning rate, from the same initial state, in either package:

    python tools/train_witness.py port --device cpu --out DIR --save-init
    python tools/train_witness.py port --device cuda --out DIR
    JAX_PLATFORMS=cpu python tools/train_witness.py jax --out DIR

Each mode imports one package. The port mode initializes on the CPU from a
seeded ``torch.Generator``, so every machine starts from the same tree
(its SHA-256 is printed and recorded); ``--save-init`` writes it and the
configuration into DIR for the jax mode, which reads them. Each mode
prints its losses and writes them to DIR/<mode>_<device>.json.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

LEARNING_RATES = (1e-4, 1e-5)


def batch(vision: dict, text: dict, n: int = 16) -> dict:
    """chip_smoke.py phase 13's batch: pixels and ids from default_rng(0)."""
    rng = np.random.default_rng(0)
    size = vision["image_size"]
    return {"pixels": rng.uniform(-1, 1, (n, size, size, 3)).astype(np.float32),
            "input_ids": rng.integers(1, text["vocab_size"], (n, text["context_length"]))
            .astype(np.int32)}


def digest(flat: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(flat):
        h.update(k.encode())
        h.update(np.ascontiguousarray(flat[k], dtype=np.float32).tobytes())
    return h.hexdigest()


def unflatten(flat: dict) -> dict:
    tree: dict = {}
    for key, val in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = val
    return tree


def run_port(args) -> dict:
    import torch

    from chip_smoke import nvidia_smi, so400m_train_config
    from clip_embedder_tpu_torch import train as tt
    from clip_embedder_tpu_torch.weights import _flatten, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, _ = so400m_train_config(layers=args.layers, vocab_size=args.vocab)
    params, _ = tt.init_train_state(torch.Generator().manual_seed(0), cfg, device="cpu")
    init = tree_map(lambda p: p.detach().numpy().copy(), params)
    del params
    flat = _flatten(init)
    vision, text = dataclasses.asdict(cfg.vision_cfg), dataclasses.asdict(cfg.text_cfg)
    if args.save_init:
        np.savez(args.out / "init.npz", **flat)
        (args.out / "cfg.json").write_text(json.dumps({"vision": vision, "text": text}))
    data = batch(vision, text)
    card = args.device == "cuda"
    out = {"package": "port", "device": nvidia_smi() if card else "cpu",
           "init_sha256": digest(flat), "losses": {}, "s_per_step": {}}
    for lr in LEARNING_RATES:
        run_cfg = dataclasses.replace(cfg, learning_rate=lr)
        params = tt.train_params_from_numpy(init, device=args.device)
        opt, tx = tt.init_opt_state(run_cfg, params), tt.make_optimizer(run_cfg)
        losses, t = [], time.perf_counter()
        for _ in range(args.steps):
            params, opt, loss = tt.train_step(params, opt, data, cfg=run_cfg, tx=tx)
            losses.append(float(loss))
        out["losses"][str(lr)] = losses
        out["s_per_step"][str(lr)] = (time.perf_counter() - t) / args.steps
        del params, opt
        if card:
            torch.cuda.empty_cache()
    return out


def run_jax(args) -> dict:
    from functools import partial

    import jax
    import jax.numpy as jnp

    from clip_embedder_tpu import train as jt
    from clip_embedder_tpu.models.text_transformer import TextCfgResolved
    from clip_embedder_tpu.models.vit import ViTCfg

    cfgs = json.loads((args.out / "cfg.json").read_text())
    with np.load(args.out / "init.npz") as z:
        flat = {k: z[k] for k in z.files}
    tree = unflatten(flat)
    data = {k: jnp.asarray(v) for k, v in batch(cfgs["vision"], cfgs["text"]).items()}
    cfg = jt.TrainConfig(vision_cfg=ViTCfg(**cfgs["vision"]),
                         text_cfg=TextCfgResolved(**cfgs["text"]), loss="siglip", remat=True)
    out = {"package": "jax", "device": str(jax.devices()[0].platform),
           "init_sha256": digest(flat), "losses": {}, "s_per_step": {}}
    for lr in LEARNING_RATES:
        run_cfg = dataclasses.replace(cfg, learning_rate=lr)
        tx = jt.make_optimizer(run_cfg)
        step = jax.jit(partial(jt.train_step, cfg=run_cfg, tx=tx))
        params = jax.tree.map(jnp.asarray, tree)
        state = jt.init_opt_state(run_cfg, params)
        losses, t = [], time.perf_counter()
        for _ in range(args.steps):
            params, state, loss = step(params, state, data)
            losses.append(float(loss))
        out["losses"][str(lr)] = losses
        out["s_per_step"][str(lr)] = (time.perf_counter() - t) / args.steps
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("port", "jax"))
    ap.add_argument("--device", default="cuda", help="the port's device (cuda or cpu)")
    ap.add_argument("--out", type=Path, required=True)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--vocab", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--save-init", action="store_true")
    args = ap.parse_args(argv)
    args.out.mkdir(parents=True, exist_ok=True)
    out = run_port(args) if args.mode == "port" else run_jax(args)
    out.update(layers=args.layers, vocab=args.vocab, steps=args.steps)
    name = f"{args.mode}_{args.device if args.mode == 'port' else 'cpu'}.json"
    (args.out / name).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.exit(main(sys.argv[1:]))
