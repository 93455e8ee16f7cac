"""Contrastive training: CLIP softmax-CE and SigLIP sigmoid losses, AdamW,
and a train step over the port's mesh.

Counterpart of ``clip_embedder_tpu.train``: fine-tune or train the same
tower trees the embedders serve (the JAX layout, blocks stacked on axis 0),
then hand them to serving with ``export_trained_model``. The towers run
their trainable forward (``models.vit.ViT(..., trainable=True)``: the
tree's own tensors, the stacked blocks indexed inside the forward) on the
eager attention core, as the JAX train step runs its towers on XLA's; the
CUDA kernels have no backward and refuse operands that require grad.

Layouts (``make_sharded_train_step``) keep one rule: each trained tensor
exists once, as a leaf that the optimizer steps once. Where a data row or a
model rank needs it on another device it gets an autograd-tracked ``.to()``
move, so the backward pass sums the rows' gradients into the leaf, as
GSPMD's all-reduce over the data axis does:

* DP: leaves on the mesh's first device; each data row runs its shard of
  the batch (``parallel.mesh.shard_batch``) on a move of the tree to its
  first device; the embeddings gather to the first device for the loss (or
  stay per row for the ring loss);
* TP: each model rank's shard of a sharded leaf (``parallel.sharding.
  tp_param_specs``) is a leaf on that rank's device of the first data row
  (``sharding.Sharded``), the replicated leaves on the first device; each
  data row runs ``parallel.tensor_parallel``'s TP towers over them;
* FSDP: each leaf with an axis the data rows divide is split along its
  largest such axis into one chunk a row, on the row's first device; a
  row's forward gathers the chunks once (``Sharded.gather``).

A ``Mesh`` is a grid of devices one process owns (entries may repeat), so
every row runs in this process: on a mesh of two entries of one card the
layouts price their overhead, not a gain.

On the card the step is compiled, as the JAX package jits its step with
``donate_argnums=(0, 1)``: ``train_step`` (and the step that
``make_sharded_train_step`` returns) replays one CUDA graph per batch
shape, which holds the forward, the backward and the AdamW update
(``utils.captured``; the optimizer owns the graphs). That holds with no
mesh and on a mesh whose entries are all one card (two ``cuda:0`` entries:
DP, the ring loss, FSDP, TP). A mesh over several distinct cards runs the
step eagerly (``eager_train_step``), a route chosen by the layout:
PyTorch's graph capture does not span devices. The CPU runs it eagerly.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from .errors import DeviceError
from .models import text_transformer, vit
from .models.text_transformer import TextCfgResolved, TextTransformer
from .models.vit import ViT, ViTCfg
from .parallel.mesh import DATA_AXIS, Mesh, shard_batch
from .parallel.sharding import Sharded, tp_param_specs
from .parallel.tensor_parallel import TPTextTransformer, TPViT
from .utils import captured
from .weights import _to_numpy, params_from_numpy, save_pytree, tree_map, validate_tower_pytree

BETAS, EPS = (0.9, 0.999), 1e-8  # optax.adamw's defaults


@dataclass(frozen=True)
class TrainConfig:
    vision_cfg: ViTCfg
    text_cfg: TextCfgResolved
    loss: str = "clip"          # "clip" (softmax CE) | "siglip" (sigmoid)
    learning_rate: float = 1e-4
    weight_decay: float = 0.05
    tensor_parallel: bool = False
    # FSDP/ZeRO-3-style: split each leaf (and its optimizer moments) over
    # the 'data' rows; a row's forward gathers the chunks. For towers whose
    # replicated params + adamw moments don't fit a card. Mutually
    # exclusive with tensor_parallel.
    fsdp: bool = False
    # recompute blocks on backward: activations of one block instead of
    # all (torch.utils.checkpoint; jax.checkpoint in the JAX package)
    remat: bool = False
    # chunked SigLIP loss over the data-axis ring (siglip_ring_loss): the
    # [B, B] global logit matrix never materializes. Only valid with
    # loss="siglip".
    ring_loss: bool = False


def _device(device) -> torch.device:
    """``device`` as a ``torch.device``; ``DeviceError`` without CUDA for
    a CUDA device. Leaves torch's TF32 flags as they are."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceError("CUDA is not available; pass device='cpu' to train on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise DeviceError(f"Unsupported device '{dev}' (cuda or cpu)")
    return dev


def _trainable(tree):
    return tree_map(lambda t: t.requires_grad_(True), tree)


def _leaf(t: torch.Tensor, device) -> torch.Tensor:
    """A new trainable leaf: a contiguous copy of ``t`` on ``device``."""
    return t.detach().to(device, copy=True,
                         memory_format=torch.contiguous_format).requires_grad_(True)


def _whole(t, device=None) -> torch.Tensor:
    """A leaf as one tensor (a ``Sharded`` one gathered on its first part's
    device, or on ``device``)."""
    if isinstance(t, Sharded):
        return t.gather(t.parts[0].device if device is None else device)
    return t if device is None else t.to(device)


def init_train_state(generator: torch.Generator | None, cfg: TrainConfig, *,
                     device: torch.device | str = "cuda", dtype: torch.dtype = torch.float32):
    """Params (both towers + learnable logit scale/bias) as trainable leaf
    tensors on ``device``, in the JAX layout: ``{"visual", "text",
    "logit_scale", "logit_bias"}``, the scale stored as log(1/0.07), the
    bias −10 for SigLIP and 0 otherwise, both f32 whatever ``dtype``.

    Returns ``(params, None)``: the optimizer state comes from
    ``init_opt_state`` or ``make_sharded_train_step``, over the leaves as
    they are placed."""
    dev = _device(device)
    params = {
        "visual": vit.init(cfg.vision_cfg, generator=generator, device=dev, dtype=dtype),
        "text": text_transformer.init(cfg.text_cfg, generator=generator, device=dev,
                                      dtype=dtype),
        "logit_scale": torch.tensor(1.0 / 0.07, dtype=torch.float32, device=dev).log(),
        "logit_bias": torch.tensor(-10.0 if cfg.loss == "siglip" else 0.0,
                                   dtype=torch.float32, device=dev),
    }
    return _trainable(params), None


def train_params_from_numpy(tree, *, device: torch.device | str = "cuda",
                            dtype: torch.dtype = torch.float32) -> dict:
    """A train tree of arrays (numpy, or the JAX package's ``init_train_state``
    params) → trainable leaves on ``device``: the towers in ``dtype`` through
    ``weights.params_from_numpy``, the logit scale and bias in f32."""
    dev = _device(device)
    params = {k: params_from_numpy(tree[k], device=dev, dtype=dtype) for k in ("visual", "text")}
    for k in ("logit_scale", "logit_bias"):
        params[k] = torch.tensor(np.asarray(tree[k], dtype=np.float32), device=dev)
    return _trainable(params)


def train_params_to_numpy(params) -> dict:
    """The train tree as numpy arrays in the JAX layout (shards gathered;
    bf16 as f32)."""
    return tree_map(lambda t: _to_numpy(_whole(t)), params)


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------

def _decay_mask(params):
    """Decay only leaves of two dimensions or more in the JAX layout, as the
    JAX package's mask does. Its docstring says biases and LayerNorm scales
    don't decay, but the blocks' are stacked [layers, D], so they do; only
    the unstacked 1-D leaves (ln_pre, ln_post, ln_final, patch_embed.b) and
    the logit scale and bias don't. A ``Sharded`` leaf keeps its whole
    leaf's dimensions."""
    return tree_map(lambda p: (p.dims() if isinstance(p, Sharded) else p.dim()) >= 2, params)


def _parts(leaf) -> list[torch.Tensor]:
    """The tensors an optimizer steps for one leaf: a ``Sharded`` leaf's
    parts, else the leaf."""
    return leaf.parts if isinstance(leaf, Sharded) else [leaf]


def _stepped(params) -> list[torch.Tensor]:
    """The tensors an optimizer over ``params`` steps, in the tree's order."""
    leaves = []
    tree_map(lambda t: leaves.extend(_parts(t)), params)
    return leaves


def make_optimizer(cfg: TrainConfig, *,
                   capturable: bool | None = None) -> Callable[[dict], torch.optim.AdamW]:
    """``optax.adamw(lr, weight_decay=wd, mask=_decay_mask)`` in torch: a
    function of a param tree that returns ``torch.optim.AdamW`` over its
    leaves in two groups, decayed and not (b1 0.9, b2 0.999, eps 1e-8,
    decoupled decay: p − lr·(m̂/(√v̂ + ε) + wd·p)).

    On the card it is ``capturable`` (its step count on the device, so that
    a CUDA graph can hold the update) and its state is made at once
    (``init_adamw_state``), so that a captured step's first replay is step
    1, as the JAX step's first call is; the card's eager step takes the
    same optimizer, so that the two routes compare bit for bit. The CPU
    keeps the lazy one (``capturable`` is for accelerators).
    ``capturable=False`` makes the lazy one on the card too: the plain
    AdamW the captured step is held to. A state loaded into the optimizer
    takes its flavour (``_follow_params``), so a checkpoint moves between
    the CPU and the card."""
    def tx(params) -> torch.optim.AdamW:
        leaves, mask = [], []
        tree_map(leaves.append, params)
        tree_map(mask.append, _decay_mask(params))
        groups = [{"params": [], "weight_decay": cfg.weight_decay},
                  {"params": [], "weight_decay": 0.0}]
        for leaf, decay in zip(leaves, mask):
            groups[0 if decay else 1]["params"].extend(_parts(leaf))
        card = all(t.is_cuda for t in _stepped(params))
        opt = torch.optim.AdamW([g for g in groups if g["params"]], lr=cfg.learning_rate,
                                betas=BETAS, eps=EPS,
                                capturable=card if capturable is None else capturable)
        opt.register_load_state_dict_post_hook(_follow_params)
        if opt.defaults["capturable"]:
            init_adamw_state(opt)
        return opt

    return tx


def _follow_params(opt: torch.optim.AdamW) -> None:
    """After ``load_state_dict``: the loaded groups' ``capturable``, saved
    with the state by the saving device's optimizer, is set back to this
    optimizer's own, and each step count moved to match (on the params'
    device where capturable, else on the CPU). So a state saved on the card
    resumes on the CPU, and one saved on the CPU in the card's captured
    step; a capturable state saved before its first step is made here, as
    ``make_optimizer`` makes it."""
    capturable = opt.defaults["capturable"]
    for group in opt.param_groups:
        group["capturable"] = capturable
        for p in group["params"]:
            state = opt.state.get(p)
            if state and "step" in state:
                state["step"] = state["step"].to(p.device if capturable else "cpu")
    if capturable:
        init_adamw_state(opt)


def init_adamw_state(opt: torch.optim.AdamW) -> None:
    """Make each parameter's AdamW state now, as the first ``step()`` would
    make it lazily (``torch.optim.Adam._init_group``): the step count 0 (on
    the parameter's device where the optimizer is ``capturable``, else on
    the CPU) and both moments zero. A captured step reads and writes these
    tensors in place; made inside the capture, they would live in the
    graph's pool."""
    scalar = torch.float64 if torch.get_default_dtype() == torch.float64 else torch.float32
    for group in opt.param_groups:
        for p in group["params"]:
            state = opt.state[p]
            if state:
                continue
            state["step"] = (torch.zeros((), dtype=scalar, device=p.device)
                             if group["capturable"] or group["fused"]
                             else torch.tensor(0.0, dtype=scalar))
            state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            state["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)


def init_opt_state(cfg: TrainConfig, params) -> torch.optim.AdamW:
    """Optimizer state for the unsharded ``train_step`` path."""
    return make_optimizer(cfg)(params)


# ---------------------------------------------------------------------------
# the losses
# ---------------------------------------------------------------------------

def clip_loss(img_emb: torch.Tensor, txt_emb: torch.Tensor, scale: torch.Tensor,
              bias: torch.Tensor) -> torch.Tensor:
    """Symmetric InfoNCE over the global batch (CLIP)."""
    logits = img_emb @ txt_emb.T * scale + bias  # [B, B]
    labels = torch.arange(logits.shape[0], device=logits.device)
    li = F.cross_entropy(logits, labels, reduction="none")
    lt = F.cross_entropy(logits.T, labels, reduction="none")
    return (li + lt).mean() * 0.5


def siglip_loss(img_emb: torch.Tensor, txt_emb: torch.Tensor, scale: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    """Pairwise sigmoid loss (SigLIP): positives on the diagonal."""
    logits = img_emb @ txt_emb.T * scale + bias
    n = logits.shape[0]
    signs = 2.0 * torch.eye(n, dtype=logits.dtype, device=logits.device) - 1.0
    return -F.logsigmoid(signs * logits).mean() * n


def siglip_ring_loss(img_emb, txt_emb, scale: torch.Tensor, bias: torch.Tensor, *,
                     mesh: Mesh, axis: str = DATA_AXIS) -> torch.Tensor:
    """Device-chunked sigmoid loss over the mesh's data rows: the SigLIP
    recipe for giant global batches.

    ``img_emb`` / ``txt_emb``: lists of one [b, D] shard a data row, on the
    row's first device (the rows' embeddings, as ``loss_fn`` has them; a
    [B, D] batch is ``list(t.chunk(n))``). Each row keeps its image shard;
    the text shards rotate one row around the ring a hop (an autograd-tracked
    ``.to()`` to the next row's device, which carries the gradient back),
    every row adding its [b, b] block's terms, positives on its diagonal on
    hop 0 only. The sum
    over rows lands on the first row's device and is normalized as the
    dense loss: /(n·b). The [B, B] matrix never exists."""
    if axis != DATA_AXIS:
        raise ValueError(f"the ring runs over the '{DATA_AXIS}' axis, not '{axis}'")
    devices = list(mesh.devices[:, 0])
    n = len(devices)
    imgs, txts = list(img_emb), list(txt_emb)
    b = imgs[0].shape[0]
    scales = [scale.to(d) for d in devices]
    biases = [bias.to(d) for d in devices]
    acc = [torch.zeros((), dtype=torch.float32, device=d) for d in devices]
    for k in range(n):
        for i, d in enumerate(devices):
            logits = imgs[i] @ txts[i].T * scales[i] + biases[i]
            if k == 0:
                signs = 2.0 * torch.eye(b, dtype=logits.dtype, device=d) - 1.0
                logits = signs * logits
            else:
                logits = -logits
            acc[i] = acc[i] - F.logsigmoid(logits).sum()
        if k + 1 < n:  # row i now holds row i-1's text shard
            txts = [txts[i - 1].to(d) for i, d in enumerate(devices)]
    total = acc[0]
    for a in acc[1:]:
        total = total + a.to(devices[0])
    return total / (n * b)


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

def _row_embeddings(params, pixels, ids, cfg: TrainConfig, row, tp: bool):
    """One data row's f32 embeddings of its batch shard, on ``row[0]``:
    the TP towers over the row's devices, or the towers over a move of the
    tree to ``row[0]`` (FSDP chunks gathered there)."""
    if tp:
        vision = TPViT(cfg.vision_cfg, params["visual"], row)
        text = TPTextTransformer(cfg.text_cfg, params["text"], row)
    else:
        def on_row(tree):
            return tree_map(lambda t: _whole(t, row[0]), tree)

        vision = ViT(cfg.vision_cfg, on_row(params["visual"]), trainable=True)
        text = TextTransformer(cfg.text_cfg, on_row(params["text"]), trainable=True)
    img = vision(pixels.to(row[0], torch.float32), remat=cfg.remat)
    txt = text(ids.to(row[0]), remat=cfg.remat)
    return img.float(), txt.float()


def loss_fn(params, batch, cfg: TrainConfig, mesh: Mesh | None = None) -> torch.Tensor:
    """The contrastive loss of ``batch`` ({"pixels": [B, H, W, 3] f32,
    "input_ids": [B, L] int}, numpy or tensors). Without a mesh the batch
    runs on the params' device; with one, each data row runs its shard
    (``make_sharded_train_step``'s layouts). A batch already on the first
    device is read where it lies, with no copy: the captured step's static
    buffers, which a call fills before the replay (a copy from the host is
    no op a CUDA graph holds)."""
    if cfg.ring_loss:
        if cfg.loss != "siglip":
            raise ValueError("ring_loss requires loss='siglip' (softmax CE needs the global "
                             "logit row; the sigmoid loss is the one that chunks exactly)")
        if mesh is None:
            raise ValueError("ring_loss needs the mesh — use make_sharded_train_step")
    if mesh is None:
        home = params["logit_scale"].device
        rows = [[home]]
        pixels = [torch.as_tensor(batch["pixels"]).to(home)]
        ids = [torch.as_tensor(batch["input_ids"]).to(home)]
    else:
        rows = [list(r) for r in mesh.devices]
        pixels = shard_batch(batch["pixels"], mesh)
        ids = shard_batch(batch["input_ids"], mesh)
    tp = cfg.tensor_parallel and mesh is not None
    embs = [_row_embeddings(params, p, i, cfg, row, tp) for p, i, row in zip(pixels, ids, rows)]
    first = rows[0][0]
    scale = params["logit_scale"].to(first).exp()
    bias = params["logit_bias"].to(first)
    if cfg.ring_loss:
        return siglip_ring_loss([e[0] for e in embs], [e[1] for e in embs], scale, bias,
                                mesh=mesh)
    img = torch.cat([e[0].to(first) for e in embs])
    txt = torch.cat([e[1].to(first) for e in embs])
    if cfg.loss == "siglip":
        return siglip_loss(img, txt, scale, bias)
    return clip_loss(img, txt, scale, bias)


def train_step(params, opt_state, batch, *, cfg: TrainConfig, tx, mesh: Mesh | None = None):
    """One step: loss, backward, AdamW. The leaves are stepped in place (the
    JAX step donates its params); ``opt_state`` None starts ``tx(params)``.
    Returns ``(params, opt_state, loss)``, the loss a detached 0-d
    tensor.

    On the card, with no mesh or a mesh of one card, the step replays its
    CUDA graph for the batch's shapes and dtypes (``_captured_step``);
    otherwise it is ``eager_train_step`` (the module docstring)."""
    if opt_state is None:
        opt_state = tx(params)
    devices = [params["logit_scale"].device] if mesh is None else list(mesh.devices.flat)
    if devices[0].type != "cuda" or captured.several_devices(devices):
        return eager_train_step(params, opt_state, batch, cfg=cfg, mesh=mesh)
    return params, opt_state, _captured_step(params, opt_state, batch, cfg, mesh)


def eager_train_step(params, opt_state, batch, *, cfg: TrainConfig, mesh: Mesh | None = None):
    """``train_step`` run eagerly, op by op: the route of the CPU and of a
    mesh over several cards, and the plain route the captured step is held
    to. ``opt_state`` is the optimizer (``tx(params)``)."""
    loss = loss_fn(params, batch, cfg, mesh)
    loss.backward()
    opt_state.step()
    opt_state.zero_grad(set_to_none=True)
    return params, opt_state, loss.detach()


def _state_tensors(params, opt: torch.optim.AdamW) -> list[torch.Tensor]:
    return [t for p in _stepped(params) for t in opt.state[p].values()]


def _captured_step(params, opt, batch, cfg: TrainConfig, mesh: Mesh | None) -> torch.Tensor:
    """The step replayed on the card (``train_step``): the batch copied into
    the graph's static buffers on the first device, the graph of its key
    (the config, the mesh's layout, the batch's shapes and dtypes; captured
    at its first call) replayed, a copy of the loss returned. ``params``
    must be the tree ``opt`` steps: a tree reloaded by ``load_checkpoint``
    takes an optimizer (and so a step) of its own. A graph is captured
    anew where the optimizer's state tensors were replaced
    (``load_state_dict``)."""
    if {id(t) for t in _stepped(params)} != {id(p) for g in opt.param_groups
                                              for p in g["params"]}:
        raise ValueError("train_step: params is not the tree its optimizer steps; a new tree "
                         "(e.g. from load_checkpoint) needs its own optimizer, tx(params)")
    device = params["logit_scale"].device
    batch = {k: torch.as_tensor(batch[k]) for k in ("pixels", "input_ids")}
    layout = None if mesh is None else (mesh.devices.shape, tuple(map(str, mesh.devices.flat)))
    key = (cfg, layout, tuple((k, tuple(t.shape), t.dtype) for k, t in batch.items()))
    graphs = captured.graphs_of(opt, create=True)
    with graphs.lock, torch.cuda.device(device), graphs.in_order(device):
        g = graphs.graphs.get(key)
        state = _state_tensors(params, opt)
        if g is None or len(g.state) != len(state) or any(
                a is not b for a, b in zip(g.state, state)):
            g = graphs.graphs[key] = _capture_step(graphs, params, opt, batch, cfg, mesh,
                                                   device)
        for static, t in zip(g.inputs, batch.values()):
            static.copy_(t)
        g.replay()
        return g.output[0].clone()


def _capture_step(graphs, params, opt, batch, cfg, mesh, device):
    """Capture the step over static copies of ``batch`` on ``device``: the
    warm-up runs the forward and the backward alone (never ``opt.step()``,
    which would update the params; AdamW's kernels load inside the capture,
    as CUDA loads modules lazily there too); the graph then holds the
    forward, the backward (remat's recompute included) and ``opt.step()``.
    The gradients are None when the capture begins, so the backward makes
    them in the graph's pool; the graph keeps them, and the leaves'
    ``.grad`` is None after each call, as the eager step leaves it."""
    static = {k: t.to(device, copy=True) for k, t in batch.items()}

    def forward_backward():
        loss = loss_fn(params, static, cfg, mesh)
        loss.backward()
        return loss

    def warmup():
        forward_backward()
        opt.zero_grad(set_to_none=True)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = forward_backward()
        opt.step()
        return loss.detach(), [p.grad for p in _stepped(params)]

    g = graphs.capture(step, device, list(static.values()), what="the train step",
                       warmup=warmup)
    opt.zero_grad(set_to_none=True)
    g.state = _state_tensors(params, opt)
    return g


def _fsdp_axis(p: torch.Tensor, n: int) -> int | None:
    """The axis FSDP splits ``p`` along over ``n`` data rows: its largest
    axis that ``n`` divides; None (replicated) below two dimensions or
    without one."""
    if p.dim() < 2:
        return None
    for axis in sorted(range(p.dim()), key=lambda a: -p.shape[a]):
        if p.shape[axis] % n == 0 and p.shape[axis] >= n:
            return axis
    return None


def _place_tp(tree, specs, devices):
    """Leaves of a TP layout: each sharded leaf's parts on the model ranks'
    devices, each replicated one on the first."""
    if isinstance(tree, dict):
        return {k: _place_tp(v, specs[k], devices) for k, v in tree.items()}
    if specs.dim is None:
        return _leaf(tree, devices[0])
    parts = tree.chunk(len(devices), dim=specs.dim)
    return Sharded([_leaf(p, d) for p, d in zip(parts, devices)], specs.dim)


def make_sharded_train_step(cfg: TrainConfig, mesh: Mesh, params):
    """Place ``params`` on the mesh (DP, TP or FSDP, the module docstring's
    layouts: new leaves, the given tree is left as it is) and return
    ``(step, placed_params, opt_state)``: ``step(params, opt_state, batch)``
    is ``train_step`` over the mesh, the batch split over the data rows."""
    if cfg.tensor_parallel and cfg.fsdp:
        raise ValueError("tensor_parallel and fsdp are mutually exclusive")
    first = mesh.devices[0, 0]
    rest = {k: _leaf(params[k], first) for k in ("logit_scale", "logit_bias")}
    if cfg.tensor_parallel:
        row = list(mesh.devices[0])
        towers = {k: _place_tp(params[k], tp_param_specs(params[k], tower=tower), row)
                  for k, tower in (("visual", "vit"), ("text", "text"))}
    elif cfg.fsdp:
        rows = list(mesh.devices[:, 0])

        def place(t):
            axis = _fsdp_axis(t, len(rows))
            if axis is None:
                return _leaf(t, first)
            return Sharded([_leaf(c, d) for c, d in zip(t.chunk(len(rows), dim=axis), rows)],
                           axis)

        towers = {k: tree_map(place, params[k]) for k in ("visual", "text")}
    else:
        towers = {k: tree_map(lambda t: _leaf(t, first), params[k]) for k in ("visual", "text")}
    placed = {**towers, **rest}
    tx = make_optimizer(cfg)
    opt_state = tx(placed)

    def step(params, opt_state, batch):
        return train_step(params, opt_state, batch, cfg=cfg, tx=tx, mesh=mesh)

    return step, placed, opt_state


# ---------------------------------------------------------------------------
# checkpoint / resume
# ---------------------------------------------------------------------------

CHECKPOINT_FILE = "train_state.pt"


def save_checkpoint(path, params, opt_state=None, *, step: int = 0) -> None:
    """Persist train state under ``path/step_{step}`` (the JAX package's
    directory layout) as one ``torch.save`` of ``{"params", "opt_state",
    "step"}``: the port's own format, not orbax's. The params are saved in
    the JAX layout (shards gathered, on the CPU), so any layout resumes
    from them; the optimizer state is the optimizer's ``state_dict()``, its
    moments per stepped tensor, so it resumes in the layout that saved
    it."""
    d = Path(path).absolute() / f"step_{step}"
    d.mkdir(parents=True, exist_ok=True)
    state = {"params": tree_map(lambda t: _whole(t).detach().cpu(), params), "step": step}
    if opt_state is not None:
        state["opt_state"] = opt_state.state_dict()
    torch.save(state, d / CHECKPOINT_FILE)


def load_checkpoint(path, *, step: int, device: torch.device | str = "cuda") -> dict:
    """Restore what ``save_checkpoint`` wrote: ``{"params": trainable leaves
    on ``device``, "step", "opt_state"}`` (the last where it was saved; hand
    it to ``init_opt_state(cfg, params).load_state_dict``)."""
    dev = _device(device)
    state = torch.load(Path(path).absolute() / f"step_{step}" / CHECKPOINT_FILE,
                       map_location="cpu", weights_only=True)
    state["params"] = _trainable(tree_map(lambda t: t.to(dev), state["params"]))
    return state


def export_trained_model(model_dir, params) -> None:
    """Write trained tower params into a model dir's native weight files so
    the inference embedders serve them (training → serving handoff); shards
    are gathered first.

    When the dir already carries an ``open_clip_config.json``, the trained
    trees are validated against the architecture it resolves — an export
    whose config doesn't describe the weights (e.g. a non-default mlp_ratio
    the JSON omits) fails HERE as a typed WeightError instead of producing
    a dir that every later load rejects."""
    from .config import OpenClipConfig
    from .models.build import resolve_text, resolve_vision

    model_dir = Path(model_dir)
    trees = {k: tree_map(lambda t: _whole(t).detach(), params[k]) for k in ("visual", "text")}
    occ = model_dir / "open_clip_config.json"
    if occ.is_file():
        cfg = OpenClipConfig.from_file(occ)
        validate_tower_pytree(trees["visual"], resolve_vision(cfg.model_cfg),
                              source="trained visual params vs open_clip_config.json")
        validate_tower_pytree(trees["text"], resolve_text(cfg.model_cfg),
                              source="trained text params vs open_clip_config.json")
    save_pytree(model_dir / "visual.npz", trees["visual"])
    save_pytree(model_dir / "text.npz", trees["text"])
