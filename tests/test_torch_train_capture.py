"""The graph-ready train step and the tensor-parallel forward on the CPU (no
JAX here; ``tests/test_torch_train.py`` holds the step to the JAX package).

On the card ``train.train_step`` replays a CUDA graph of the forward, the
backward and the AdamW update, and a tensor-parallel mesh row on one card
replays its ``TPViT``'s graph (``utils.captured``). The CPU runs both
eagerly. Here, at the golden_siglip fixture's dims:

* AdamW with its state made up front (``train.init_adamw_state``, what the
  card's optimizer does before its capture) steps as the lazy one does;
* what the card captures reads nothing on the host
  (``captured.HostReadGuard``): the step's forward and backward in every
  layout, remat included, and the ``TPViT`` forward;
* the TP embedder's rows through ``captured.forward`` equal the eager
  ``TPViT``'s, and on the CPU neither path makes a ``GraphSet``;
* the route's choice by layout (``captured.several_devices``) and the
  refusal of a params tree that its optimizer does not step;
* a state saved by the card's capturable optimizer resumes on the CPU, and
  PE-Core's shared rope tables, first made under ``inference_mode`` by a
  served tower, serve a trainable tower's backward.

``tests/test_torch_cuda.py`` holds the captured routes against the eager
ones on the card, and ``chip_smoke.py`` phases 12 and 13 at full size.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from clip_embedder_tpu_torch import Clip
from clip_embedder_tpu_torch import train as tt
from clip_embedder_tpu_torch.config import OpenClipConfig
from clip_embedder_tpu_torch.models.build import resolve_text, resolve_vision
from clip_embedder_tpu_torch.parallel import ShardedVisionEmbedder, get_mesh
from clip_embedder_tpu_torch.parallel.tensor_parallel import TPViT, tower_tree
from clip_embedder_tpu_torch.utils import captured
from clip_embedder_tpu_torch.weights import _flatten, tree_map

FIXTURE = Path(__file__).parent / "fixtures" / "golden_siglip"


@pytest.fixture(autouse=True)
def one_thread():
    """Small towers: one intra-op thread (``tests/test_torch_capture.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(**kw) -> tt.TrainConfig:
    """The golden_siglip fixture's towers as a SigLIP ``TrainConfig``."""
    occ = OpenClipConfig.from_dict(json.loads((FIXTURE / "open_clip_config.json").read_text()))
    return tt.TrainConfig(vision_cfg=resolve_vision(occ.model_cfg).cfg,
                          text_cfg=resolve_text(occ.model_cfg).cfg, loss="siglip",
                          learning_rate=1e-3, **kw)


def _batch(cfg, seed, b=4) -> dict:
    rng = np.random.default_rng(seed)
    v, t = cfg.vision_cfg, cfg.text_cfg
    return {"pixels": torch.from_numpy(rng.uniform(-1, 1, (b, v.image_size, v.image_size, 3))
                                       .astype(np.float32)),
            "input_ids": torch.from_numpy(rng.integers(1, t.vocab_size, (b, t.context_length))
                                          .astype(np.int32))}


def _params(cfg, seed=0):
    params, _ = tt.init_train_state(torch.Generator().manual_seed(seed), cfg, device="cpu")
    return params


def test_adamw_state_made_up_front_steps_as_the_lazy_adamw():
    """3 steps from one state: the optimizer whose state ``init_adamw_state``
    made before the first step gives the lazy ``torch.optim.AdamW``'s params
    and moments bit for bit."""
    cfg = _cfg(weight_decay=0.1)
    lazy_p, eager_p = _params(cfg), tree_map(lambda t: t.detach().clone().requires_grad_(True),
                                             _params(cfg))
    lazy, early = tt.make_optimizer(cfg)(lazy_p), tt.make_optimizer(cfg)(eager_p)
    assert not lazy.state and not early.param_groups[0]["capturable"]
    tt.init_adamw_state(early)
    assert all(set(early.state[p]) == {"step", "exp_avg", "exp_avg_sq"} and
               float(early.state[p]["step"]) == 0 for g in early.param_groups for p in g["params"])
    for seed in range(3):
        batch = _batch(cfg, seed)
        for params, opt in ((lazy_p, lazy), (eager_p, early)):
            tt.eager_train_step(params, opt, batch, cfg=cfg)
    for k, t in _flatten(lazy_p).items():
        assert torch.equal(_flatten(eager_p)[k], t), k
    for p, q in zip(tt._stepped(lazy_p), tt._stepped(eager_p)):
        for name in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(lazy.state[p][name], early.state[q][name]), name


def test_a_state_saved_by_a_capturable_optimizer_resumes_on_the_cpu():
    """The card's optimizer saves its groups ``capturable``; loaded into the
    CPU's optimizer they take its own flag back (torch's CPU AdamW refuses
    a capturable group), and the resumed step is the uninterrupted one's,
    bit for bit. ``tests/test_torch_cuda.py`` resumes across the two
    devices through ``save_checkpoint`` / ``load_checkpoint``."""
    import copy

    cfg = _cfg(weight_decay=0.1)
    params = _params(cfg)
    opt = tt.init_opt_state(cfg, params)
    tt.eager_train_step(params, opt, _batch(cfg, 10), cfg=cfg)
    saved = copy.deepcopy(opt.state_dict())
    for group in saved["param_groups"]:
        group["capturable"] = True  # as the card's optimizer saves it
    resumed = tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
    ropt = tt.init_opt_state(cfg, resumed)
    ropt.load_state_dict(saved)
    assert not any(g["capturable"] for g in ropt.param_groups)
    for tree, o in ((params, opt), (resumed, ropt)):
        tt.eager_train_step(tree, o, _batch(cfg, 11), cfg=cfg)
    assert all(torch.equal(a, b) for a, b in zip(tt._stepped(params), tt._stepped(resumed)))
    assert all(float(s["step"]) == 2 and s["step"].device.type == "cpu"
               for s in ropt.state.values())


def test_rope_tables_made_while_serving_serve_a_backward_after():
    """PE-Core's rope tables are shared by every tower of a config and
    device (``vit._rope_tables``): a first call under ``inference_mode``
    (serving, a graph's warm-up) makes them as plain tensors, so a
    trainable tower of the same config then trains on them."""
    import dataclasses

    from clip_embedder_tpu_torch.models import vit

    base = _cfg()
    vcfg = vit.ViTCfg(image_size=32, patch_size=8, width=64, layers=1, heads=2, mlp_hidden=128,
                      embed_dim=base.vision_cfg.embed_dim, rope_2d=True, pool="map",
                      pool_heads=2, pool_mlp_hidden=128)
    cfg = dataclasses.replace(base, vision_cfg=vcfg)
    vit._rope_tables.cache_clear()
    params = _params(cfg)
    served = vit.ViT(vcfg, tree_map(lambda t: t.detach(), params["visual"]))
    with torch.inference_mode():
        served(_batch(cfg, 12)["pixels"], attn_impl="eager")
    assert not any(t.is_inference() for t in served.rope_tables(torch.device("cpu")))
    loss = tt.loss_fn(params, _batch(cfg, 12), cfg)
    loss.backward()
    assert bool(torch.isfinite(loss)) and params["visual"]["pos_embed"].grad is not None


LAYOUTS = {"unsharded": (None, {}), "dp": (1, {}), "ring": (1, {"ring_loss": True}),
           "fsdp": (1, {"fsdp": True}), "tp": (2, {"tensor_parallel": True})}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_the_step_reads_nothing_on_the_host(layout):
    """The forward and backward that the card captures, with remat, over a
    batch already on the device (the graph's static buffers), under the
    guard around every capture; the gradients reach every stepped tensor.
    ``opt.step()`` is left out: on the CPU AdamW reads its step count on the
    host, where the card's ``capturable`` one does not."""
    model_parallel, kw = LAYOUTS[layout]
    cfg = _cfg(remat=True, **kw)
    params = _params(cfg)
    mesh = None if model_parallel is None else get_mesh(devices=["cpu"] * 2,
                                                        model_parallel=model_parallel)
    if mesh is not None:
        _, params, _ = tt.make_sharded_train_step(cfg, mesh, params)
    batch = _batch(cfg, 5)
    with captured.HostReadGuard():
        loss = tt.loss_fn(params, batch, cfg, mesh)
        loss.backward()
    assert bool(torch.isfinite(loss))
    assert all(t.grad is not None and bool(torch.isfinite(t.grad).all())
               for t in tt._stepped(params))


def test_cpu_train_steps_make_no_graph():
    """On the CPU ``train_step`` and the sharded step run eagerly: the
    optimizer owns no ``GraphSet`` and the leaves' gradients are None after
    the step."""
    cfg = _cfg()
    params = _params(cfg)
    params, opt, loss = tt.train_step(params, None, _batch(cfg, 6), cfg=cfg,
                                      tx=tt.make_optimizer(cfg))
    assert np.isfinite(float(loss)) and captured.graphs_of(opt) is None
    step, placed, sopt = tt.make_sharded_train_step(cfg, get_mesh(devices=["cpu"] * 2), params)
    step(placed, sopt, _batch(cfg, 7))
    assert captured.graphs_of(sopt) is None
    assert all(t.grad is None for t in tt._stepped(params) + tt._stepped(placed))


def test_the_captured_step_refuses_a_tree_its_optimizer_does_not_step():
    """A tree other than the one the optimizer was made over (one reloaded
    by ``load_checkpoint``) takes an optimizer of its own: the captured
    route raises before it touches the card."""
    cfg = _cfg()
    params, other = _params(cfg), _params(cfg, seed=1)
    opt = tt.make_optimizer(cfg)(params)
    with pytest.raises(ValueError, match="not the tree its optimizer steps"):
        tt._captured_step(other, opt, _batch(cfg, 8), cfg, None)


@pytest.mark.parametrize("devices,several", [
    (["cuda:0", "cuda:0"], False), (["cuda:0", "cuda:1"], True), (["cpu"] * 8, False),
    (["cuda:1"], False), (["cpu", "cuda:0"], True)])
def test_the_route_follows_the_layout(devices, several):
    """A path over one device is captured on the card; over several distinct
    cards it runs eagerly, whatever happens at run time."""
    assert captured.several_devices(devices) is several
    assert captured.several_devices([torch.device(d) for d in devices]) is several


def _images(n, seed=9):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 255, (40 + 9 * i, 70 - 5 * i, 3), dtype=np.uint8) for i in range(n)]


def test_tp_embedder_through_the_graph_layer_equals_the_eager_tpvit():
    """Each mesh row of a TP mesh of two CPU ranks goes through
    ``captured.forward`` (on the CPU: the eager forward), whose rows are the
    ``TPViT``'s called directly; its forward passes the capture's guard once
    warm, and no ``GraphSet`` is made on the CPU."""
    clip = Clip.from_local_dir(FIXTURE, device="cpu")
    mesh = get_mesh(devices=["cpu"] * 4, model_parallel=2)
    sharded = ShardedVisionEmbedder(clip.vision, mesh, tensor_parallel=True)
    assert not any(captured.several_devices(row) for row in mesh.devices) and all(
        isinstance(t, TPViT) for t in sharded.towers)
    calls = []
    forward = captured.forward

    def spy(tower, *args, **kwargs):
        calls.append(tower)
        return forward(tower, *args, **kwargs)

    images = _images(3)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(captured, "forward", spy)
        rows, n = sharded.embed_images_device(images)
    assert n == 3 and calls == sharded.towers
    pp, tower = clip.vision.preprocessor, sharded.towers[0]
    padded = pp.padded_size(images)
    with torch.inference_mode():
        ref = torch.cat([tower(pp.run(images[i * 2:(i + 1) * 2], batch_bucket=2, padded=padded),
                               attn_impl="eager", channels_first=True) for i in range(2)])
        pixels = pp.run(images[:2], batch_bucket=2, padded=padded)
        with captured.HostReadGuard():
            guarded = tower(pixels, attn_impl="eager", channels_first=True)
    assert torch.equal(rows, ref) and torch.equal(guarded, ref[:2])
    assert all(captured.graphs_of(t) is None for t in sharded.towers)


def test_tpvit_with_rope_and_uneven_heads_reads_nothing_on_the_host():
    """PE-Core's 2-D rope (each rank's table columns, made at the first call,
    outside a graph) and heads the ranks do not divide (the gathered
    attention core): a warm ``TPViT`` forward under the guard equals the
    unsharded ``ViT``'s within f32 rounding."""
    from clip_embedder_tpu_torch.models import vit

    cfg = vit.ViTCfg(image_size=32, patch_size=8, width=192, layers=2, heads=3, mlp_hidden=256,
                     embed_dim=64, rope_2d=True, pool="map", pool_heads=3, pool_mlp_hidden=256)
    params = vit.init(cfg, generator=torch.Generator().manual_seed(3), device="cpu")
    tower = vit.ViT(cfg, params)
    tp = TPViT(cfg, tower_tree(tower), [torch.device("cpu")] * 2)
    pixels = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 3, 32, 32)).astype(np.float32))
    with torch.inference_mode():
        first = tp(pixels, attn_impl="eager", channels_first=True)
        with captured.HostReadGuard():
            again = tp(pixels, attn_impl="eager", channels_first=True)
        ref = tower(pixels, attn_impl="eager", channels_first=True)
    assert torch.equal(first, again)
    torch.testing.assert_close(again, ref, atol=1e-5, rtol=1e-5)
