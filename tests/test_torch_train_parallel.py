"""The torch port's training layouts (``train.make_sharded_train_step``: DP,
TP, FSDP, the ring loss) against the unsharded port step and the JAX
package's sharded step, on the CPU.

The JAX side runs on conftest's 8 virtual devices
(``clip_embedder_tpu.parallel.get_mesh(model_parallel=2)``, 4 x 2); the
port side on a mesh of eight ``"cpu"`` entries, 4 x 2. Params cross as
numpy, at tests/test_torch_train.py's small SigLIP and CLIP towers.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from clip_embedder_tpu import train as jt
from clip_embedder_tpu.parallel import get_mesh as jget_mesh
from clip_embedder_tpu_torch import train as tt
from clip_embedder_tpu_torch.parallel import get_mesh
from clip_embedder_tpu_torch.parallel.sharding import Sharded

from test_torch_train import cfgs, jax_params, make_batch, unit_embeddings

LAYOUTS = {"dp": {}, "tp": {"tensor_parallel": True}, "fsdp": {"fsdp": True},
           "ring": {"ring_loss": True}}


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"
    return jget_mesh(model_parallel=2)


@pytest.fixture(scope="module")
def mesh():
    return get_mesh(devices=["cpu"] * 8, model_parallel=2)


@pytest.fixture(scope="module")
def jax_losses():
    """The JAX unsharded ``train_step``'s 3 losses on the sharded tests'
    batch (lr 1e-3), one jit a loss kind."""
    cache = {}

    def get(loss):
        if loss not in cache:
            jcfg, _ = cfgs(loss, learning_rate=1e-3)
            tx = jt.make_optimizer(jcfg)
            step = jax.jit(partial(jt.train_step, cfg=jcfg, tx=tx))
            jp = jax.tree.map(jnp.asarray, jax_params(jcfg))
            state = jt.init_opt_state(jcfg, jp)
            jbatch = jax.tree.map(jnp.asarray, make_batch(11, b=8))
            cache[loss] = []
            for _ in range(3):
                jp, state, jl = step(jp, state, jbatch)
                cache[loss].append(float(jl))
        return cache[loss]

    return get


def _port_losses(step, params, opt, batch, steps):
    losses = []
    for _ in range(steps):
        params, opt, loss = step(params, opt, batch)
        losses.append(float(loss))
    return losses, params


@pytest.mark.parametrize("layout,loss", [("dp", "clip"), ("dp", "siglip"), ("tp", "clip"),
                                         ("tp", "siglip"), ("fsdp", "siglip"),
                                         ("ring", "siglip")])
def test_sharded_step_matches_unsharded_and_jax(mesh, jmesh, jax_losses, layout, loss):
    """3 steps on one batch of 8 (2 a data row): the port's sharded losses
    are its unsharded step's within 1e-5 and they descend; all 3 are the JAX
    unsharded ``train_step``'s on the same batch within 1e-4, so the sharded
    backward pass and AdamW step are held against JAX (losses 2 and 3 come
    after an update); under the SigLIP loss (every layout takes it) the
    first is the JAX sharded step's within 1e-4 too. The JAX sharded step
    compiles again on its second call (~4 s a compile here), so it is held
    on its first loss alone."""
    jcfg, pcfg = cfgs(loss, learning_rate=1e-3, **LAYOUTS[layout])
    npp, batch = jax_params(jcfg), make_batch(11, b=8)

    flat_cfg = cfgs(loss, learning_rate=1e-3)[1]
    tx = tt.make_optimizer(flat_cfg)
    unsharded, _ = _port_losses(partial(tt.train_step, cfg=flat_cfg, tx=tx),
                                tt.train_params_from_numpy(npp, device="cpu"), None, batch, 3)
    step, placed, opt = tt.make_sharded_train_step(
        pcfg, mesh, tt.train_params_from_numpy(npp, device="cpu"))
    got, placed = _port_losses(step, placed, opt, batch, 3)

    np.testing.assert_allclose(got, unsharded, rtol=1e-5)
    np.testing.assert_allclose(got, jax_losses(loss), rtol=1e-4)
    assert got[-1] < got[0]
    if loss == "siglip":
        jstep, jp, jstate = jt.make_sharded_train_step(jcfg, jmesh,
                                                       jax.tree.map(jnp.asarray, npp))
        sh = NamedSharding(jmesh, P("data"))
        jbatch = {k: jax.device_put(jnp.asarray(v), sh) for k, v in batch.items()}
        _, _, jl = jstep(jp, jstate, jbatch)
        np.testing.assert_allclose(got[0], float(jl), rtol=1e-4)


def test_layouts_place_each_leaf_once(mesh):
    """TP holds q/k/v and fc by output feature and out/proj by input over the
    model ranks, FSDP the largest divisible axis over the data rows (the
    stacked fc kernel [2, 32, 64] along its 64); the optimizer steps each
    part once."""
    jcfg, _ = cfgs("siglip")
    npp = jax_params(jcfg)
    for layout, leaf, n, dim in (("tp", ("mlp", "fc", "w"), 2, 2),
                                 ("tp", ("mlp", "proj", "w"), 2, 1),
                                 ("fsdp", ("mlp", "fc", "w"), 4, 2)):
        _, pcfg = cfgs("siglip", **LAYOUTS[layout])
        _, placed, opt = tt.make_sharded_train_step(
            pcfg, mesh, tt.train_params_from_numpy(npp, device="cpu"))
        got = placed["visual"]["blocks"]
        for key in leaf:
            got = got[key]
        full = npp["visual"]["blocks"]
        for key in leaf:
            full = full[key]
        assert isinstance(got, Sharded) and len(got.parts) == n and got.dim == dim
        assert all(p.is_leaf and p.requires_grad for p in got.parts)
        np.testing.assert_array_equal(got.gather("cpu").detach().numpy(), full)
        stepped = [p for g in opt.param_groups for p in g["params"]]
        assert len({id(p) for p in stepped}) == len(stepped)
        assert {id(p) for p in got.parts} <= {id(p) for p in stepped}
        assert tt._decay_mask(placed)["visual"]["blocks"]["mlp"]["fc"]["w"]


def test_fsdp_and_tp_are_mutually_exclusive(mesh):
    _, pcfg = cfgs("siglip", fsdp=True, tensor_parallel=True)
    params, _ = tt.init_train_state(torch.Generator().manual_seed(0), pcfg, device="cpu")
    with pytest.raises(ValueError):
        tt.make_sharded_train_step(pcfg, mesh, params)


@pytest.mark.parametrize("model_parallel", [1, 2])
def test_ring_loss_matches_dense(model_parallel):
    """The ring loss over the data rows (one embedding shard a row) equals
    the dense sigmoid loss, the port's and the JAX package's, at rtol
    1e-5."""
    mesh = get_mesh(devices=["cpu"] * 8, model_parallel=model_parallel)
    n = mesh.shape["data"]
    img, txt = unit_embeddings(0, 8 * n, 16)
    scale, bias = torch.tensor(10.0), torch.tensor(-10.0)
    want = float(jt.siglip_loss(jnp.asarray(img), jnp.asarray(txt), 10.0, -10.0))
    ti, tx_ = torch.from_numpy(img), torch.from_numpy(txt)
    dense = float(tt.siglip_loss(ti, tx_, scale, bias))
    ring = float(tt.siglip_ring_loss(list(ti.chunk(n)), list(tx_.chunk(n)), scale, bias,
                                     mesh=mesh))
    np.testing.assert_allclose([ring, dense], want, rtol=1e-5)


def test_ring_loss_gradients_match_dense():
    """Gradients of the ring loss (img, txt, scale, bias) against the dense
    loss's, the port's and the JAX package's: rtol 2e-5, atol 1e-7."""
    mesh = get_mesh(devices=["cpu"] * 8)
    img, txt = unit_embeddings(1, 4 * 8, 8)
    want = jax.grad(jt.siglip_loss, argnums=(0, 1, 2, 3))(
        jnp.asarray(img), jnp.asarray(txt), jnp.float32(5.0), jnp.float32(-2.0))
    def ring(i, t, scale, bias):
        return tt.siglip_ring_loss(list(i.chunk(8)), list(t.chunk(8)), scale, bias, mesh=mesh)

    grads = {}
    for name, fn in (("dense", tt.siglip_loss), ("ring", ring)):
        args = [torch.tensor(a, requires_grad=True)
                for a in (img, txt, np.float32(5.0), np.float32(-2.0))]
        fn(*args).backward()
        grads[name] = [a.grad.numpy() for a in args]
    for gr, gd, gj in zip(grads["ring"], grads["dense"], want):
        np.testing.assert_allclose(gr, gd, rtol=2e-5, atol=1e-7)
        np.testing.assert_allclose(gr, np.asarray(gj), rtol=2e-5, atol=1e-7)
