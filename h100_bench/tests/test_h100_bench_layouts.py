"""A configuration's family enters through its layout module alone
(``hbench.layouts.of``): the weight tree, the program's resolved widths,
the model FLOP of ``mfu.bulk`` and the CPU cut. The ViT layout draws the
same weights bit for bit as the code it was moved from."""

from __future__ import annotations

import hashlib
import sys
from types import ModuleType, SimpleNamespace

import pytest
import torch

import tiny
from hbench import layouts
from hbench.cell import cell_files, load_benchmark, reader
from hbench.program import check_resolved
from hbench.weights import make_tree

BENCH = load_benchmark()

# sha256 (``tree_digest``) of each configuration's tree, cut by tiny.shrink,
# at seed 7 on the CPU, as the ViT code drew it before it moved into
# hbench/layouts/vit.py
TINY_DIGESTS = {
    "vit-so400m-16-siglip2-384": "90701ead873f9b6688df15c3d14e44117022facdcccecfa4290f34001158ba8a",
    "pe-core-bigg-14-448": "a8fa4d8a0206f673eef2f83b356e6158f4cda2556886afc06742c37074c51e12",
}


def tree_digest(tree: dict) -> str:
    """sha256 over every leaf in sorted path order: its path, shape and
    dtype, then its raw bytes."""
    h = hashlib.sha256()

    def walk(node, path):
        for key in sorted(node):
            if isinstance(node[key], dict):
                walk(node[key], path + (key,))
                continue
            t = node[key].detach().reshape(-1).cpu()
            h.update(f"{'/'.join(path + (key,))}:{tuple(node[key].shape)}:{t.dtype}\n".encode())
            h.update(t.view(torch.uint8).numpy().tobytes())

    walk(tree, ())
    return h.hexdigest()


def config_cell(name):
    return next(w["name"] for w in BENCH["workloads"] if w["config"] == name)


@pytest.mark.parametrize("name", sorted(TINY_DIGESTS))
def test_tiny_tree_is_bitwise_as_before_the_move(name):
    _, config, traffic = cell_files(BENCH, config_cell(name))
    config, _ = tiny.shrink(config, traffic)
    assert tree_digest(make_tree(config, 7, "cpu")) == TINY_DIGESTS[name]


def _toy_module() -> ModuleType:
    toy = ModuleType("hbench.layouts.toy")

    def leaves(v):
        w = v["width"]
        return [(("blocks", "fc", "w"), (v["layers"], w, 2 * w), f"std={w ** -0.5!r}"),
                (("blocks", "fc", "b"), (v["layers"], 2 * w), "small"),
                (("ln", "scale"), (w,), "ln_scale"), (("ln", "bias"), (w,), "small")]

    def resolved(cfg):
        return {"width": cfg.width, "layers": cfg.layers}

    def flop_per_image(v):
        return 1e9 * v["width"]

    def shrink(config, *, width, layers, heads, mlp):
        config["vision"].update(width=width, layers=layers)
        config["open_clip"]["vision_cfg"]["toy_cfg"] = {"width": width, "layers": layers}

    toy.leaves, toy.resolved, toy.flop_per_image, toy.shrink = (
        leaves, resolved, flop_per_image, shrink)
    return toy


@pytest.fixture
def toy(monkeypatch):
    """A configuration of a family that no file under hbench/layouts/
    knows, its layout registered as a module for this test alone."""
    monkeypatch.setitem(sys.modules, "hbench.layouts.toy", _toy_module())
    return {"layout": "toy", "dtype": "float32", "vision": {"width": 8, "layers": 3},
            "open_clip": {"vision_cfg": {}}}


def test_make_tree_draws_the_layouts_leaves(toy):
    tree = make_tree(toy, 3, "cpu")
    assert set(tree) == {"blocks", "ln"}
    assert tree["blocks"]["fc"]["w"].shape == (3, 8, 16)
    assert tree["blocks"]["fc"]["b"].shape == (3, 16) and tree["ln"]["bias"].shape == (8,)
    assert tree["ln"]["scale"].dtype == torch.float32
    assert torch.equal(tree["blocks"]["fc"]["w"], make_tree(toy, 3, "cpu")["blocks"]["fc"]["w"])


def test_check_resolved_reads_the_layouts_widths(toy):
    check_resolved(toy, SimpleNamespace(width=8, layers=3, heads=99))  # heads is not read
    with pytest.raises(SystemExit, match=r"resolves another tower .*'layers': \(3, 4\)"):
        check_resolved(toy, SimpleNamespace(width=8, layers=4))


def test_mfu_reads_the_layouts_flop(toy):
    inputs = SimpleNamespace(trace={"batches": 3, "batch_size": 10, "window_s": 2.0},
                             config=toy, device_name="NVIDIA H100 80GB HBM3")
    assert reader("mfu.bulk")(inputs) == pytest.approx(100.0 * 8e9 * 15.0 / 989e12)


def test_tiny_shrink_cuts_through_the_layout(toy):
    traffic = {"shape": "pipeline_closed", "sizes": [[1, 1]], "pool_images": 1,
               "check_rows": 1}
    config, traffic = tiny.shrink(toy, traffic, width=4, layers=1)
    assert config["vision"] == {"width": 4, "layers": 1}
    assert config["open_clip"]["vision_cfg"] == {"toy_cfg": {"width": 4, "layers": 1}}
    assert toy["vision"] == {"width": 8, "layers": 3}  # the caller's copy is left whole
    assert traffic["batch_size"] == 8 and traffic["sizes"] == tiny.TINY_SIZES


def test_layout_found_by_name():
    _, config, _ = cell_files(BENCH, "so400m.bulk")
    assert layouts.of(config) is sys.modules["hbench.layouts.vit"]
    with pytest.raises(ModuleNotFoundError):
        layouts.of({"layout": "no_such_family"})
