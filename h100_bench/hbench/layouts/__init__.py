"""Everything that depends on a configuration's tower family, one module a
family, found by the configuration file's ``layout`` name: ``vit.py`` for
``"layout": "vit"``. A new family joins the benchmark as a new module here.

Each module exports four functions, each of the configuration's
``vision`` dict (``v``) or of the program's resolved tower config:

* ``leaves(v)``: the ``(path, shape, kind)`` of every leaf of the weight
  tree that ``hbench.weights.make_tree`` draws, in the tree that the
  program's ``build_tower`` takes for the family;
* ``resolved(cfg)``: the program's resolved widths, keyed like ``v``, which
  ``hbench.program.check_resolved`` holds to the stated ones;
* ``flop_per_image(v)``: model FLOP of one image through the tower;
* ``shrink(config, *, width, layers, heads, mlp)``: the configuration cut
  in place to a CPU test's size through the family's override hook in
  ``open_clip``, with ``vision`` restating the cut widths."""

from __future__ import annotations

import importlib
from types import ModuleType


def of(config: dict) -> ModuleType:
    """The layout module of ``config`` (its ``layout`` key)."""
    return importlib.import_module(f"{__name__}.{config['layout']}")
