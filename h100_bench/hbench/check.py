"""How ``correct`` is decided: the rows that the timed path returned,
against the plain reference.

Once the window has closed and the program's state is freed, a sample of
the answered requests (or bulk rows), drawn from the seed, is embedded again
by the configuration's reference (``reference.run``) from the same pool
images and from weights drawn anew from the same seed. Each sampled row is
compared by its L2 distance to the reference's row (both unit vectors).
Compared, each against its limit from the configuration file's ``check``:

* ``rows_missing``: requests that failed or never answered (limit 0);
* ``row_gap_max``: the widest gap over the sample;
* ``row_gap_median``: the median gap over the sample.

A gap that is not finite fails. The limits and the readings they were set
from are in ``PERF.md``."""

from __future__ import annotations

import numpy as np

from .reference.run import reference_rows
from .weights import make_tree, seed_for


def sample_ids(answers: dict, k: int, seed: int) -> list:
    ids = sorted(answers)
    rng = np.random.default_rng(seed_for(seed, "sample"))
    pick = rng.choice(len(ids), size=min(k, len(ids)), replace=False)
    return [ids[i] for i in sorted(pick)]


def judge(config: dict, seed: int, pool: list, answers: dict, image_of, missing: int,
          device, sample_rows: int) -> tuple[bool, dict, dict]:
    """(correct, checks {name: {"value", "limit"}}, info) for the answers
    ``{id: row}``, ``image_of(id)`` giving the pool index an answer embeds."""
    ids = sample_ids(answers, sample_rows, seed)
    images = sorted({image_of(i) for i in ids})
    tree = make_tree(config, seed, device)
    ref = dict(zip(images, reference_rows(config, tree, [pool[j] for j in images], device)))
    del tree
    got = np.stack([np.asarray(answers[i], dtype=np.float32) for i in ids])
    want = np.stack([ref[image_of(i)] for i in ids])
    gaps = np.linalg.norm(got - want, axis=1)
    limits = config["check"]
    checks = {"rows_missing": {"value": missing, "limit": 0}}
    for name, value in (("row_gap_max", gaps.max()), ("row_gap_median", np.median(gaps))):
        checks[name] = {"value": float(value) if np.isfinite(value) else None,
                        "limit": limits[name]}
    correct = all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
    rows = np.stack([ref[j] for j in images])
    dist = np.linalg.norm(rows[:, None] - rows[None], axis=2)[~np.eye(len(images), dtype=bool)]
    info = {"sampled_rows": len(ids), "distinct_images": len(images),
            "nearest_other_image": float(dist.min()) if dist.size else None}
    return correct, checks, info
