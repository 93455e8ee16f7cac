"""The traffic made from a seed: the open-loop schedule, the image pool,
and the tail taken over all requests."""

from __future__ import annotations

import json

import numpy as np
import pytest

import tiny  # noqa: F401
from hbench.cell import BENCH_DIR
from hbench.drivers.microbatch_open import latencies_ms, percentile, schedule
from hbench.images import make_pool, size_sequence
from hbench.readers import p95

BIG_SEED = 2**31 + 12345


def traffic(name):
    return json.loads((BENCH_DIR / "traffic" / f"{name}.json").read_text())


def test_schedule_same_seed_same_times():
    a, b = schedule(300.0, 20.0, BIG_SEED), schedule(300.0, 20.0, BIG_SEED)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, schedule(300.0, 20.0, BIG_SEED + 1))


def test_schedule_every_seed_the_same_gaps_in_another_order():
    a, b = schedule(300.0, 20.0, 1), schedule(300.0, 20.0, BIG_SEED)
    assert len(a) == len(b) == 6000
    assert np.allclose(np.sort(np.diff(a, prepend=0)), np.sort(np.diff(b, prepend=0)))
    assert a[-1] == pytest.approx(b[-1])


def test_schedule_is_poisson_at_the_rate():
    due = schedule(300.0, 20.0, BIG_SEED)
    gaps = np.diff(due, prepend=0)
    assert due[-1] == pytest.approx(20.0, rel=0.01)
    assert gaps.mean() == pytest.approx(1 / 300, rel=0.01)
    assert gaps.std() == pytest.approx(1 / 300, rel=0.05)  # exponential: std = mean
    counts = np.histogram(due, bins=np.arange(0, 20.5, 0.5))[0]
    assert counts.var() / counts.mean() == pytest.approx(1.0, abs=0.5)  # Poisson counts


def test_pool_sizes_stratified_and_seeded():
    t = traffic("bulk")
    seq = size_sequence(t, BIG_SEED)
    k = len(t["sizes"])
    assert len(seq) == t["pool_images"]
    for i in range(0, len(seq), k):
        assert sorted(seq[i:i + k]) == list(range(k))
    for i in range(len(seq) - (2 * k - 1)):
        assert set(seq[i:i + 2 * k - 1]) == set(range(k))
    assert seq == size_sequence(t, BIG_SEED) != size_sequence(t, BIG_SEED + 1)


def test_pool_images_made_from_the_seed_read_only():
    t = dict(traffic("bulk"), sizes=tiny.TINY_SIZES, pool_images=12)
    a, b = make_pool(t, BIG_SEED, "cpu"), make_pool(t, BIG_SEED, "cpu")
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    seq = size_sequence(t, BIG_SEED)
    assert [im.shape for im in a] == [(t["sizes"][s][1], t["sizes"][s][0], 3) for s in seq]
    assert all(im.dtype == np.uint8 and not im.flags.writeable for im in a)
    with pytest.raises(ValueError):
        a[0][0, 0, 0] = 1


def test_tail_over_all_requests_not_chunks():
    # 20 chunks of 100 requests: one chunk holds every slow request, so the
    # median of chunk p95s sees none of them; the p95 of all requests does
    rng = np.random.default_rng(0)
    lat = rng.uniform(10, 20, 2000)
    lat[:150] = 500.0
    chunked = np.median([percentile(c, 95) for c in np.split(lat, 20)])
    assert chunked < 20
    assert percentile(lat, 95) == 500.0
    assert p95(list(lat)) == 500.0


def test_nearest_rank_percentile():
    assert percentile(range(1, 101), 95) == 95
    assert percentile(range(1, 101), 50) == 50
    assert percentile([7.0], 95) == 7.0


def test_missing_and_failed_requests_wait_until_given_up():
    res = {"due": np.array([0.0, 1.0, 2.0]), "done": np.array([0.5, np.nan, 2.1]),
           "errors": {2: "boom"}, "give_up": 62.0}
    assert latencies_ms(res) == pytest.approx([500.0, 61000.0, 60000.0])
