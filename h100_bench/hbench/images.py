"""The image pool of a traffic mix, made from the seed on the device.

A pool holds ``pool_images`` decoded RGB uint8 arrays whose sizes come from
the mix's ``sizes`` (W × H): the pool is a run of blocks, each a seeded
permutation of all the sizes, so every seed serves the same set of sizes in
another order, and any run of 2·len(sizes) − 1 consecutive images holds
every size. Each image is a smooth random field (a seeded ``grid`` × ``grid``
colour grid, upsampled) with pixel noise on top: images differ from one
another in their embeddings, not only in noise that the resize averages
away. The arrays are read-only, so that nothing downstream can change
what the reference is later given."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .weights import seed_for


def size_sequence(traffic: dict, seed: int) -> list[int]:
    """The index into ``traffic["sizes"]`` of each pool image."""
    k = len(traffic["sizes"])
    n = traffic["pool_images"]
    if n % k:
        raise ValueError(f"pool_images {n} is not a multiple of the {k} sizes")
    rng = np.random.default_rng(seed_for(seed, "sizes"))
    return [int(i) for _ in range(n // k) for i in rng.permutation(k)]


def make_pool(traffic: dict, seed: int, device) -> list[np.ndarray]:
    seq = size_sequence(traffic, seed)
    gen = torch.Generator(device=device).manual_seed(seed_for(seed, "pixels"))
    grid, noise = traffic["grid"], traffic["noise"]
    pool: list = [None] * len(seq)
    for k, (w, h) in enumerate(traffic["sizes"]):
        idx = [i for i, s in enumerate(seq) if s == k]
        base = torch.rand((len(idx), 3, grid, grid), generator=gen, device=device)
        field = F.interpolate(base, size=(h, w), mode="bilinear", align_corners=False)
        jitter = torch.rand((len(idx), 3, h, w), generator=gen, device=device) - 0.5
        x = (field * (1 - noise) + noise * (jitter + 0.5)).clamp_(0, 1)
        u8 = (x * 255).round_().to(torch.uint8).permute(0, 2, 3, 1).contiguous().cpu().numpy()
        u8.flags.writeable = False
        for j, i in enumerate(idx):
            pool[i] = u8[j]
    return pool
