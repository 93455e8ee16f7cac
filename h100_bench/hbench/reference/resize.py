# Frozen copy of the resize arithmetic of clip_embedder_tpu_torch/ops/preprocess.py
# (_catmull_rom, _bilinear, resize_weights, shortest_crop_box, preprocess_weights_for)
# at commit 4365e722da82de69a44f96d71d1126ef91d02509, with the padded-size option
# dropped: the reference resizes each image at its own size.
"""The reference preprocess: Pillow's convolution resize as two f32 products
per image, worked out here from the source size alone, then (x - mean) / std.

Independent of the program: nothing here reads the program's matrices,
buckets or staging buffers."""

from __future__ import annotations

import numpy as np
import torch


def _catmull_rom(x: np.ndarray) -> np.ndarray:
    """Keys cubic with a = -0.5: Pillow's BICUBIC."""
    x = np.abs(x)
    x2 = x * x
    x3 = x2 * x
    a = -0.5
    return np.where(
        x <= 1.0,
        (a + 2.0) * x3 - (a + 3.0) * x2 + 1.0,
        np.where(x < 2.0, a * x3 - 5.0 * a * x2 + 8.0 * a * x - 4.0 * a, 0.0),
    )


def _bilinear(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


_FILTERS = {"bicubic": (_catmull_rom, 2.0), "bilinear": (_bilinear, 1.0)}


def resize_weights(out_size: int, in_size: int, *, crop_start: float = 0.0,
                   crop_size: float | None = None,
                   interpolation: str = "bicubic") -> np.ndarray:
    """[out_size, in_size] weights of Pillow's precompute_coeffs: antialiased
    support and each output's window renormalised."""
    if crop_size is None:
        crop_size = float(in_size)
    weights = np.zeros((out_size, in_size), dtype=np.float32)
    scale = crop_size / out_size
    if interpolation in _FILTERS:
        kernel, support = _FILTERS[interpolation]
        filterscale = max(scale, 1.0)
        support = support * filterscale
        for i in range(out_size):
            center = crop_start + (i + 0.5) * scale
            xmin = max(int(center - support + 0.5), 0)
            xmax = min(int(center + support + 0.5), in_size)
            xs = np.arange(xmin, xmax, dtype=np.float64)
            w = kernel((xs + 0.5 - center) / filterscale)
            total = w.sum()
            if total != 0:
                w = w / total
            weights[i, xmin:xmax] = w
    elif interpolation == "nearest":
        for i in range(out_size):
            src = min(max(int(crop_start + (i + 0.5) * scale), 0), in_size - 1)
            weights[i, src] = 1.0
    else:
        raise ValueError(f"unsupported interpolation '{interpolation}'")
    return weights


def shortest_crop_box(width: int, height: int) -> tuple[float, float, float]:
    side = float(min(width, height))
    return (width - side) / 2.0, (height - side) / 2.0, side


def preprocess_weights_for(width: int, height: int, target: int, *,
                           interpolation: str, resize_mode: str):
    """(Wh [target, height], Ww [target, width]) for one source size."""
    if resize_mode == "squash":
        cx, cy, cw, ch = 0.0, 0.0, float(width), float(height)
    else:
        cx, cy, side = shortest_crop_box(width, height)
        cw = ch = side
    wh = resize_weights(target, height, crop_start=cy, crop_size=ch,
                        interpolation=interpolation)
    ww = resize_weights(target, width, crop_start=cx, crop_size=cw,
                        interpolation=interpolation)
    return wh, ww


def preprocess(images: list[np.ndarray], pp: dict, image_size: int,
               device) -> torch.Tensor:
    """[B, 3, S, S] f32 pixels of uint8 [H, W, 3] images: each resized by its
    own matrices in full f32, then normalised."""
    mean = torch.tensor(pp["mean"], dtype=torch.float32, device=device)[:, None, None]
    std = torch.tensor(pp["std"], dtype=torch.float32, device=device)[:, None, None]
    out = []
    for img in images:
        h, w = img.shape[:2]
        wh, ww = preprocess_weights_for(w, h, image_size, interpolation=pp["interpolation"],
                                        resize_mode=pp["resize_mode"])
        x = torch.from_numpy(np.array(img, dtype=np.float32)).to(device) / 255.0
        wh_t = torch.from_numpy(wh).to(device)
        ww_t = torch.from_numpy(ww).to(device)
        x = torch.einsum("sh,hwc,tw->cst", wh_t, x, ww_t)
        out.append((x - mean) / std)
    return torch.stack(out)
