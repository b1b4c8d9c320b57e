"""The general generator of the benchmark's training traffic: CAM5-shaped
samples made from the seed, read by every cell through the parameters of
its workload file (``workloads/<cell>.json``, key ``traffic``).

A sample is (data (H, W, C) fp32, label (H, W) int64), the schema of the
reference's HDF5 files.  Each channel of a sample is normal noise with its
own mean, drawn from +-``channel_offset``, and its own standard deviation,
drawn from ``channel_scale``, as CAM5 tiles differ by region and season;
the label holds one atmospheric-river disc (class 2) and one cyclone disc
(class 1), whose radii, as fractions of H, are drawn from ``ar_radius``
and ``tc_radius``, so that their shares of the pixels vary from none to a
few times CAM5's means (1.3% and 0.05%); channel 0 carries ``signal``
times the label.  The statistics file's (minval, maxval) per channel are
drawn from the seed alone, the same for every rank.  Every seed gives the
same sizes.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .seeds import sub_seed


def make_sample(cfg: dict, traffic: dict, seed: int, rank: int, index: int,
                device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rank ``rank``'s sample ``index``, on ``device``."""
    h, w = cfg["image_size"]
    c = cfg["in_channels"]
    key = sub_seed(seed, "sample", rank, index)
    gen = torch.Generator(device=device).manual_seed(key)
    rng = np.random.RandomState(key % (2 ** 32))
    scale = torch.as_tensor(rng.uniform(*traffic["channel_scale"], c), dtype=torch.float32,
                            device=device)
    offset = traffic["channel_offset"] * (2 * rng.random_sample(c) - 1)
    data = torch.randn((h, w, c), generator=gen, device=device).mul_(scale).add_(
        torch.as_tensor(offset, dtype=torch.float32, device=device))
    yy = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    label = torch.zeros((h, w), dtype=torch.int64, device=device)
    for cls, (lo, hi) in ((2, traffic["ar_radius"]), (1, traffic["tc_radius"])):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        r = rng.uniform(lo, hi) * h
        label[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = cls
    data[..., 0] += traffic["signal"] * label.to(torch.float32)
    return data, label


def stats(cfg: dict, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """(minval, maxval) per channel, fp32, of the data set's statistics."""
    rng = np.random.RandomState(sub_seed(seed, "stats") % (2 ** 32))
    c = cfg["in_channels"]
    minval = (-8.0 - 0.5 * rng.random_sample(c)).astype(np.float32)
    maxval = (8.0 + 0.5 * rng.random_sample(c)).astype(np.float32)
    maxval[0] += 2.0  # channel 0 carries the label signal
    return minval, maxval


def normalize(data: torch.Tensor, minval: np.ndarray, maxval: np.ndarray) -> torch.Tensor:
    """min-max normalisation of (..., C) fp32 data, as the reference's
    loader applies it: (data - minval) / (maxval - minval)."""
    lo = torch.as_tensor(minval, device=data.device)
    scale = 1.0 / (torch.as_tensor(maxval, device=data.device) - lo)
    return (data - lo) * scale
