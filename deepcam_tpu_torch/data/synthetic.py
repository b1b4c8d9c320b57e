"""Synthetic CAM5 samples in the reference's HDF5 schema (counterpart of
``deepcam_tpu/data/synthetic.py``): the same files, bit for bit, from the
same seed.

Schema: ``climate/data (H, W, 16) fp32`` and ``climate/labels_0 (H, W)
int64`` per file, and a ``stats.h5`` with per-channel
``climate/{count,mean,sqmean,minval,maxval}`` over the train split.

``make_arrays`` makes the arrays; ``make_synthetic_dataset`` writes them
with h5py, and ``data.dataset.MemoryCamDataset`` serves them from memory
where h5py is missing.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

Sample = Tuple[str, np.ndarray, np.ndarray]  # (path under root, data, label)


def make_arrays(root: str, n_train: int = 8, n_validation: int = 4, n_test: int = 0,
                shape: Tuple[int, int] = (64, 96), n_channels: int = 16,
                n_classes: int = 3, seed: int = 0, signal: float = 1.0,
                ) -> Tuple[Dict[str, List[Sample]], Dict[str, np.ndarray]]:
    """({split: [(path, data, label), ...]}, stats) with the paths, values
    and random-number order of the JAX package's writer.  Labels are blobby,
    and ``signal`` scales how strongly channel 0 encodes them."""
    del n_classes  # labels are 0, 1, 2 by construction, as in the JAX writer
    rng = np.random.RandomState(seed)
    h, w = shape
    splits = {"train": n_train, "validation": n_validation}
    if n_test:
        splits["test"] = n_test
    out: Dict[str, List[Sample]] = {}
    train_data = []
    yy, xx = np.mgrid[0:h, 0:w]
    for split, count in splits.items():
        d = os.path.join(root, split)
        out[split] = []
        for i in range(count):
            data = rng.randn(h, w, n_channels).astype(np.float32)
            # low-frequency structured labels: two discs
            cy, cx = rng.randint(0, h), rng.randint(0, w)
            r1 = rng.randint(max(2, h // 8), max(3, h // 3))
            r2 = rng.randint(max(2, h // 10), max(3, h // 4))
            label = np.zeros((h, w), dtype=np.int64)
            label[((yy - cy) ** 2 + (xx - cx) ** 2) < r1**2] = 1
            cy2, cx2 = rng.randint(0, h), rng.randint(0, w)
            label[((yy - cy2) ** 2 + (xx - cx2) ** 2) < r2**2] = 2
            data[..., 0] += signal * label.astype(np.float32)
            fname = os.path.join(d, f"data-2000-{i:02d}-01-{rng.randint(0, 4)}.h5")
            out[split].append((fname, data, label))
            if split == "train":
                train_data.append(data)
    stacked = np.stack(train_data)  # (n, h, w, c)
    stats = {
        "count": np.full(n_channels, stacked[..., 0].size, np.float64),
        "mean": stacked.mean(axis=(0, 1, 2)),
        "sqmean": (stacked**2).mean(axis=(0, 1, 2)),
        "minval": stacked.min(axis=(0, 1, 2)),
        "maxval": stacked.max(axis=(0, 1, 2)),
    }
    return out, stats


def make_synthetic_dataset(root: str, n_train: int = 8, n_validation: int = 4,
                           n_test: int = 0, shape: Tuple[int, int] = (64, 96),
                           n_channels: int = 16, n_classes: int = 3, seed: int = 0,
                           signal: float = 1.0) -> str:
    """Writes ``root/{train,validation[,test]}/data-*.h5`` and
    ``root/stats.h5``; returns ``root``."""
    import h5py

    splits, stats = make_arrays(root, n_train, n_validation, n_test, shape, n_channels,
                                n_classes, seed, signal)
    os.makedirs(root, exist_ok=True)
    for split, samples in splits.items():
        os.makedirs(os.path.join(root, split), exist_ok=True)
        for fname, data, label in samples:
            with h5py.File(fname, "w") as f:
                f.create_dataset("climate/data", data=data)
                f.create_dataset("climate/labels_0", data=label)
    with h5py.File(os.path.join(root, "stats.h5"), "w") as f:
        for k in ("count", "mean", "sqmean", "minval", "maxval"):
            f.create_dataset(f"climate/{k}", data=stats[k])
    return root
