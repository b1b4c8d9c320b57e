"""The train step alone: ``resident_batches`` distinct batches made from
the seed, normalised and cast to the compute type once, held on the device and used in
turn, so the data pipeline drops out.  Step s takes batch s mod
``resident_batches``."""

from __future__ import annotations

import torch

from ..traffic import make_sample, normalize, stats


class Feed:
    def __init__(self, run):
        cfg, tr = run.cfg, run.wl["traffic"]
        self.batch = run.wl["local_batch"]
        self.n_batches = tr["resident_batches"]
        minval, maxval = stats(cfg, run.seed)
        self.batches = []
        for b in range(self.n_batches):
            xs, ys = [], []
            for j in range(self.batch):
                d, lb = make_sample(cfg, tr, run.seed, run.rank, b * self.batch + j,
                                    run.device)
                xs.append(normalize(d, minval, maxval).to(getattr(torch, cfg["compute_dtype"])))
                ys.append(lb.to(torch.int32))
            self.batches.append((torch.stack(xs), torch.stack(ys)))
        self.step = 0

    def next(self):
        x, y = self.batches[self.step % self.n_batches]
        self.step += 1
        return x, y

    def close(self):
        self.batches = []


def indices(wl: dict, step: int):
    """This rank's sample indices at 0-based ``step``."""
    b = wl["local_batch"]
    first = (step % wl["traffic"]["resident_batches"]) * b
    return [first + j for j in range(b)]
