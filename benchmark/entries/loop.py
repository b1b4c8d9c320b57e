"""The users' training loop: the port's ``DataLoader`` over
``MemoryCamDataset`` with pinned memory, and ``prefetch_to_device``.

Each rank holds ``samples_per_rank`` distinct samples in host memory,
made from the seed; the dataset names ``max_steps * local_batch`` files per
rank, file k of a rank being its sample k mod ``samples_per_rank``, so no
epoch ends inside a run, and the pipeline still reads, normalises and casts
every sample of every batch.  Files are in order (no shuffle), so step s
takes samples s*B .. s*B + B - 1 (mod ``samples_per_rank``)."""

from __future__ import annotations

from ..traffic import make_sample, stats


class Feed:
    def __init__(self, run):
        from deepcam_tpu_torch.data.dataset import MemoryCamDataset
        from deepcam_tpu_torch.data.pipeline import DataLoader, prefetch_to_device

        cfg, tr = run.cfg, run.wl["traffic"]
        self.n = tr["samples_per_rank"]
        self.batch = run.wl["local_batch"]
        arrays = []
        for i in range(self.n):
            d, lb = make_sample(cfg, tr, run.seed, run.rank, i, run.device)
            arrays.append((d.cpu().numpy(), lb.cpu().numpy()))
        per_rank = tr["max_steps"] * self.batch
        if per_rank % self.n:
            raise ValueError("max_steps * local_batch must be a multiple of samples_per_rank")
        files = {f"train/data-{k:07d}.h5": arrays[k % self.n]
                 for k in range(run.world * per_rank)}
        self.first = run.rank * per_rank
        minval, maxval = stats(cfg, run.seed)
        ds = MemoryCamDataset("train", "stats.h5", list(range(cfg["in_channels"])),
                              files=files, stats={"minval": minval, "maxval": maxval},
                              comm_size=run.world, comm_rank=run.rank,
                              bf16_out=cfg["compute_dtype"] == "bfloat16",
                              shuffle=False, allow_uneven_distribution=False)
        loader = DataLoader(ds, self.batch, drop_last=True,
                            pin_memory=run.device.type == "cuda",
                            num_workers=min(tr["max_inter_threads"], self.batch))
        self.it = prefetch_to_device(loader, run.device)
        self.step = 0

    def next(self):
        data, label, names = next(self.it)
        if self.step < 3:  # the compared steps: the files this feed stands for
            want = tuple(f"train/data-{self.first + self.step * self.batch + j:07d}.h5"
                         for j in range(self.batch))
            if tuple(names) != want:
                raise RuntimeError(f"the loader gave {names} at step {self.step}, not {want}")
        self.step += 1
        return data, label

    def close(self):
        self.it.close()


def indices(wl: dict, step: int):
    """This rank's sample indices at 0-based ``step``."""
    b, n = wl["local_batch"], wl["traffic"]["samples_per_rank"]
    return [(step * b + j) % n for j in range(b)]
