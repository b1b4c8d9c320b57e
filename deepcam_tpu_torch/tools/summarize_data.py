"""Offline per-channel statistics (``stats.h5``) over the train split
(counterpart of ``deepcam_tpu/tools/summarize_data.py``).

Parity target: the reference's ``utils/summarize_data.py``: one pass over
``train/*.h5`` computing per-channel count, mean, mean of squares, min and
max, merged pairwise by weight, written to ``stats.h5`` under ``climate``
(``count``, ``mean``, ``sqmean``, ``minval``, ``maxval``), which
``data/dataset.py:CamDataset`` reads.  The reference runs under mpi4py;
here a thread pool covers a process's files (h5py releases the GIL), and
under a process group (``core/mesh.py``) each rank takes every size-th file
and the ranks' tokens are gathered through ``parallel/collectives.py`` and
merged in rank order; rank 0 writes.  h5py is imported inside the
functions.

    python -m deepcam_tpu_torch.tools.summarize_data --train_dir ROOT/train
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import os
from functools import reduce
from typing import Tuple

import numpy as np

Token = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]


def create_token(filename: str, data_format: str = "nhwc") -> Token:
    """One file's token: (count, mean, sqmean, min, max) per channel."""
    import h5py

    with h5py.File(filename, "r") as f:
        arr = f["climate"]["data"][...]
    ch_axis = 0 if data_format == "nchw" else arr.ndim - 1
    axes = tuple(i for i in range(arr.ndim) if i != ch_axis)
    count = np.full(arr.shape[ch_axis], float(arr.size // arr.shape[ch_axis]))
    return (count, arr.mean(axis=axes).astype(np.float64),
            (arr.astype(np.float64) ** 2).mean(axis=axes),
            arr.min(axis=axes).astype(np.float64), arr.max(axis=axes).astype(np.float64))


def merge_token(a: Token, b: Token) -> Token:
    """Pairwise weighted merge of two tokens."""
    ca, ma, sa, mina, maxa = a
    cb, mb, sb, minb, maxb = b
    c = ca + cb
    return (c, (ca * ma + cb * mb) / c, (ca * sa + cb * sb) / c, np.minimum(mina, minb),
            np.maximum(maxa, maxb))


def summarize(train_dir: str, out_path: str, num_workers: int = 8,
              data_format: str = "nhwc") -> Token:
    """Writes ``out_path`` (on rank 0) and returns the merged token."""
    from ..core.mesh import get_rank, get_size
    from ..parallel.collectives import allgather_object

    files = sorted(os.path.join(train_dir, x) for x in os.listdir(train_dir)
                   if x.endswith(".h5"))
    if not files:
        raise ValueError(f"no .h5 files in {train_dir}")
    mine = files[get_rank()::get_size()]
    with cf.ThreadPoolExecutor(max_workers=num_workers) as pool:
        tokens = list(pool.map(lambda f: create_token(f, data_format), mine))
    local = reduce(merge_token, tokens) if tokens else None
    token = reduce(merge_token, [t for t in allgather_object(local) if t is not None])
    if get_rank() == 0:
        import h5py

        with h5py.File(out_path, "w") as f:
            for name, value in zip(("count", "mean", "sqmean", "minval", "maxval"), token):
                f.create_dataset(f"climate/{name}", data=value)
    return token


def main(argv=None):
    p = argparse.ArgumentParser(description="Compute stats.h5 for the train split")
    p.add_argument("--train_dir", required=True)
    p.add_argument("--output", default=None, help="default: <train_dir>/../stats.h5")
    p.add_argument("--num_workers", type=int, default=8)
    args = p.parse_args(argv)
    out = args.output or os.path.join(os.path.dirname(args.train_dir.rstrip("/")),
                                      "stats.h5")
    summarize(args.train_dir, out, args.num_workers)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
