"""Offline 80/10/10 train/validation/test split by symlink (counterpart of
``deepcam_tpu/tools/split_data.py``).

Parity target: the reference's ``utils/split_data.py``: the files named
``data*.h5`` (so a ``stats.h5`` in the input directory stays out), shuffled
with ``np.random.seed(12345)``, 80% train, 10% validation, the rest test,
symlinked into ``{output}/{train,validation,test}``.

    python -m deepcam_tpu_torch.tools.split_data --input_dir IN --output_dir OUT
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def split_data(input_dir: str, output_dir: str, train_frac: float = 0.8,
               val_frac: float = 0.1, seed: int = 12345) -> dict:
    """Symlinks the split; returns the number of files per split."""
    files = sorted(x for x in os.listdir(input_dir)
                   if x.startswith("data") and x.endswith(".h5"))
    np.random.seed(seed)
    files = [files[i] for i in np.random.permutation(len(files))]
    n_train, n_val = int(len(files) * train_frac), int(len(files) * val_frac)
    splits = {"train": files[:n_train], "validation": files[n_train:n_train + n_val],
              "test": files[n_train + n_val:]}
    for split, names in splits.items():
        d = os.path.join(output_dir, split)
        os.makedirs(d, exist_ok=True)
        for name in names:
            dst = os.path.join(d, name)
            if not os.path.lexists(dst):
                os.symlink(os.path.abspath(os.path.join(input_dir, name)), dst)
    return {k: len(v) for k, v in splits.items()}


def main(argv=None):
    p = argparse.ArgumentParser(description="Split CAM5 HDF5 data by symlink")
    p.add_argument("--input_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--train_fraction", type=float, default=0.8)
    p.add_argument("--validation_fraction", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=12345)
    args = p.parse_args(argv)
    print(split_data(args.input_dir, args.output_dir, args.train_fraction,
                     args.validation_fraction, args.seed))


if __name__ == "__main__":
    main()
