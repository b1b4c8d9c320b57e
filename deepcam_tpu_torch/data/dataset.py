"""HDF5 CAM5 dataset with the reference's sharding and normalization
(counterpart of ``deepcam_tpu/data/dataset.py``).

* file list: the sorted ``*.h5`` of the source directory, optionally
  shuffled ONCE at construction with ``np.random.RandomState(12345)``, so
  every epoch repeats that order;
* sharding by rank: ``allow_uneven_distribution=False`` (train) gives every
  rank ``floor(N/size)`` files and sets ``global_size = size * floor``;
  ``True`` (validation) lets the LAST rank take the remainder;
* normalization: min-max to [0, 1] from ``stats.h5``, ``scale * (data -
  shift)`` with ``shift = minval[channels]`` and ``scale = 1/(maxval -
  minval)``, through the native routine (``ops/native``);
* samples stay HWC (channels last), the on-disk layout and the model's
  NHWC input.

All access to storage sits in three methods: ``_list`` (the sample names),
``_read_stats`` (minval, maxval) and ``_read`` (one sample's data and
label).  ``h5py`` is imported inside them, so the module imports on a
machine without it.  ``MemoryCamDataset`` replaces those three and nothing
else: it serves the arrays the HDF5 writer would write
(``data/synthetic.py``) from memory, through the same normalization,
sharding and loader code.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..ops import native

# the reference's construction-time shuffle seed (cam_hdf5_dataset.py)
SHUFFLE_SEED = 12345


class CamDataset:
    """Map-style dataset over a directory of ``.h5`` CAM5 files.

    ``bf16_out`` emits each normalized sample as bf16 in one native pass,
    held as its bit patterns in a ``uint16`` array (numpy has no bf16);
    ``ops.native.as_bf16_tensor`` views it as a ``torch.bfloat16`` tensor.
    """

    def __init__(self, source: str, statsfile: str, channels: Sequence[int],
                 allow_uneven_distribution: bool = False, shuffle: bool = False,
                 comm_size: int = 1, comm_rank: int = 0, bf16_out: bool = False):
        self.source = source
        self.statsfile = statsfile
        self.channels = list(channels)
        self.shuffle = shuffle
        self.comm_size = comm_size
        self.comm_rank = comm_rank
        self.allow_uneven_distribution = allow_uneven_distribution
        self.bf16_out = bf16_out

        self.all_files = sorted(self._list(source))
        self.rng = np.random.RandomState(SHUFFLE_SEED)
        self._init_reader()

        data, label = self._read(self.files[0])
        self.data_shape = data.shape[:-1] + (len(self.channels),)
        self.label_shape = label.shape

        minval, maxval = self._read_stats(statsfile)
        shift = minval[self.channels]
        scale = 1.0 / (maxval[self.channels] - shift)
        self.data_shift = shift.astype(np.float32).reshape(1, 1, -1)
        self.data_scale = scale.astype(np.float32).reshape(1, 1, -1)

    # -- storage --------------------------------------------------------------

    def _list(self, source: str) -> List[str]:
        return [os.path.join(source, x) for x in os.listdir(source) if x.endswith(".h5")]

    def _read_stats(self, statsfile: str) -> Tuple[np.ndarray, np.ndarray]:
        import h5py

        with h5py.File(statsfile, "r") as f:
            return f["climate"]["minval"][...], f["climate"]["maxval"][...]

    def _read(self, filename: str) -> Tuple[np.ndarray, np.ndarray]:
        """(data[H, W, C_all], label[H, W]) as stored."""
        import h5py

        with h5py.File(filename, "r") as f:
            return f["climate/data"][...], f["climate/labels_0"][...]

    # -- sharding and samples ---------------------------------------------------

    def _init_reader(self):
        if self.shuffle:
            self.rng.shuffle(self.all_files)
        self.global_size = len(self.all_files)
        num_files_local = self.global_size // self.comm_size
        start_idx = self.comm_rank * num_files_local
        if self.allow_uneven_distribution and self.comm_rank == self.comm_size - 1:
            end_idx = self.global_size
        else:
            end_idx = start_idx + num_files_local
        self.files = self.all_files[start_idx:end_idx]
        if not self.allow_uneven_distribution:
            self.global_size = self.comm_size * len(self.files)
        self.local_size = len(self.files)

    def __len__(self) -> int:
        return self.local_size

    @property
    def shapes(self):
        return self.data_shape, self.label_shape

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray, str]:
        """(data[H, W, C] normalized, label[H, W], filename)."""
        filename = self.files[idx]
        data, label = self._read(filename)
        if self.channels != list(range(data.shape[-1])):
            data = data[..., self.channels]
        normalize = native.normalize_hwc_bf16 if self.bf16_out else native.normalize_hwc
        return normalize(data, self.data_shift, self.data_scale), label, filename


class MemoryCamDataset(CamDataset):
    """``CamDataset`` over samples held in memory: ``files`` maps each
    sample's path to its (data, label) arrays, and ``stats`` is
    ``{"minval": ..., "maxval": ...}``, as ``synthetic.make_arrays`` gives
    them.  Only the storage methods differ from ``CamDataset``."""

    def __init__(self, source: str, statsfile: str, channels: Sequence[int], *,
                 files: Dict[str, Tuple[np.ndarray, np.ndarray]],
                 stats: Dict[str, np.ndarray], **kw):
        self._files = files
        self._stats = stats
        super().__init__(source, statsfile, channels, **kw)

    def _list(self, source: str) -> List[str]:
        return [k for k in self._files if os.path.dirname(k) == source]

    def _read_stats(self, statsfile: str) -> Tuple[np.ndarray, np.ndarray]:
        return self._stats["minval"], self._stats["maxval"]

    def _read(self, filename: str) -> Tuple[np.ndarray, np.ndarray]:
        return self._files[filename]
