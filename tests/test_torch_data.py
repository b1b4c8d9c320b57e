"""The port's data pipeline against the JAX package's, on the same
synthetic HDF5 files: file order under the construction-time shuffle,
sharding at 1-3 ranks (even for train, uneven for validation), fp32
samples bit-exact and bf16 samples bit-identical, labels, and the loader's
batches.  The in-memory dataset serves the same samples as the HDF5 one.

JAX and h5py are imported inside the tests that use them, so the ``gpu``
test runs on a machine with a card and neither:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_data.py
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

from deepcam_tpu_torch.data.dataset import CamDataset, MemoryCamDataset
from deepcam_tpu_torch.data.pipeline import DataLoader, prefetch_to_device
from deepcam_tpu_torch.data.synthetic import make_arrays

SHAPE = (12, 20)
N_TRAIN, N_VAL = 7, 5


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    from deepcam_tpu_torch.data.synthetic import make_synthetic_dataset

    return make_synthetic_dataset(str(tmp_path_factory.mktemp("data") / "d"),
                                  n_train=N_TRAIN, n_validation=N_VAL, shape=SHAPE, seed=4)


def _pair(root, split, **kw):
    from deepcam_tpu.data.dataset import CamDataset as JaxCamDataset

    args = (os.path.join(root, split), os.path.join(root, "stats.h5"))
    return CamDataset(*args, **kw), JaxCamDataset(*args, **kw)


def test_synthetic_files_are_bit_identical(root, tmp_path):
    from deepcam_tpu.data.synthetic import make_synthetic_dataset as jax_writer

    ref = jax_writer(str(tmp_path / "j"), n_train=N_TRAIN, n_validation=N_VAL,
                     shape=SHAPE, seed=4)
    names = sorted(os.path.relpath(os.path.join(d, f), ref)
                   for d, _, fs in os.walk(ref) for f in fs)
    assert len(names) == N_TRAIN + N_VAL + 1
    for name in names:
        with open(os.path.join(ref, name), "rb") as a, open(os.path.join(root, name), "rb") as b:
            assert a.read() == b.read(), name


@pytest.mark.parametrize("comm_size", [1, 2, 3])
@pytest.mark.parametrize("split,uneven,shuffle", [("train", False, True),
                                                  ("validation", True, False),
                                                  ("validation", True, True)])
def test_sharding_and_order_match_jax(root, comm_size, split, uneven, shuffle):
    for rank in range(comm_size):
        port, ref = _pair(root, split, channels=range(16), comm_size=comm_size,
                          comm_rank=rank, allow_uneven_distribution=uneven, shuffle=shuffle)
        assert port.all_files == ref.all_files
        assert port.files == ref.files
        assert (len(port), port.global_size) == (len(ref), ref.global_size)
        assert port.shapes == ref.shapes


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("channels", [list(range(16)), [0, 3, 5, 15]])
def test_samples_match_jax(root, bf16, channels):
    port, ref = _pair(root, "train", channels=channels, shuffle=True, bf16_out=bf16)
    np.testing.assert_array_equal(port.data_shift, ref.data_shift)
    np.testing.assert_array_equal(port.data_scale, ref.data_scale)
    for i in range(len(ref)):
        (pd, pl, pn), (jd, jl, jn) = port[i], ref[i]
        assert pn == jn and pd.shape == jd.shape == SHAPE + (len(channels),)
        if bf16:
            np.testing.assert_array_equal(pd, jd.view(np.uint16))
        else:
            assert pd.dtype == np.float32
            np.testing.assert_array_equal(pd, jd)
        np.testing.assert_array_equal(pl, jl)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("split,batch,drop_last", [("train", 2, True), ("validation", 2, False)])
def test_loader_batches_match_jax(root, bf16, split, batch, drop_last):
    from deepcam_tpu.data.pipeline import DataLoader as JaxDataLoader

    port, ref = _pair(root, split, channels=range(16), shuffle=True, bf16_out=bf16)
    got = list(DataLoader(port, batch, num_workers=3, drop_last=drop_last))
    want = list(JaxDataLoader(ref, batch, num_workers=3, drop_last=drop_last))
    assert len(got) == len(want) == (len(ref) // batch if drop_last else -(-len(ref) // batch))
    for (pd, pl, pn), (jd, jl, jn) in zip(got, want):
        assert pn == jn
        assert pd.dtype == (torch.bfloat16 if bf16 else torch.float32)
        bits = pd.view(torch.int16).numpy().view(np.uint16) if bf16 else pd.numpy()
        np.testing.assert_array_equal(bits, jd.view(np.uint16) if bf16 else jd)
        assert pl.dtype == torch.int32
        np.testing.assert_array_equal(pl.numpy(), jl)


def _memory_pair(tmp_path, **kw):
    from deepcam_tpu_torch.data.synthetic import make_synthetic_dataset

    root = make_synthetic_dataset(str(tmp_path / "m"), n_train=5, n_validation=3,
                                  shape=SHAPE, seed=9)
    splits, stats = make_arrays(root, n_train=5, n_validation=3, shape=SHAPE, seed=9)
    files = {name: (data, label) for samples in splits.values()
             for name, data, label in samples}
    args = (os.path.join(root, "train"), os.path.join(root, "stats.h5"), range(16))
    return MemoryCamDataset(*args, files=files, stats=stats, **kw), CamDataset(*args, **kw)


@pytest.mark.parametrize("bf16", [False, True])
def test_memory_dataset_matches_hdf5(tmp_path, bf16):
    mem, disk = _memory_pair(tmp_path, shuffle=True, bf16_out=bf16)
    assert mem.files == disk.files and mem.shapes == disk.shapes
    for i in range(len(disk)):
        (md, ml, mn), (dd, dl, dn) = mem[i], disk[i]
        assert mn == dn
        np.testing.assert_array_equal(md, dd)
        np.testing.assert_array_equal(ml, dl)


class _Slow:
    """A dataset whose reads finish in reverse order, and whose item
    ``fail`` raises."""

    def __init__(self, n, fail=None):
        self.n, self.fail = n, fail

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        time.sleep(0.002 * (self.n - i))
        if i == self.fail:
            raise OSError(f"read of sample {i} failed")
        return np.full((2, 3, 1), i, np.float32), np.full((2, 3), i, np.int64), f"s{i}"


def test_loader_order_does_not_follow_thread_completion():
    got = [names for _, _, names in DataLoader(_Slow(12), 3, num_workers=6)]
    assert got == [tuple(f"s{i}" for i in range(b, b + 3)) for b in range(0, 12, 3)]


def test_reader_exception_propagates_through_prefetch():
    before = threading.active_count()
    it = prefetch_to_device(DataLoader(_Slow(8, fail=5), 2, num_workers=3), "cpu")
    got = []
    with pytest.raises(OSError, match="sample 5"):
        for _, _, names in it:
            got.append(names)
    assert got == [("s0", "s1"), ("s2", "s3")]
    assert threading.active_count() == before  # the readers are gone


def test_prefetch_on_cpu_is_an_in_order_pass_through():
    items = [(torch.full((2,), float(i)), torch.zeros(2), (f"n{i}",)) for i in range(5)]
    got = list(prefetch_to_device(iter(items), "cpu", depth=2))
    assert all(g is w for g, w in zip(got, items)) and len(got) == 5


@pytest.mark.gpu
def test_prefetch_to_card_delivers_the_loader_batches():
    """Every batch the card receives equals the loader's host copy, read by
    a kernel on the compute stream while later copies are in flight and the
    stream is kept busy: a copy read before its event, or a pinned buffer
    refilled early, shows as a wrong batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    splits, stats = make_arrays("/d", n_train=12, n_validation=1, shape=(96, 144), seed=2)
    files = {name: (data, label) for samples in splits.values() for name, data, label in samples}
    for bf16 in (False, True):
        ds = MemoryCamDataset("/d/train", "/d/stats.h5", range(16), files=files, stats=stats,
                              shuffle=True, bf16_out=bf16)
        host = [(d.clone(), lb.clone()) for d, lb, _ in DataLoader(ds, 2, num_workers=2)]
        busy = torch.randn(2048, 2048, device="cuda")
        seen = []
        for d, lb, _ in prefetch_to_device(DataLoader(ds, 2, num_workers=2, pin_memory=True),
                                           "cuda", depth=2):
            for _ in range(4):
                busy = busy @ busy / busy.norm()  # keep the compute stream behind
            seen.append((d.clone(), lb.clone()))
        torch.cuda.synchronize()
        assert len(seen) == len(host) == 6
        for (d, lb), (hd, hl) in zip(seen, host):
            assert torch.equal(d.cpu(), hd) and torch.equal(lb.cpu(), hl)
