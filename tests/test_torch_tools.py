"""The port's offline data tools against the JAX package's: the 80/10/10
symlink split, and ``stats.h5`` (one pass, and two rank shards merged
through ``merge_token``), which the port's ``CamDataset`` then reads."""

import os

import h5py
import numpy as np
import pytest

from deepcam_tpu.tools import split_data as jax_split
from deepcam_tpu.tools import summarize_data as jax_summarize
from deepcam_tpu_torch.core import mesh
from deepcam_tpu_torch.data.dataset import CamDataset
from deepcam_tpu_torch.data.synthetic import make_synthetic_dataset
from deepcam_tpu_torch.parallel import collectives
from deepcam_tpu_torch.tools import split_data, summarize_data
from tests.torch_port_ref import release_memory  # noqa: F401

STATS = ("count", "mean", "sqmean", "minval", "maxval")


@pytest.mark.parametrize("n_files", [7, 23])
def test_split_matches_jax(tmp_path, n_files):
    """The same files in each split (seed 12345), ``data*.h5`` only, as
    symlinks to the inputs; the CLI prints the counts."""
    src = tmp_path / "all"
    src.mkdir()
    for i in range(n_files):
        (src / f"data-2001-01-{i:02d}-0-1.h5").write_bytes(b"")
    for stray in ("stats.h5", "notes.txt", "other.h5"):
        (src / stray).write_bytes(b"")
    counts = split_data.split_data(str(src), str(tmp_path / "port"))
    ref = jax_split.split_data(str(src), str(tmp_path / "jax"))
    assert counts == ref and sum(counts.values()) == n_files
    for split in ("train", "validation", "test"):
        got = sorted(os.listdir(tmp_path / "port" / split))
        assert got == sorted(os.listdir(tmp_path / "jax" / split)), split
        assert all(os.path.realpath(tmp_path / "port" / split / f) == str(src / f) for f in got)
    split_data.main(["--input_dir", str(src), "--output_dir", str(tmp_path / "again")])


@pytest.fixture
def train_dir(tmp_path):
    root = make_synthetic_dataset(str(tmp_path / "data"), n_train=4, n_validation=1,
                                  shape=(16, 24), seed=5)
    return os.path.join(root, "train")


def _read_stats(path):
    with h5py.File(path, "r") as f:
        return [f["climate"][k][...] for k in STATS]


def test_summarize_matches_jax_and_the_dataset_reads_it(train_dir, tmp_path):
    """``stats.h5`` within 1e-6 (relative, each array) of the JAX tool's; the
    port's ``CamDataset`` normalizes with its minval and maxval."""
    port, ref = str(tmp_path / "port_stats.h5"), str(tmp_path / "jax_stats.h5")
    token = summarize_data.summarize(train_dir, port, num_workers=2)
    jax_summarize.summarize(train_dir, ref, num_workers=2)
    for name, got, want in zip(STATS, _read_stats(port), _read_stats(ref)):
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=name)
    for got, want in zip(token, _read_stats(port)):
        np.testing.assert_array_equal(got, want)
    ds = CamDataset(train_dir, port, channels=list(range(16)))
    minval, maxval = _read_stats(port)[3:]
    np.testing.assert_allclose(ds.data_shift.ravel(), minval.astype(np.float32))
    np.testing.assert_allclose(ds.data_scale.ravel(), (1.0 / (maxval - minval)).astype(np.float32),
                               rtol=1e-6)
    data, _, _ = ds[0]
    assert data.shape == (16, 24, 16) and np.isfinite(data).all()
    assert data.min() >= -1e-6 and data.max() <= 1 + 1e-6
    summarize_data.main(["--train_dir", train_dir, "--num_workers", "1"])
    assert os.path.isfile(os.path.join(os.path.dirname(train_dir), "stats.h5"))


def test_two_rank_shards_merge_to_the_single_pass(train_dir, tmp_path, monkeypatch):
    """Under a process group of 2 each rank summarizes every second file;
    the ranks' tokens, merged through ``merge_token`` in rank order, equal
    the single pass within 1e-12 (relative: the same sums in another
    order), and only rank 0 writes."""
    single = summarize_data.summarize(train_dir, str(tmp_path / "one.h5"), num_workers=1)
    gathered = []
    monkeypatch.setattr(mesh, "get_size", lambda: 2)
    monkeypatch.setattr(collectives, "allgather_object",
                        lambda v: gathered.append(v) or [v])
    for rank in (0, 1):
        monkeypatch.setattr(mesh, "get_rank", lambda r=rank: r)
        summarize_data.summarize(train_dir, str(tmp_path / f"rank{rank}.h5"), num_workers=1)
    assert os.path.isfile(tmp_path / "rank0.h5") and not os.path.exists(tmp_path / "rank1.h5")
    files = sorted(os.listdir(train_dir))
    assert gathered[0][0][0] == gathered[1][0][0] == 2 * 16 * 24  # two files each
    merged = summarize_data.merge_token(*gathered)
    for got, want in zip(merged, single):
        np.testing.assert_allclose(got, want, rtol=1e-12)
    by_hand = summarize_data.merge_token(
        *[summarize_data.merge_token(*[summarize_data.create_token(
            os.path.join(train_dir, f)) for f in files[r::2]]) for r in (0, 1)])
    for got, want in zip(by_hand, merged):
        np.testing.assert_array_equal(got, want)
