"""The port's row-window copy (``deepcam_tpu_torch/analysis``) against the
archived Mosaic probe ``analysis/archive/probe_element_window.py``.

The probe runs its ``pallas_call`` at import, so the call is restated here
as it stands there (``pl.Element`` row windows of TH + 2D rows at offsets
t * TH), and run in interpret mode on the CPU.  The copy must be exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from deepcam_tpu_torch.analysis import probe_element_window as pw


def _pallas_windows(xp, th, d):
    """The probe's pallas_call, interpret mode, for any (N, rows, W, C)."""
    n, rows, w, c = xp.shape
    nht = (rows - 2 * d) // th

    def kernel(x_ref, o_ref):
        o_ref[0, 0] = x_ref[0]

    return pl.pallas_call(
        kernel,
        grid=(n, nht),
        in_specs=[pl.BlockSpec(
            (pl.Element(1), pl.Element(th + 2 * d), pl.Element(w), pl.Element(c)),
            lambda ni, hi: (ni, hi * th, 0, 0))],
        out_specs=pl.BlockSpec((1, 1, th + 2 * d, w, c), lambda ni, hi: (ni, hi, 0, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((n, nht, th + 2 * d, w, c), jnp.float32),
        interpret=True,
    )(xp)


@pytest.mark.parametrize("shape,th,d", [
    (pw.PROBE_SHAPE, pw.PROBE_TH, pw.PROBE_D),  # the probe's own
    ((1, 13, 5, 8), 3, 2),                      # a ragged last row tile
    ((3, 10, 4, 12), 2, 0),                     # no halo
])
def test_plain_matches_pallas_probe(shape, th, d):
    xp = np.random.RandomState(0).randn(*shape).astype(np.float32)
    want = np.asarray(_pallas_windows(jnp.asarray(xp), th, d))
    got = pw.row_windows_plain(torch.from_numpy(xp), th, d)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_cpu_tensor_takes_the_plain_version():
    pw.reset_launches()
    xp = torch.from_numpy(np.random.RandomState(1).randn(2, 10, 3, 4).astype(np.float32))
    out = pw.row_windows(xp, 4, 1)
    assert out.shape == (2, 2, 6, 3, 4)
    assert torch.equal(out[1, 1, 5], xp[1, 9])
    assert pw.LAUNCHES == {"row_windows": 0}


def test_kernel_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        pw.row_windows_kernel(torch.zeros(1, 6, 2, 4), 4, 1)
