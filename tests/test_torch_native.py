"""The port's native host routines (``deepcam_tpu_torch/ops/native``)
against numpy and against the JAX package's copy of the same library:
bit-exact in fp32, bit-identical bf16 patterns, on the native path and on
the numpy path a box without a compiler takes."""

import numpy as np
import pytest
import torch

from deepcam_tpu_torch.ops import native


def _sample(seed, h=9, w=13, c=16):
    rng = np.random.RandomState(seed)
    data = (50 * rng.randn(h, w, c)).astype(np.float32)
    shift = rng.randn(c).astype(np.float32)
    scale = (1.0 / (1.0 + rng.rand(c))).astype(np.float32)
    return data, shift, scale


@pytest.fixture(params=["native", "numpy"])
def path(request, monkeypatch):
    if request.param == "numpy":
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_failed", True)
    else:
        assert native.lib() is not None, "g++ could not build the native library"
    native.reset_uses()
    yield request.param
    assert native.USES[request.param] > 0
    assert native.USES["native" if request.param == "numpy" else "numpy"] == 0


def test_normalize_matches_numpy_and_jax_native(path):
    from deepcam_tpu.ops import native as jax_native

    data, shift, scale = _sample(0)
    got = native.normalize_hwc(data, shift, scale)
    np.testing.assert_array_equal(got, scale * (data - shift))
    np.testing.assert_array_equal(got, jax_native.normalize_hwc(data, shift, scale))


def test_normalize_bf16_bits_match_jax_native(path):
    from deepcam_tpu.ops import native as jax_native

    data, shift, scale = _sample(1)
    bits = native.normalize_hwc_bf16(data, shift, scale)
    assert bits.dtype == np.uint16 and bits.shape == data.shape
    want = jax_native.normalize_hwc_bf16(data, shift, scale)
    np.testing.assert_array_equal(bits, want.view(np.uint16))
    # torch's own fp32 -> bf16 cast rounds to nearest even as well
    ref = torch.from_numpy(scale * (data - shift)).bfloat16()
    assert torch.equal(native.as_bf16_tensor(bits), ref)


def test_stack_samples_matches_np_stack(path):
    samples = [_sample(s)[0] for s in range(3)]
    np.testing.assert_array_equal(native.stack_samples(samples), np.stack(samples))
    out = np.empty((3,) + samples[0].shape, np.float32)
    assert native.stack_samples(samples, out=out) is out
    np.testing.assert_array_equal(out, np.stack(samples))


def test_bad_operands_raise():
    data, shift, scale = _sample(2)
    with pytest.raises(ValueError):
        native.normalize_hwc(data, shift[:3], scale)
    with pytest.raises(ValueError):
        native.stack_samples([data, data[:, :5].copy()])
    with pytest.raises(TypeError):
        native.as_bf16_tensor(data)


def test_library_is_built_under_the_package():
    assert native.lib() is not None
    so = native.so_path()
    assert so.exists() and so.parent == native.BUILD_DIR
    assert so.parent.parent.parent.name == "deepcam_tpu_torch"
