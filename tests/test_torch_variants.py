"""The model variants against the JAX package: output stride 8 with the
bilinear-interpolation decoder, fp32 on the CPU at (2, 32, 48, 16), from the
same (bridged) weights, in the default configuration
(``jax_default_config``); the fused units of that model, the resize op, and
the variants' construction, weight bridge and reference names.

Tolerances are those of ``tests/test_torch_model.py``: eval logits rtol
2e-3 and atol 1e-4 of the output scale, eval-mode gradients with random
running statistics 1e-4 of each leaf's largest entry outside the entry-flow
leaves, train logits rtol 1e-2 and atol 5e-3, BN running statistics 1e-4,
train-mode gradients within 2x the port's own spread under a 1e-7 input
nudge.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcam_tpu_torch.models.deeplab import DeepLabv3plus
from deepcam_tpu_torch.ops.interpolate import resize_bilinear_align_corners
from deepcam_tpu_torch.tools import weights
from deepcam_tpu_torch.tools.ref_names import reference_names, xception_names
from tests.test_torch_model import ENTRY, _forms, _leaf_errors, _spy_units
from tests.torch_port_ref import (
    assert_trees_close,
    few_torch_threads,  # noqa: F401  (pytestmark)
    flatten,
    jax_default_config,
    port_variables,
    release_memory,  # noqa: F401  (autouse)
)

pytestmark = pytest.mark.usefixtures("few_torch_threads")

SHAPE = (2, 32, 48, 16)
OS8 = dict(output_stride=8, decoder="interpolation")
# the port's initialisation from this seed, bridged to JAX, and the draws
# of the input, cotangent and running statistics from RNG_SEED
SEED, RNG_SEED = 1, 11


def test_os8_interpolation_matches_jax():
    """One test, so the JAX reference (one compile of both gradients) is
    computed once per run."""
    from deepcam_tpu.models.deeplab import DeepLabv3plus as JaxDeepLab

    rng = np.random.RandomState(RNG_SEED)
    x = rng.rand(*SHAPE).astype(np.float32)
    x_nudged = x * (1 + 1e-7 * rng.randn(*SHAPE)).astype(np.float32)
    ct = rng.randn(*SHAPE[:3], 3).astype(np.float32)
    variables = port_variables(SEED, **OS8)
    params = variables["params"]
    stats = jax.tree_util.tree_map(
        lambda a: (rng.rand(*a.shape).astype(np.float32) * 0.5
                   + (0.75 if a.sum() > 0 else -0.25)), variables["batch_stats"])
    with jax_default_config():
        jm = JaxDeepLab(n_classes=3, dtype=jnp.float32, **OS8)

        def eval_loss(p):
            logits = jm.apply({"params": p, "batch_stats": stats}, x, train=False)
            return jnp.sum(logits * ct), logits

        def train_loss(p):
            logits, upd = jm.apply({"params": p, "batch_stats": stats}, x, train=True,
                                   mutable=["batch_stats"])
            return jnp.sum(logits * ct), (logits, upd["batch_stats"])

        @jax.jit
        def both(p):
            return (jax.grad(eval_loss, has_aux=True)(p),
                    jax.grad(train_loss, has_aux=True)(p))

        (eval_grads, eval_logits), (grads, (train_logits, new_stats)) = both(params)

    port = DeepLabv3plus(3, dtype=torch.float32, device="cpu", **OS8)
    weights.load_jax_variables(port, params, stats)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731

    def port_grads():
        out, _ = weights.state_dict_to_jax(port, {k: p.grad for k, p in port.named_parameters()})
        port.zero_grad(set_to_none=True)
        return out

    logits = port.eval()(torch.from_numpy(x))
    (logits * torch.from_numpy(ct)).sum().backward()
    want = np.asarray(eval_logits)
    assert logits.shape == want.shape == (*SHAPE[:3], 3)
    np.testing.assert_allclose(logits.detach().numpy(), want, rtol=2e-3,
                               atol=1e-4 * np.abs(want).max())
    errs = _leaf_errors(port_grads(), np_tree(eval_grads))
    rest = {k: v for k, v in errs.items() if not k.startswith(ENTRY)}
    worst = max(rest, key=rest.get)
    assert rest[worst] <= 1e-4, (worst, rest[worst])

    logits = port.train()(torch.from_numpy(x))
    (logits * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(train_logits),
                               rtol=1e-2, atol=5e-3)
    _, port_stats = weights.state_dict_to_jax(port, port.state_dict())
    assert_trees_close(port_stats, np_tree(new_stats), 1e-4, "batch_stats")
    got = port_grads()
    (port(torch.from_numpy(x_nudged)) * torch.from_numpy(ct)).sum().backward()
    err = np.array(list(_leaf_errors(got, np_tree(grads)).values()))
    spread = np.array(list(_leaf_errors(port_grads(), got).values()))
    assert np.median(err) <= 2 * np.median(spread), (np.median(err), np.median(spread))
    assert err.max() <= 2 * spread.max(), (err.max(), spread.max())


def test_os8_units_forms_and_dilations(monkeypatch):
    """61 fused units per forward at output stride 8: block3's stride-1
    tail is the 61st, an affine unit at dilation 1 like block20's
    sepconv_last.  Train: stats 5, affine_stats 38, boundary_stats 16,
    affine 2; eval: base 5, affine 40, boundary 16.  pre_relu off for the
    unit 0s of blocks 1-4, both tails and conv3.  Dilation 1 in blocks 1-3
    and the two tails (8 units), 2 in the middle flow and block20's two
    units (50), 4 in conv3-5 (3)."""
    calls = _spy_units(monkeypatch)
    model = DeepLabv3plus(3, device="cpu", **OS8)
    x = torch.rand(1, 32, 48, 16)
    with torch.no_grad():
        for mode, want in (("train", {"stats": 5, "affine_stats": 38, "boundary_stats": 16,
                                      "affine": 2}),
                           ("eval", {"base": 5, "affine": 40, "boundary": 16})):
            calls.clear()
            getattr(model, mode)()(x)
            assert len(calls) == 61, mode
            assert _forms(calls) == want, mode
            assert sum(not c[3] for c in calls) == 4 + 2 + 1, mode
            dils = [c[4] for c in calls]
            assert {d: dils.count(d) for d in set(dils)} == {1: 8, 2: 50, 4: 3}, mode
            assert dils[:7] == [1] * 7 and dils[-3:] == [4] * 3, mode
            # block3's tail: 728→728 at stride 8 (4 x 6 here), after its two units
            assert calls[6][1:] == ((4, 6, 728), 728, False, 1), mode
            assert calls[-4][1:] == ((4, 6, 1024), 1024, False, 1), mode  # block20's tail


# (input size, output size): a 1x1 input, one input row or column, an
# output of size 1, odd sizes, the identity and a shrink
RESIZE_CASES = [((1, 1), (4, 6)), ((1, 5), (3, 7)), ((4, 1), (9, 2)), ((5, 7), (1, 1)),
                ((6, 9), (1, 4)), ((4, 6), (8, 12)), ((3, 5), (17, 23)), ((7, 11), (7, 11)),
                ((9, 13), (4, 5))]


def test_resize_matches_jax():
    """``F.interpolate(align_corners=True)`` against the JAX package's
    matrix form at RESIZE_CASES, fp32 within 1e-6 relative (one test: the
    cases take milliseconds, the module's memory fixture seconds); a bf16
    input comes back in bf16, an unchanged size as the input itself."""
    from deepcam_tpu.ops.interpolate import resize_bilinear_align_corners as jax_resize

    for in_hw, out_hw in RESIZE_CASES:
        x = np.random.RandomState(sum(in_hw + out_hw)).randn(2, *in_hw, 5).astype(np.float32)
        want = np.asarray(jax_resize(jnp.asarray(x), out_hw))
        xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        got = resize_bilinear_align_corners(xt, out_hw)
        assert tuple(got.shape) == (2, 5, *out_hw) and got.dtype == torch.float32, in_hw
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max(), err_msg=str(in_hw))
        assert (got is xt) == (in_hw == out_hw)
        assert resize_bilinear_align_corners(xt.bfloat16(), out_hw).dtype == torch.bfloat16


def test_variant_construction():
    """Output stride 8 with the deconv decoder raises at construction (the
    JAX model fails at its concat); an output stride other than 16 or 8
    and an unknown decoder raise; the ASPP rates follow the stride."""
    with pytest.raises(ValueError, match="output_stride=8 needs decoder='interpolation'"):
        DeepLabv3plus(3, output_stride=8, device="cpu")
    with pytest.raises(NotImplementedError, match="output_stride 4"):
        DeepLabv3plus(3, output_stride=4, decoder="interpolation", device="cpu")
    with pytest.raises(ValueError, match="unknown decoder"):
        DeepLabv3plus(3, decoder="bilinear", device="cpu")
    assert DeepLabv3plus(3, device="cpu").rates == (1, 6, 12, 18)
    model = DeepLabv3plus(3, device="cpu", **OS8)
    assert model.rates == (1, 12, 24, 36)
    assert [m.atrous_conv.dilation for m in (model.aspp2, model.aspp3, model.aspp4)] == [
        12, 24, 36]
    assert model.xception.block3.tail == "sepconv_last"
    assert model.xception.block3.skip_conv.stride == 1


def test_os8_weight_bridge_covers_the_jax_tree():
    """The bridge carries every leaf of the JAX os=8 interpolation model
    (its ``eval_shape``: traced, not computed) into the port's state_dict
    exactly once, block3's ``sepconv_last`` and the decoder's conv0, bn0,
    conv1, bn1 and conv2 (with its bias) included, and back."""
    from deepcam_tpu.models.deeplab import DeepLabv3plus as JaxDeepLab

    with jax_default_config():
        jm = JaxDeepLab(n_classes=3, dtype=jnp.float32, **OS8)
        shapes = jax.eval_shape(lambda r: jm.init(r, jnp.zeros((1, *SHAPE[1:])), train=False),
                                jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    variables = jax.tree_util.tree_map(lambda s: rng.randn(*s.shape).astype(np.float32),
                                       shapes)
    model = DeepLabv3plus(3, device="cpu", **OS8)
    sd = weights.jax_to_state_dict(model, variables["params"], variables["batch_stats"])
    assert sorted(sd) == sorted(model.state_dict())
    for key in ("xception.block3.sepconv_last.depthwise.weight", "upsample.conv2.bias",
                "upsample.bn1.running_var"):
        assert key in sd, key
    assert sorted(k for k in sd if k.startswith("upsample.")) == sorted(
        f"upsample.{m}.{t}" for m, ts in (
            ("conv0", ["weight"]), ("conv1", ["weight"]), ("conv2", ["weight", "bias"]),
            ("bn0", ["weight", "bias", "running_mean", "running_var"]),
            ("bn1", ["weight", "bias", "running_mean", "running_var"])) for t in ts)
    model.load_state_dict(sd, strict=True)
    back = weights.state_dict_to_jax(model, sd)
    for got, want in zip(back, (variables["params"], variables["batch_stats"])):
        g, w = flatten(got), flatten(want)
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


def test_reference_names_of_the_variants():
    """Block3's stride-1 tail takes the reference index of the stride-2
    one (``rep.6``: the tail follows the two units); the interpolation
    decoder has no reference schema, so naming it, and so saving such a
    model, raises."""
    os8, os16 = DeepLabv3plus(3, device="cpu", **OS8), DeepLabv3plus(3, device="cpu")
    with pytest.raises(NotImplementedError, match="interpolation"):
        reference_names(os8)
    names8, names16 = xception_names(os8.xception), xception_names(os16.xception)
    assert [r for _, r in names8] == [r for _, r in names16]
    assert [p.replace("sepconv_last", "sepconv_stride") if "block3." in p else p
            for p, _ in names8] == [p for p, _ in names16]
    assert dict(names8)["xception.block3.sepconv_last.pointwise.weight"] == (
        "xception_features.block3.rep.6.pointwise.weight")
    assert sorted(p for p, _ in names8) == sorted(
        k for k in os8.state_dict() if k.startswith("xception."))
