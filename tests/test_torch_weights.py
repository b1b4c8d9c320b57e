"""The weight bridge covers every leaf of the JAX variables exactly once,
and every tensor of the port's state_dict."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcam_tpu_torch.models.deeplab import DeepLabv3plus
from deepcam_tpu_torch.tools import weights
from tests.torch_port_ref import flatten, jax_base_config


@pytest.fixture(scope="module")
def pair():
    """The port model and random JAX variables of the JAX model's shapes
    (``eval_shape``: traced, not computed)."""
    from deepcam_tpu.models.deeplab import DeepLabv3plus as JaxDeepLab

    with jax_base_config():
        jm = JaxDeepLab(n_classes=3, dtype=jnp.float32)
        shapes = jax.eval_shape(lambda r: jm.init(r, jnp.zeros((1, 32, 48, 16)), train=False),
                                jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    variables = jax.tree_util.tree_map(
        lambda s: rng.randn(*s.shape).astype(np.float32), shapes)
    return DeepLabv3plus(3, device="cpu"), variables["params"], variables["batch_stats"]


def test_bridge_assigns_every_leaf_once(pair):
    model, params, stats = pair
    sd = weights.jax_to_state_dict(model, params, stats)
    assert sorted(sd) == sorted(model.state_dict())
    targets = [(coll, path) for _, coll, path, _ in weights.assignments(model)]
    assert len(targets) == len(set(targets))
    n_leaves = len(flatten(params)) + len(flatten(stats))
    assert len(targets) == n_leaves == len(sd)
    for k, t in model.state_dict().items():
        assert sd[k].shape == t.shape, k
    model.load_state_dict(sd, strict=True)


def test_bridge_layouts(pair):
    model, params, stats = pair
    sd = weights.jax_to_state_dict(model, params, stats)
    dw = params["xception"]["block4"]["sepconv1"]["depthwise"]["kernel"]  # (3, 3, 1, C)
    np.testing.assert_array_equal(
        sd["xception.block4.sepconv1.depthwise.weight"][:, 0].numpy(),
        np.transpose(dw[:, :, 0, :], (2, 0, 1)))
    k = params["upsample"]["deconv3"]["kernel"]  # HWIO, no flip
    np.testing.assert_array_equal(sd["upsample.deconv3.weight"].numpy(),
                                  np.transpose(k, (2, 3, 0, 1)))
    np.testing.assert_array_equal(sd["xception.bn5.running_var"].numpy(),
                                  stats["xception"]["bn5"]["var"])


def test_bridge_round_trip(pair):
    model, params, stats = pair
    sd = weights.jax_to_state_dict(model, params, stats)
    back_p, back_s = weights.state_dict_to_jax(model, sd)
    for got, want in ((back_p, params), (back_s, stats)):
        g, w = flatten(got), flatten(want)
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


def test_bridge_to_jax_copies(pair):
    """A later in-place update of a port tensor (the running statistics of
    a train step) leaves an earlier snapshot as it was."""
    model, _, _ = pair
    var = model.xception.bn5.running_var
    _, stats = weights.state_dict_to_jax(model, model.state_dict())
    before = stats["xception"]["bn5"]["var"].copy()
    var.add_(1.0)
    try:
        np.testing.assert_array_equal(stats["xception"]["bn5"]["var"], before)
    finally:
        var.sub_(1.0)


def test_bridge_raises_on_unassigned(pair):
    model, params, stats = pair
    extra = {**params, "extra": {"kernel": np.zeros((1,), np.float32)}}
    with pytest.raises(KeyError, match="not assigned"):
        weights.jax_to_state_dict(model, extra, stats)
    missing = {k: v for k, v in params.items() if k != "gap_conv"}
    with pytest.raises(KeyError, match="gap_conv"):
        weights.jax_to_state_dict(model, missing, stats)
    model.register_parameter("extra", torch.nn.Parameter(torch.zeros(1)))
    try:
        with pytest.raises(KeyError, match="port tensors not assigned"):
            weights.jax_to_state_dict(model, params, stats)
    finally:
        del model.extra
