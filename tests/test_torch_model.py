"""The whole port DeepLabv3+ against the JAX model, fp32 on the CPU at
(2, 32, 48, 16), from the same (bridged) weights.

The JAX model runs in the port's configuration (``jax_base_config``: the
unfused XLA sepconv path, no BN fold, no kernel statistics, plain concats).
Tolerances as in ``tests/test_golden_model.py``: eval logits rtol 2e-3 and
atol 1e-4 of the output scale (random running statistics amplify the
activations to ~1e5 through 60 layers, and fp32 reduction-order differences
scale with them); train logits rtol 1e-2, atol 5e-3.  BN running statistics
within 1e-4 of each leaf's largest entry.  Gradients: see the comments in
``test_model_matches_jax`` (train-mode gradients are held to the port's own
spread under a 1e-7 input nudge, which is cheap: no second JAX run).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from deepcam_tpu_torch.models import layers as tl
from deepcam_tpu_torch.models.deeplab import DeepLabv3plus
from deepcam_tpu_torch.tools.weights import load_jax_variables, state_dict_to_jax
from tests.torch_port_ref import assert_trees_close, flatten, jax_base_config

SHAPE = (2, 32, 48, 16)


def _leaf_errors(got, want):
    """{leaf: max |got - want| / max |want|}."""
    g, w = flatten(got), flatten(want)
    assert sorted(g) == sorted(w)
    return {k: float(np.abs(g[k] - w[k]).max()) / max(float(np.abs(w[k]).max()), 1e-30)
            for k in w}


def _results():
    from deepcam_tpu.models.deeplab import DeepLabv3plus as JaxDeepLab

    rng = np.random.RandomState(11)
    x = rng.rand(*SHAPE).astype(np.float32)
    x_nudged = x * (1 + 1e-7 * rng.randn(*SHAPE)).astype(np.float32)
    ct = rng.randn(*SHAPE[:3], 3).astype(np.float32)
    with jax_base_config():
        jm = JaxDeepLab(n_classes=3, dtype=jnp.float32)
        variables = jax.jit(lambda r: jm.init(r, jnp.zeros((1, *SHAPE[1:])), train=False))(
            jax.random.PRNGKey(3))
        params = variables["params"]
        # random running statistics, so eval-mode normalization is non-trivial
        stats = jax.tree_util.tree_map(
            lambda a: jnp.asarray(rng.rand(*a.shape).astype(np.float32) * 0.5
                                  + (0.75 if a.sum() > 0 else -0.25)),
            variables["batch_stats"])

        def eval_loss(p):
            logits = jm.apply({"params": p, "batch_stats": stats}, x, train=False)
            return jnp.sum(logits * ct), logits

        def train_loss(p, x):
            logits, upd = jm.apply({"params": p, "batch_stats": stats}, x, train=True,
                                   mutable=["batch_stats"])
            return jnp.sum(logits * ct), (logits, upd["batch_stats"])

        eval_grads, eval_logits = jax.jit(jax.grad(eval_loss, has_aux=True))(params)
        train_grad = jax.jit(jax.grad(train_loss, has_aux=True))
        grads, (train_logits, new_stats) = train_grad(params, x)

    port = DeepLabv3plus(3, dtype=torch.float32, device="cpu")
    load_jax_variables(port, params, stats)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731

    def port_grads():
        out, _ = state_dict_to_jax(port, {k: p.grad for k, p in port.named_parameters()})
        port.zero_grad(set_to_none=True)
        return out

    logits = port.eval()(torch.from_numpy(x))
    (logits * torch.from_numpy(ct)).sum().backward()
    eval_out = (logits.detach().numpy(), port_grads())
    logits = port.train()(torch.from_numpy(x))
    (logits * torch.from_numpy(ct)).sum().backward()
    _, port_stats = state_dict_to_jax(port, port.state_dict())
    train_grads = port_grads()
    (port(torch.from_numpy(x_nudged)) * torch.from_numpy(ct)).sum().backward()
    return {
        "eval": (eval_out[0], np.asarray(eval_logits)),
        "eval_grads": (eval_out[1], np_tree(eval_grads)),
        "train": (logits.detach().numpy(), np.asarray(train_logits)),
        "stats": (port_stats, np_tree(new_stats)),
        "grads": (train_grads, np_tree(grads), port_grads()),
    }


ENTRY = ("xception/conv1/", "xception/bn1/", "xception/conv2/", "xception/bn2/",
         "xception/block1/")


def test_model_matches_jax():
    """One test, so the JAX reference is computed once per run (test
    workers each compute a module fixture anew)."""
    results = _results()

    # eval logits
    got, want = results["eval"]
    assert got.shape == want.shape == (*SHAPE[:3], 3)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=1e-4 * np.abs(want).max())

    # Eval-mode gradients of every parameter agree to fp32 noise (1e-4 of
    # the leaf's largest entry; measured median 2e-6) — except upstream of
    # block1's output, where one activation lies within rounding of zero at
    # this input: its ReLU mask (low-level tap / block2 entry) differs
    # between the frameworks and moves the 19 entry-flow leaves by ~1.5e-2
    # (measured), so those are held to 5e-2.
    errs = _leaf_errors(*results["eval_grads"])
    entry = {k: v for k, v in errs.items() if k.startswith(ENTRY)}
    rest = {k: v for k, v in errs.items() if k not in entry}
    worst = max(rest, key=rest.get)
    assert rest[worst] <= 1e-4, (worst, rest[worst])
    assert max(entry.values()) <= 5e-2, max(entry.values())

    # train logits and the BN running statistics
    got, want = results["train"]
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=5e-3)
    assert_trees_close(*results["stats"], 1e-4, "batch_stats")

    # Train-mode gradients of the whole model at this size are chaotic in
    # both stacks: a 1e-7 (relative) nudge of the input moves them by a few
    # percent of each leaf's largest entry (median leaf), in JAX as in the
    # port.  It comes from the depth of train-mode BNs over 12-value
    # populations (2 x 2 x 3 at stride 16), not from the GAP branch's
    # 2-value BN: zeroing that BN's scale leaves it, a larger input shrinks
    # it.  So the port is held to its own nudged run: two such perturbations
    # lie ~1.4x one apart, and the port must stay within 2x (median and
    # worst leaf).  The BN batch-statistics backward itself is held to 1e-4
    # where it is well-conditioned, block by block
    # (test_torch_layers.py::test_xception_block_train_matches_jax).
    got, want, nudged = results["grads"]
    port = np.array(list(_leaf_errors(got, want).values()))
    spread = np.array(list(_leaf_errors(nudged, got).values()))
    assert np.median(port) <= 2 * np.median(spread), (np.median(port), np.median(spread))
    assert port.max() <= 2 * spread.max(), (port.max(), spread.max())


def test_every_stride1_sepconv_runs_fused(monkeypatch):
    """60 fused units per forward: pre_relu off for each block's unit 0,
    sepconv_last and conv3; dilation 2 for exit conv3-5 only."""
    calls = []
    real = tl.fused_sepconv

    def spy(x, dwk, pwk, pre_relu, dilation):
        calls.append((x.shape[1:], pwk.shape[1], pre_relu, dilation))
        return real(x, dwk, pwk, pre_relu, dilation)

    monkeypatch.setattr(tl, "fused_sepconv", spy)
    model = DeepLabv3plus(3, device="cpu").eval()
    with torch.no_grad():
        model(torch.rand(1, 32, 48, 16))
    assert len(calls) == 60
    assert sum(not c[2] for c in calls) == 3 + 16 + 1 + 1 + 1  # unit 0s, last, conv3
    assert [c[3] for c in calls[-3:]] == [2, 2, 2] and {c[3] for c in calls[:-3]} == {1}
    assert [(c[0][-1], c[1]) for c in calls[-3:]] == [(1024, 1536), (1536, 1536), (1536, 2048)]
