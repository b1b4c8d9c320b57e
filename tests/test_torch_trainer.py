"""The port's loss, metrics, optimizer and train step against the JAX
package, on the CPU.

The loss, the IoU score and the argmax agree to fp32 noise (1e-6).  AdamW
is held to ``optax.adamw`` update by update (1e-6).  Two train steps of
``make_train_step`` and one eval step of ``make_eval_step`` run on both
stacks from the same weights and batches (the JAX steps on a one-device
mesh, in the JAX default configuration, which is the port's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepcam_tpu.ops.classify import argmax_channels as jax_argmax
from deepcam_tpu.train import losses as jl
from deepcam_tpu.train import metrics as jmet
from deepcam_tpu_torch.models.deeplab import DeepLabv3plus
from deepcam_tpu_torch.ops.classify import argmax_channels
from deepcam_tpu_torch.tools.weights import load_jax_variables, state_dict_to_jax
from deepcam_tpu_torch.train import losses as tl
from deepcam_tpu_torch.train.metrics import compute_score, per_sample_iou
from deepcam_tpu_torch.train.optim import build_optimizer
from deepcam_tpu_torch.train.trainer import create_train_state, make_eval_step, make_train_step
from tests.torch_port_ref import flatten, jax_default_config, port_variables
from tests.torch_port_ref import release_memory  # noqa: F401  (autouse)

LR, EPS, WD = 1e-3, 1e-8, 1e-2


def test_class_weights_match_jax():
    assert tl.class_weights() == jl.class_weights()
    assert (tl.FPW_1, tl.FPW_2) == (jl.FPW_1, jl.FPW_2)


@pytest.mark.parametrize("n_classes", [3, 11])
def test_weighted_ce_loss_matches_jax(n_classes):
    rng = np.random.RandomState(0)
    logits = (3 * rng.randn(2, 8, 12, n_classes)).astype(np.float32)
    labels = rng.randint(0, n_classes, size=(2, 8, 12)).astype(np.int32)
    weight = list(rng.rand(n_classes) + 0.5)
    want = float(jl.weighted_ce_loss(jnp.asarray(logits), jnp.asarray(labels), weight))
    got = float(tl.weighted_ce_loss(torch.from_numpy(logits), torch.from_numpy(labels), weight))
    assert abs(got - want) <= 1e-6 * abs(want)


def test_compute_score_and_argmax_match_jax():
    rng = np.random.RandomState(1)
    logits = rng.randint(0, 3, size=(2, 8, 12, 3)).astype(np.float32)  # many ties
    labels = rng.randint(0, 2, size=(2, 8, 12)).astype(np.int32)  # class 2 absent
    preds = argmax_channels(torch.from_numpy(logits))
    np.testing.assert_array_equal(preds.numpy(), np.asarray(jax_argmax(jnp.asarray(logits))))
    for p in (preds, torch.from_numpy(labels)):  # the second: perfect score
        want = float(jmet.compute_score(jnp.asarray(p.numpy()), jnp.asarray(labels), 3))
        got = float(compute_score(p, torch.from_numpy(labels), 3))
        assert abs(got - want) <= 1e-6
    # every class absent from both: each empty union scores 1.0
    zeros = torch.zeros(2, 4, 4, dtype=torch.int32)
    assert float(compute_score(zeros, zeros, 3)) == 1.0


def test_per_sample_iou_matches_jax():
    rng = np.random.RandomState(4)
    preds = rng.randint(0, 3, size=(4, 8, 12)).astype(np.int32)
    labels = rng.randint(0, 3, size=(4, 8, 12)).astype(np.int32)
    labels[1] = preds[1]           # a perfect sample
    labels[2][labels[2] == 2] = 0  # class 2 absent from the labels
    preds[3][:] = 0                # one class predicted everywhere
    want = np.asarray(jmet.per_sample_iou(jnp.asarray(preds), jnp.asarray(labels), 3))
    got = per_sample_iou(torch.from_numpy(preds), torch.from_numpy(labels), 3).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert got[1] == 1.0


def test_adamw_matches_optax():
    rng = np.random.RandomState(2)
    params = {"a": rng.randn(5, 7).astype(np.float32), "b": rng.randn(3).astype(np.float32)}
    tx = optax.adamw(LR, b1=0.9, b2=0.999, eps=EPS, weight_decay=WD)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(params[k].copy())) for k in ("a", "b")]
    opt = build_optimizer("AdamW", tp, LR, eps=EPS, weight_decay=WD)
    for _ in range(4):
        grads = {k: rng.randn(*v.shape).astype(np.float32) for k, v in params.items()}
        updates, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for t, k in zip(tp, ("a", "b")):
            t.grad = torch.from_numpy(grads[k])
        opt.step()
    for t, k in zip(tp, ("a", "b")):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-6)


def test_only_adamw_is_ported():
    with pytest.raises(NotImplementedError):
        build_optimizer("LAMB", [torch.nn.Parameter(torch.zeros(1))], LR)


def _two_steps():
    """Two AdamW train steps from the same weights on JAX, on the port, and
    on the port again with every input nudged by 1e-7 (relative): the last
    run measures how far the port moves from itself under fp32-sized
    perturbations."""
    from deepcam_tpu.core import mesh as meshlib
    from deepcam_tpu.models.deeplab import DeepLabv3plus as JaxDeepLab
    from deepcam_tpu.train.optim import build_optimizer as jax_build_optimizer
    from deepcam_tpu.train.trainer import create_train_state as jax_create_state
    from deepcam_tpu.train.trainer import make_train_step as jax_make_step

    rng = np.random.RandomState(3)
    batches = [(rng.rand(2, 32, 48, 16).astype(np.float32),
                rng.randint(0, 3, size=(2, 32, 48)).astype(np.int32)) for _ in range(2)]
    nudged = [((x * (1 + 1e-7 * rng.randn(*x.shape))).astype(np.float32), y)
              for x, y in batches]
    weights = list(jl.class_weights())
    with jax_default_config():
        jm = JaxDeepLab(n_classes=3, dtype=jnp.float32)
        # host copies: the JAX step donates (and so deletes) its state buffers
        variables = port_variables(21)
        mesh = meshlib.make_mesh(devices=jax.devices()[:1])
        tx = jax_build_optimizer("AdamW", LR, eps=EPS, weight_decay=WD)
        step = jax_make_step(jm, tx, weights, mesh, fpw_1=jl.FPW_1, fpw_2=jl.FPW_2)
        state = jax.device_put(jax_create_state(jm, variables, tx), meshlib.replicated(mesh))
        ref_m = []
        for x, y in batches:
            state, m = step(state, jnp.asarray(x), jnp.asarray(y))
            ref_m.append({k: float(v) for k, v in m.items()})
        ref = (ref_m, jax.tree_util.tree_map(np.asarray, state.params),
               jax.tree_util.tree_map(np.asarray, state.batch_stats))

    def run_port(data):
        model = DeepLabv3plus(3, dtype=torch.float32, device="cpu")
        load_jax_variables(model, variables["params"], variables["batch_stats"])
        opt = build_optimizer("AdamW", model.parameters(), LR, eps=EPS, weight_decay=WD)
        pstate = create_train_state(model, opt)
        pstep = make_train_step(tl.class_weights(), fpw_1=tl.FPW_1, fpw_2=tl.FPW_2)
        metrics = []
        for x, y in data:
            pstate, m = pstep(pstate, torch.from_numpy(x), torch.from_numpy(y))
            metrics.append({k: float(v) for k, v in m.items()})
        assert pstate.step == len(data)
        return (metrics, *state_dict_to_jax(model, model.state_dict()))

    return {"port": run_port(batches), "jax": ref, "port_nudged": run_port(nudged),
            "start": variables["params"]}


def _entry_diffs(a, b):
    a, b = flatten(a), flatten(b)
    return np.concatenate([np.abs(a[k] - b[k]).ravel() for k in b])


def _leaf_errs(a, b):
    a, b = flatten(a), flatten(b)
    return np.array([np.abs(a[k] - b[k]).max() / max(np.abs(b[k]).max(), 1e-30) for k in b])


def test_two_train_steps_match_jax():
    """One test, so the JAX run happens once per run (test workers each
    compute a module fixture anew)."""
    runs = _two_steps()
    (port_m, port_p, port_s), (ref_m, ref_p, ref_s), (nud_m, nud_p, nud_s) = (
        runs[k] for k in ("port", "jax", "port_nudged"))

    # Step 1 runs on identical weights: loss and IoU to fp32 noise.  Step 2
    # runs on weights after one update, and the train-mode gradients of the
    # randomly initialised net are chaotic at this size (see
    # test_torch_model.py): its loss must agree with JAX within 2x the
    # distance between the port and the port on nudged inputs.
    assert abs(port_m[0]["loss"] - ref_m[0]["loss"]) <= 1e-5 * ref_m[0]["loss"]
    assert abs(port_m[0]["iou"] - ref_m[0]["iou"]) <= 1e-6
    spread = abs(nud_m[1]["loss"] - port_m[1]["loss"])
    assert abs(port_m[1]["loss"] - ref_m[1]["loss"]) <= 2 * spread + 1e-6 * ref_m[1]["loss"]

    # Parameters after two AdamW steps: as close to JAX's as the port's own
    # nudged run (median and 99th percentile of the entry-wise differences
    # within 2x), and both stacks really moved (median |Δ| > lr).
    port = _entry_diffs(port_p, ref_p)
    nudge = _entry_diffs(nud_p, port_p)
    assert np.median(_entry_diffs(runs["start"], ref_p)) > LR
    for q in (0.5, 0.99):
        assert np.quantile(port, q) <= 2 * np.quantile(nudge, q), q

    # BN running statistics, leaf by leaf relative to the leaf's largest
    # entry: median and worst within 2x the port's nudged run.
    port, nudge = _leaf_errs(port_s, ref_s), _leaf_errs(nud_s, port_s)
    assert np.median(port) <= 2 * np.median(nudge)
    assert port.max() <= 2 * nudge.max()


def test_eval_step_matches_jax():
    """One eval step on both stacks from the same weights (the JAX step on a
    one-device mesh, full-resolution logits) on a batch of 3 whose second
    sample is masked out: the count exactly, the summed per-sample loss
    within 1e-5 and the summed per-sample IoU within 1e-6."""
    from deepcam_tpu.core import mesh as meshlib
    from deepcam_tpu.models.deeplab import DeepLabv3plus as JaxDeepLab
    from deepcam_tpu.train.optim import build_optimizer as jax_build_optimizer
    from deepcam_tpu.train.trainer import create_train_state as jax_create_state
    from deepcam_tpu.train.trainer import make_eval_step as jax_make_eval

    rng = np.random.RandomState(5)
    x = rng.rand(3, 32, 48, 16).astype(np.float32)
    y = rng.randint(0, 3, size=(3, 32, 48)).astype(np.int32)
    valid = np.array([1, 0, 1], np.int32)
    weights = list(jl.class_weights())
    with jax_default_config():
        jm = JaxDeepLab(n_classes=3, dtype=jnp.float32)
        variables = port_variables(22)
        mesh = meshlib.make_mesh(devices=jax.devices()[:1])
        tx = jax_build_optimizer("AdamW", LR, eps=EPS, weight_decay=WD)
        state = jax.device_put(jax_create_state(jm, variables, tx), meshlib.replicated(mesh))
        eval_fn = jax_make_eval(jm, weights, mesh, fpw_1=jl.FPW_1, fpw_2=jl.FPW_2)
        want = [float(v) for v in eval_fn(state, jnp.asarray(x), jnp.asarray(y),
                                           jnp.asarray(valid))]

    model = DeepLabv3plus(3, dtype=torch.float32, device="cpu")
    load_jax_variables(model, variables["params"], variables["batch_stats"])
    opt = build_optimizer("AdamW", model.parameters(), LR, eps=EPS, weight_decay=WD)
    pstate = create_train_state(model, opt)
    peval = make_eval_step(tl.class_weights(), fpw_1=tl.FPW_1, fpw_2=tl.FPW_2)
    got = [float(v) for v in peval(pstate, torch.from_numpy(x), torch.from_numpy(y),
                                   torch.from_numpy(valid))]
    assert got[0] == want[0] == 2.0
    assert abs(got[1] - want[1]) <= 1e-5 * abs(want[1]), (got, want)
    assert abs(got[2] - want[2]) <= 1e-6, (got, want)
    assert pstate.step == 0 and not model.training
