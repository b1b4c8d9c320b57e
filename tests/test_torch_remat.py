"""``--remat`` on the CPU (``models/layers.py:rematerialized``): the port's
rematerialized train step against JAX's ``make_train_step(remat=True)``,
bit for bit against its own step without remat, with the forward run
twice and the BN running statistics moved once per step.  fp32 on the
kernels' plain versions, (2, 32, 48, 16) batches, the JAX default
configuration.  The same bits under DDP, ``--spatial 2`` and gspmd are
checked inside the rank runs of ``tests/test_torch_dist.py``,
``tests/test_torch_spatial.py`` and ``tests/test_torch_gspmd.py``.
"""

import numpy as np
import pytest
import torch

from deepcam_tpu_torch.models import layers
from deepcam_tpu_torch.models.deeplab import DeepLabv3plus
from deepcam_tpu_torch.ops import fused_sepconv as fs
from deepcam_tpu_torch.tools.weights import load_jax_variables, state_dict_to_jax
from deepcam_tpu_torch.train import losses as tl
from deepcam_tpu_torch.train.optim import build_optimizer
from deepcam_tpu_torch.train.trainer import create_train_state, make_train_step, running_stats
from tests.torch_port_ref import flatten, release_memory  # noqa: F401  (autouse)
from tests.torch_port_ref import few_torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_torch_threads")

SEED = 21
LR, EPS, WD = 1e-3, 1e-8, 1e-2
# fused units per train step (the os=16 model)
UNITS = 60
NUDGES = 2


def _batches(n=2):
    rng = np.random.RandomState(8)
    return [(torch.from_numpy(rng.rand(2, 32, 48, 16).astype(np.float32)),
             torch.from_numpy(rng.randint(0, 3, size=(2, 32, 48)).astype(np.int32)))
            for _ in range(n)]


def _state(model):
    return create_train_state(model, build_optimizer("AdamW", model.parameters(), LR,
                                                     eps=EPS, weight_decay=WD))


def _step(remat):
    return make_train_step(tl.class_weights(), fpw_1=tl.FPW_1, fpw_2=tl.FPW_2, remat=remat)


def _random_running_stats(model):
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for b in running_stats(model):
            b.copy_(torch.rand(b.shape, generator=gen) + 0.5)


def test_jax_remat_keeps_no_residual_inside_the_model():
    """What the port's remat must keep: JAX's ``dots_with_no_batch_dims_saveable``
    on the model's apply (the JAX steps' ``remat=True``) saves no residual
    inside the model, only the parameters, the input, constants and the
    loss's own residuals, because the model has no dot product without batch
    dimensions (``jax.ad_checkpoint.print_saved_residuals`` at (2, 32, 48,
    16), XLA sepconv path, the JAX default configuration).  Without remat
    the model's residuals are hundreds.  So ``layers.rematerialized``
    checkpoints the whole forward with no selective policy."""
    import contextlib
    import io

    import jax
    import jax.numpy as jnp
    from jax.ad_checkpoint import print_saved_residuals

    from deepcam_tpu.models.deeplab import DeepLabv3plus as JaxDeepLab
    from deepcam_tpu.train.losses import weighted_ce_loss
    from tests.torch_port_ref import jax_default_config, port_variables

    (x, y), = _batches(1)
    variables = port_variables(SEED)
    counts = {}
    with jax_default_config():
        jm = JaxDeepLab(n_classes=3, dtype=jnp.float32)

        def apply(params, x):
            return jm.apply({"params": params, "batch_stats": variables["batch_stats"]}, x,
                            train=True, mutable=["batch_stats"])[0]

        for remat in (True, False):
            fn = (jax.checkpoint(apply, policy=jax.checkpoint_policies.
                                 dots_with_no_batch_dims_saveable) if remat else apply)

            def loss(params):
                return weighted_ce_loss(fn(params, jnp.asarray(x.numpy())),
                                        jnp.asarray(y.numpy()), list(tl.class_weights()))

            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                print_saved_residuals(loss, variables["params"])
            lines = out.getvalue().splitlines()
            inside = [line for line in lines if not any(
                src in line for src in ("from the argument", "from a literal",
                                        "from a constant", "losses.py"))]
            counts[remat] = (len(lines), len(inside))
    jax.clear_caches()
    assert counts[True][1] == 0 and counts[True][0] > 300, counts
    assert counts[False][1] > 500, counts


def test_remat_steps_match_jax_remat_steps():
    """Two steps of JAX's ``make_train_step(remat=True)`` (a one-device
    mesh, one compile) and of the port's, from the same weights
    (``port_variables``) and batches, held as ``tests/test_torch_trainer.py``
    holds the steps without remat.  Step 1 runs on the same weights: its
    loss within 1e-5 relative.  Step 2's loss, the entry conv's kernel
    (median and 99th percentile of its entries' distance) and the BN
    running statistics (leaf by leaf relative to the leaf's largest entry,
    median and worst), within 2x the port's own distance under a 1e-7
    input nudge, the largest over NUDGES runs: train-mode gradients at init
    are chaotic.  The statistics take one momentum update per step in both
    (JAX returns them from the primal, the port skips them in the replay);
    a second one per step would move them by 1e-2 and more."""
    import jax
    import jax.numpy as jnp

    from deepcam_tpu.core import mesh as meshlib
    from deepcam_tpu.models.deeplab import DeepLabv3plus as JaxDeepLab
    from deepcam_tpu.train.optim import build_optimizer as jax_build_optimizer
    from deepcam_tpu.train.trainer import create_train_state as jax_create_state
    from deepcam_tpu.train.trainer import make_train_step as jax_make_step
    from tests.torch_port_ref import jax_default_config, port_variables

    batches = _batches()
    variables = port_variables(SEED)
    key = "xception/conv1/kernel"
    start = flatten(variables["params"])[key].copy()

    def port(data, remat=True):
        """The port's steps: the losses, the entry conv's kernel and the
        running statistics after them (flat).  The nudged runs skip the
        replay: remat gives the same bits (the next test)."""
        model = DeepLabv3plus(3, dtype=torch.float32, device="cpu")
        load_jax_variables(model, variables["params"], variables["batch_stats"])
        state, step, losses = _state(model), _step(remat), []
        for x, y in data:
            state, metrics = step(state, x, y)
            losses.append(float(metrics["loss"]))
        params, stats = (flatten(t) for t in state_dict_to_jax(model, model.state_dict()))
        return losses, params[key], stats

    # the port first: the JAX step donates its state, whose buffers may
    # share the host arrays of ``variables``
    losses, kernel, stats = port(batches)
    gen = torch.Generator().manual_seed(9)
    nudged = [port([(x * (1 + 1e-7 * torch.randn(x.shape, generator=gen)), y)
                    for x, y in batches], remat=False) for _ in range(NUDGES)]
    with jax_default_config():
        jm = JaxDeepLab(n_classes=3, dtype=jnp.float32)
        mesh = meshlib.make_mesh(devices=jax.devices()[:1])
        tx = jax_build_optimizer("AdamW", LR, eps=EPS, weight_decay=WD)
        step = jax_make_step(jm, tx, list(tl.class_weights()), mesh, fpw_1=tl.FPW_1,
                             fpw_2=tl.FPW_2, remat=True)
        state = jax.device_put(jax_create_state(jm, variables, tx), meshlib.replicated(mesh))
        ref_losses = []
        for x, y in batches:
            state, m = step(state, jnp.asarray(x.numpy()), jnp.asarray(y.numpy()))
            ref_losses.append(float(m["loss"]))
        ref_kernel = np.asarray(state.params["xception"]["conv1"]["kernel"])
        ref_s = flatten(jax.tree_util.tree_map(np.asarray, state.batch_stats))
        del state, step
    jax.clear_caches()

    def leaf_errs(a, b):
        return np.array([np.abs(a[k] - b[k]).max() / np.abs(b[k]).max() for k in b])

    assert abs(losses[0] - ref_losses[0]) <= 1e-5 * ref_losses[0]
    spread = max(abs(n[0][1] - losses[1]) for n in nudged)
    assert abs(losses[1] - ref_losses[1]) <= 2 * spread + 1e-6 * ref_losses[1]
    assert np.median(np.abs(ref_kernel - start)) > LR  # both stacks moved
    diff, nudge = np.abs(kernel - ref_kernel), [np.abs(n[1] - kernel) for n in nudged]
    for q in (0.5, 0.99):
        assert np.quantile(diff, q) <= 2 * max(np.quantile(n, q) for n in nudge), q
    assert sorted(stats) == sorted(ref_s)
    errs, nudge = leaf_errs(stats, ref_s), [leaf_errs(n[2], stats) for n in nudged]
    assert np.median(errs) <= 2 * max(np.median(n) for n in nudge)
    assert errs.max() <= 2 * max(n.max() for n in nudge)


def test_remat_steps_are_the_same_bits_with_the_forward_twice():
    """Two AdamW steps with and without remat from the same weights: the
    metrics, every gradient, parameter and running statistic equal bit
    for bit.  The fused units' forward runs twice per remat step (120
    calls: the primal and the replay, JAX's policy keeping no residual
    inside the model), the backward once (60)."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = fs.sepconv_fwd_plain, fs.sepconv_bwd_plain

    def counted(name, fn):
        def run(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return run

    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fs, "sepconv_fwd_plain", counted("fwd", fwd))
        mp.setattr(fs, "sepconv_bwd_plain", counted("bwd", bwd))
        for remat in (False, True):
            model = DeepLabv3plus(3, dtype=torch.float32, device="cpu", seed=SEED)
            state, step, metrics = _state(model), _step(remat), []
            calls.update(fwd=0, bwd=0)
            for x, y in _batches():
                state, m = step(state, x, y)
                metrics.append({k: float(v) for k, v in m.items()})
            runs[remat] = (metrics, dict(calls), list(model.parameters()),
                           [p.grad for p in model.parameters()], running_stats(model))
    (m0, c0, *plain), (m1, c1, *remat) = runs[False], runs[True]
    assert m0 == m1
    assert c0 == {"fwd": 2 * UNITS, "bwd": 2 * UNITS}
    assert c1 == {"fwd": 4 * UNITS, "bwd": 2 * UNITS}
    for group_a, group_b in zip(plain, remat):
        assert len(group_a) == len(group_b) > 0
        assert all(torch.equal(a, b) for a, b in zip(group_a, group_b))


def test_running_stats_move_once_per_remat_step():
    """From random running statistics, one remat step leaves each BN's
    statistics at one momentum update from their start: bit-equal to one
    train-mode forward from the same start, and not to two.  Without the
    replay's skip (``layers.recomputing`` forced False) the same step
    takes a second momentum update and misses."""
    (x, y), = _batches(1)

    def stats_after(fn):
        model = DeepLabv3plus(3, dtype=torch.float32, device="cpu", seed=SEED)
        _random_running_stats(model)
        start = [b.clone() for b in running_stats(model)]
        fn(model)
        return start, running_stats(model)

    def one_forward(model):
        with torch.no_grad():
            model.train()(x)

    def remat_step(model):
        _step(True)(_state(model), x, y)

    start, once = stats_after(one_forward)
    _, got = stats_after(remat_step)
    assert all(torch.equal(a, b) for a, b in zip(got, once))
    assert not any(torch.equal(a, b) for a, b in zip(got, start))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(layers, "recomputing", lambda: False)
        _, twice = stats_after(remat_step)
    assert not any(torch.equal(a, b) for a, b in zip(twice, once))
