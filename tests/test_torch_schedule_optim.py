"""The port's LR schedules and optimizers against the JAX package's.

Schedules are held to JAX's ``get_lr_schedule`` step by step in fp32.
Adam, AdamW and LAMB are held to the JAX package's ``build_optimizer``
(optax) over three updates under a warmup + multistep schedule, on the same
parameters and gradients, to 1e-6 of each tensor's largest entry; LAMB also
to the numpy port of apex's FusedLAMB kernel in ``tests/test_lamb_golden.py``.

JAX is imported inside the tests that use it, so the ``gpu`` test runs on a
machine with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_schedule_optim.py
"""

import numpy as np
import pytest
import torch

from deepcam_tpu_torch.train.optim import LAMB, build_optimizer, update_count
from deepcam_tpu_torch.train.schedule import get_lr_schedule

SCHEDULES = {
    "constant": (None, 0, 1.0),
    "warmup": ({"type": "multistep", "milestones": "1000", "decay_rate": "0.1"}, 5, 4.0),
    "multistep": ({"type": "multistep", "milestones": "7 19", "decay_rate": "0.1"}, 0, 1.0),
    "warmup_multistep": ({"type": "multistep", "milestones": "7 19", "decay_rate": "0.5"},
                         6, 2.0),
}
SHAPES = {"conv": (4, 3, 3, 3), "dw": (6, 1, 3, 3), "bias": (7,), "zero": (5,)}
UPDATE_TOL = 1e-6


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_jax(name):
    from deepcam_tpu.train.schedule import get_lr_schedule as jax_schedule

    arg, warmup, factor = SCHEDULES[name]
    port = get_lr_schedule(1e-3, arg, warmup_steps=warmup, warmup_factor=factor)
    ref = jax_schedule(1e-3, arg, warmup_steps=warmup, warmup_factor=factor)
    for step in range(41):
        got, want = np.float32(port(step)), np.float32(ref(step))
        assert abs(got - want) <= np.spacing(want), (step, got, want)


def test_schedule_milestones_and_warmup_values():
    sched = get_lr_schedule(1e-3, SCHEDULES["warmup_multistep"][0], warmup_steps=6,
                            warmup_factor=2.0)
    assert sched(0) == pytest.approx(1e-3, rel=1e-7)
    assert sched(3) == pytest.approx(1e-3 * (1 * 3 / 6 + 1), rel=1e-7)
    # after warmup the base runs shifted by 6: milestones at 13 and 25
    assert [sched(s) for s in (6, 12, 13, 24, 25)] == pytest.approx(
        [2e-3, 2e-3, 1e-3, 1e-3, 5e-4], rel=1e-7)
    with pytest.raises(ValueError):
        get_lr_schedule(1e-3, {"type": "cosine"})


def _problem(seed, grad_scales):
    rng = np.random.RandomState(seed)
    params = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    params["zero"][:] = 0.0  # a zero tensor: LAMB's trust ratio falls back to 1
    grads = [{k: (g * rng.randn(*s)).astype(np.float32) for k, s in SHAPES.items()}
             for g in grad_scales]
    return params, grads


def _port_run(name, params, grads, sched, device="cpu", wd=1e-2):
    tp = [torch.nn.Parameter(torch.from_numpy(params[k].copy()).to(device)) for k in SHAPES]
    opt = build_optimizer(name, tp, sched, eps=1e-8, weight_decay=wd)
    lrs = []
    for g in grads:
        for t, k in zip(tp, SHAPES):
            t.grad = torch.from_numpy(g[k]).to(device)
        opt.step()
        lrs.append(opt.param_groups[0]["lr"])
    return {k: t.detach().cpu().numpy() for t, k in zip(tp, SHAPES)}, opt, lrs


@pytest.mark.parametrize("name", ["Adam", "AdamW", "LAMB"])
@pytest.mark.parametrize("grad_scale", [0.05, 3.0])  # LAMB: below / above the clip
def test_optimizer_matches_optax(name, grad_scale):
    import jax
    import jax.numpy as jnp
    import optax

    from deepcam_tpu.train.optim import build_optimizer as jax_build
    from deepcam_tpu.train.schedule import get_lr_schedule as jax_schedule

    arg, warmup, factor = SCHEDULES["warmup_multistep"]
    arg = {**arg, "milestones": "1", "decay_rate": "0.1"}
    params, grads = _problem(1, [grad_scale] * 3)
    tx = jax_build(name, jax_schedule(1e-2, arg, 1, factor), eps=1e-8, weight_decay=1e-2)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
    got, opt, lrs = _port_run(name, params, grads, get_lr_schedule(1e-2, arg, 1, factor))
    # the lr of update s is schedule(s): warmup, then the milestone
    assert lrs == pytest.approx([1e-2, 2e-2, 2e-3], rel=1e-7)
    assert update_count(opt) == 3
    # LAMB computes optax's fp32 bias corrections; torch's Adam and AdamW
    # compute them in double, where optax's fp32 1 - 0.999**2 loses 5e-6
    # to cancellation: their zero-started tensor, whose largest entry is
    # the sum of the updates alone, is left out
    for k in SHAPES if name == "LAMB" else [k for k in SHAPES if k != "zero"]:
        want = np.asarray(jax.device_get(jp[k]))
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(got[k] - want).max()) <= UPDATE_TOL * scale, (name, k)
    st = opt.state[opt.param_groups[0]["params"][0]]
    assert sorted(st) == ["exp_avg", "exp_avg_sq", "step"] and int(st["step"]) == 3


@pytest.mark.parametrize("grad_scale", [0.01, 5.0])
def test_lamb_matches_apex_port(grad_scale):
    from tests.test_lamb_golden import apex_lamb_step

    params, grads = _problem(2, [grad_scale] * 4)
    lr, wd = 0.02, 1e-6
    got, _, _ = _port_run("LAMB", params, grads, lr, wd=wd)
    ref = {k: v.astype(np.float64) for k, v in params.items()}
    m = {k: np.zeros(s) for k, s in SHAPES.items()}
    v = {k: np.zeros(s) for k, s in SHAPES.items()}
    for step, g in enumerate(grads, start=1):
        ref, m, v = apex_lamb_step(ref, {k: x.astype(np.float64) for k, x in g.items()},
                                   m, v, step, lr=lr, eps=1e-8, wd=wd)
    for k in SHAPES:
        np.testing.assert_allclose(got[k], ref[k], rtol=2e-5, atol=2e-6, err_msg=k)


def test_lamb_zero_parameter_takes_a_ratio_one_step():
    p = torch.nn.Parameter(torch.zeros(4))
    opt = LAMB([p], lr=0.1, eps=1e-8, weight_decay=1e-6)
    p.grad = torch.full((4,), 0.1)
    opt.step()
    assert torch.isfinite(p).all() and not torch.equal(p.detach(), torch.zeros(4))
    # Adam's first update is m̂/sqrt(v̂) = sign(g), so the step is -lr, up
    # to optax's fp32 bias correction 1 - 0.999, which rounds by 1.3e-5
    assert torch.allclose(p.detach(), torch.full((4,), -0.1), rtol=2e-5)


@pytest.mark.gpu
def test_lamb_on_card_matches_cpu():
    """LAMB with the schedule on CUDA tensors against the same run on the
    CPU, fp32: the same foreach arithmetic, reductions in another order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    arg, warmup, factor = SCHEDULES["warmup_multistep"]
    sched = get_lr_schedule(1e-2, {**arg, "milestones": "1"}, 1, factor)
    params, grads = _problem(3, [0.05, 3.0, 0.5])
    cpu, _, _ = _port_run("LAMB", params, grads, sched)
    card, _, _ = _port_run("LAMB", params, grads, sched, device="cuda")
    for k in SHAPES:
        scale = max(float(np.abs(cpu[k]).max()), 1e-30)
        assert float(np.abs(card[k] - cpu[k]).max()) <= UPDATE_TOL * scale, k
