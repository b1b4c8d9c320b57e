"""Faults planted in the program underneath a run: the readings that set the
check's limits (``calibrate.py``) and the tests that see ``correct`` come
out false (``tests/test_bench_faults.py``) both take them from here.

Each is a context manager that replaces an attribute of the port for as
long as it is entered and then puts the original back; the harness builds
the program inside it, as a run does.
"""

from __future__ import annotations

import contextlib

import torch

SCALE = 1.3  # the factor of the scaled-gradient faults


@contextlib.contextmanager
def _patched(obj, name: str, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _wrapped_step(wrap):
    """``make_train_step`` returning ``wrap(step_fn)``."""
    from deepcam_tpu_torch.train import trainer

    make = trainer.make_train_step
    return _patched(trainer, "make_train_step", lambda *a, **k: wrap(make(*a, **k)))


def unchanged_state():
    """A step that returns its state unchanged: the parameters put back."""

    def wrap(step):
        def broken(state, x, y):
            before = [p.detach().clone() for p in state.model.parameters()]
            state, metrics = step(state, x, y)
            with torch.no_grad():
                torch._foreach_copy_(list(state.model.parameters()), before)
            return state, metrics

        return broken

    return _wrapped_step(wrap)


def half_batch():
    """A step that leaves out the second half of its batch, the mean taken
    over the rest."""

    def wrap(step):
        return lambda state, x, y: step(state, x[:x.shape[0] // 2], y[:y.shape[0] // 2])

    return _wrapped_step(wrap)


def no_exchange():
    """Ranks that train alone: no gradient or statistic is exchanged."""
    from deepcam_tpu_torch.train import trainer

    return _patched(trainer, "_replica", lambda state: None)


def grad_scaled():
    """Every gradient scaled by ``SCALE`` between the backward and the
    optimizer: directions and signs as they should be."""

    def wrap(step):
        def broken(state, x, y):
            opt = state.optimizer
            real = opt.step

            def scaled_step(*a, **k):
                with torch.no_grad():
                    torch._foreach_mul_([p.grad for g in opt.param_groups for p in g["params"]
                                         if p.grad is not None], SCALE)
                return real(*a, **k)

            opt.step = scaled_step
            try:
                return step(state, x, y)
            finally:
                del opt.step

        return broken

    return _wrapped_step(wrap)


@contextlib.contextmanager
def _bwd_scaled(field: str):
    """One output of the fused sepconv backward scaled by ``SCALE`` where
    it is produced, on the card and on the CPU."""
    from deepcam_tpu_torch.ops import fused_sepconv as fs

    def scaled(fn):
        def broken(*a, **k):
            out = fn(*a, **k)
            return out._replace(**{field: getattr(out, field) * SCALE})

        return broken

    with _patched(fs, "sepconv_bwd", scaled(fs.sepconv_bwd)), \
            _patched(fs, "sepconv_bwd_plain", scaled(fs.sepconv_bwd_plain)):
        yield


def dpw_scaled():
    """The fused backward's pointwise-weight gradient scaled."""
    return _bwd_scaled("dpw")


def dx_scaled():
    """The fused backward's input gradient scaled: every unit passes a
    gradient 1.3 times too large to the layers before it."""
    return _bwd_scaled("dx")


FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_batch,
          "no_exchange": no_exchange, "grad_scaled": grad_scaled, "dpw_scaled": dpw_scaled,
          "dx_scaled": dx_scaled}
