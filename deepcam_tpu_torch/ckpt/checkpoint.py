"""Checkpoint save and restore in the reference's schema (counterpart of
``deepcam_tpu/ckpt/checkpoint.py``).

The reference writes ``{step, epoch, model, optimizer}`` with ``torch.save``
every ``save_frequency`` steps as ``<prefix>_step_<N>.cpt``:

* ``model``: the ``DeepLabv3_plus`` state_dict under DDP's ``module.``
  prefix and the reference's names (``tools/ref_names.py``), fp32 CPU
  tensors, without ``num_batches_tracked``;
* ``optimizer``: ``{"state": {i: {"step", "exp_avg", "exp_avg_sq"}},
  "param_groups": [{..., "params": [0 .. n-1]}]}`` with ``i`` the index of
  the parameter in the order of the model keys (the reference's
  registration order), which is how the JAX package's importer
  (``tools/import_torch_checkpoint.py``) reads it.

The LR schedule is a function of the optimizer's update count, which the
state's ``step`` entries carry, so no scheduler state is saved.  Under a
process group rank 0 alone writes (the ranks' states are identical after
every step), and the other ranks take no snapshot at all; every rank
restores from the file onto its own device.

``AsyncCheckpointWriter`` takes the CPU snapshot on the calling thread (the
state keeps changing in place once the loop goes on) and writes the file on
a worker thread; one save is in flight at a time, and ``wait()`` re-raises
a worker's error.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Optional, Tuple

import torch

from ..core.mesh import get_rank
from ..tools.ref_names import is_parameter, reference_names
from ..train.trainer import TrainState

PREFIX = "module."
OPT_STATE_KEYS = ("step", "exp_avg", "exp_avg_sq")


def checkpoint_path(output_dir: str, model_prefix: str, step: int) -> str:
    """``<output_dir>/<prefix>_step_<N>.cpt``."""
    return os.path.join(output_dir, f"{model_prefix}_step_{step}.cpt")


def _cpu(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def snapshot(state: TrainState, epoch: int) -> dict:
    """The checkpoint payload as CPU copies, taken now."""
    names = reference_names(state.model)
    sd = state.model.state_dict()
    model = OrderedDict((PREFIX + ref, _cpu(sd[port])) for port, ref in names)
    opt = state.optimizer
    if len(opt.param_groups) != 1:
        raise ValueError("the reference schema holds one parameter group")
    params = dict(state.model.named_parameters())
    opt_state = {}
    ref_params = [port for port, ref in names if is_parameter(ref)]
    for i, port in enumerate(ref_params):
        st = opt.state.get(params[port])
        if st:
            opt_state[i] = {k: _cpu(st[k]) for k in OPT_STATE_KEYS}
    group = {k: v for k, v in opt.param_groups[0].items() if k != "params"}
    group["params"] = list(range(len(ref_params)))
    return {"step": int(state.step), "epoch": int(epoch), "model": model,
            "optimizer": {"state": opt_state, "param_groups": [group]}}


def _write(path: str, payload: dict) -> None:
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)  # atomic publish


def save_checkpoint(path: str, state: TrainState, epoch: int) -> None:
    """Writes the checkpoint from rank 0; a no-op on the other ranks."""
    if get_rank() == 0:
        _write(path, snapshot(state, epoch))


def _reference_model_keys(model_sd: dict) -> dict:
    """The model entries of a checkpoint under the reference's names without
    DDP's ``module.`` prefix, which a checkpoint may or may not carry, and
    without the ``num_batches_tracked`` counter of each ``nn.BatchNorm2d``,
    which the reference writes and the port's BN has no use for (as the JAX
    package's importer reads them)."""
    return {(k[len(PREFIX):] if k.startswith(PREFIX) else k): v
            for k, v in model_sd.items() if not k.endswith("num_batches_tracked")}


def _restored_count(states: dict) -> torch.Tensor:
    """The optimizer's update count: the largest ``step`` over the saved
    per-parameter states, a missing one read as 0 (as the JAX package's
    importer reads it)."""
    steps = [float(st["step"]) for st in states.values() if "step" in st]
    return torch.tensor(max(steps, default=0.0), dtype=torch.float32)


def restore_checkpoint(path: str, state: TrainState) -> Tuple[TrainState, int]:
    """Loads a checkpoint into ``state`` (its model and optimizer, in place,
    on their device) and returns ``(state, epoch)``.  Takes the port's files
    and the reference's: model keys with or without ``module.``, BN
    ``num_batches_tracked`` counters (dropped), and per-parameter optimizer
    states without ``step``; every restored state carries the count of
    ``_restored_count``."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    names = reference_names(state.model)
    model_sd = _reference_model_keys(blob["model"])
    want = [ref for _, ref in names]
    if sorted(model_sd) != sorted(want):
        diff = sorted(set(model_sd) ^ set(want))[:10]
        raise KeyError(f"{path}: model keys differ from the reference schema: {diff}")
    state.model.load_state_dict({port: model_sd[ref] for port, ref in names}, strict=True)

    opt = state.optimizer
    saved = blob["optimizer"]
    ref_index = {ref: i for i, ref in
                 enumerate(ref for _, ref in names if is_parameter(ref))}
    port_to_ref = dict(names)
    name_of = {id(p): n for n, p in state.model.named_parameters()}
    order = [p for g in opt.param_groups for p in g["params"]]
    if len(opt.param_groups) != 1 or len(order) != len(ref_index):
        raise ValueError("the optimizer must hold the model's parameters in one group")
    count = _restored_count(saved["state"])
    opt_state = {}
    for j, p in enumerate(order):
        i = ref_index[port_to_ref[name_of[id(p)]]]
        if i in saved["state"]:
            opt_state[j] = {**saved["state"][i], "step": count.clone()}
    group = dict(saved["param_groups"][0])
    group["params"] = list(range(len(order)))
    opt.load_state_dict({"state": opt_state, "param_groups": [group]})
    state.step = int(blob["step"])
    state.epoch = int(blob["epoch"])
    return state, state.epoch


class AsyncCheckpointWriter:
    """Writes checkpoints on a background thread, one in flight at a time."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, path: str, state: TrainState, epoch: int) -> None:
        """Snapshots ``state`` and starts its write, on rank 0; a no-op on
        the other ranks."""
        if get_rank() != 0:
            return
        self.wait()  # one save in flight; keeps publish order
        payload = snapshot(state, epoch)

        def work():
            try:
                _write(path, payload)
            except BaseException as e:  # raised again by wait()
                self._error = e

        self._thread = threading.Thread(target=work, name="ckpt-writer", daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Blocks until the save in flight has published; raises its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
