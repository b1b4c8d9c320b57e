"""Weight bridge between the JAX package's variables and the port's
``state_dict`` (counterpart of ``deepcam_tpu/tools/import_torch_checkpoint.py``).

The JAX variables come as nested dicts of numpy arrays, ``params`` and
``batch_stats``.  The port names its modules after the JAX tree
(``xception.block4.sepconv1.depthwise``, ``upsample.deconv3``, …), so the
bridge only changes layouts:

* conv kernel HWIO (kh, kw, I, O) → OIHW; the depthwise (3, 3, 1, C) → (C, 1, 3, 3);
* transposed-conv kernel HWIO (kh, kw, I, O) → (I, O, kh, kw), no flip;
* BN ``scale``/``bias``/``mean``/``var`` → ``weight``/``bias``/``running_mean``/``running_var``.

It raises on a JAX leaf it does not assign and on a port tensor left
unassigned.  Mapping to the reference checkpoint schema is not done here.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..models.layers import BatchNorm2d, Conv2d, ConvTranspose2d

CONV_PERM = (3, 2, 0, 1)   # HWIO -> OIHW
CONVT_PERM = (2, 3, 0, 1)  # HWIO (kh, kw, I, O) -> (I, O, kh, kw)

# (port state_dict key, JAX collection, JAX path, permutation or None)
Assignment = Tuple[str, str, Tuple[str, ...], Optional[Tuple[int, ...]]]


def assignments(model: torch.nn.Module) -> List[Assignment]:
    out: List[Assignment] = []
    for name, mod in model.named_modules():
        path = tuple(name.split("."))
        if isinstance(mod, (Conv2d, ConvTranspose2d)):
            perm = CONV_PERM if isinstance(mod, Conv2d) else CONVT_PERM
            out.append((f"{name}.weight", "params", path + ("kernel",), perm))
            if getattr(mod, "bias", None) is not None:
                out.append((f"{name}.bias", "params", path + ("bias",), None))
        elif isinstance(mod, BatchNorm2d):
            out += [(f"{name}.weight", "params", path + ("scale",), None),
                    (f"{name}.bias", "params", path + ("bias",), None),
                    (f"{name}.running_mean", "batch_stats", path + ("mean",), None),
                    (f"{name}.running_var", "batch_stats", path + ("var",), None)]
    return out


def _flatten(tree, prefix=()) -> Dict[Tuple[str, ...], np.ndarray]:
    if isinstance(tree, Mapping):
        flat = {}
        for k, v in tree.items():
            flat.update(_flatten(v, prefix + (str(k),)))
        return flat
    return {prefix: np.asarray(tree)}


def _set(tree: dict, path: Tuple[str, ...], value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def jax_to_state_dict(model: torch.nn.Module, params, batch_stats) -> Dict[str, torch.Tensor]:
    """The port's state_dict (CPU fp32 tensors) from JAX ``params`` and
    ``batch_stats``.  Every leaf is used exactly once and every port tensor
    is assigned exactly once, or it raises."""
    leaves = {"params": _flatten(params), "batch_stats": _flatten(batch_stats)}
    used = set()
    sd = {}
    for key, coll, path, perm in assignments(model):
        if path not in leaves[coll]:
            raise KeyError(f"{key}: no JAX leaf {coll}/{'/'.join(path)}")
        a = leaves[coll][path]
        if perm is not None:
            a = np.transpose(a, perm)
        sd[key] = torch.from_numpy(np.array(a, dtype=np.float32, order="C"))
        used.add((coll, path))
    extra = [f"{c}/{'/'.join(p)}" for c, lv in leaves.items() for p in lv
             if (c, p) not in used]
    if extra:
        raise KeyError(f"JAX leaves not assigned: {extra}")
    missing = sorted(set(model.state_dict()) - set(sd))
    if missing:
        raise KeyError(f"port tensors not assigned: {missing}")
    return sd


def load_jax_variables(model: torch.nn.Module, params, batch_stats) -> None:
    """Loads JAX variables into ``model`` in place (any device)."""
    model.load_state_dict(jax_to_state_dict(model, params, batch_stats), strict=True)


def state_dict_to_jax(model: torch.nn.Module, tensors: Mapping[str, torch.Tensor]):
    """The inverse layout map: (params, batch_stats) nested dicts of numpy
    fp32 arrays from port tensors keyed like the state_dict (for example the
    parameters' gradients).  Keys absent from ``tensors`` are skipped.  The
    arrays are copies: later in-place updates of the tensors (the BN running
    statistics of a train step) do not reach them."""
    params, stats = {}, {}
    for key, coll, path, perm in assignments(model):
        if key not in tensors:
            continue
        a = tensors[key].detach().float().cpu().numpy()
        if perm is not None:
            a = np.transpose(a, np.argsort(perm))
        _set(params if coll == "params" else stats, path, np.array(a, order="C"))
    return params, stats
