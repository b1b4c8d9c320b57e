"""The comparison that decides ``correct``.

The program's first three training steps, taken in set-up through the
window's own feed and step, are followed by the plain fp32 reference from
the same weights on the same samples.  Each side gives its readings: each
step's loss and train IoU, the per-tensor norm of the first step's gradient
as LAMB receives it (before its global-norm clip), each BN running
statistic after the first step, and after the third step the per-tensor
norm of each parameter's change.

At random initialisation the backward through the Xception encoder is
chaotic: rounding anywhere in the forward turns the encoder's gradient
directions (the fp32 reference and the same reference with bf16 operands
agree to a cosine of ~0.05 there, to ~1.0 in the decoder's last layers),
and LAMB's first update moves each tensor along sign(g) by its trust
ratio, so the change after three steps does not see a gradient's size.
The held numbers therefore read what that chaos leaves alone:

* ``grad``: the median tensor's gap of first-gradient norms, each over the
  larger of the reference's norm of that tensor and of the median tensor:
  the chaos moves norms by a few percent, a gradient that grows from unit
  to unit on its way back moves them many times over;
* ``grad_head``: the worst gap of gradient norms over the layers after the
  model's last BN, which the loss's gradient reaches without a BN's
  backward (every gradient's scale, the loss and its weights);
* ``grad_units``: over the separable convolutions (a depthwise weight
  followed by a pointwise one), the median gap of the ratio of the
  pointwise to the depthwise gradient norm, program over reference: the
  two outputs of one fused backward, whose shared upstream scale cancels;
* ``update``: the worst tensor's gap of the norms of the parameters'
  change after three steps, leaving out tensors whose reference gradient
  is under a thousandth of the median tensor's (they move by round-off
  alone): a state left unchanged reads 1;
* ``bn_stats``: the median BN running statistic's change after the first
  step, as the norm of the two sides' difference over the larger of the
  reference's norm of that statistic's change and of the median one's;
* ``bn_input``: the same for the first BN's two statistics (the batch
  statistics of the input's first convolution), the worse of the two, each
  over its own reference norm: every sample of the batch counts there,
  before any BN has normalised the samples' differences away.

Printed and not held: ``loss`` (the largest relative gap of a step's
loss), ``iou`` (the largest absolute gap of a step's train IoU),
``grad_worst`` (the worst tensor's gap of first-gradient norms: the first
convolution's weight, whose bf16 gradient carries the input's mean of
~0.5 times the rounding that train-mode BN's backward leaves in each
channel's mean) and ``bn_worst`` (the worst BN statistic).

The tensors that ``grad_head``, ``grad_units`` and ``bn_input`` single out
are the configuration's family's ``layout`` (``families/<family>.py``); a
number whose tensors the family does not give (an empty list, or a model
without BN for ``bn_stats``) is not computed.  Each number has its own
limit, in the workload file (``limits``); a number without a limit there
is printed and not held, and a limit whose number the run did not produce
fails the run.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List

from . import spec

NUMBERS = ("loss", "iou", "grad", "grad_head", "grad_units", "update", "bn_stats",
           "bn_input")
PRINTED = ("grad_worst", "bn_worst")
SMALL_GRAD = 1e-3
BUFFERS = "bn"


def _largest(values) -> float:
    """The largest of ``values``; infinite if one is not finite (a NaN
    would otherwise lose every comparison and vanish)."""
    values = list(values)
    if not all(math.isfinite(v) for v in values):
        return math.inf
    return max(values, default=0.0)


def _gaps(prog: Dict[str, float], ref: Dict[str, float], keys: List[str]) -> List[float]:
    med = statistics.median(ref[k] for k in keys)
    return [abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys]


def _worst_gap(prog: Dict[str, float], ref: Dict[str, float], keys: List[str]) -> float:
    return _largest(_gaps(prog, ref, keys))


def _median(gaps: List[float]) -> float:
    return statistics.median(gaps) if _largest(gaps) < math.inf else math.inf


def _median_gap(prog: Dict[str, float], ref: Dict[str, float], keys: List[str]) -> float:
    return _median(_gaps(prog, ref, keys))


def _bn_gaps(prog: dict, ref: dict) -> List[float]:
    keys = sorted(ref[BUFFERS])
    norms = {k: float(ref[BUFFERS][k].double().norm()) for k in keys}
    med = statistics.median(norms.values())
    return [float((prog[BUFFERS][k].double() - ref[BUFFERS][k].double()).norm())
            / max(norms[k], med, 1e-30) for k in keys]


def numbers(prog: dict, ref: dict, cfg: dict) -> Dict[str, float]:
    """The compared numbers of two sides' readings (see the module
    docstring); ``ref`` is the reference's.  Only those whose tensors the
    family's layout gives."""
    lay = spec.config_family(cfg).layout(cfg)
    g_p, g_r = prog["grad1"], ref["grad1"]
    grad_keys = sorted(g_r)
    med_grad = statistics.median(g_r[k] for k in grad_keys)
    moved = [k for k in grad_keys if g_r[k] >= SMALL_GRAD * med_grad]
    out = {
        "loss": _largest(abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"])),
        "iou": _largest(abs(p - r) for p, r in zip(prog["iou"], ref["iou"])),
        "grad": _median_gap(g_p, g_r, grad_keys),
        "grad_worst": _worst_gap(g_p, g_r, grad_keys),
    }
    if lay["head"]:
        out["grad_head"] = _largest(abs(g_p[k] - g_r[k]) / max(g_r[k], med_grad, 1e-30)
                                    for k in lay["head"])
    if lay["units"]:
        out["grad_units"] = _median([abs((g_p[p] / max(g_p[d], 1e-30)) / (g_r[p] / g_r[d])
                                         - 1.0) for d, p in lay["units"]])
    if moved:
        out["update"] = _worst_gap(prog["delta"], ref["delta"], moved)
    if ref[BUFFERS]:
        bn = _bn_gaps(prog, ref)
        out["bn_stats"] = _median(bn)
        out["bn_worst"] = _largest(bn)
    if lay["input_bn"]:
        out["bn_input"] = _largest(
            float((prog[BUFFERS][k].double() - ref[BUFFERS][k].double()).norm())
            / max(float(ref[BUFFERS][k].double().norm()), 1e-30) for k in lay["input_bn"])
    return out


def worst(prog: dict, ref: dict, key: str, n: int = 5) -> List[tuple]:
    """The ``n`` tensors with the largest gaps of ``key`` ("grad1", "delta"
    or ``BUFFERS``): (name, gap, program's norm, reference's norm)."""
    keys = sorted(ref[key])
    if key == BUFFERS:
        gaps = _bn_gaps(prog, ref)
        p, r = ([float(side[key][k].norm()) for k in keys] for side in (prog, ref))
    else:
        gaps = _gaps(prog[key], ref[key], keys)
        p, r = ([side[key][k] for k in keys] for side in (prog, ref))
    return sorted(zip(keys, gaps, p, r), key=lambda g: -g[1])[:n]


def judge(nums: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """{name: {"value", "limit"}} in ``NUMBERS`` order, then the readings
    that are printed and not held; a number with no limit carries ``None``
    as its limit, and a limit whose number was not produced carries
    ``None`` as its value."""
    out = {k: {"value": nums[k], "limit": limits.get(k)} for k in NUMBERS + PRINTED
           if k in nums}
    out.update({k: {"value": None, "limit": v} for k, v in limits.items() if k not in nums})
    return out


def passed(checks: Dict[str, dict]) -> bool:
    return all(c["limit"] is None or (c["value"] is not None and c["value"] <= c["limit"])
               for c in checks.values())
