"""Host spans and counters inside the port, one entry per train step.

``span(name)`` times a region of host work with ``time.perf_counter_ns``
and adds its nanoseconds and a count of 1 to the open entry under
``<name>.ns`` and ``<name>.n``.  While a profiler records
(``torch.autograd.profiler._is_profiler_enabled``) the span is also a
``record_function`` range named ``deepcam.<name>``, so it lands in the same
Chrome trace as the CUDA kernels, on the clock the device activity is put
on; otherwise it enters none.  The record keeps durations and counts only:
the trace carries the timeline.

``add(name, ns)`` adds the same without a range, for a region too short
or too frequent to be worth one in a trace.

The root span ``step`` (the train step, ``train/trainer.py``) closes the
open entry when it exits: everything added since the previous close (the
data spans of the batch the step consumed, what the reader threads did in
between, the fused units' host calls) becomes one dict of ints appended to
the record, which keeps the last ``MAX_STEPS``.  Spans from any thread add
to the same open entry, under a lock.

The spans and what they cover:

``data.read``       a reader thread's ``dataset.__getitem__`` (read,
                    normalise, cast), ``data/pipeline.py``
``data.wait``       the consumer blocked on the readers' futures
``data.stage``      a batch's assembly into (pinned) host memory and its
                    queued copy to the card
``step``            the whole train step (the root)
``step.forward``    the model call and the loss
``step.backward``   clearing the gradients and ``loss.backward()`` (with
                    DDP's overlapped all-reduce under a group)
``step.optimizer``  ``optimizer.step()``
``sepconv.fwd``     (``add``) a fused unit's forward kernel call from its
``sepconv.bwd``     autograd entry point, and its backward's,
                    ``ops/fused_sepconv.py``: on the card the kernel
                    wrapper (checks, plan, allocations, tensor-map
                    encoding, the ctypes launch), on the CPU the plain
                    version
``bn.fwd``          (``add``) train-mode BatchNorm's glue call from its
``bn.bwd``          autograd function, forward and backward,
                    ``ops/bn_glue.py``: on the card the kernel wrapper
                    (checks, allocations, the ctypes launch), on the CPU
                    the plain version
``dense.block``     each dense block's forward, ``models/tiramisu.py``
``dense.transition`` each transition down's and up's forward

This module imports only torch and the standard library, so that any
module of the port can import it.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List

import torch
import torch.autograd.profiler as _profiler

ROOT = "step"
MAX_STEPS = 4096
PREFIX = "deepcam."

_lock = threading.Lock()
_open: Dict[str, list] = {}     # span name -> [ns, count] since the last close
_record: collections.deque = collections.deque(maxlen=MAX_STEPS)


def add(name: str, ns: int) -> None:
    """Adds ``ns`` host nanoseconds and a count of 1 to the open entry
    under ``name``."""
    with _lock:
        acc = _open.get(name)
        if acc is None:
            _open[name] = [ns, 1]
        else:
            acc[0] += ns
            acc[1] += 1


class span:
    """``with span(name):`` adds the block's host nanoseconds and a count
    of 1 to the open entry; ``name == ROOT`` then closes the entry.  Under
    a recording profiler the block is also the range ``deepcam.<name>``."""

    __slots__ = ("name", "t0", "range")

    def __init__(self, name: str):
        self.name = name
        self.range = None

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            self.range = torch.autograd.profiler.record_function(PREFIX + self.name)
            self.range.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self.t0
        if self.range is not None:
            self.range.__exit__(*exc)
            self.range = None
        add(self.name, ns)
        if self.name == ROOT:
            _close()
        return False


def _close() -> None:
    with _lock:
        entry = {}
        for name, (ns, n) in _open.items():
            entry[name + ".ns"] = ns
            entry[name + ".n"] = n
        _open.clear()
        _record.append(entry)


def steps() -> List[Dict[str, int]]:
    """The closed entries, oldest first (the last ``MAX_STEPS``)."""
    with _lock:
        return list(_record)


def reset() -> None:
    """Drops the record and the open entry."""
    with _lock:
        _record.clear()
        _open.clear()
