"""Module scopes for a ``torch.profiler`` trace (copied from
``deepcam_tpu_torch/profiling/profiler.py:ModuleScopes`` at commit
2718cf8).

Changed from the original: ``calls`` keeps every call made while the scopes
are entered (the original kept the last forward's only, so the backward of
earlier traced steps could not be placed), and it records no fused unit's
shape (the benchmark takes the units from the configuration).
"""

from __future__ import annotations

from typing import List

import torch


class ModuleScopes:
    """While entered, every call of a named submodule of ``model`` is a
    ``record_function`` of its path (``xception/block4/sepconv1``), and
    ``calls`` records ``[seq_lo, seq_hi, path]`` per call: the autograd
    sequence numbers the call created, through which a backward kernel,
    launched from autograd's thread outside any forward range, is placed in
    the module whose forward made its node."""

    def __init__(self, model: torch.nn.Module):
        self.model = model
        self.calls: List[list] = []
        self._open: List[tuple] = []
        self._handles: List = []

    def _pre(self, module, args, path):
        if path == "":
            return
        rf = torch.profiler.record_function(path)
        rf.__enter__()
        self._open.append((rf, torch._C._autograd._get_sequence_nr()))

    def _post(self, module, args, out, path):
        if path == "":
            return
        rf, seq_lo = self._open.pop()
        rf.__exit__(None, None, None)
        self.calls.append([seq_lo, torch._C._autograd._get_sequence_nr(), path])

    def __enter__(self):
        for name, module in self.model.named_modules():
            path = name.replace(".", "/")
            self._handles.append(module.register_forward_pre_hook(
                lambda m, a, p=path: self._pre(m, a, p)))
            self._handles.append(module.register_forward_hook(
                lambda m, a, o, p=path: self._post(m, a, o, p)))
        return self

    def __exit__(self, *exc):
        for h in self._handles:
            h.remove()
        self._handles = []
        return False
