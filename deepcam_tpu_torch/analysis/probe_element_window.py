"""Overlapping row windows: the counterpart of the archived Mosaic probe
``analysis/archive/probe_element_window.py``.

That probe is a ``pallas_call`` whose input block spec takes ``pl.Element``
windows of ``TH + 2D`` rows at row offsets ``t * TH`` of a host-padded
NHWC input, the halo'd row tiles a depthwise conv reads, and copies each
window out:

    out[n, t, r] = xp[n, t * TH + r]        t < (rows - 2D) // TH, r < TH + 2D

at (2, 18, 72, 728) fp32 with TH 4, D 1.  Here, as for every kernel of the
port, two versions: the CUDA kernel of ``ops/csrc/row_windows.cu`` for
tensors on the card, and a plain PyTorch version for tensors on the CPU
(and for ``chip_smoke.py`` to hold the kernel to).
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.build import launch, library

# The probe's shape: (N, H + 2D, W, C) fp32, row tile TH, halo D.
PROBE_SHAPE = (2, 18, 72, 728)
PROBE_TH, PROBE_D = 4, 1

# Launches of the kernel since the last reset (added where it launches).
LAUNCHES = {"row_windows": 0}


def reset_launches() -> None:
    LAUNCHES["row_windows"] = 0


def window_count(rows: int, th: int, d: int) -> int:
    """Windows of th + 2d rows at offsets t * th inside ``rows`` rows."""
    return (rows - 2 * d) // th


def row_windows_plain(xp: torch.Tensor, th: int, d: int) -> torch.Tensor:
    """(N, T, TH + 2D, W, C): the windows, copied."""
    t = window_count(xp.shape[1], th, d)
    return torch.stack([xp[:, i * th:i * th + th + 2 * d] for i in range(t)], dim=1)


def _lib():
    fn = library("row_windows").row_windows
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def row_windows_kernel(xp: torch.Tensor, th: int, d: int) -> torch.Tensor:
    """The CUDA kernel on a contiguous fp32 CUDA tensor (N, rows, W, C)."""
    if xp.device.type != "cuda" or xp.dtype != torch.float32 or xp.dim() != 4:
        raise ValueError(f"row_windows: want a 4-d fp32 CUDA tensor, got {xp.dtype} "
                         f"{xp.device} {tuple(xp.shape)}")
    n, rows, w, c = xp.shape
    if not xp.is_contiguous() or xp.data_ptr() % 16 or (w * c) % 4:
        raise ValueError("row_windows: contiguous, 16-byte aligned, W * C a multiple of 4")
    t, win = window_count(rows, th, d), th + 2 * d
    if t < 1 or th < 1 or d < 0:
        raise ValueError(f"row_windows: no window of {win} rows in {rows}")
    out = torch.empty((n, t, win, w, c), dtype=xp.dtype, device=xp.device)
    launch("row_windows", _lib(), xp.device, xp.data_ptr(), out.data_ptr(), n, rows, w, c,
           th, win, t)
    LAUNCHES["row_windows"] += 1
    return out


def row_windows(xp: torch.Tensor, th: int = PROBE_TH, d: int = PROBE_D) -> torch.Tensor:
    """The windows of ``xp``: the kernel for a CUDA tensor, the plain
    version for a CPU tensor."""
    if xp.device.type == "cuda":
        return row_windows_kernel(xp, th, d)
    if xp.device.type != "cpu":
        raise ValueError(f"row_windows runs on cuda or cpu, got {xp.device}")
    return row_windows_plain(xp, th, d)
