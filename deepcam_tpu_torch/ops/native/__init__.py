"""Native (C++) host-side routines of the data pipeline (counterpart of
``deepcam_tpu/ops/native``), built at first use, with a numpy path for a
box without a compiler.

``lib()`` returns a ctypes handle to the port's own copy of
``preprocess.cpp``, compiled with ``g++ -O3 -fopenmp`` into
``deepcam_tpu_torch/build/native/`` (a directory that ``.gitignore`` lists)
under a name keyed by the source and the flags.  The flags carry no
``-march=native``, so a library built on one x86-64 host runs on another;
the routines are bound by memory, not by vector width.

bf16 output needs no ``ml_dtypes``: ``normalize_hwc_bf16`` returns the bf16
bit patterns as a ``uint16`` array, which ``as_bf16_tensor`` views as a
``torch.bfloat16`` tensor without a copy.

``USES`` counts the calls of each path (``native`` or ``numpy``) since the
last ``reset_uses()``, so a run can show which one it took.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np
import torch

SRC = Path(__file__).resolve().parent / "preprocess.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-fopenmp", "-ffp-contract=off", "-shared", "-fPIC")

USES = {"native": 0, "numpy": 0}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed = False


def reset_uses() -> None:
    for k in USES:
        USES[k] = 0


def so_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libdeepcam_host-{h.hexdigest()[:16]}.so"


def _build(so: Path) -> bool:
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (subprocess.SubprocessError, OSError):
        return False
    os.replace(tmp, so)  # atomic: concurrent builds race safely
    return True


def _sanity_check(cdll: ctypes.CDLL) -> bool:
    """A tiny call held to numpy before the library is trusted."""
    data = np.arange(12, dtype=np.float32).reshape(2, 2, 3)
    shift = np.asarray([1.0, 2.0, 3.0], np.float32)
    scale = np.asarray([2.0, 0.5, 1.0], np.float32)
    out = np.empty_like(data)
    f32p = ctypes.POINTER(ctypes.c_float)
    cdll.normalize_hwc_f32(out.ctypes.data_as(f32p), data.ctypes.data_as(f32p),
                           shift.ctypes.data_as(f32p), scale.ctypes.data_as(f32p), 4, 3)
    return bool(np.array_equal(out, scale * (data - shift)))


def lib() -> Optional[ctypes.CDLL]:
    """The native library, built if needed; None where it cannot be built
    or loaded (the numpy path then runs)."""
    global _lib, _failed
    if _lib is not None or _failed:
        return _lib
    with _lock:
        if _lib is not None or _failed:
            return _lib
        so = so_path()
        if not so.exists() and not _build(so):
            _failed = True
            return None
        try:
            cdll = ctypes.CDLL(str(so))
        except OSError:
            _failed = True
            return None
        f32p = ctypes.POINTER(ctypes.c_float)
        u16p = ctypes.POINTER(ctypes.c_uint16)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64 = ctypes.c_int64
        cdll.normalize_hwc_f32.argtypes = [f32p, f32p, f32p, f32p, i64, i64]
        cdll.normalize_hwc_f32.restype = None
        cdll.normalize_hwc_f32_to_bf16.argtypes = [u16p, f32p, f32p, f32p, i64, i64]
        cdll.normalize_hwc_f32_to_bf16.restype = None
        cdll.assemble_batch.argtypes = [u8p, ctypes.POINTER(u8p), i64, i64]
        cdll.assemble_batch.restype = None
        if not _sanity_check(cdll):
            _failed = True
            return None
        _lib = cdll
        return _lib


def _operands(data, shift, scale):
    data = np.ascontiguousarray(data, dtype=np.float32)
    if data.ndim != 3 or np.size(shift) != data.shape[2] or np.size(scale) != data.shape[2]:
        raise ValueError(f"normalize: data {data.shape} with {np.size(shift)} shifts and "
                         f"{np.size(scale)} scales")
    shift = np.ascontiguousarray(np.reshape(shift, -1), dtype=np.float32)
    scale = np.ascontiguousarray(np.reshape(scale, -1), dtype=np.float32)
    return data, shift, scale


def _bf16_bits(x: np.ndarray) -> np.ndarray:
    """fp32 → bf16 bit patterns, round to nearest even (the native routine's
    rounding; inputs are finite)."""
    u = x.view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


def normalize_hwc(data, shift, scale) -> np.ndarray:
    """``scale * (data - shift)`` over an (H, W, C) array in fp32; ``shift``
    and ``scale`` hold one value per channel."""
    data, shift, scale = _operands(data, shift, scale)
    cdll = lib()
    if cdll is None:
        USES["numpy"] += 1
        return scale * (data - shift)
    USES["native"] += 1
    h, w, c = data.shape
    out = np.empty_like(data)
    f32p = ctypes.POINTER(ctypes.c_float)
    cdll.normalize_hwc_f32(out.ctypes.data_as(f32p), data.ctypes.data_as(f32p),
                           shift.ctypes.data_as(f32p), scale.ctypes.data_as(f32p), h * w, c)
    return out


def normalize_hwc_bf16(data, shift, scale) -> np.ndarray:
    """``bf16(scale * (data - shift))`` in one pass, as bf16 bit patterns in
    a ``uint16`` array: bit-identical to ``normalize_hwc`` followed by a
    round-to-nearest-even cast, without the fp32 intermediate."""
    data, shift, scale = _operands(data, shift, scale)
    cdll = lib()
    if cdll is None:
        USES["numpy"] += 1
        return _bf16_bits(scale * (data - shift))
    USES["native"] += 1
    h, w, c = data.shape
    out = np.empty((h, w, c), dtype=np.uint16)
    f32p = ctypes.POINTER(ctypes.c_float)
    cdll.normalize_hwc_f32_to_bf16(out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
                                   data.ctypes.data_as(f32p), shift.ctypes.data_as(f32p),
                                   scale.ctypes.data_as(f32p), h * w, c)
    return out


def stack_samples(samples, out: Optional[np.ndarray] = None) -> np.ndarray:
    """``np.stack(samples)`` through the library's parallel copy, into
    ``out`` when given (for example the numpy view of a pinned buffer).
    Samples must be contiguous arrays of one shape and type."""
    s0 = samples[0]
    shape = (len(samples),) + s0.shape
    if any(s.shape != s0.shape or s.dtype != s0.dtype or not s.flags.c_contiguous
           for s in samples):
        raise ValueError("stack_samples: samples differ in shape or type, or are not contiguous")
    if out is None:
        out = np.empty(shape, dtype=s0.dtype)
    elif out.shape != shape or out.dtype != s0.dtype or not out.flags.c_contiguous:
        raise ValueError(f"stack_samples: out {out.shape} {out.dtype} for {shape} {s0.dtype}")
    cdll = lib()
    if cdll is None:
        USES["numpy"] += 1
        np.stack(samples, out=out)
        return out
    USES["native"] += 1
    u8p = ctypes.POINTER(ctypes.c_uint8)
    ptrs = (u8p * len(samples))(*[s.ctypes.data_as(u8p) for s in samples])
    cdll.assemble_batch(out.ctypes.data_as(u8p), ptrs, len(samples), s0.nbytes)
    return out


def as_bf16_tensor(bits: np.ndarray) -> torch.Tensor:
    """A ``torch.bfloat16`` view of bf16 bit patterns held as ``uint16``."""
    if bits.dtype != np.uint16:
        raise TypeError(f"as_bf16_tensor: {bits.dtype}, want uint16 bit patterns")
    return torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
