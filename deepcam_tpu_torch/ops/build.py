"""Builds the port's CUDA sources into shared libraries and loads them.

Each ``csrc/<name>.cu`` becomes ``build/lib<name>-<hash>.so`` under the
package (a directory that ``.gitignore`` lists), compiled by ``nvcc`` for
Hopper (``sm_90a``) with a plain C interface and loaded with ``ctypes``.  The
hash covers the sources and the flags, so an edited kernel is rebuilt.  A
build happens at first use, one ``nvcc`` per source, all started together.
Nothing here runs at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
SOURCES = ("sepconv_fwd", "sepconv_bwd", "row_windows", "bn_glue", "bn_own")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise FileNotFoundError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the port's CUDA "
        "kernels are built from source at first use")


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for part in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(part.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names=SOURCES) -> float:
    """Compiles every library of ``names`` that is missing, one ``nvcc`` per
    source, all at once.  Returns the seconds spent; raises with the
    compiler's output if a build fails.  The compiler's report (registers,
    shared memory, spills) is kept beside each library as ``.log``."""
    t0 = time.perf_counter()
    todo = [(n, _target(n)) for n in names if not _target(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = []
    for name, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return time.perf_counter() - t0


def launch(name: str, fn, device, *args) -> None:
    """Calls a kernel's C entry ``fn(*args, stream)`` with ``device`` (the
    CUDA device of its tensors) as the current device, and that device's
    current stream.  The C side launches on the current device
    (``cudaGetDevice``), so without this a rank on ``cuda:1`` whose current
    device was never set would launch onto device 0 with device-1 pointers.
    The device guard is entered only when ``device`` is not already the
    current one, which spares its host cost on every launch of a process
    that set its device.  The stream is read as the raw handle
    (``torch._C._cuda_getCurrentRawStream``, what PyTorch's own generated
    kernels launch on): ``torch.cuda.current_stream`` builds a Stream
    object, a third of a small launch's host time on an H100's host.
    Raises on a nonzero CUDA error code."""
    import torch

    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == current:
        rc = fn(*args, stream)
    else:
        with torch.cuda.device(device):
            rc = fn(*args, stream)
    if rc:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(_target(name)))
        _LIBS[name] = lib
    return lib
