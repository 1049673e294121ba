"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The sources are compiled by hand with ``nvcc`` for ``sm_90a``, one
``nvcc`` per source, all started together, then linked into one shared
library with a plain C interface, loaded with ``ctypes``.  The
library lands in ``build/torch_kernels/<sha256 of the sources>/`` at the
root of the checkout on first use, so a changed source builds anew and an
unchanged one is built once.  Nothing is compiled at import time: the CPU
tests import every module, and this machine may have no ``nvcc``.

Every C entry point returns its ``cudaGetLastError()``; :func:`check`
raises when that is not 0.  A failed build raises with nvcc's stderr.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
LIB_NAME = "libbricklib_torch.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_VOID = ctypes.c_void_p
_INT = ctypes.c_int
_I64 = ctypes.c_longlong

# argtypes of every C entry point: pointers and the stream as c_void_p
SIGNATURES = {
    "bt_pencil_sweep": [_VOID, _VOID, _VOID] + [_INT] * 20
                       + [_VOID, _VOID, _INT, _INT, _VOID],
    "bt_pencil_sweep_4d": [_VOID, _VOID, _VOID] + [_INT] * 25
                          + [_VOID, _VOID, _INT, _INT, _VOID],
    "bt_pencil_sweep_2d": [_VOID, _VOID, _VOID] + [_INT] * 15
                          + [_VOID] * 4 + [_INT, _INT, _VOID],
    "bt_copy_intervals": [_VOID, _VOID, _INT, _I64, _VOID],
    "bt_copy_stage": [_VOID, _VOID, _VOID, _INT, _I64, _VOID],
    "bt_copy_storage": [_VOID, _VOID, _I64, _VOID],
}

_lock = threading.Lock()
_lib = None


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_digest() -> str:
    h = hashlib.sha256()
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            "/usr/local/cuda/bin/nvcc"]:
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                           "kernels are built on the machine with the card")
    return found


def _run(cmd: list[str]) -> str:
    """Run one nvcc command; its output, or raise with its stderr."""
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stderr}")
    return proc.stdout + proc.stderr


def build(force: bool = False) -> Path:
    """Compile ``csrc/*.cu`` into the library, one nvcc per source in
    parallel, then link; returns its path.  The compiler's ``-Xptxas -v``
    report is kept beside it as ``nvcc.log``."""
    out_dir = BUILD_ROOT / source_digest()
    lib = out_dir / LIB_NAME
    if lib.exists() and not force:
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [os.path.join(tmp, p.stem + ".o") for p in sources()]
        with ThreadPoolExecutor(len(objs)) as pool:
            logs = list(pool.map(_run, [
                [nvcc, *NVCC_FLAGS, "-c", "-o", o, str(p)]
                for p, o in zip(sources(), objs)]))
        so = os.path.join(tmp, LIB_NAME)
        _run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
              "-o", so, *objs])
        (out_dir / "nvcc.log").write_text("".join(logs))
        os.replace(so, lib)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = _INT
            lib.bt_error_string.argtypes = [_INT]
            lib.bt_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err:
        msg = library().bt_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_handle(device) -> int:
    """PyTorch's current stream on ``device``, as an int for ctypes."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
