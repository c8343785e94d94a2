"""Builds and loads the hand-written CUDA kernels of ``longlive_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled at first use
by ``nvcc`` for ``sm_90a`` into a shared library under ``build/kernels``
beside the package, named by a hash of its source so an edited source
rebuilds.  The library is loaded with ctypes.  Nothing here runs at import
time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

KERNELS = ("flash_attention", "causal_conv")

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD = _CSRC.parent.parent / "build" / "kernels"
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a host "
                       "with the CUDA toolkit (PATH or /usr/local/cuda/bin)")


def _lib_path(name: str) -> Path:
    src = (_CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src).hexdigest()[:12]
    return _BUILD / f"lib{name}-{tag}.so"


def _nvcc_cmd(name: str, out: Path) -> list:
    return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v",
            "-o", str(out), str(_CSRC / f"{name}.cu")]


def build_all(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compiles every kernel that has no up-to-date library, one ``nvcc``
    per source, all started together.  Returns nvcc's messages by kernel
    (ptxas reports each kernel's registers and spills)."""
    _BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        procs[name] = (subprocess.Popen(_nvcc_cmd(name, tmp), stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, out)
    logs = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of kernel library ``name``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        lib.longlive_cuda_error_string.restype = ctypes.c_char_p
        lib.longlive_cuda_error_string.argtypes = [ctypes.c_int]
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raises when a C entry point returned a CUDA error code."""
    if rc != 0:
        msg = lib.longlive_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
