"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles, at first use, into a shared library with
a plain ``extern "C"`` interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC

No PyTorch header is included, so a build takes seconds, not minutes.  The
library lands in ``repro_torch/_build/`` (ignored by git) under a name
keyed on a hash of the source and the flags, so a stale library is never
loaded.  ``build`` starts one ``nvcc`` per missing source, all at once.

Every library exports ``<name>_launch`` (returns ``cudaGetLastError()``
after its launches) and ``cuda_error_string``.  A failed build or launch
raises: there is no fallback to the plain PyTorch version for a CUDA
tensor.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_build"
SOURCES = ("flash_attention", "decode_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under PyTorch's idea of CUDA_HOME."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                       "need the CUDA toolkit to build")


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, Path]:
    """Compile every named source whose library is missing, in parallel.

    Returns name -> library path.  ``ptxas``'s report (registers, shared
    memory, spills per kernel) is kept beside each library as ``.log``.
    """
    paths = {n: library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    exe = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n, p in todo.items():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        procs[n] = (tmp, subprocess.Popen(
            [exe, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{n}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        todo[n].with_suffix(".log").write_text(out)
        if proc.returncode == 0:
            os.replace(tmp, todo[n])
        else:
            os.unlink(tmp)
            failed.append(f"{n}.cu (nvcc exit {proc.returncode}):\n{out}")
    if failed:
        raise RuntimeError("CUDA build failed: " + "\n".join(failed))
    return paths


def library(name: str, argtypes) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; declare its entry."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        entry = getattr(lib, f"{name}_launch")
        entry.argtypes = argtypes
        entry.restype = ctypes.c_int
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, name: str):
    """Raise if a launch returned a CUDA error (e.g. a refused launch)."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({lib.cuda_error_string(err).decode()})")


def ptxas_report(name: str) -> str:
    """The ptxas lines of the last build of ``name`` (empty if none)."""
    log = library_path(name).with_suffix(".log")
    if not log.exists():
        return ""
    return "\n".join(line for line in log.read_text().splitlines()
                     if "ptxas" in line)
