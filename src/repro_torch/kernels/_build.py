"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles, at first use, into a shared library with
a plain ``extern "C"`` interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC

No PyTorch header is included, so a build takes seconds, not minutes.  The
library lands in ``repro_torch/_build/`` (ignored by git) under a name
keyed on a hash of the source, the shared headers ``csrc/*.cuh`` and the
flags, so a stale library is never loaded.  ``build`` starts one ``nvcc``
per missing source, all at once.

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
import threading
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_build"
SOURCES = ("flash_attention", "flash_attention_bwd", "decode_attention",
           "ssd_scan", "ssd_scan_bwd", "rglru_scan", "rope",
           "partition_probe")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}
# .part: (key, SMs) of the SM partition whose context is current on this
# thread (a CUDA context is current per thread), set by
# ``repro_torch.launch.partition.Partition``; unset for the whole card
_current = threading.local()
_card_sms: dict[int, int] = {}


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
    for header in sorted(CSRC.glob("*.cuh")):  # the shared headers
        digest.update(header.read_bytes())
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


def current_stream(device_index: int) -> int:
    """The raw handle of PyTorch's current stream on a card: the stream a
    kernel launches on.  (``torch.cuda.current_stream().cuda_stream``
    gives the same handle through a Python stream object, at several
    microseconds a call on the H100 host: too slow for a decode step that
    waits on the host.)"""
    import torch
    return torch._C._cuda_getCurrentRawStream(device_index)


def set_partition(part: tuple[int, int] | None):
    """Make ``part`` ((key, SMs), or None for the whole card) the partition
    that launches go to; returns the one it replaces."""
    prev = getattr(_current, "part", None)
    _current.part = part
    return prev


def partition_key() -> int:
    """The key of the current partition (0: the whole card)."""
    part = getattr(_current, "part", None)
    return 0 if part is None else part[0]


def partition(device_index: int) -> tuple[int, int]:
    """(key, SMs) of where a launch on card ``device_index`` runs now: the
    current partition's, or (0, the card's SM count)."""
    part = getattr(_current, "part", None)
    if part is not None:
        return part
    sms = _card_sms.get(device_index)
    if sms is None:
        import torch
        sms = _card_sms[device_index] = torch.cuda.get_device_properties(
            device_index).multi_processor_count
    return 0, sms


def check(lib: ctypes.CDLL, err: int, name: str):
    """Raise if a launch returned a CUDA error (e.g. a refused launch)."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({lib.cuda_error_string(err).decode()})")


def ptxas_report(name: str) -> str:
    """The ptxas lines of the last build of ``name`` (empty if none), with
    each function's stack frame and spills."""
    log = library_path(name).with_suffix(".log")
    if not log.exists():
        return ""
    return "\n".join(line for line in log.read_text().splitlines()
                     if "ptxas" in line or "spill" in line)
