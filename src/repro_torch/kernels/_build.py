"""Build and load the port's CUDA kernels.

Each source under ``src/repro_torch/csrc/*.cu`` is compiled by ``nvcc``
into its own shared library with a plain C interface and loaded with
`ctypes`:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/kernels/<stem>-<hash>.so csrc/<stem>.cu

The build is lazy: nothing is compiled when a module is imported, only at
the first kernel launch (or an explicit :func:`build_all`), and then every
source at once, one ``nvcc`` process per source, all started together.
Libraries land in ``build/kernels/`` at the root of the checkout, named by
a hash of their source, the shared headers and the flags, so an edited
source is rebuilt and a current one is reused.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
SOURCES = ("sliced_ell_spmv", "cheb_step", "cheb_sweep", "jacobi_step",
           "jacobi_sweep", "ista_shrink", "flash_attention")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit on the machine that holds the card")


def _target(stem: str) -> Path:
    src = (CSRC / f"{stem}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{stem}-{digest[:12]}.so"


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile every missing library in parallel and load all of them."""
    with _lock:
        missing = [s for s in SOURCES
                   if s not in _libs and not _target(s).exists()]
        if missing:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            nvcc = _nvcc()
            procs = []
            for stem in missing:
                tmp = _target(stem).with_suffix(f".{os.getpid()}.tmp")
                cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
                       str(CSRC / f"{stem}.cu")]
                procs.append((stem, tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
            errors = []
            for stem, tmp, proc in procs:
                out, _ = proc.communicate()
                if proc.returncode != 0:
                    errors.append(f"nvcc {stem}.cu failed "
                                  f"({proc.returncode}):\n{out.decode()}")
                else:
                    os.replace(tmp, _target(stem))
            if errors:
                raise RuntimeError("\n".join(errors))
        for stem in SOURCES:
            if stem not in _libs:
                _libs[stem] = ctypes.CDLL(str(_target(stem)))
        return dict(_libs)


def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (builds on first
    use)."""
    lib = _libs.get(stem)
    return lib if lib is not None else build_all()[stem]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C launcher of `lib` returned a CUDA error code."""
    if err != 0:
        lib.error_string.restype = ctypes.c_char_p
        lib.error_string.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{what}: CUDA error {err} at launch: "
                           f"{lib.error_string(err).decode()}")


def current_stream(device: torch.device) -> int:
    """The raw handle of `device`'s current CUDA stream, which a launch
    takes (the value of ``torch.cuda.current_stream(device).cuda_stream``,
    without building the Stream object on every launch)."""
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    return torch._C._cuda_getCurrentRawStream(index)


def device_scope(device: torch.device):
    """The context a launch on `device` runs in: nothing when `device` is
    the current CUDA device (the usual case), else ``torch.cuda.device``.
    Reusable: a loop resolves it once."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)
