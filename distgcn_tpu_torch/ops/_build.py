"""Build and load the hand-written CUDA kernels of `csrc/`.

Each ``csrc/<name>.cu`` exposes a plain C interface. At first use it is
compiled with nvcc for ``sm_90a`` into a shared library under
`BUILD_DIR`, ``build/kernels/`` at the repository root (gitignored) unless
`utils.compile_cache.enable_persistent_cache` places it elsewhere, and
loaded with ctypes. The library's file name carries a hash of the source, the headers
of ``csrc/`` (``*.cuh``) and the flags, so an edited source or header is
rebuilt and a stale library is never loaded. `build` starts one nvcc per
source, all together, and keeps each ``-Xptxas -v`` report (registers,
shared memory, spills) in `BUILD_LOGS`. `bind` gives a
source's launch function with its argument types, raising on a non-zero
launch status. ``defines`` (``NAME=VALUE`` strings, passed as ``-D``)
build a variant of a source into a library of its own.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch

from distgcn_tpu_torch.utils.compile_cache import REPO_BUILD

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = REPO_BUILD / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_TIMEOUT_S = 600

BUILD_LOGS: Dict[str, str] = {}
_LIBS: Dict[tuple, ctypes.CDLL] = {}
_BOUND: Dict[tuple, Callable[..., None]] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.isfile(path):
        raise RuntimeError(f"nvcc not found (looked on PATH and at {path}); "
                           "the CUDA kernels are built on the machine with "
                           "the card")
    return path


def _flags(defines: Tuple[str, ...]) -> list:
    return [*NVCC_FLAGS, *(f"-D{d}" for d in defines)]


def library_path(name: str, defines: Tuple[str, ...] = ()) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(_flags(defines)).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None,
          defines: Tuple[str, ...] = ()) -> None:
    """Compile every source in `names` (default: all of csrc/) that has no
    current library. Raises with the compiler's output if one fails."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    jobs = {}
    for name in names:
        out = library_path(name, defines)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # compile to a private name, then rename: a process that already
        # loaded a library never sees it truncated
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *_flags(defines), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    failed = []
    for name, (proc, tmp, out) in jobs.items():
        try:
            log, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
            log += f"\nnvcc timed out after {BUILD_TIMEOUT_S} s"
        BUILD_LOGS[name] = log
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(f"--- {name}.cu (exit {proc.returncode}) ---\n{log}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def load(name: str, defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """The ctypes library of ``csrc/<name>.cu``, built at first use."""
    key = (name, tuple(defines))
    lib = _LIBS.get(key)
    if lib is None:
        path = library_path(name, defines)
        if not path.exists():
            build([name], defines)
        lib = ctypes.CDLL(str(path))
        _LIBS[key] = lib
    return lib


def bind(name: str, fn: str, argtypes,
         defines: Tuple[str, ...] = ()) -> Callable[..., None]:
    """The launch function `fn` of ``csrc/<name>.cu`` with its ctypes
    argtypes. It returns a cudaError_t; the bound callable raises
    RuntimeError when that is not 0, with the message of
    ``<name>_error_string``."""
    key = (name, fn, tuple(defines))
    call = _BOUND.get(key)
    if call is None:
        lib = load(name, defines)
        c_fn = getattr(lib, fn)
        c_fn.argtypes = list(argtypes)
        c_fn.restype = ctypes.c_int
        err_str = getattr(lib, f"{name}_error_string")
        err_str.argtypes = [ctypes.c_int]
        err_str.restype = ctypes.c_char_p

        def call(*args):
            err = c_fn(*args)
            if err != 0:
                raise RuntimeError(f"{name} kernel launch failed: "
                                   f"{err_str(err).decode()} ({err})")

        _BOUND[key] = call
    return call


def stream_of(t) -> int:
    """The current CUDA stream of tensor `t`'s device, as an int handle."""
    return torch.cuda.current_stream(t.device).cuda_stream
