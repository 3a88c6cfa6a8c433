"""Build and load the hand-written CUDA kernels of `csrc/`.

Each ``csrc/<name>.cu`` exposes a plain C interface. At first use it is
compiled with nvcc for ``sm_90a`` into a shared library under
``build/kernels/`` at the repository root (gitignored) and loaded with
ctypes. The library's file name carries a hash of the source and flags, so
an edited source is rebuilt and a stale library is never loaded. `build`
starts one nvcc per source, all together, and keeps each ``-Xptxas -v``
report (registers, shared memory, spills) in `BUILD_LOGS`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_TIMEOUT_S = 600

BUILD_LOGS: Dict[str, str] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.isfile(path):
        raise RuntimeError(f"nvcc not found (looked on PATH and at {path}); "
                           "the CUDA kernels are built on the machine with "
                           "the card")
    return path


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> None:
    """Compile every source in `names` (default: all of csrc/) that has no
    current library. Raises with the compiler's output if one fails."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # compile to a private name, then rename: a process that already
        # loaded a library never sees it truncated
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
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


def load(name: str) -> ctypes.CDLL:
    """The ctypes library of ``csrc/<name>.cu``, built at first use."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib
