"""Where the port's native builds live: the counterpart of the JAX
package's persistent compilation cache (`distgcn_tpu/utils/compile_cache.py`).

The JAX package's cold-start cost is XLA compiling its programs; the
port's is its builds: nvcc of ``csrc/*.cu`` (`ops/_build.py`) and g++ of
``native/mwis_exact.cpp`` (`solvers/exact.py`). Both keep their libraries
under one build root, each under a name that hashes its source and flags
(and, for the host library, the CPU), so a library is never loaded on
another source or CPU, and a second process with the same sources starts
without a build.

``DISTGCN_TORCH_CACHE`` places the root:

    unset          the repository's ``build/`` (the default)
    a path         ``<path>/kernels`` and ``<path>/native``
    ``0``, ``off`` a temporary directory of this process, removed at exit:
                   every process builds anew, as without a persistent cache
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile
from pathlib import Path
from typing import Optional

REPO_BUILD = Path(__file__).resolve().parents[2] / "build"
_OFF = ("0", "", "off", "none")
_TEMP: list = []          # this process's temporary root, made at most once


def _temp_root() -> Path:
    if not _TEMP:
        path = tempfile.mkdtemp(prefix="distgcn_torch_build-")
        atexit.register(shutil.rmtree, path, ignore_errors=True)
        _TEMP.append(Path(path))
    return _TEMP[0]


def enable_persistent_cache() -> Optional[str]:
    """Point the kernel and native builds at the root that
    ``DISTGCN_TORCH_CACHE`` names (`ops._build.BUILD_DIR`,
    `solvers.exact.BUILD_DIR`). Safe to call repeatedly.

    Returns the root, or None when the cache is off."""
    from distgcn_tpu_torch.ops import _build
    from distgcn_tpu_torch.solvers import exact

    spec = os.environ.get("DISTGCN_TORCH_CACHE")
    if spec is None:
        root, out = REPO_BUILD, str(REPO_BUILD)
    elif spec.strip().lower() in _OFF:
        root, out = _temp_root(), None
    else:
        root, out = Path(spec), spec
    _build.BUILD_DIR = root / "kernels"
    exact.BUILD_DIR = root / "native"
    return out
