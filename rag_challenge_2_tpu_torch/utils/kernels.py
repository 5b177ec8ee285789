"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled on first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface under the git-ignored
``build/kernels/`` at the root of the checkout, then loaded with ctypes.
A plain C interface keeps a build at seconds; a PyTorch extension that
includes the torch headers takes minutes per build.  Pointers go in as
``data_ptr()`` and the stream as ``torch.cuda.current_stream().cuda_stream``,
all typed ``c_void_p`` so ctypes never truncates them to 32 bits.

Nothing here runs at import time: the CPU-only test machines import every
module and have no ``nvcc``.  A failed build raises — there is no fallback
to a plain version for CUDA tensors.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Sequence

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    "-lcuda",  # the driver API: cuTensorMapEncodeTiled for TMA tensor maps
]

_libs: Dict[str, ctypes.CDLL] = {}
# the ptxas report (registers, shared memory, spills) of each build
build_logs: Dict[str, str] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def source_files(src: Path) -> List[Path]:
    """``src`` and every header of ``csrc/`` it includes with quotes,
    directly or through another such header."""
    seen, todo = [], [src]
    while todo:
        f = todo.pop()
        if f in seen or not f.exists():
            continue
        seen.append(f)
        todo += [f.parent / inc for inc in _INCLUDE.findall(f.read_text())]
    return seen


def _build(name: str, src: Optional[Path] = None) -> Path:
    src = src or CSRC / f"{name}.cu"
    lib = BUILD_DIR / f"lib{name}.so"
    # rebuilt when the source or a header it includes is newer
    newest = max(f.stat().st_mtime for f in source_files(src))
    if lib.exists() and lib.stat().st_mtime >= newest:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, str(src), "-o", tmp],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {src.name}:\n{proc.stdout}\n{proc.stderr}"
            )
        build_logs[name] = proc.stderr
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def build_all(names: Optional[Sequence[str]] = None) -> None:
    """Build every ``csrc/*.cu`` (or ``names``) at once: one ``nvcc`` per
    source, all started together, so the wall time is the slowest build's.
    :func:`load_library` then finds the libraries built."""
    names = list(names or sorted(p.stem for p in CSRC.glob("*.cu")))
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        list(pool.map(_build, names))


def load_library(name: str, src: Optional[Path] = None) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, or from ``src`` (a
    baseline kept outside the port), built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_build(name, src)))
            lib.rc2_cuda_error_string.restype = ctypes.c_char_p
            lib.rc2_cuda_error_string.argtypes = [ctypes.c_int]
            _libs[name] = lib
        return lib


def check_launch(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` returned by a launch."""
    if rc != 0:
        msg = lib.rc2_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")

