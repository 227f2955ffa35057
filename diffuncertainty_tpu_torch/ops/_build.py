"""Build the package's CUDA sources with plain ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into
``_build/lib<name>_<hash>.so`` (the hash covers the source text and the
flags), so a changed source rebuilds and an unchanged one is reused. All
sources build in parallel, one ``nvcc`` each. The libraries expose plain C
functions and include no PyTorch headers, so a build takes seconds and needs
neither PyTorch's C++ extension machinery nor ``ninja``. The build runs at first
use, never at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}  # source name -> nvcc's output (ptxas register report)


def find_nvcc() -> str:
    """``nvcc`` from PATH, then ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found on PATH, in $CUDA_HOME/bin or /usr/local/cuda/bin")


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all() -> float:
    """Compile every source that has no up-to-date library; returns seconds."""
    t0 = time.perf_counter()
    todo = [n for n in sources() if not _lib_path(n).is_file()]
    if not todo:
        return 0.0
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        tmp = _lib_path(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        build_log[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        if not _lib_path(name).is_file():
            build_all()
        lib = ctypes.CDLL(str(_lib_path(name)))
        _loaded[name] = lib
    return lib
