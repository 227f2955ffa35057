"""ctypes bridge to the native npy batch reader (``csrc/npy_batch_loader.cpp``,
a copy of the JAX package's ``native/npy_batch_loader.cpp``; port of
``diffuncertainty_tpu/data/native_loader.py``).

Reads a batch of npy files straight into one contiguous numpy buffer with a
C++ thread pool. The source compiles with the host C++ compiler (``$CXX``,
else ``g++``, else ``c++``) at first use, never at import, into
``_build/libnpy_batch_loader_<hash>.so`` (the hash covers the source and the
flags): built under a temporary name and renamed, so processes that build at
once do not read a half-written library.

Unlike the JAX module, nothing falls back to numpy here: a missing compiler,
a failed build, a failed load or a failed read raises with the compiler's or
the reader's message. ``data/loader.py`` decides from the dataset's files
whether a tree goes through this reader (``READS`` lists the npy dtypes it
converts), never by catching its errors.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "npy_batch_loader.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-pthread", "-Wall", "-shared")
# the npy dtypes (``descr``) the reader converts into each slot dtype
READS = {"float32": {"<f4", "<f8", "|u1", "<i4"},
         "int32": {"<i4", "<i8", "|u1", "|i1"}}

_lib = None
_reads = 0


def find_cxx() -> str:
    for name in (os.environ.get("CXX"), "g++", "c++"):
        found = name and shutil.which(name)
        if found:
            return found
    raise RuntimeError("no C++ compiler ($CXX, g++ or c++) on PATH to build the native batch "
                       "reader")


def library_path(source: Path = SOURCE) -> Path:
    digest = hashlib.sha256(Path(source).read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"lib{Path(source).stem}_{digest.hexdigest()[:16]}.so"


def build(source: Path = SOURCE) -> Path:
    """The library of ``source``, compiled first unless it is up to date;
    raises with the compiler's output if the compiler fails."""
    lib = library_path(source)
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    out = subprocess.run([find_cxx(), *CXX_FLAGS, "-o", str(tmp), str(source)],
                         capture_output=True, text=True)
    if out.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the native batch reader from {source} failed (exit "
                           f"{out.returncode}):\n{out.stdout}{out.stderr}")
    os.replace(tmp, lib)
    return lib


def _load_lib():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.npy_load_batch.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_void_p,
                                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
        lib.npy_load_batch.restype = ctypes.c_int
        _lib = lib
    return _lib


def read_count() -> int:
    """Batches read through the library since :func:`reset_read_count`."""
    return _reads


def reset_read_count() -> None:
    global _reads
    _reads = 0


_DESCR = re.compile(r"'descr':\s*'([^']+)'")
_FORTRAN = re.compile(r"'fortran_order':\s*(True|False)")
_SHAPE = re.compile(r"'shape':\s*\(([0-9,\s]*)\)")


def header(path: str | Path) -> tuple[tuple[int, ...], str, bool]:
    """(shape, dtype descr, fortran order) from an npy file's header, read as
    the reader reads it: each of the dictionary's three fields found by name
    (numpy's own reader evaluates the dictionary as a literal, several times
    slower, and a plan reads the header of every file of a split)."""
    with open(path, "rb") as f:
        head = f.read(12)
        if head[:6] != b"\x93NUMPY":
            raise ValueError(f"{path}: not an npy file")
        size, start = (int.from_bytes(head[8:10], "little"), 10) if head[6] == 1 else \
            (int.from_bytes(head[8:12], "little"), 12)
        text = (head[start:] + f.read(size - (12 - start))).decode("latin1")
    found = [r.search(text) for r in (_DESCR, _FORTRAN, _SHAPE)]
    if not all(found):
        raise ValueError(f"{path}: an npy header the reader does not parse: {text!r}")
    descr, fortran, shape = (m.group(1) for m in found)
    return tuple(int(n) for n in shape.replace(",", " ").split()), descr, fortran == "True"


def load_batch(paths: list[str | Path], slot_shape: tuple[int, ...], *,
               dtype: str = "float32", num_threads: int = 8) -> np.ndarray:
    """Read ``paths`` into a (N, *slot_shape) float32 or int32 array; every
    file must hold exactly ``prod(slot_shape)`` elements in C order, of a
    dtype in ``READS[dtype]`` (uint8 images are scaled by 1/255 into float32
    slots, as the dataset's reader does)."""
    global _reads
    lib = _load_lib()
    out = np.empty((len(paths), *slot_shape), np.float32 if dtype == "float32" else np.int32)
    blob = b"\0".join(str(p).encode() for p in paths) + b"\0"
    rc = lib.npy_load_batch(blob, len(paths), out.ctypes.data_as(ctypes.c_void_p),
                            int(np.prod(slot_shape)), 0 if dtype == "float32" else 1,
                            num_threads)
    if rc != 0:
        raise IOError(f"the native batch reader failed on '{paths[rc - 100]}' (a missing file, "
                      f"a bad header, another element count or an unread dtype)"
                      if rc >= 100 else f"the native batch reader failed: error {rc}")
    _reads += 1
    return out
