"""Build and load the port's CUDA sources.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface (no PyTorch headers, so a build takes seconds), and
loads with ``ctypes``. The library lands in ``rovit_kan_tpu_torch/_build/``
(listed in ``.gitignore``) under a name keyed on a hash of the source, of
every ``csrc/*.cuh`` header it includes (directly or through another header)
and of the flags, so an edited source or header rebuilds and an unchanged one
is reused. The build
runs at first use, never at import: the CPU tests import every module on a
machine with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _headers(path: Path, seen: List[Path]) -> List[Path]:
    """The ``csrc`` headers ``path`` includes, in first-seen order."""
    for name in _INCLUDE.findall(path.read_text()):
        header = CSRC / name
        if header.exists() and header not in seen:
            seen.append(header)
            _headers(header, seen)
    return seen


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in _headers(src, []):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start ``nvcc`` for one source; returns (process, tmp path, target)
    or None when the library is already built."""
    target = library_path(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def _finish(started) -> str:
    proc, tmp, target = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {target.name}:\n{log}")
    os.replace(tmp, target)          # atomic when two processes build at once
    target.with_suffix(".log").write_text(log)
    return log


def build(names: Iterable[str]) -> Dict[str, str]:
    """Build the named sources concurrently (one ``nvcc`` each, all started
    together). Returns each source's compiler log ("" when it was cached)."""
    names: List[str] = list(names)
    started = {n: _start(n) for n in names}
    logs = {}
    try:
        for n in names:
            logs[n] = "" if started[n] is None else _finish(started[n])
    finally:
        for s in started.values():          # stop any nvcc left running
            if s is not None and s[0].poll() is None:
                s[0].kill()
                s[0].wait()
    return logs


def all_sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
        return lib
