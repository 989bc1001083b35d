"""Build-at-first-use for the hand-written CUDA kernels.

Each kernel family is one or more ``.cu`` files with a plain C interface.
They are compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``build/repro_torch/`` (override with ``REPRO_TORCH_BUILD_DIR``), keyed on a
hash of the flags, the sources and every file beside them and in
``kernels/csrc/`` (the shared include directory), so that a header edit
rebuilds, and loaded with ``ctypes``. Nothing here runs at import time: a build starts the first time a wrapper is handed a CUDA
tensor. There is no fallback: if ``nvcc`` is missing or the build fails the
caller gets the error.

``start_build`` returns at once so that several libraries can compile side
by side; ``load`` waits for one and opens it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

# headers shared by several kernel families (the quantizer's device code)
INCLUDE_DIR = Path(__file__).resolve().parent / "csrc"

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
_pending: Dict[str, "Build"] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    # src/repro_torch/kernels/_build.py -> the checkout's root
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH, $CUDA_HOME/bin and "
        "/usr/local/cuda/bin): the CUDA kernels cannot be built here")


class Build:
    """One library's compilation, possibly still running."""

    def __init__(self, name: str, target: Path, proc, tmp: Optional[Path],
                 cmd: Sequence[str]):
        self.name, self.target, self.proc = name, target, proc
        self.tmp, self.cmd = tmp, list(cmd)

    def wait(self) -> Path:
        if self.proc is not None:
            out, _ = self.proc.communicate()
            if self.proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {self.name} (exit "
                    f"{self.proc.returncode}):\n{' '.join(self.cmd)}\n"
                    f"{out.decode(errors='replace')}")
            os.replace(self.tmp, self.target)   # atomic: no half-written .so
            self.proc = None
        return self.target


def key_files(sources: Sequence[Path],
              include_dirs: Sequence[Path] = (INCLUDE_DIR,)) -> List[Path]:
    """The files a library's key hashes: the sources, then every file in
    their own directories and in ``include_dirs`` (all a source can
    include), each once."""
    files = dict.fromkeys(Path(s).resolve() for s in sources)
    for d in [Path(s).resolve().parent for s in sources] + list(include_dirs):
        files.update(dict.fromkeys(
            sorted(p.resolve() for p in Path(d).iterdir() if p.is_file())))
    return list(files)


def _key(sources: Sequence[Path], flags: Sequence[str],
         include_dirs: Sequence[Path] = (INCLUDE_DIR,)) -> str:
    h = hashlib.sha256()
    for f in flags:
        h.update(f.encode())
    for src in key_files(sources, include_dirs):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def start_build(name: str, sources: Sequence[os.PathLike],
                extra_flags: Sequence[str] = ()) -> Build:
    """Start compiling ``sources`` into ``lib<name>-<hash>.so`` unless that
    file already exists. Returns a :class:`Build` to ``wait()`` on."""
    with _lock:
        if name in _pending:
            return _pending[name]
        sources = [Path(s) for s in sources]
        flags = list(NVCC_FLAGS) + list(extra_flags)
        out_dir = build_dir()
        out_dir.mkdir(parents=True, exist_ok=True)
        target = out_dir / f"lib{name}-{_key(sources, flags)}.so"
        if target.exists():
            build = Build(name, target, None, None, ())
        else:
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            # the include directory is not part of the key: its path differs
            # between checkouts, the headers' contents are hashed instead
            cmd = [find_nvcc(), *flags, "-I", str(INCLUDE_DIR),
                   "-o", str(tmp), *[str(s) for s in sources]]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT)
            build = Build(name, target, proc, tmp, cmd)
        _pending[name] = build
        return build


def load(name: str, sources: Sequence[os.PathLike],
         extra_flags: Sequence[str] = ()) -> ctypes.CDLL:
    """Build (if needed) and open one kernel library; cached per process."""
    lib = _loaded.get(name)
    if lib is None:
        path = start_build(name, sources, extra_flags).wait()
        with _lock:
            lib = _loaded.setdefault(name, ctypes.CDLL(str(path)))
    return lib
