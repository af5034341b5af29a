"""Build the port's CUDA C++ kernels with ``nvcc`` and load them.

Every ``*.cu`` file under ``src/repro_torch/csrc/`` has a plain C
interface and is compiled on its own into a shared library for Hopper
(``sm_90a``), all sources at once, one ``nvcc`` process each. Outputs go
to ``build/repro_torch/<hash>/`` at the repository root, keyed by a hash
of the sources and flags, so a checkout builds once and reuses the
result. Libraries are loaded with ``ctypes``; callers set ``argtypes``.

A failed or missing compiler raises: nothing stands in for a kernel
that did not build.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
#: ptxas report (registers, shared memory, spills) of each library, kept
#: beside it as ``lib<stem>.log`` so that a reused build reports it too
BUILD_LOG: Dict[str, str] = {}


def _nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cands.append(os.path.join(os.environ[env], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA toolkit is required to "
                       "build the port's kernels")


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> Dict[str, Path]:
    """Compile every ``csrc/*.cu`` that has no up-to-date library yet, all
    in parallel. Returns {source stem: library path}."""
    out_dir = _build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {src.stem: out_dir / f"lib{src.stem}.so"
            for src in sorted(CSRC.glob("*.cu"))}
    todo = {stem: lib for stem, lib in libs.items() if not lib.exists()}
    for stem in libs.keys() - todo.keys():
        log = out_dir / f"lib{stem}.log"
        if log.exists():
            BUILD_LOG[stem] = log.read_text()
    if not todo:
        return libs
    nvcc = _nvcc()
    procs = {}
    for stem, lib in todo.items():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{stem}.cu")]
        procs[stem] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for stem, (tmp, p) in procs.items():
        log, _ = p.communicate()
        BUILD_LOG[stem] = log
        if p.returncode != 0:
            failed.append(f"{stem}.cu (exit {p.returncode}):\n{log}")
            os.unlink(tmp)
        else:
            (out_dir / f"lib{stem}.log").write_text(log)
            os.replace(tmp, todo[stem])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return libs


def load(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (built on first
    use)."""
    lib = _LIBS.get(stem)
    if lib is None:
        path: Optional[Path] = build_all().get(stem)
        if path is None:
            raise RuntimeError(f"no source csrc/{stem}.cu")
        lib = _LIBS[stem] = ctypes.CDLL(str(path))
    return lib
