"""Build the port's CUDA sources into shared libraries with a C interface.

Each source under ``repro_torch/csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into ``build/kernels/lib<name>-<digest>.so`` at the repository
root (listed in ``.gitignore``) and loaded with ``ctypes``. The digest
covers the source and the flags, so an edited source builds anew and an
unchanged one is reused. Sources build at first use, one ``nvcc`` process
each, all started together; a build writes to a temporary name and is
renamed into place, so concurrent processes never load a half-written
library. The digest also covers the shared headers (``csrc/*.cuh``) and
any ``-D`` defines, with which a probe builds a variant of a source's
compile-time constants beside the default build. Nothing here runs at
import: the CPU-only test environment imports every module and has no
``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

__all__ = ["SOURCES", "BUILD_DIR", "NVCC_FLAGS", "build", "load",
           "aligned16"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

# kernel library name -> source file under csrc/
SOURCES: Dict[str, str] = {"skyline": "skyline.cu",
                           "cluster_step": "cluster_step.cu",
                           "flash_attention": "flash_attention.cu",
                           "ssd": "ssd.cu"}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[Tuple[str, Tuple[str, ...]], ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin); the port's "
                       "CUDA kernels build only where the CUDA toolkit is")


def library_path(name: str, defines: Tuple[str, ...] = ()) -> Path:
    h = hashlib.sha256((CSRC / SOURCES[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):      # shared device code
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS + _define_flags(defines)).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _define_flags(defines: Tuple[str, ...]) -> Tuple[str, ...]:
    return tuple(f"-D{d}" for d in defines)


def build(names: Optional[Iterable[str]] = None,
          defines: Tuple[str, ...] = ()) -> Dict[str, Path]:
    """Compile the named sources (all by default) not built yet, in
    parallel, with ``defines`` (``"NAME=value"``, none by default) passed
    as ``-D`` flags. Returns {name: library path}; raises with nvcc's
    output if a build fails. ``<library>.log`` keeps nvcc's output (ptxas
    registers, shared memory and spills, from ``-Xptxas -v``)."""
    names = list(SOURCES) if names is None else list(names)
    defines = tuple(defines)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    for name in names:
        out = library_path(name, defines)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *_define_flags(defines), "-o", str(tmp),
               str(CSRC / SOURCES[name])]
        running[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True),
                         tmp, out)
    failed = []
    for name, (proc, tmp, out) in running.items():
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return {name: library_path(name, defines) for name in names}


def aligned16(t):
    """``t`` itself where its data is 16-byte aligned, else a copy in a
    fresh allocation (the caching allocator aligns every block): the
    kernels' TMA and vector loads need the alignment, and a contiguous
    view at an odd offset is still a valid input."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def load(name: str, defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """The named kernel library (built with ``defines``, none by default),
    built first if needed; loaded once per process."""
    key = (name, tuple(defines))
    with _lock:
        lib = _loaded.get(key)
        if lib is None:
            lib = _loaded[key] = ctypes.CDLL(
                str(build([name], key[1])[name]))
        return lib
