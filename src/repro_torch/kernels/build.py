"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/*.cu`` file compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), for
``sm_90a``.  All sources compile in parallel, one ``nvcc`` each.  Builds
land in ``build/repro_torch_kernels/`` at the repository root (listed in
``.gitignore``), named by a hash of the sources and flags, so a changed
source never loads a stale library.  Nothing is built or loaded at
import time: the first kernel launch (or an explicit ``build_all()``)
does it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

# library name -> source file; each exports its extern "C" entry points
SOURCES: Dict[str, str] = {
    "paged_attention": "paged_attention.cu",
    "flash_attention": "flash_attention.cu",
    "flash_attention_bwd": "flash_attention_bwd.cu",
    "topk": "topk.cu",
    "topk_list": "topk_list.cu",
    "topk_select": "topk_select.cu",
    "ivf_topk": "ivf_topk.cu",
    "ivf_select": "ivf_select.cu",
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda/bin/nvcc,
    or ``nvcc`` on PATH.  Raises when none exists."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels are built from source at first use")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(ptxas_verbose: bool = False) -> Dict[str, str]:
    """Compile every missing library in parallel; returns {name: nvcc
    stderr} (the ``-Xptxas -v`` register/spill report when asked for).
    Raises with the compiler output when a build fails."""
    extra = ["-Xptxas", "-v"] if ptxas_verbose else []
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name, src in SOURCES.items():
        out = _lib_path(name)
        if out.exists() and not ptxas_verbose:
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-o", str(tmp), str(CSRC / src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       tmp, out)
    reports, failures = {}, []
    for name, (proc, tmp, out) in procs.items():
        stdout, stderr = proc.communicate()
        reports[name] = stdout + stderr
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n"
                            f"{stdout}{stderr}")
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return reports


def sass(name: str) -> str:
    """``cuobjdump -sass`` of the built library ``name`` (built first if
    missing): the machine code the card runs."""
    path = _lib_path(name)
    if not path.exists():
        build_all()
    tool = Path(nvcc_path()).parent / "cuobjdump"
    return subprocess.run([str(tool), "-sass", str(path)], check=True,
                          capture_output=True, text=True).stdout


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (built first if missing)."""
    lib = _LIBS.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib

