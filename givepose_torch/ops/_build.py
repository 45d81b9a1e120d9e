"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/*.cu`` file is compiled, at first use, into a plain-C shared
library under ``build/givepose_torch/`` at the repository root (listed in
``.gitignore``).  The file name carries a hash of the source, of every
shared header (``csrc/*.cuh``) and of the flags, so an edited source or
header is rebuilt and an unchanged one is loaded as it is.  ``build()``
starts one nvcc per source, all at once.  Nothing here runs at import
time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "givepose_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
# ptxas report (registers, spills) of each library built by this process
build_logs: dict[str, str] = {}


def find_nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are built from source")


def all_sources() -> list[str]:
    return sorted(p.name for p in CSRC_DIR.glob("*.cu"))


def library_path(source: str) -> Path:
    src = CSRC_DIR / source
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    digest = h.hexdigest()
    return BUILD_DIR / f"lib{src.stem}-{digest[:16]}.so"


def build(sources: list[str] | None = None) -> None:
    """Compile every source (default: all of ``csrc/*.cu``) that has no
    library yet, one nvcc each, started together; raise if any fails."""
    jobs = []
    for source in sources or all_sources():
        out = library_path(source)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / source)]
        jobs.append((source, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    errors = []
    for source, out, tmp, proc in jobs:
        stdout, stderr = proc.communicate()
        if proc.returncode == 0:
            build_logs[source] = stderr
            os.replace(tmp, out)          # atomic: concurrent builders agree
        else:
            os.unlink(tmp)
            errors.append(f"nvcc failed on {source} ({proc.returncode}):\n"
                          f"{stdout}\n{stderr}")
    if errors:
        raise RuntimeError("\n".join(errors))


def load_library(source: str) -> ctypes.CDLL:
    """Compile ``csrc/<source>`` if needed and return the loaded library."""
    with _lock:
        if source not in _loaded:
            build([source])
            _loaded[source] = ctypes.CDLL(str(library_path(source)))
        return _loaded[source]
