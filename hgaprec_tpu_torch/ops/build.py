"""Build the package's CUDA kernels at first use and load them with ctypes.

Sources are `hgaprec_tpu_torch/csrc/*.cu` and nothing else; the only
headers they include are the CUDA toolkit's. `nvcc` compiles them into one
shared library with a plain C interface under `<checkout>/.kernel_build/`,
named by a hash of the sources and flags, so a changed source or flag
builds anew and an unchanged one is loaded as is. Nothing here runs at
import time: the CPU test machines have no nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import List

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), ".kernel_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def sources() -> List[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH): the CUDA kernels cannot be built")
    return path


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"hgaprec_kernels_{h.hexdigest()[:16]}.so")


def build_log_path() -> str:
    return library_path()[:-len(".so")] + ".log"


def nvcc_command(out_path: str) -> List[str]:
    return [_nvcc(), *NVCC_FLAGS, "-o", out_path, *sources()]


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if no cached build matches) and load the kernel library.

    Raises with nvcc's stderr when the build fails. A build leaves nvcc's
    stderr (ptxas register and shared-memory usage) beside the library,
    in `build_log_path()`."""
    path = library_path()
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.run(nvcc_command(tmp), capture_output=True,
                              text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stderr}")
        with open(build_log_path(), "w") as f:
            f.write(proc.stderr)
        os.replace(tmp, path)     # atomic: a reader never sees half a file
    return ctypes.CDLL(path)
