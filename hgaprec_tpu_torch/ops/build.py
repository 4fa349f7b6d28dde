"""Build the package's CUDA kernels at first use and load them with ctypes.

Sources are `hgaprec_tpu_torch/csrc/*.cu`; the headers they share are
`csrc/*.cuh`, and the only other headers they include are the CUDA
toolkit's. One `nvcc` per source compiles it into an object, all of them
started together, and a last `nvcc` links the objects into one shared
library with a plain C interface under `<checkout>/.kernel_build/`, named
by a hash of the sources, the headers and the flags, so a changed source,
header or flag builds anew and an unchanged one is loaded as is. Nothing
here runs at import time: the CPU test machines have no nvcc.
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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def sources() -> List[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def headers() -> List[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


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
    for src in sources() + headers():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"hgaprec_kernels_{h.hexdigest()[:16]}.so")


def build_log_path() -> str:
    return library_path()[:-len(".so")] + ".log"


def compile_command(src: str, obj: str) -> List[str]:
    """nvcc command that compiles one source into an object."""
    return [_nvcc(), *NVCC_FLAGS, "-c", "-o", obj, src]


def link_command(out_path: str, objs: List[str]) -> List[str]:
    """nvcc command that links the objects into the shared library."""
    return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
            "-o", out_path, *objs]


def _build(out_path: str, tmpdir: str) -> str:
    """Compile every source in parallel, then link. Returns nvcc's
    stderr (ptxas register and shared-memory usage); raises on failure."""
    objs = [os.path.join(tmpdir, os.path.basename(s) + ".o")
            for s in sources()]
    procs = [subprocess.Popen(compile_command(s, o), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for s, o in zip(sources(), objs)]
    logs, failed = [], []
    for src, proc in zip(sources(), procs):
        _, err = proc.communicate()
        logs.append(f"== {os.path.basename(src)}\n{err}")
        if proc.returncode != 0:
            failed.append(f"{os.path.basename(src)} ({proc.returncode})")
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
    proc = subprocess.run(link_command(out_path, objs), capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                           f"{proc.stderr}")
    return "\n".join(logs)


def sass() -> str:
    """The built library's machine code (cuobjdump -sass), built first if
    no cached build matches."""
    load_library()
    tool = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    return subprocess.run([tool, "-sass", library_path()],
                          capture_output=True, text=True, check=True).stdout


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if no cached build matches) and load the kernel library.

    Raises with nvcc's stderr when the build fails. A build leaves nvcc's
    stderr (ptxas register and shared-memory usage) beside the library,
    in `build_log_path()`."""
    path = library_path()
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
            tmp = os.path.join(tmpdir, "lib.so")
            log = _build(tmp, tmpdir)
            with open(build_log_path(), "w") as f:
                f.write(log)
            os.replace(tmp, path)   # atomic: a reader never sees half a file
    return ctypes.CDLL(path)
