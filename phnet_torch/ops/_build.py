"""Build and load the port's CUDA kernels and host libraries.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface and loaded with ``ctypes``
(no PyTorch headers, so a build takes seconds). The host C++ libraries of
the data and evaluation paths (:data:`HOST_SOURCES`: the libjpeg clip
decoder and gray JPEG encoder, the nvJPEG decoder and encoder of the card,
the CULane evaluator, the PNG codec's scanline unfilter) are compiled the same
way by ``g++``, with the JAX package's Makefile flags. Libraries go to
``phnet_torch/build/`` (created at first use, ignored by git) under a
name that carries a hash of the source, so an edited source is rebuilt
and a stale library is never loaded. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
# kernel library name -> source file under csrc/
SOURCES = {"lane_nms": "lane_nms.cu", "router_chain": "router_chain.cu",
           "w8_matmul": "w8_matmul.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# host library name -> (source under the package, libraries to link);
# the nvJPEG decoder also takes the CUDA toolkit's headers and libraries
HOST_SOURCES = {"clip_loader": ("data/native/clip_loader.cpp", ["-ljpeg"]),
                "nvjpeg_decode": ("data/native/nvjpeg_decode.cpp",
                                  ["-lnvjpeg"]),
                "culane_eval": ("evaluation/native/culane_eval.cpp", []),
                "png_unfilter": ("data/native/png_unfilter.cpp", [])}
GXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-fopenmp",
             "-Wall", "-shared"]


def _cuda_home() -> str:
    return os.environ.get("CUDA_HOME", "/usr/local/cuda")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = os.path.join(_cuda_home(), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return path


def _gxx() -> str:
    found = shutil.which("g++")
    if not found:
        raise RuntimeError("g++ not found: the port's host libraries build "
                           "with g++")
    return found


def _flags(name: str):
    """(source path, compiler flags, trailing link flags) of a library."""
    if name in SOURCES:
        return CSRC / SOURCES[name], NVCC_FLAGS, []
    src, libs = HOST_SOURCES[name]
    if name == "nvjpeg_decode":
        home = _cuda_home()
        return (_PKG / src, GXX_FLAGS + ["-I", os.path.join(home, "include")],
                ["-L", os.path.join(home, "lib64"),
                 "-Wl,-rpath," + os.path.join(home, "lib64"), *libs])
    return _PKG / src, GXX_FLAGS, libs


def library_path(name: str) -> Path:
    src, flags, libs = _flags(name)
    tag = hashlib.sha1(src.read_bytes()
                       + " ".join(flags + libs).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build(names=None) -> Dict[str, str]:
    """Compile the named libraries (default: the CUDA kernels), one
    compiler process per source, all started together: ``nvcc`` for a
    kernel, ``g++`` for a host library (:data:`HOST_SOURCES`). An
    up-to-date library is not rebuilt. Returns ``{name: compiler
    output}``; a kernel's holds the ``ptxas`` report (registers, shared
    memory, spills). It is kept beside the library. Raises if any build
    fails."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        src, flags, libs = _flags(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        compiler = _nvcc() if name in SOURCES else _gxx()
        cmd = [compiler, *flags, "-o", str(tmp), str(src), *libs]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name} (rc={proc.returncode}):\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("build failed for " + "\n".join(failed))
    logs = {name: library_path(name).with_suffix(".log") for name in names}
    return {name: log.read_text() if log.exists() else ""
            for name, log in logs.items()}


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (a kernel or a host library), built
    first if needed."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))
