"""Build the port's native sources and load them with ctypes.

Every kernel of the port is one ``dream_tpu_torch/csrc/<name>.cu`` file with
a plain C interface, compiled with plain ``nvcc`` for ``sm_90a``; the host
image loader is ``csrc/image_loader.cpp``, compiled with the host's C++
compiler (``g++``, or ``$CXX``) and linked against zlib, with no
``-march=native``, since the library may be built on one host and run on
another.  :func:`build` compiles a source into a shared library under the
ignored ``dream_tpu_torch/_build/``, named by a hash of the source and the
flags, so an edited source builds anew and an unchanged one is not
rebuilt; it writes a temporary file and renames it into place, so
processes that build the same source at once do not clobber each other.
ptxas's register, shared-memory and spill report is kept beside a kernel's
library (:func:`ptxas_report` reads it).  :func:`build_all` starts one
compiler for each source at once and waits for them together.  A failed
build raises with the compiler's output, which names a missing header or
library.

Nothing here runs at import: a kernel's wrapper builds and loads its
library at its first launch, and the loader at its first decode.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Dict, Iterable, Tuple

_PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PACKAGE_DIR / "csrc"
BUILD_DIR = _PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
HOST_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared", "-ffp-contract=off")
# The libraries a host source links, after the source on the command line.
HOST_LIBS = {"image_loader": ("-lz", "-lpthread")}


def source(name: str) -> Path:
    """``csrc/<name>.cu`` (a kernel) or ``csrc/<name>.cpp`` (host code)."""
    cuda = CSRC_DIR / f"{name}.cu"
    return cuda if cuda.exists() else CSRC_DIR / f"{name}.cpp"


def _is_cuda(name: str) -> bool:
    return source(name).suffix == ".cu"


def _flags(name: str) -> Tuple[str, ...]:
    return NVCC_FLAGS if _is_cuda(name) else HOST_FLAGS + HOST_LIBS.get(name, ())


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` or ``.cpp`` in its current
    state goes."""
    text = source(name).read_bytes()
    digest = hashlib.sha256(text + " ".join(_flags(name)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return path


def _cxx() -> str:
    found = shutil.which(os.environ.get("CXX", "g++"))
    if not found:
        raise RuntimeError("no C++ compiler found: install g++ or set CXX")
    return found


def _command(name: str, output: str) -> list:
    if _is_cuda(name):
        return [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", output, str(source(name))]
    return [_cxx(), *HOST_FLAGS, "-o", output, str(source(name)), *HOST_LIBS.get(name, ())]


def build_all(names: Iterable[str], verbose: bool = False) -> Dict[str, Path]:
    """Compile every ``csrc/<name>.cu`` or ``.cpp`` not built yet, all at
    once.

    Returns the library path of each name.  ``verbose`` prints ptxas's
    report to stderr.  A failed compile raises with the compiler's output.
    """
    libs = {name: library_path(name) for name in names}
    todo = {name: lib for name, lib in libs.items() if not lib.exists()}
    if not todo:
        return libs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs: Dict[str, Tuple[subprocess.Popen, str]] = {}
    try:
        for name, lib in todo.items():
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            jobs[name] = (subprocess.Popen(_command(name, tmp), stdout=subprocess.PIPE,
                                           stderr=subprocess.PIPE, text=True), tmp)
        errors = []
        for name, (proc, tmp) in jobs.items():
            _, err = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{proc.args[0]} failed on {source(name).name} "
                              f"({proc.returncode}):\n{err}")
                continue
            if _is_cuda(name):
                if verbose:
                    print(err.strip(), file=sys.stderr, flush=True)
                todo[name].with_suffix(".ptxas.txt").write_text(err)
            os.replace(tmp, todo[name])
        if errors:
            raise RuntimeError("\n".join(errors))
    finally:
        for proc, tmp in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    return libs


def build(name: str, verbose: bool = False) -> Path:
    """Compile ``csrc/<name>.cu`` or ``.cpp`` unless already built; returns
    the library."""
    return build_all([name], verbose=verbose)[name]


def load(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build(name)))


def ptxas_report(name: str) -> Dict[str, Dict[str, int]]:
    """Per kernel of a built library: registers, spill stores and loads and
    static shared memory (bytes), from the ptxas report kept at build time."""
    text = library_path(name).with_suffix(".ptxas.txt").read_text()
    report: Dict[str, Dict[str, int]] = {}
    kernel = None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            kernel = m.group(1)
            report[kernel] = {}
            continue
        if kernel is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            report[kernel]["spill_stores"] = int(m.group(1))
            report[kernel]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            report[kernel]["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            report[kernel]["static_smem"] = int(m.group(1))
    return report
