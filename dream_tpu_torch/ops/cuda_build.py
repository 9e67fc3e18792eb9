"""Build the port's CUDA sources with plain ``nvcc`` and load them with ctypes.

Every kernel of the port is one ``dream_tpu_torch/csrc/<name>.cu`` file with
a plain C interface.  :func:`build` compiles it for ``sm_90a`` into a shared
library under the ignored ``dream_tpu_torch/_build/``, named by a hash of
the source and the flags, so an edited source builds anew and an unchanged
one is not rebuilt.  ptxas's register, shared-memory and spill report is
kept beside the library (:func:`ptxas_report` reads it).  :func:`build_all`
starts one ``nvcc`` for each source at once and waits for them together.

Nothing here runs at import: a kernel's wrapper builds and loads its
library at its first launch.
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


def source(name: str) -> Path:
    return CSRC_DIR / f"{name}.cu"


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` in its current state goes."""
    text = source(name).read_bytes()
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
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


def build_all(names: Iterable[str], verbose: bool = False) -> Dict[str, Path]:
    """Compile every ``csrc/<name>.cu`` not built yet, all at once.

    Returns the library path of each name.  ``verbose`` prints ptxas's
    report to stderr.  A failed compile raises with nvcc's output.
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
            cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, str(source(name))]
            jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.PIPE, text=True), tmp)
        errors = []
        for name, (proc, tmp) in jobs.items():
            _, err = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed on {name}.cu ({proc.returncode}):\n{err}")
                continue
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
    """Compile ``csrc/<name>.cu`` unless already built; returns the library."""
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
