"""Builds the port's native code at first use and loads it with ctypes.

Kernels: each `csrc/<name>.cu` compiles on its own with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC

into `_build/<name>-<hash>.so`. The sources expose a plain C interface
(pointers and the stream as void*, cudaGetLastError() returned), so no
PyTorch header is compiled and a source builds in seconds. The host
assembler (`native/assemble.cpp` + `native/smiles.cpp` at the repo
root, with the port's batched entry point `csrc/assemble_batch.cpp`)
builds the same way with g++ and the flags of `native/Makefile`.

`_build/` is listed in .gitignore. A library's file name carries a hash
of its sources and command, so a changed source rebuilds and an
unchanged one loads at once. Builds write to a temporary name and are
renamed into place, so concurrent processes never load a half-written
file. `build()` starts every requested compiler at once and waits for
all of them. A failed build raises with the compiler's output; nothing
falls back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Iterable, List, Tuple

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PKG)
BUILD_DIR = os.path.join(PKG, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")

KERNELS = ("unpack", "noise", "nms_topk", "bn_act", "conv_s8")
NATIVE = "native"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels of abcnet_tpu_torch "
                       "build with the CUDA toolkit's nvcc")


def _job(name: str) -> Tuple[List[str], List[str]]:
    """(command without output and sources, sources) for one library."""
    if name == NATIVE:
        srcs = [os.path.join(REPO, "native", f)
                for f in ("assemble.cpp", "smiles.cpp")]
        srcs.append(os.path.join(PKG, "csrc", "assemble_batch.cpp"))
        return ["g++", *GXX_FLAGS], srcs
    if name not in KERNELS:
        raise ValueError(f"unknown native library {name!r}")
    return [_nvcc(), *NVCC_FLAGS], [os.path.join(PKG, "csrc",
                                                 f"{name}.cu")]


def _target(name: str, cmd: List[str], srcs: List[str]) -> str:
    h = hashlib.sha256(" ".join(cmd[1:]).encode())
    for s in srcs:
        with open(s, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build(names: Iterable[str] = KERNELS + (NATIVE,)) -> Dict[str, str]:
    """Build the named libraries (those not yet built), all compilers in
    parallel. Returns {name: path of the shared library}. The compiler's
    output is kept beside each library as `<path>.log` (for the kernels
    it holds ptxas's register and shared-memory report)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths, running = {}, []
    for name in names:
        cmd, srcs = _job(name)
        path = _target(name, cmd, srcs)
        paths[name] = path
        if os.path.exists(path):
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        proc = subprocess.Popen([*cmd, "-o", tmp, *srcs],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((name, path, tmp, proc))
    failed = []
    for name, path, tmp, proc in running:
        out, _ = proc.communicate()
        with open(f"{path}.log", "w") as f:
            f.write(out)
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, path)
    if failed:
        raise RuntimeError("native build failed: " + "\n".join(failed))
    return paths


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The shared library `name`, built first if needed."""
    return ctypes.CDLL(build([name])[name])
