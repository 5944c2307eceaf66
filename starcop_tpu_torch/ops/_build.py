"""Build and load the hand-written CUDA kernels (``csrc/``) at first use.

``nvcc`` compiles each ``.cu`` source (plain C interface, no PyTorch headers)
for ``sm_90a`` and ``csrc/bindings.cpp`` (the ``TORCH_LIBRARY`` op
registrations), all in parallel, links them into one shared library under
``starcop_tpu_torch/_build/<hash>/`` and loads it with
``torch.ops.load_library``. The hash covers the sources, the flags and the
torch version, so an edited source builds anew. A failed build raises with
the compiler's output; nothing falls back to the plain torch twins.
"""

from __future__ import annotations

import functools
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, "_build")
CUDA_SOURCES = ("mag1c.cu", "mag1c_fused.cu")
SOURCES = (*CUDA_SOURCES, "mag1c_common.cuh", "bindings.cpp")
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
LIB_NAME = "libstarcop_mag1c.so"
_LOAD_LOCK = threading.Lock()  # serving workers may reach their first kernel together


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def build_commands(nvcc: str, out_dir: str) -> list[list[str]]:
    """One compile command per source (run in parallel), then the link
    command."""
    from torch.utils import cpp_extension

    inc = cpp_extension.include_paths(device_type="cuda")
    libdirs = cpp_extension.library_paths(device_type="cuda")
    abi = f"-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}"
    includes = [f"-I{p}" for p in inc]
    common = ["-O3", "-std=c++17", "-Xcompiler", "-fPIC", abi]
    obj = lambda name: os.path.join(out_dir, name + ".o")  # noqa: E731
    cuda = [os.path.splitext(name)[0] for name in CUDA_SOURCES]
    return [
        *([nvcc, *common, ARCH, "-Xptxas", "-v", "-c", os.path.join(CSRC, name + ".cu"),
           "-o", obj(name)] for name in cuda),
        [nvcc, *common, *includes, "-c", os.path.join(CSRC, "bindings.cpp"),
         "-o", obj("bindings")],
        [nvcc, "-shared", *(obj(name) for name in cuda), obj("bindings"),
         "-o", os.path.join(out_dir, LIB_NAME),
         *[f"-L{p}" for p in libdirs], "-lc10", "-ltorch_cpu", "-ltorch",
         *[f"-Xlinker=-rpath={p}" for p in libdirs]],
    ]


def _digest(commands_key: str) -> str:
    h = hashlib.sha256(commands_key.encode())
    for name in SOURCES:
        with open(os.path.join(CSRC, name), "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def _run(cmds: list[list[str]], log_path: str) -> None:
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    with open(log_path, "a") as log:
        for c, out in zip(cmds, outs):
            log.write(" ".join(c) + "\n" + out + "\n")
    for c, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"kernel build failed ({p.returncode}): {' '.join(c)}\n{out}")


def _build_dir(nvcc: str) -> str:
    key = " ".join(" ".join(c) for c in build_commands(nvcc, "OUT")) + torch.__version__
    return os.path.join(BUILD_ROOT, _digest(key))


@functools.lru_cache(maxsize=1)
def load():
    """Build (once per source hash) and load the kernels; returns the
    ``torch.ops.starcop_mag1c`` namespace."""
    with _LOAD_LOCK:
        nvcc = _nvcc()
        out_dir = _build_dir(nvcc)
        lib = os.path.join(out_dir, LIB_NAME)
        if not os.path.exists(lib):
            tmp = f"{out_dir}.tmp{os.getpid()}"
            os.makedirs(tmp, exist_ok=True)
            *compiles, link = build_commands(nvcc, tmp)
            log = os.path.join(tmp, "build.log")
            _run(compiles, log)
            _run([link], log)
            shutil.rmtree(out_dir, ignore_errors=True)
            os.replace(tmp, out_dir)
        torch.ops.load_library(lib)
        return torch.ops.starcop_mag1c


def build_log() -> str:
    """The compiler output of the current sources' build (``-Xptxas -v``
    register and shared-memory counts per kernel), '' if none is on disk."""
    path = os.path.join(_build_dir(_nvcc()), "build.log")
    if not os.path.exists(path):
        return ""
    with open(path) as fh:
        return fh.read()
