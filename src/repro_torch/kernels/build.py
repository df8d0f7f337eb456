"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and load them with
``ctypes``.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C interface,
compiled at first use into ``build/repro_torch_kernels/<hash>/`` at the root
of the checkout (a git-ignored directory). The hash covers the source and
the flags, so an edited source builds anew and an unchanged one is loaded
from the previous build. ``build_all`` starts one ``nvcc`` per source, all
at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong
# C signatures of every exported launcher: (argtypes, restype)
SIGNATURES = {
    "cd_glm": {
        "cd_residual_launch": ([_P] * 8 + [_I] * 4 + [_F] * 4 + [_I] + [_P],
                               _I),
        "cd_residual_layout": ([_I, _I, ctypes.POINTER(_I)], _I),
        "cd_gram_launch": ([_P] * 7 + [_I] * 4 + [_F] * 4 + [_I] + [_P], _I),
    },
    "flash_attention": {
        "flash_attention_launch": ([_I] + [_P] * 6 + [_I] + [_P] * 3 + [_I]
                                   + [ctypes.POINTER(_LL)] + [_I] * 7 + [_F]
                                   + [_I] * 4 + [_P] * 2, _I),
        "flash_combine_launch": ([_P] * 4 + [_LL] * 3 + [_I] * 7 + [_P], _I),
    },
}

_LOADED: dict = {}
LAST_BUILD_LOG: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_ROOT / digest[:16] / f"lib{name}.so"


def _bind(name: str, path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, (argtypes, restype) in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def build_all(names=None) -> dict:
    """Compile every listed source (default: all of ``csrc/``) that has no
    build yet, in parallel, and load each. Returns ``{name: seconds}`` spent
    compiling (0.0 for a source already built)."""
    names = sorted(names or SIGNATURES)
    procs = {}
    for name in names:
        if name in _LOADED:
            continue
        out = _target(name)
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    seconds = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        LAST_BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    for name in names:
        if name not in _LOADED:
            _LOADED[name] = _bind(name, _target(name))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it on first use."""
    if name not in _LOADED:
        build_all([name])
    return _LOADED[name]
