"""Build and load the port's hand-written CUDA kernels.

Every ``*.cu`` file under ``kernels/csrc/`` is compiled by its own ``nvcc``,
all started together, and the objects are linked into one shared library
with a plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a
build takes seconds, not minutes). The library lands in
``build/kernels/<hash>/`` at the repository root, keyed by a hash of the
sources, the headers they share (``csrc/*.cuh``) and the compiler flags, and
is built at first use: importing this module compiles nothing, and nothing
is fetched.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-lineinfo", "-Xptxas", "-v", "-Xcompiler", "-fPIC"]
LIB_NAME = "libgenesys_kernels.so"

_ptr, _int, _ll, _f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_float)
# argtypes of every entry point: ctypes would pass an undeclared Python
# int as a 32-bit int and cut a device pointer
SIGNATURES = {
    "paged_decode_attention_launch": (
        [_ptr] * 8 + [_ll] + [_ptr] * 4 + [_int] * 11
        + [_f32, _f32, _int, _int, _ptr], _int),
    "dense_decode_attention_launch": (
        [_ptr] * 11 + [_int] * 10 + [_f32, _f32, _int, _int, _ptr], _int),
    "kv_append_launch": ([_ptr] * 5 + [_int, _ll, _ll, _ptr], _int),
    "flash_attention_fwd_launch": (
        [_ptr] * 6 + [_int] * 7 + [_f32, _int, _int, _ptr], _int),
    "flash_attention_bwd_launch": (
        [_ptr] * 11 + [_int] * 8 + [_f32, _int, _int, _int, _int, _ptr],
        _int),
    "mamba2_ssd_fwd_launch": ([_ptr] * 9 + [_int] * 8 + [_ptr], _int),
    "mamba2_ssd_bwd_launch": ([_ptr] * 17 + [_int] * 8 + [_ptr], _int),
    "rwkv6_wkv_fwd_launch": ([_ptr] * 10 + [_int] * 6 + [_ptr], _int),
    "rwkv6_wkv_bwd_launch": ([_ptr] * 16 + [_int] * 6 + [_ptr], _int),
    "gmm_fwd_launch": ([_ptr] * 4 + [_int] * 7 + [_ptr], _int),
    "gmm_dw_launch": ([_ptr] * 4 + [_int] * 6 + [_ptr], _int),
    "adamw_sqnorm_launch": (
        [_ptr, _ptr, _int, _f32, _ptr, _int, _ptr, _ptr], _int),
    "adamw_update_launch": (
        [_ptr] * 5 + [_int, _ptr, _ptr] + [_f32] * 9 + [_int, _ptr], _int),
    "genesys_mapped_alloc": (
        [_ll, ctypes.POINTER(_ptr), ctypes.POINTER(_ptr)], _int),
    "genesys_mapped_free": ([_ptr], _int),
    "genesys_device_attributes": ([_int, ctypes.POINTER(_int)], _int),
    "genesys_invoke_launch": (
        [_ptr, _ptr, _int, _int, _ptr] + [_int] * 4
        + [_ptr, _ptr, _ptr, _ll, _ptr],
        _int),
    "genesys_bare_respond": (
        [_ptr, _int, _ptr, _ll, ctypes.POINTER(_ll)], _int),
    "genesys_doorbell_scan": (
        [_ptr, _int, _int, _int, _ptr, _ptr, _int], _int),
    "genesys_doorbell_wait": (
        [_ptr, _int, _int, _int, _ptr, _ptr, _int, _ptr, _ll, _ptr, _ll],
        _int),
    "genesys_kernels_error_string": ([_int], ctypes.c_char_p),
}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def headers() -> list[Path]:
    return sorted(CSRC.glob("*.cuh"))


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels are "
            "built on the machine with the GPU")
    return str(path)


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources unless a library for their hash exists; return
    the library path. The compiler's ``-Xptxas -v`` report (registers,
    shared memory and spills per kernel) is kept beside it as
    ``ptxas.log``."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    # build in a private directory, then rename the library into place: a
    # concurrent build never loads a half-written one
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        tmp = Path(tmp)
        objs = [tmp / f"{src.stem}.o" for src in sources()]
        procs = [subprocess.Popen([nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj),
                                   str(src)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(sources(), objs)]
        logs = [p.communicate()[0] for p in procs]
        (out_dir / "ptxas.log").write_text("".join(logs))
        for src, p, log in zip(sources(), procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name} "
                                   f"({p.returncode}):\n{log[-4000:]}")
        link = subprocess.run([nvcc(), "-shared", "-o", str(tmp / LIB_NAME),
                               *map(str, objs)], capture_output=True,
                              text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stderr[-4000:]}")
        os.replace(tmp / LIB_NAME, lib)
    return lib


@functools.lru_cache(maxsize=1)
def library() -> ctypes.PyDLL:
    """The loaded kernel library (built on first call, once per process).

    Loaded as a ``PyDLL``: a launch takes microseconds, so the calls keep
    the GIL. A ``CDLL`` call releases it, and on the serving path the
    host plane's poller threads then win it and hold the decode step up
    for their next poll round, twice per layer."""
    lib = ctypes.PyDLL(str(build()))
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launch entry point returned a CUDA error code."""
    if err != 0:
        msg = library().genesys_kernels_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
