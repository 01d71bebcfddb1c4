"""Build and load the package's CUDA kernels.

Every ``*.cu`` under ``stutter_tpu_torch/csrc/`` is compiled by ``nvcc`` for
Hopper (``sm_90a``), one ``nvcc`` per source, all started together, and the
objects are linked into one shared library with a plain C interface, which is
loaded with ``ctypes``. The library goes into ``build/stutter_tpu_torch/`` at
the repository root, named by a hash of the sources (``*.cu`` and the
``*.cuh`` headers they share) and flags, and is built at first use: a
checkout with no build directory builds its kernels the first time one is
launched, and a changed source builds a new library.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "stutter_tpu_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

_p = ctypes.c_void_p
_i = ctypes.c_int
_ll = ctypes.c_longlong
# C signatures: every pointer and the stream are c_void_p.
SIGNATURES = {
    "wavlm_gated_relpos_attention": (
        [_p, _p, _p, _p, _p, _p, _p, _p, _i, _i, _i, _ll, _ll, _ll, _i, _p], _i),
    "wavlm_gated_relpos_attention_bwd": (
        [_p] * 14 + [_i, _i, _i, _ll, _ll, _ll, _i, _p], _i),
    "flash_mha": ([_p, _p, _p, _p, _p, _i, _i, _i, _ll, _ll, _ll, _i, _p], _i),
    "flash_mha_bias": ([_p, _p, _p, _p, _p, _i, _i, _i, _ll, _ll, _ll, _i, _p], _i),
    "whisper_log_mel": ([_p, _p, _p, _p, _i, _i, _p], _i),
    "wavlm_fused_stem": ([_p, _p, _p, _p, _p, _p, _i, _i, _p], _i),
    "attn_int8_quantize_kv": ([_p] * 6 + [_i, _i, _i, _p], _i),
    "attn_int8": ([_p] * 9 + [_i, _i, _i, _i, _p], _i),
    "attn_softmax_variant": ([_p] * 7 + [_i] * 5 + [_p], _i),
}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libstutter_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the kernels unless this source set is already built.

    Returns (library path, seconds spent compiling; 0.0 when it was built)."""
    lib = library_path()
    if lib.exists():
        return lib, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs, procs = [], []
    try:
        for src in _sources():  # one nvcc per source, all at once
            obj = tmp.with_name(f"{tmp.name}.{src.stem}.o")
            cmd = [nvcc, *COMPILE_FLAGS, "-c", "-o", str(obj), str(src)]
            procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
            objs.append(obj)
        for cmd, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"kernel build failed ({' '.join(cmd)}):\n{out}")
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"kernel link failed ({' '.join(cmd)}):\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)  # atomic: a concurrent build sees a whole library
    finally:
        for _, proc in procs:  # on a failure, stop the compilers still running
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for obj in objs:
            obj.unlink(missing_ok=True)
    return lib, time.perf_counter() - t0


@functools.cache
def kernel_library() -> ctypes.CDLL:
    """The loaded kernel library with typed entry points (built if needed)."""
    lib = ctypes.CDLL(str(build()[0]))
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib
