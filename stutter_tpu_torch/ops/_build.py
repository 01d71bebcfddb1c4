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
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "stutter_tpu_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_p = ctypes.c_void_p
_i = ctypes.c_int
_ll = ctypes.c_longlong
# C signatures: every pointer and the stream are c_void_p.
SIGNATURES = {
    "wavlm_gated_relpos_attention": (
        [_p] * 8 + [_i] * 5 + [_ll, _ll, _ll, _i, _p], _i),
    "wavlm_gated_relpos_attention_bwd": (
        [_p] * 16 + [_i] * 6 + [_ll, _ll, _ll, _i, _p], _i),
    "flash_mha": ([_p, _p, _p, _p, _p, _i, _i, _i, _i, _ll, _ll, _ll, _i, _p], _i),
    "flash_mha_bias": ([_p, _p, _p, _p, _p, _i, _i, _i, _i, _ll, _ll, _ll, _i, _p], _i),
    "relkey_attention": ([_p] * 6 + [_i] * 3 + [_ll] * 6 + [_i, _p], _i),
    "whisper_log_mel": ([_p] * 7 + [_i, _i, _p], _i),
    "wavlm_fused_stem": ([_p, _p, _p, _p, _p, _p, _i, _i, _p], _i),
    "pos_conv_residual": ([_p] * 4 + [_i] * 4 + [_p], _i),
    "layer_norm_bf16": ([_p] * 6 + [_ll, _i, ctypes.c_float, _p], _i),
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


def resource_report_path(lib: Path) -> Path:
    """Where ``build`` keeps what ``ptxas -v`` said of the library's kernels."""
    return lib.with_suffix(".ptxas.txt")


def resource_report(pattern: str) -> list[dict]:
    """Registers, spills, stack and static shared memory of every kernel of
    the built library whose mangled name contains ``pattern``, as ``ptxas
    -v`` printed them at the build."""
    text = resource_report_path(library_path()).read_text()
    found = []
    entry = re.compile(
        r"Compiling entry function '(\S*%s\S*)' for 'sm_90a'.*?"
        r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads.*?"
        r"Used (\d+) registers(?:, used \d+ barriers)?(?:, (\d+) bytes smem)?" % re.escape(pattern),
        re.S)
    for m in entry.finditer(text):
        name, stack, stores, loads, regs, smem = m.groups()
        found.append({"kernel": name, "registers": int(regs), "stack_bytes": int(stack),
                      "spill_store_bytes": int(stores), "spill_load_bytes": int(loads),
                      "static_smem_bytes": int(smem or 0)})
    return found


def serialized_wgmma_warnings() -> list[str]:
    """The lines of the build's ``ptxas`` output that report a serialised
    ``wgmma`` (the compiler then waits between the asynchronous products)."""
    text = resource_report_path(library_path()).read_text()
    return [line for line in text.splitlines() if "wgmma" in line and "serializ" in line]


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
        report = []
        for cmd, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"kernel build failed ({' '.join(cmd)}):\n{out}")
            report.append(out)
        report_tmp = tmp.with_name(f"{tmp.name}.ptxas.txt")
        report_tmp.write_text("".join(report))
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"kernel link failed ({' '.join(cmd)}):\n{proc.stdout}{proc.stderr}")
        # atomic, the report first: a concurrent build or reader sees a whole
        # report beside a whole library
        os.replace(report_tmp, resource_report_path(lib))
        os.replace(tmp, lib)
    finally:
        for _, proc in procs:  # on a failure, stop the compilers still running
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for obj in objs:
            obj.unlink(missing_ok=True)
        tmp.with_name(f"{tmp.name}.ptxas.txt").unlink(missing_ok=True)
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
