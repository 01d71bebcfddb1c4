"""Build and load the host audio runtime: two C++ libraries called through
ctypes (counterpart of ``stutter_tpu/audio/build.py``).

- ``csrc/wavio.cpp``: the RIFF/WAVE parser, the windowed-sinc resampler and
  the thread pool that decodes a whole batch. Always built; a failed build
  raises with g++'s output (there is no numpy fallback).
- ``csrc/ffdecode.cpp``: FLAC, MP3, OGG and whatever else libav decodes,
  probes and encodes. Optional, as in the JAX package: with no libav headers
  on the host compressed decode is unavailable (logged once) and the runtime
  reads WAV only; with headers present a failed build or link raises. When
  it is built, ``ffdecode_decode`` is registered as wavio's fallback
  decoder, so every entry point, the thread pool included, reads any format.

Both are compiled with ``g++ -O3 -shared -fPIC -std=c++17 -pthread`` at first
use into ``build/stutter_tpu_torch/`` at the repository root, each named by a
hash of its source and flags (as ``ops/_build.py`` names the CUDA library),
so a checkout with no build directory builds them the first time audio is
read. A library is written under a temporary name and moved into place with
``os.replace``: several processes (test workers, the ranks of
``--devices N``) may build at once.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import logging
import os
import subprocess
import threading
import time
from pathlib import Path

logger = logging.getLogger("stutter_tpu_torch.audio.build")

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "stutter_tpu_torch"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
LIBAV_LIBS = ("-lavformat", "-lavcodec", "-lavutil")
# where Debian/Ubuntu (any architecture), plain and /usr/local installs keep
# libavformat's header
LIBAV_HEADERS = ("/usr/include/*/libavformat/avformat.h",
                 "/usr/include/libavformat/avformat.h",
                 "/usr/local/include/libavformat/avformat.h")

_F = ctypes.POINTER(ctypes.c_float)
_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL | None] = {}
build_seconds = 0.0  # seconds this process spent compiling the two libraries


def library_path(source: Path, flags: tuple[str, ...]) -> Path:
    """The library built from ``source`` with ``flags``: named by a hash of both."""
    h = hashlib.sha256(" ".join(flags).encode())
    h.update(source.read_bytes())
    return BUILD_DIR / f"lib{source.stem}_{h.hexdigest()[:16]}.so"


def _compile(source: Path, extra: tuple[str, ...] = ()) -> Path:
    """Build ``source`` unless this source and these flags are built; raise
    with the compiler's output when g++ fails."""
    global build_seconds
    flags = (*CXX_FLAGS, *extra)
    lib = library_path(source, flags)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    # the libraries follow the source on the command line, as the linker wants
    cmd = ["g++", *CXX_FLAGS, str(source), "-o", str(tmp), *extra]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except FileNotFoundError as e:
        raise RuntimeError(f"g++ not found: the host audio runtime ({source.name}) "
                           "is built with g++") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {source.name} failed ({' '.join(cmd)}):\n"
                           f"{proc.stderr}{proc.stdout}")
    os.replace(tmp, lib)
    build_seconds += time.perf_counter() - t0
    return lib


def _sig(fn, restype, *argtypes) -> None:
    fn.restype = restype
    fn.argtypes = list(argtypes)


def libav_include_flags() -> tuple[str, ...] | None:
    """``-I`` flags for the libav headers found on this host, or None when
    there are none. A non-default include root (e.g. ``/usr/include/ffmpeg``)
    needs its ``-I``; g++ ignores one for a default root."""
    hits = [h for pat in LIBAV_HEADERS for h in glob.glob(pat)]
    if not hits:
        return None
    return tuple(sorted({f"-I{os.path.dirname(os.path.dirname(h))}" for h in hits}))


def _load_ff() -> ctypes.CDLL | None:
    inc = libav_include_flags()
    if inc is None:
        logger.info("no libav headers on this host: compressed audio cannot be decoded "
                    "(WAV only)")
        return None
    lib = ctypes.CDLL(str(_compile(CSRC / "ffdecode.cpp", (*inc, *LIBAV_LIBS))))
    _sig(lib.ffdecode_decode, ctypes.c_int, ctypes.c_char_p, ctypes.POINTER(_F),
         ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32))
    _sig(lib.ffdecode_free, None, _F)
    _sig(lib.ffdecode_probe, ctypes.c_int, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
         ctypes.POINTER(ctypes.c_int32))
    _sig(lib.ffdecode_encode, ctypes.c_int, ctypes.c_char_p, _F, ctypes.c_int64,
         ctypes.c_int32, ctypes.c_int32)
    return lib


def _load_wavio() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_compile(CSRC / "wavio.cpp")))
    _sig(lib.wavio_decode, ctypes.c_int, ctypes.c_char_p, ctypes.POINTER(_F),
         ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32))
    _sig(lib.wavio_free, None, _F)
    _sig(lib.wavio_resample, ctypes.c_int, _F, ctypes.c_int64, ctypes.c_int32,
         ctypes.c_int32, ctypes.c_int32, ctypes.c_double, ctypes.POINTER(_F),
         ctypes.POINTER(ctypes.c_int64))
    _sig(lib.wavio_resample_threads, ctypes.c_int, _F, ctypes.c_int64, ctypes.c_int32,
         ctypes.c_int32, ctypes.c_int32, ctypes.c_double, ctypes.c_int32,
         ctypes.POINTER(_F), ctypes.POINTER(ctypes.c_int64))
    _sig(lib.wavio_decode_batch, None, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64,
         ctypes.c_int32, ctypes.c_int64, ctypes.c_int32, _F, ctypes.POINTER(ctypes.c_int64),
         ctypes.POINTER(ctypes.c_int32))
    _sig(lib.wavio_set_fallback_decoder, None, ctypes.c_void_p)
    return lib


def get_ff_lib() -> ctypes.CDLL | None:
    """The libav codec library (built at first call), or None when this host
    has no libav headers."""
    with _lock:
        if "ffdecode" not in _libs:
            _libs["ffdecode"] = _load_ff()
        return _libs["ffdecode"]


def get_lib() -> ctypes.CDLL:
    """The wavio library (built at first call), with libav's decoder
    registered as its fallback when there is one."""
    ff = get_ff_lib()
    with _lock:
        if "wavio" not in _libs:
            lib = _load_wavio()
            if ff is not None:
                lib.wavio_set_fallback_decoder(ctypes.cast(ff.ffdecode_decode, ctypes.c_void_p))
            _libs["wavio"] = lib
        return _libs["wavio"]


def build() -> dict:
    """Build and load both libraries now: {"wavio": its path, "libav":
    whether the codec library was built, "seconds": compile seconds of this
    process}."""
    lib = get_lib()
    return {"wavio": Path(lib._name), "libav": get_ff_lib() is not None,
            "seconds": build_seconds}
