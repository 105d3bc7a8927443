"""ctypes bindings for the native IQ ingest runtime (native/ingest.cpp).

Port of rub_mimo_tpu/io/native.py.  The library supplies the host-side
runtime the reference got from UHD and pthreads (sc16 <-> fc32 wire
conversion, mimo/config.h:51-52; the capture read loop, mimo/main.cc:
872-898): format conversion, validation scans, a background-prefetch
block reader over a file and a live TCP source.

The port builds its own copy of the library at first use:

    g++ -O3 -shared -fPIC -std=c++17 -pthread native/ingest.cpp

into ``rub_mimo_tpu_torch/_build/libingest-<hash>.so`` (the hash covers
the source and the flags), under a temporary name renamed into place, so
concurrent first uses never load a half-written file.  Nothing is built
at import.  Every entry point but ``SocketReader`` has a numpy fallback
where the library cannot be built; ``available()`` says whether it
loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

_SOURCE = Path(__file__).resolve().parents[2] / "native" / "ingest.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    """Where the library built from native/ingest.cpp lives."""
    h = hashlib.sha256(_SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return _BUILD_DIR / f"libingest-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile native/ingest.cpp with g++ unless it is built already;
    raises if there is no g++ or the compile fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native ingest library is "
                           "built with g++")
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(_SOURCE)],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, out)  # atomic: a concurrent loader sees all
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        lib = ctypes.CDLL(str(build()))
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return None
    lib.rmt_sc16_to_fc32.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_float]
    lib.rmt_sc16_to_fc32.restype = None
    lib.rmt_fc32_to_sc16.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_float]
    lib.rmt_fc32_to_sc16.restype = None
    lib.rmt_validate_fc32.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_float)]
    lib.rmt_validate_fc32.restype = ctypes.c_int32
    lib.rmt_reader_open.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32]
    lib.rmt_reader_open.restype = ctypes.c_void_p
    lib.rmt_reader_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.rmt_reader_next.restype = ctypes.c_int64
    lib.rmt_reader_close.argtypes = [ctypes.c_void_p]
    lib.rmt_reader_close.restype = None
    lib.rmt_socket_open.argtypes = [
        ctypes.c_int32, ctypes.c_int64, ctypes.c_int32]
    lib.rmt_socket_open.restype = ctypes.c_void_p
    lib.rmt_socket_port.argtypes = [ctypes.c_void_p]
    lib.rmt_socket_port.restype = ctypes.c_int32
    lib.rmt_socket_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.rmt_socket_next.restype = ctypes.c_int64
    lib.rmt_socket_close.argtypes = [ctypes.c_void_p]
    lib.rmt_socket_close.restype = None
    _lib = lib
    return _lib


def available() -> bool:
    """Whether the native library is built and loaded."""
    return _load() is not None


# ---------------------------------------------------------------------
# format conversion
# ---------------------------------------------------------------------
SC16_SCALE = 1.0 / 32767.0  # UHD's default sc16 full-scale mapping


def sc16_to_fc32(raw: np.ndarray, scale: float = SC16_SCALE) -> np.ndarray:
    """Interleaved int16 IQ -> complex64 (a trailing half sample of a
    truncated capture is dropped)."""
    raw = np.ascontiguousarray(raw, dtype=np.int16)
    n_iq = raw.size // 2
    raw = raw[: n_iq * 2]
    lib = _load()
    if lib is None:
        return (raw.astype(np.float32) * np.float32(scale)).view(np.complex64)
    out = np.empty(n_iq * 2, dtype=np.float32)
    lib.rmt_sc16_to_fc32(raw.ctypes.data_as(ctypes.c_void_p),
                         out.ctypes.data_as(ctypes.c_void_p), n_iq,
                         ctypes.c_float(scale))
    return out.view(np.complex64)


def fc32_to_sc16(iq: np.ndarray, scale: float = 32767.0) -> np.ndarray:
    """complex64 -> interleaved int16 IQ, rounded and clamped."""
    iq = np.ascontiguousarray(iq, dtype=np.complex64)
    flat = iq.view(np.float32)
    lib = _load()
    if lib is None:
        return np.clip(np.rint(flat * np.float32(scale)), -32768,
                       32767).astype(np.int16)
    out = np.empty(flat.size, dtype=np.int16)
    lib.rmt_fc32_to_sc16(flat.ctypes.data_as(ctypes.c_void_p),
                         out.ctypes.data_as(ctypes.c_void_p), iq.size,
                         ctypes.c_float(scale))
    return out


def validate_fc32(iq: np.ndarray) -> tuple[bool, float]:
    """(all finite, peak magnitude of the float parts) of complex64 IQ."""
    iq = np.ascontiguousarray(iq, dtype=np.complex64)
    flat = iq.view(np.float32)
    lib = _load()
    if lib is None:
        return (bool(np.isfinite(flat).all()),
                float(np.abs(flat).max(initial=0.0)))
    peak = ctypes.c_float(0.0)
    bad = lib.rmt_validate_fc32(flat.ctypes.data_as(ctypes.c_void_p),
                                flat.size, ctypes.byref(peak))
    return bad == 0, float(peak.value)


class _Blocks:
    """Iteration and closing shared by the two block readers."""

    def __iter__(self):
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()


# ---------------------------------------------------------------------
# background-prefetch block reader
# ---------------------------------------------------------------------
class StreamReader(_Blocks):
    """Iterate complex64 blocks of block_samples samples (the last one
    shorter) of a capture file.  The native reader prefetches n_buffers
    blocks on a background thread; the fallback reads synchronously."""

    def __init__(self, path: str | os.PathLike, block_samples: int = 1 << 20,
                 n_buffers: int = 4):
        self.path = str(path)
        self.block_samples = block_samples
        self.block_bytes = block_samples * 8  # complex64
        self._lib = _load()
        self._handle = None
        self._fh = None
        if self._lib is not None:
            self._handle = self._lib.rmt_reader_open(
                self.path.encode(), self.block_bytes, n_buffers)
            if not self._handle:
                raise FileNotFoundError(self.path)
        else:
            self._fh = open(self.path, "rb")

    def __next__(self) -> np.ndarray:
        if self._handle is not None:
            buf = np.empty(self.block_bytes, dtype=np.uint8)
            got = self._lib.rmt_reader_next(
                self._handle, buf.ctypes.data_as(ctypes.c_void_p))
            if got == 0:
                raise StopIteration
            return buf[:got].view(np.complex64)
        if self._fh is None:
            raise StopIteration
        data = self._fh.read(self.block_bytes)
        if not data:
            raise StopIteration
        return np.frombuffer(data, dtype=np.complex64).copy()

    def close(self) -> None:
        if getattr(self, "_handle", None) is not None:
            self._lib.rmt_reader_close(self._handle)
            self._handle = None
        if getattr(self, "_fh", None) is not None:
            self._fh.close()
            self._fh = None


# ---------------------------------------------------------------------
# live TCP IQ source
# ---------------------------------------------------------------------
class SocketReader(_Blocks):
    """Receive complex64 IQ blocks from one TCP sender on 127.0.0.1 (the
    reference's rx_worker recv loop, mimo/main.cc:872-877, with the
    prefetch ring in native code).  port=0 picks a free port (read
    .port); iteration yields whole samples until the sender closes.
    Needs the native library: there is no fallback."""

    def __init__(self, port: int = 0, block_samples: int = 1 << 16,
                 n_buffers: int = 8):
        self._handle = None
        self._lib = _load()
        if self._lib is None:
            raise RuntimeError("native ingest library unavailable")
        self.block_samples = block_samples
        self.block_bytes = block_samples * 8
        self._handle = self._lib.rmt_socket_open(port, self.block_bytes,
                                                 n_buffers)
        if not self._handle:
            raise OSError(f"could not bind 127.0.0.1:{port}")
        self.port = int(self._lib.rmt_socket_port(self._handle))

    def __next__(self) -> np.ndarray:
        if self._handle is None:
            raise StopIteration
        buf = np.empty(self.block_bytes, dtype=np.uint8)
        got = self._lib.rmt_socket_next(self._handle,
                                        buf.ctypes.data_as(ctypes.c_void_p))
        if got == 0:
            raise StopIteration
        n = (int(got) // 8) * 8  # whole complex64 samples only
        return buf[:n].view(np.complex64)

    def close(self) -> None:
        if getattr(self, "_handle", None) is not None:
            self._lib.rmt_socket_close(self._handle)
            self._handle = None
