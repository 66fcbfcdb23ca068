"""The system libzstd through ctypes, as the port's codec calls it.

``codec.zstd_backend`` compresses through this module whenever the system
libzstd is there (the library the reference binaries link, as
``naf_tpu/codec/syszstd.py`` does for the JAX package), and decompresses
through the ``zstandard`` package where it imports, else through this module
too.  ``CompressStream`` is one frame through ``ZSTD_compressStream2``, fed
from the caller's memory by address and written into the caller's
``FrameBuffer``, so no byte of a section is copied on the host outside
libzstd; it makes the same calls, in the same order, as
``naf_tpu/codec/syszstd.py``, so both write the same frames.  The
decompressors offer the part of the ``zstandard`` package's API the codec
calls (one-shot and streaming), so a host with the system library but not
the package (a CUDA machine set up for PyTorch, for one) runs the codec
unchanged.
"""

from __future__ import annotations

import ctypes as ct
import ctypes.util
import threading

import numpy as np

# stable public libzstd enum values
_C_LEVEL, _C_WINDOWLOG, _C_ENABLE_LDM, _C_CONTENTSIZE, _C_NBWORKERS = 100, 101, 160, 200, 400
_D_WINDOWLOG_MAX = 100
_E_CONTINUE, _E_END = 0, 2

_lib = None
_tried = False
_lock = threading.Lock()


class ZstdError(Exception):
    pass


def system_lib():
    """The system libzstd, bound, or None where there is none (or one
    older than 1.4, which lacks ZSTD_compressStream2).  The codec's
    section threads may ask first, so the lookup runs under a lock."""
    global _lib, _tried
    with _lock:
        if not _tried:
            _lib = _bind_system_lib()
            _tried = True
        return _lib


def _bind_system_lib():
    lib = None
    for name in (ctypes.util.find_library("zstd"), "libzstd.so.1", "libzstd.so"):
        if not name:
            continue
        try:
            lib = ct.CDLL(name)
            break
        except OSError:
            continue
    if lib is None:
        return None
    lib.ZSTD_versionNumber.restype = ct.c_uint
    if lib.ZSTD_versionNumber() < 10400:
        return None
    P, S = ct.c_void_p, ct.c_size_t
    for fn, res, args in (
            ("ZSTD_createCCtx", P, []), ("ZSTD_freeCCtx", S, [P]),
            ("ZSTD_CCtx_setParameter", S, [P, ct.c_int, ct.c_int]),
            ("ZSTD_CCtx_setPledgedSrcSize", S, [P, ct.c_ulonglong]),
            ("ZSTD_compressStream2", S, [P, P, P, ct.c_int]),
            ("ZSTD_CStreamOutSize", S, []), ("ZSTD_compressBound", S, [S]),
            ("ZSTD_createDCtx", P, []), ("ZSTD_freeDCtx", S, [P]),
            ("ZSTD_DCtx_setParameter", S, [P, ct.c_int, ct.c_int]),
            ("ZSTD_decompressDCtx", S, [P, P, S, ct.c_char_p, S]),
            ("ZSTD_decompressStream", S, [P, P, P]), ("ZSTD_DStreamOutSize", S, []),
            ("ZSTD_isError", ct.c_uint, [S]), ("ZSTD_getErrorName", ct.c_char_p, [S])):
        f = getattr(lib, fn)
        f.restype, f.argtypes = res, args
    return lib


def _libzstd():
    lib = system_lib()
    if lib is None:
        raise ImportError("neither the zstandard package nor a system libzstd is available")
    return lib


def _check(lib, r: int) -> int:
    if lib.ZSTD_isError(r):
        raise ZstdError(lib.ZSTD_getErrorName(r).decode())
    return r


class _Buf(ct.Structure):          # ZSTD_inBuffer / ZSTD_outBuffer
    _fields_ = [("dst", ct.c_void_p), ("size", ct.c_size_t), ("pos", ct.c_size_t)]


def compress_bound(n: int) -> int:
    """ZSTD_compressBound: the most bytes a frame of ``n`` input bytes takes."""
    return int(_libzstd().ZSTD_compressBound(n))


def address(mv: memoryview) -> int:
    """The address of a C-contiguous buffer's first byte (read-only ones
    too); the caller keeps the buffer alive while libzstd reads it."""
    return np.frombuffer(mv, np.uint8).ctypes.data


class FrameBuffer:
    """One growing byte buffer that libzstd writes a frame into, in place.

    ``CompressStream.feed`` writes at ``pos``; the bytes written are
    ``arr[:pos]``.  ``copied`` counts the bytes moved on the host: those
    kept when the buffer grows and those ``put`` copies in.
    """

    def __init__(self):
        self.arr = np.empty(0, np.uint8)
        self.pos = 0
        self.taken = 0          # bytes handed out by take(), before arr[0]
        self.copied = 0

    def reserve(self, n: int) -> None:
        """At least ``n`` bytes free past ``pos``; grows geometrically."""
        if self.arr.size - self.pos >= n:
            return
        grown = np.empty(max(2 * self.arr.size, self.pos + n), np.uint8)
        grown[:self.pos] = self.arr[:self.pos]
        self.copied += self.pos
        self.arr = grown

    def put(self, data) -> None:
        """Append a copy of ``data`` (output another compressor made)."""
        src = np.frombuffer(data, np.uint8)
        self.reserve(src.size)
        self.arr[self.pos:self.pos + src.size] = src
        self.pos += src.size
        self.copied += src.size

    def close(self) -> memoryview:
        """The bytes written, without a copy, once no write follows: the
        free space past them is given back first (a realloc that shrinks
        the buffer in place), so the view holds only its bytes."""
        self.arr.resize(self.pos, refcheck=False)
        return memoryview(self.arr)

    def take(self) -> memoryview:
        """The bytes written, after which the buffer is written from its
        start again: the view holds only until the next write."""
        v = memoryview(self.arr)[:self.pos]
        self.taken += self.pos
        self.pos = 0
        return v


class CompressStream:
    """One frame through ZSTD_compressStream2.

    The parameters go in ennaf's order (compressor.c:7-21): long-distance
    matching and the window log with ``window_log``, the level, the
    workers; then the pledged ``size``, or no content size in the header
    where it is None (a streamed frame).
    """

    def __init__(self, level: int, window_log: int = 0, threads: int = 0,
                 size: int | None = None):
        lib = self._lib = _libzstd()
        self._cctx = lib.ZSTD_createCCtx()
        if not self._cctx:
            raise MemoryError("ZSTD_createCCtx failed")
        if window_log:
            _check(lib, lib.ZSTD_CCtx_setParameter(self._cctx, _C_ENABLE_LDM, 1))
            _check(lib, lib.ZSTD_CCtx_setParameter(self._cctx, _C_WINDOWLOG, window_log))
        _check(lib, lib.ZSTD_CCtx_setParameter(self._cctx, _C_LEVEL, level))
        if threads:
            _check(lib, lib.ZSTD_CCtx_setParameter(self._cctx, _C_NBWORKERS, threads))
        if size is not None:
            _check(lib, lib.ZSTD_CCtx_setPledgedSrcSize(self._cctx, size))
        else:
            _check(lib, lib.ZSTD_CCtx_setParameter(self._cctx, _C_CONTENTSIZE, 0))
        #: the free space each call is given at least
        self.out_size = max(int(lib.ZSTD_CStreamOutSize()), 1 << 17)

    def __del__(self):
        if getattr(self, "_cctx", None):
            self._lib.ZSTD_freeCCtx(self._cctx)
            self._cctx = None

    def feed(self, addr: int, n: int, end: bool, out: FrameBuffer) -> None:
        """Compress the ``n`` bytes at ``addr`` (ZSTD_e_continue), or end
        the frame after them (ZSTD_e_end), straight into ``out``.  Every
        byte is read before the call returns: libzstd copies the input into
        its own buffers, so the caller may reuse its memory."""
        lib = self._lib
        inb = _Buf(addr, n, 0)
        directive = _E_END if end else _E_CONTINUE
        while True:
            out.reserve(self.out_size)
            outb = _Buf(out.arr.ctypes.data + out.pos, out.arr.size - out.pos, 0)
            r = _check(lib, lib.ZSTD_compressStream2(
                self._cctx, ct.byref(outb), ct.byref(inb), directive))
            out.pos += outb.pos
            if (end and r == 0) or (not end and inb.pos == inb.size):
                return


class ZstdDecompressor:
    """One-shot decompression, as ``zstandard.ZstdDecompressor`` spells it."""

    def __init__(self, max_window_size: int = 0):
        self._window_log = max_window_size.bit_length() - 1 if max_window_size else 0

    def decompress(self, data, max_output_size: int = 0) -> bytes:
        if max_output_size <= 0:
            raise ZstdError("max_output_size is required")
        lib = _libzstd()
        dctx = lib.ZSTD_createDCtx()
        if not dctx:
            raise MemoryError("ZSTD_createDCtx failed")
        try:
            if self._window_log:
                _check(lib, lib.ZSTD_DCtx_setParameter(dctx, _D_WINDOWLOG_MAX,
                                                       self._window_log))
            out = ct.create_string_buffer(max_output_size)
            src = bytes(data)
            r = _check(lib, lib.ZSTD_decompressDCtx(dctx, out, max_output_size, src,
                                                    len(src)))
            return out.raw[:r]
        finally:
            lib.ZSTD_freeDCtx(dctx)

    def decompressobj(self) -> "_DecompressObj":
        return _DecompressObj(self._window_log)


class _DecompressObj:
    """Streaming decompression of one frame through ZSTD_decompressStream."""

    def __init__(self, window_log: int):
        lib = self._lib = _libzstd()
        self._dctx = lib.ZSTD_createDCtx()
        if not self._dctx:
            raise MemoryError("ZSTD_createDCtx failed")
        if window_log:
            _check(lib, lib.ZSTD_DCtx_setParameter(self._dctx, _D_WINDOWLOG_MAX, window_log))
        self._cap = max(int(lib.ZSTD_DStreamOutSize()), 1 << 17)
        self._out = ct.create_string_buffer(self._cap)

    def __del__(self):
        if getattr(self, "_dctx", None):
            self._lib.ZSTD_freeDCtx(self._dctx)
            self._dctx = None

    def decompress(self, data) -> bytes:
        """Every byte the fed input decodes to."""
        lib = self._lib
        src = bytes(data)
        keep = ct.c_char_p(src)
        inb = _Buf(ct.cast(keep, ct.c_void_p), len(src), 0)
        chunks = []
        while True:
            outb = _Buf(ct.cast(self._out, ct.c_void_p), self._cap, 0)
            r = _check(lib, lib.ZSTD_decompressStream(self._dctx, ct.byref(outb),
                                                      ct.byref(inb)))
            if outb.pos:
                chunks.append(self._out.raw[:outb.pos])
            # the output buffer was not filled: all the input is consumed and
            # flushed, or the frame is complete
            if outb.pos < self._cap and (inb.pos == inb.size or r == 0):
                return b"".join(chunks)
