"""The system libzstd through ctypes: a frozen copy of
``naf_tpu_torch/zstd_compat.py``, for the benchmark's reference.

The reference's codec compresses and decompresses through this module
alone (the library the reference binaries link).  Its compressors make the
same calls, in the same order, as the program's, so both write the same
frames.
"""

from __future__ import annotations

import ctypes as ct
import ctypes.util
import threading

# stable public libzstd enum values
_C_LEVEL, _C_WINDOWLOG, _C_ENABLE_LDM, _C_CONTENTSIZE, _C_NBWORKERS = 100, 101, 160, 200, 400
_D_WINDOWLOG_MAX = 100
_E_CONTINUE, _E_END = 0, 2

COMPRESSOBJ_FLUSH_FINISH = 0

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
            ("ZSTD_CStreamOutSize", S, []),
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


class ZstdCompressionParameters:
    def __init__(self, level: int = 3, window_log: int = 0, enable_ldm: bool = False,
                 threads: int = 0):
        self.level, self.window_log = level, window_log
        self.enable_ldm, self.threads = enable_ldm, threads

    @classmethod
    def from_level(cls, level: int, window_log: int = 0, enable_ldm: bool = False,
                   threads: int = 0) -> "ZstdCompressionParameters":
        return cls(level, window_log, enable_ldm, threads)


class _Stream:
    """One frame through ZSTD_compressStream2."""

    def __init__(self, p: ZstdCompressionParameters, size: int | None):
        lib = self._lib = _libzstd()
        self._cctx = lib.ZSTD_createCCtx()
        if not self._cctx:
            raise MemoryError("ZSTD_createCCtx failed")
        if p.enable_ldm:
            _check(lib, lib.ZSTD_CCtx_setParameter(self._cctx, _C_ENABLE_LDM, 1))
        if p.window_log:
            _check(lib, lib.ZSTD_CCtx_setParameter(self._cctx, _C_WINDOWLOG, p.window_log))
        _check(lib, lib.ZSTD_CCtx_setParameter(self._cctx, _C_LEVEL, p.level))
        if p.threads:
            _check(lib, lib.ZSTD_CCtx_setParameter(self._cctx, _C_NBWORKERS, p.threads))
        if size is not None:
            _check(lib, lib.ZSTD_CCtx_setPledgedSrcSize(self._cctx, size))
        else:
            _check(lib, lib.ZSTD_CCtx_setParameter(self._cctx, _C_CONTENTSIZE, 0))
        self._cap = max(int(lib.ZSTD_CStreamOutSize()), 1 << 17)
        self._out = ct.create_string_buffer(self._cap)

    def __del__(self):
        if getattr(self, "_cctx", None):
            self._lib.ZSTD_freeCCtx(self._cctx)
            self._cctx = None

    def pump(self, data, end: bool) -> bytes:
        lib = self._lib
        src = bytes(data)
        keep = ct.c_char_p(src)
        inb = _Buf(ct.cast(keep, ct.c_void_p), len(src), 0)
        chunks = []
        while True:
            outb = _Buf(ct.cast(self._out, ct.c_void_p), self._cap, 0)
            r = _check(lib, lib.ZSTD_compressStream2(
                self._cctx, ct.byref(outb), ct.byref(inb), _E_END if end else _E_CONTINUE))
            if outb.pos:
                chunks.append(self._out.raw[:outb.pos])
            if (end and r == 0) or (not end and inb.pos == inb.size):
                return b"".join(chunks)


class _CompressObj:
    def __init__(self, p: ZstdCompressionParameters):
        self._s = _Stream(p, None)

    def compress(self, data) -> bytes:
        return self._s.pump(data, False)

    def flush(self, mode: int = COMPRESSOBJ_FLUSH_FINISH) -> bytes:
        return self._s.pump(b"", True)


class ZstdCompressor:
    def __init__(self, level: int = 3, compression_params=None):
        self._p = compression_params or ZstdCompressionParameters(level)

    def compress(self, data) -> bytes:
        """One frame with the content size in its header (fed, then ended,
        as the program's codec does)."""
        s = _Stream(self._p, len(memoryview(data).cast("B")))
        return s.pump(data, False) + s.pump(b"", True)

    def compressobj(self) -> _CompressObj:
        return _CompressObj(self._p)


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
