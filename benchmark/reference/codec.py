"""The zstd section codec of the reference: the library engine alone.

A copy, frozen, of the library path of ``naf_tpu_torch/codec/zstd_backend.py``:
each NAF section is one zstd frame stored minus its 4-byte frame magic
(ennaf/src/compressor.c:150-173; unnaf/src/utils.c:144-150), compressed and
decompressed through the system libzstd (``zstd_compat``), the library the
reference binaries link.  No ``zstandard`` package, no native or device
engine.
"""

from __future__ import annotations

from . import zstd_compat
from .constants import ZSTD_FRAME_MAGIC

#: zstd window-log hard bounds (matches ZSTD_WINDOWLOG_MIN/MAX used by ennaf).
WINDOWLOG_MIN = 10
WINDOWLOG_MAX = 31


def _compressor(zstd, level: int, window_log: int = 0, threads: int = 0):
    if window_log:
        params = zstd.ZstdCompressionParameters.from_level(
            level, window_log=window_log, enable_ldm=True, threads=threads)
        return zstd.ZstdCompressor(compression_params=params)
    if threads:
        params = zstd.ZstdCompressionParameters.from_level(level, threads=threads)
        return zstd.ZstdCompressor(compression_params=params)
    return zstd.ZstdCompressor(level=level)


class SectionCompressor:
    """Streaming single-frame compressor for one section.

    Feed with `write(data)` calls; `finish()` returns the magic-stripped frame.
    Mirrors the reference's per-section ZSTD_CStream usage
    (ennaf/src/compressor.c:119-147) but keeps output in RAM.
    """

    #: Fixed feed granularity in multithreaded mode.  zstd's MT path emits a
    #: slightly different (equally valid) frame when the whole input arrives
    #: in a single compress() call versus chunked; feeding in exact 4 MB
    #: units makes the frame a pure function of (options, payload bytes).
    _STAGE = 4 << 20

    def __init__(self, level: int = 1, window_log: int = 0, threads: int = 0):
        self._chunks: list[bytes] = []
        self._pending = 0           # == sum(len(c) for c in self._chunks)
        self._uncompressed = 0
        self._level = level
        self._window_log = window_log
        self._threads = threads
        self._obj = None            # created on the first _STAGE of input
        self._finished = False
        self._mt = threads != 0
        self._buf = bytearray()     # MT: sub-_STAGE staging remainder
        # Payloads below one _STAGE never build a streaming context: raw
        # pieces buffer here and finish() compresses them one-shot with a
        # pledged source size (right-sized window and tables).  The cutover
        # is a pure function of (options, payload size).
        self._raw: list | None = []
        self._raw_n = 0

    @property
    def uncompressed_size(self) -> int:
        return self._uncompressed

    def _emit(self, out: bytes) -> None:
        if out:
            self._chunks.append(out)
            self._pending += len(out)

    def write(self, data) -> None:
        mv = memoryview(data)
        if mv.nbytes == 0:
            return
        self._uncompressed += mv.nbytes
        if self._raw is not None:
            if self._raw_n + mv.nbytes < self._STAGE:
                # small pieces are copied: callers may reuse their buffers
                self._raw.append(bytes(mv))
                self._raw_n += mv.nbytes
                return
            pieces, self._raw = self._raw, None
            self._obj = _compressor(zstd_compat, self._level, self._window_log,
                                    self._threads).compressobj()
            for p in pieces:
                self._feed(memoryview(p))
        self._feed(mv)

    def _feed(self, mv: memoryview) -> None:
        if not self._mt:
            self._emit(self._obj.compress(mv))
            return
        stage = self._STAGE
        if self._buf:
            take = min(stage - len(self._buf), mv.nbytes)
            self._buf += mv[:take]
            mv = mv[take:]
            if len(self._buf) == stage:
                self._emit(self._obj.compress(self._buf))
                self._buf = bytearray()
        off = 0
        n = mv.nbytes
        while n - off >= stage:                 # large writes feed zero-copy
            self._emit(self._obj.compress(mv[off:off + stage]))
            off += stage
        if off < n:
            self._buf += mv[off:]

    def _finish_oneshot(self) -> bytes:
        """Whole payload buffered: one-shot frame with pledged source size."""
        payload = b"".join(self._raw)
        self._raw = None
        if self._window_log:
            # honor --long but never size tables beyond the payload
            wl = min(self._window_log,
                     max(WINDOWLOG_MIN, max(len(payload), 1).bit_length()))
        else:
            wl = 0
        return _compressor(zstd_compat, self._level, wl).compress(payload)

    def finish(self) -> bytes:
        """End the frame and return payload with the 4-byte magic stripped."""
        assert not self._finished
        self._finished = True
        if self._raw is not None:
            frame = self._finish_oneshot()
        else:
            if self._buf:
                self._emit(self._obj.compress(self._buf))
                self._buf = bytearray()
            self._emit(self._obj.flush(zstd_compat.COMPRESSOBJ_FLUSH_FINISH))
            frame = b"".join(self._chunks)
            self._chunks = []
            self._pending = 0
        if len(frame) < 4 or frame[:4] != ZSTD_FRAME_MAGIC:
            raise RuntimeError("compression failed")
        return frame[4:]


def compress_section(data, level: int = 1, window_log: int = 0, threads: int = 0) -> bytes:
    c = SectionCompressor(level=level, window_log=window_log, threads=threads)
    c.write(data)
    return c.finish()


def decompress_section(payload: bytes, uncompressed_size: int) -> bytes:
    """One-shot decode of a magic-stripped section payload."""
    dctx = zstd_compat.ZstdDecompressor(max_window_size=1 << WINDOWLOG_MAX)
    out = dctx.decompress(ZSTD_FRAME_MAGIC + payload,
                          max_output_size=max(uncompressed_size, 1))
    if len(out) != uncompressed_size:
        raise RuntimeError("section decompression size mismatch")
    return out
