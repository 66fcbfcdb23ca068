"""zstd section codec (host side).

Each NAF section is one zstd frame stored minus its 4-byte frame magic
(compressor parity: ennaf/src/compressor.c:150-173; decoder re-injects it,
unnaf/src/utils.c:144-150).

The port's copy of ``naf_tpu/codec/zstd_backend.py``: section compression
and decompression, one-shot and streaming, and the extended format's
blocked sections, with two entropy engines.  The library engine
(``engine="zstd"``) compresses through the system libzstd (``zstd_compat``)
where it exists, as the JAX package's does through
``naf_tpu/codec/syszstd.py``, so both write the same frames, else through
the ``zstandard`` package; it decompresses through the package where it
imports, else through ``zstd_compat``.  The native engine
(``engine="native"``, ``set_decode_engine("native")``) is the RFC 8878
encoder and decoder of ``native/naf_zstd.cpp`` in the port's host library.
The device match-finder engine (``engine="device"``,
``compress_section_device``) proposes match candidates on a device
(``ops/matchfind.py``, the card's kernels or their plain versions on the
CPU) and packs them with that library's candidate serializer; it imports
torch only when it runs, so the host stack stays torch-free.
"""

from __future__ import annotations

import ctypes as ct
import os
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from typing import Iterator, Optional

import numpy as np

from .. import zstd_compat
from ..format.constants import ZSTD_FRAME_MAGIC
from ..format.vle import decode_vle, encode_vle

try:
    import zstandard as _zstandard
except ImportError:
    _zstandard = None

#: zstd window-log hard bounds (matches ZSTD_WINDOWLOG_MIN/MAX used by ennaf).
WINDOWLOG_MIN = 10
WINDOWLOG_MAX = 31

MIN_CLEVEL = -131072
MAX_CLEVEL = 22

#: the entropy engines: the library, the native encoder, the device match finder
ENGINES = ("zstd", "native", "device")


def check_engine(engine: str) -> None:
    """Raise for an entropy engine the package does not have."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}")


def _decompress_lib():
    return _zstandard if _zstandard is not None else zstd_compat


def _package_compressor(level: int, window_log: int = 0, threads: int = 0):
    """The ``zstandard`` package's compressor, for a host without the system
    libzstd."""
    if _zstandard is None:
        raise ImportError("neither the zstandard package nor a system libzstd is available")
    zstd = _zstandard
    if window_log:
        params = zstd.ZstdCompressionParameters.from_level(
            level, window_log=window_log, enable_ldm=True, threads=threads)
        return zstd.ZstdCompressor(compression_params=params)
    if threads:
        params = zstd.ZstdCompressionParameters.from_level(level, threads=threads)
        return zstd.ZstdCompressor(compression_params=params)
    return zstd.ZstdCompressor(level=level)


def _byte_view(data) -> tuple[memoryview, int]:
    """``data`` as a flat C-contiguous byte view, and the bytes copied to
    make it one (a strided buffer only)."""
    mv = memoryview(data)
    if not mv.c_contiguous:
        return memoryview(mv.tobytes()), mv.nbytes
    if mv.format != "B" or mv.ndim != 1:
        mv = mv.cast("B")
    return mv, 0


class SectionCompressor:
    """Streaming single-frame compressor for one section.

    Feed with `write(data)` calls; `finish()` returns the magic-stripped frame.
    Mirrors the reference's per-section ZSTD_CStream usage
    (ennaf/src/compressor.c:119-147) but keeps output in RAM.

    With the system libzstd, libzstd reads each write in place (any
    contiguous buffer: bytes, bytearray, memoryview, ndarray) and writes
    the frame straight into one ``zstd_compat.FrameBuffer``, which
    ``finish()`` hands out as a memoryview.  ``copied`` counts the bytes
    copied on the host outside libzstd: the pieces of a payload below one
    _STAGE, an MT remainder staged across writes, a strided write made
    contiguous, the buffer's growth, and the ``zstandard`` package's output
    where that package compresses instead.
    """

    #: Fixed feed granularity in multithreaded mode.  zstd's MT path emits a
    #: slightly different (equally valid) frame when the whole input arrives
    #: in a single compress() call versus chunked; feeding in exact 4 MB
    #: units makes the frame a pure function of (options, payload bytes).
    _STAGE = 4 << 20

    def __init__(self, level: int = 1, window_log: int = 0, threads: int = 0):
        self._level = level
        self._window_log = window_log
        self._threads = threads
        self._mt = threads != 0
        self._uncompressed = 0
        self._stream = None         # a zstd_compat.CompressStream, or
        self._obj = None            # the package's compressobj; on the first _STAGE
        self._out = zstd_compat.FrameBuffer()
        self._finished = False
        self._buf = bytearray()     # MT: sub-_STAGE remainder across writes
        self._copied = 0
        # Payloads below one _STAGE never build a streaming context: raw
        # pieces buffer here and finish() compresses them one-shot with a
        # pledged source size (right-sized window and tables).  The cutover
        # is a pure function of (options, payload size).
        self._raw: list | None = []
        self._raw_n = 0

    @property
    def uncompressed_size(self) -> int:
        return self._uncompressed

    @property
    def copied(self) -> int:
        """Bytes copied on the host outside libzstd so far."""
        return self._copied + self._out.copied

    def write(self, data) -> None:
        """Add ``data`` to the frame; the caller may reuse its buffer as
        soon as this returns."""
        self._write(data, False)

    def _write(self, data, last: bool) -> None:
        mv, copied = _byte_view(data)
        self._copied += copied
        self._uncompressed += mv.nbytes
        if self._raw is not None:
            if self._raw_n + mv.nbytes < self._STAGE:
                if mv.nbytes:
                    # a piece that more may follow is copied: callers may
                    # reuse their buffers
                    self._raw.append(mv if last else bytes(mv))
                    self._raw_n += mv.nbytes
                    if not last:
                        self._copied += mv.nbytes
                return
            pieces, self._raw = self._raw, None
            if zstd_compat.system_lib() is not None:
                self._stream = zstd_compat.CompressStream(self._level, self._window_log,
                                                          self._threads)
            else:
                self._obj = _package_compressor(self._level, self._window_log,
                                                self._threads).compressobj()
        else:
            pieces = []
        if self._stream is not None:
            # room for the frame of all this write hands libzstd, so that
            # each call drains what libzstd has ready, in place
            n = sum(map(len, pieces)) + len(self._buf) + mv.nbytes
            self._out.reserve(zstd_compat.compress_bound(n) + self._stream.out_size)
        for p in pieces:
            self._feed(memoryview(p), False)
        self._feed(mv, last)

    def _push(self, mv: memoryview, end: bool = False) -> None:
        """One stage (or the frame's end) to the compressor."""
        if self._stream is None:
            self._out.put(self._obj.flush(_zstandard.COMPRESSOBJ_FLUSH_FINISH) if end
                          else self._obj.compress(mv))
            return
        self._stream.feed(zstd_compat.address(mv), mv.nbytes, end, self._out)

    def _feed(self, mv: memoryview, last: bool) -> None:
        if not mv.nbytes:
            return
        if not self._mt:
            self._push(mv)
            return
        stage = self._STAGE
        if self._buf:
            take = min(stage - len(self._buf), mv.nbytes)
            self._buf += mv[:take]
            self._copied += take
            mv = mv[take:]
            if len(self._buf) == stage:
                self._push(memoryview(self._buf))
                self._buf = bytearray()
        off = 0
        n = mv.nbytes
        while n - off >= stage:                 # whole stages are read in place
            self._push(mv[off:off + stage])
            off += stage
        if off < n:
            if last:                            # nothing follows: in place too
                self._push(mv[off:])
            else:
                self._buf += mv[off:]
                self._copied += n - off

    def _finish_oneshot(self) -> None:
        """Whole payload buffered: one-shot frame with pledged source size."""
        pieces, self._raw = self._raw, None
        payload = pieces[0] if len(pieces) == 1 else b"".join(pieces)
        if len(pieces) > 1:
            self._copied += len(payload)
        if self._window_log:
            # honor --long but never size tables beyond the payload
            wl = min(self._window_log,
                     max(WINDOWLOG_MIN, max(len(payload), 1).bit_length()))
        else:
            wl = 0
        if zstd_compat.system_lib() is None:
            self._out.put(_package_compressor(self._level, wl).compress(payload))
            return
        # fed, then ended, as naf_tpu/codec/syszstd.py:compress_oneshot does
        s = zstd_compat.CompressStream(self._level, wl, size=len(payload))
        self._out.reserve(zstd_compat.compress_bound(len(payload)) + s.out_size)
        s.feed(zstd_compat.address(memoryview(payload)), len(payload), False, self._out)
        s.feed(zstd_compat.address(memoryview(b"")), 0, True, self._out)

    def _close(self, data) -> None:
        """Add the last piece and end the frame."""
        assert not self._finished
        self._finished = True
        self._write(data, True)
        if self._raw is not None:
            self._finish_oneshot()
            return
        if self._buf:                           # the MT staging remainder
            self._push(memoryview(self._buf))
            self._buf = bytearray()
        self._push(memoryview(b""), end=True)

    def finish(self, data=b"") -> memoryview:
        """Add ``data``, the frame's last piece, end the frame and return
        the payload with the 4-byte magic stripped: a view of the frame
        buffer, without a copy.  The last piece is read in place, never
        staged, so a payload given whole here is copied nowhere."""
        self._close(data)
        frame = self._out.close()
        if len(frame) < 4 or frame[:4] != ZSTD_FRAME_MAGIC:
            raise RuntimeError("compression failed")
        return frame[4:]


def compress_section(data, level: int = 1, window_log: int = 0,
                     threads: int = 0) -> memoryview:
    return SectionCompressor(level=level, window_log=window_log, threads=threads).finish(data)


_DECODE_ENGINE = "zstd"


def set_decode_engine(name: str) -> None:
    """Select the decode-side entropy engine: 'zstd' (library, default) or
    'native' (the RFC 8878 decoder in native/naf_zstd.cpp; reference parity
    unnaf/src/input.c:260-292)."""
    global _DECODE_ENGINE
    if name not in ("zstd", "native"):
        raise ValueError(f"unknown decode engine {name!r}")
    _DECODE_ENGINE = name


def decode_engine() -> str:
    return _DECODE_ENGINE


def decompress_section_native(payload: bytes, uncompressed_size: int) -> bytes:
    """One-shot decode with the native zstd decoder."""
    lib = _native_lib()
    frame = ZSTD_FRAME_MAGIC + payload
    src = np.frombuffer(frame, np.uint8)
    # +32 slack: the decoder's wide match copies overshoot the logical cap
    # by up to 15 bytes (overwritten or ignored; never returned)
    out = np.empty(max(uncompressed_size, 1) + 32, np.uint8)
    w = lib.naf_zstd_decompress(src.ctypes.data_as(ct.c_void_p), src.size,
                                out.ctypes.data_as(ct.c_void_p), uncompressed_size)
    if w == (1 << 64) - 1:
        raise RuntimeError("native decode: corrupt zstd stream")
    if w != uncompressed_size:
        raise RuntimeError("section decompression size mismatch")
    return out[:w].tobytes()


def decompress_section(payload: bytes, uncompressed_size: int) -> bytes:
    """One-shot decode of a magic-stripped section payload."""
    if _DECODE_ENGINE == "native":
        return decompress_section_native(payload, uncompressed_size)
    dctx = _decompress_lib().ZstdDecompressor(max_window_size=1 << WINDOWLOG_MAX)
    out = dctx.decompress(ZSTD_FRAME_MAGIC + payload,
                          max_output_size=max(uncompressed_size, 1))
    if len(out) != uncompressed_size:
        raise RuntimeError("section decompression size mismatch")
    return out


class SectionDecompressor:
    """Streaming decoder for a magic-stripped section payload: `feed()`
    compressed chunks (the frame magic is put back in front of the first),
    get the decompressed bytes each one completes.

    With the native decode engine selected and both totals given, the
    input is buffered and decoded one-shot when the last compressed byte
    arrives (the native decoder has no incremental entry point); callers
    that feed until ``total_in`` bytes are in work unchanged, at the cost
    of section-sized memory.  ``force_library`` keeps the library's
    incremental decode, for callers that stop at an output prefix.
    """

    def __init__(self, total_in: Optional[int] = None, total_out: Optional[int] = None,
                 force_library: bool = False):
        self._done = False
        self._native = (not force_library and _DECODE_ENGINE == "native"
                        and total_in is not None and total_out is not None)
        if self._native:
            self._total_in, self._total_out = total_in, total_out
            self._got = 0
            self._parts: list = []
            return
        dctx = _decompress_lib().ZstdDecompressor(max_window_size=1 << WINDOWLOG_MAX)
        self._obj = dctx.decompressobj()
        self._first = True

    def feed(self, chunk: bytes) -> bytes:
        if self._done:
            # one-shot contract: a feed after the last chunk would hand a
            # lone fragment to the native decoder
            raise RuntimeError("section decompressor exhausted")
        if self._native:
            self._parts.append(chunk)
            self._got += len(chunk)
            if self._got < self._total_in:
                return b""
            payload = b"".join(self._parts)
            self._parts = []
            self._done = True
            return decompress_section_native(payload, self._total_out)
        if self._first:
            chunk = ZSTD_FRAME_MAGIC + chunk
            self._first = False
        return self._obj.decompress(chunk)


def iter_decompress(payload: bytes, chunk_size: int = 1 << 20) -> Iterator[bytes]:
    """Yield decompressed chunks of a magic-stripped section payload."""
    d = SectionDecompressor()
    for off in range(0, len(payload), chunk_size):
        out = d.feed(payload[off:off + chunk_size])
        if out:
            yield out


# ---------------------------------------------------------------------------
# Extended-format blocked sections (tnaf extension, container flag bit 7)
# ---------------------------------------------------------------------------
#
# Payload layout inside the standard section envelope:
#     VLE(n_blocks)  { VLE(raw_len) VLE(comp_len) } x n  frames...
# Each frame is an independent magic-stripped zstd frame, so blocks
# compress AND decompress in parallel.  The reference decoder cannot read
# these archives; the header's reserved bit 0x80 marks them (NAF spec §2.4).

def _pool_map(fn, items, threads: int) -> list:
    workers = max(1, min(threads or (os.cpu_count() or 1), len(items)))
    if workers == 1:
        return [fn(x) for x in items]
    with ThreadPoolExecutor(workers) as ex:
        return list(ex.map(fn, items))


def compress_frames(data, level: int = 1, window_log: int = 0, threads: int = 0,
                    block_bytes: int = 4 << 20, engine: str = "zstd", *, device="cuda"
                    ) -> tuple[list[int], list[bytes]]:
    """`data` -> (per-frame raw lengths, independent magic-stripped frames).

    The building block shared by the blocked section writer and the
    multi-process extended encode (each process frames only its own bytes).
    ``device`` is where the device engine proposes candidates.
    """
    check_engine(engine)
    one = {"zstd": compress_section, "native": compress_section_native,
           "device": partial(compress_section_device, device=device)}[engine]
    mv = memoryview(data)
    blocks = [mv[i:i + block_bytes] for i in range(0, mv.nbytes, block_bytes)] or [mv[:0]]
    frames = _pool_map(lambda b: one(b, level=level, window_log=window_log), blocks, threads)
    return [b.nbytes for b in blocks], frames


def blocked_payload(raw_lens: list[int], frames: list[bytes]) -> bytes:
    """The blocked-section envelope: VLE index + frames."""
    out = [encode_vle(len(frames))]
    for r, f in zip(raw_lens, frames):
        out.append(encode_vle(r))
        out.append(encode_vle(len(f)))
    out.extend(frames)
    return b"".join(out)


def compress_section_blocked(data, level: int = 1, window_log: int = 0,
                             threads: int = 0, block_bytes: int = 4 << 20,
                             engine: str = "zstd", *, device="cuda") -> bytes:
    """Compress `data` as independently-framed blocks with an index."""
    return blocked_payload(*compress_frames(data, level=level, window_log=window_log,
                                            threads=threads, block_bytes=block_bytes,
                                            engine=engine, device=device))


def parse_blocked_index(payload: bytes):
    """Returns (entries [(raw_len, comp_len)], data_offset)."""
    n, off = decode_vle(payload, 0)
    entries = []
    for _ in range(n):
        r, off = decode_vle(payload, off)
        c, off = decode_vle(payload, off)
        entries.append((r, c))
    return entries, off


def decompress_section_blocked(payload: bytes, uncompressed_size: int,
                               threads: int = 0) -> bytes:
    """Parallel decode of a blocked section payload."""
    entries, off = parse_blocked_index(payload)
    pieces = []
    for r, c in entries:
        pieces.append((payload[off:off + c], r))
        off += c
    out = b"".join(_pool_map(lambda p: decompress_section(*p), pieces, threads))
    if len(out) != uncompressed_size:
        raise RuntimeError("blocked section decompression size mismatch")
    return out


# ---------------------------------------------------------------------------
# Native entropy engine (native/naf_zstd.cpp): the package's own RFC 8878
# encoder (greedy LZ77, Huffman literals, predefined-FSE sequences) and
# decoder.  It writes standard zstd frames, so archives stay decodable by
# the reference unnaf and by the library engine alike.
# ---------------------------------------------------------------------------

_native_bound = False


def _native_lib():
    """The host library with the entropy engine's entry points bound."""
    global _native_bound
    from ..native import host

    lib = host._load()
    if lib is None:
        raise RuntimeError("native engine unavailable")
    if not _native_bound:
        u64, i32, p = ct.c_uint64, ct.c_int32, ct.c_void_p
        lib.naf_zstd_decompress.restype = u64
        lib.naf_zstd_decompress.argtypes = [p, u64, p, u64]
        for fn in (lib.naf_zstd_compress_ex, lib.naf_zstd_compress_part):
            fn.restype = u64
            fn.argtypes = [p, u64, p, u64, i32, i32]
        lib.naf_zstd_window_log_for.restype = i32
        lib.naf_zstd_window_log_for.argtypes = [i32, i32]
        lib.naf_zstd_compress_cand_stream.restype = u64
        lib.naf_zstd_compress_cand_stream.argtypes = [p, u64, u64, u64, p, i32, p, p, u64]
        _native_bound = True
    return lib


def _native_compress(fn, mv: memoryview, level: int, window_log: int) -> bytes:
    src = np.frombuffer(mv, np.uint8) if mv.nbytes else None
    cap = mv.nbytes + mv.nbytes // 4 + 4096
    dst = np.empty(cap, np.uint8)
    w = fn(src.ctypes.data_as(ct.c_void_p) if src is not None else None, mv.nbytes,
           dst.ctypes.data_as(ct.c_void_p), cap, int(level), int(window_log))
    if w == 0:
        raise RuntimeError("native engine buffer overflow")
    return dst[:w].tobytes()


def compress_section_native(data, level: int = 1, window_log: int = 0) -> bytes:
    """Compress one section with the native engine; magic-stripped frame.

    ``level`` follows the zstd scale (-131072..22; parity target
    ennaf/src/ennaf.c:216-245); ``window_log`` mirrors ``--long N``
    (compressor.c:7-21): > 0 widens the match window and enables the
    long-distance table.
    """
    frame = _native_compress(_native_lib().naf_zstd_compress_ex, memoryview(data), level,
                             window_log)
    if frame[:4] != ZSTD_FRAME_MAGIC:
        raise RuntimeError("native engine produced an invalid frame")
    return frame[4:]


def compress_part_native(data, level: int = 1, window_log: int = 0) -> bytes:
    """One part of a stitched single frame: a bare zstd block chain.

    No frame header, no last-block bit, fresh (invalid) rep-offset state:
    the chain decodes identically after any predecessor, so parts
    compressed on different threads or hosts stitch into one valid frame
    (``stitch_section_frame``).  Empty input -> empty chain.
    """
    mv = memoryview(data)
    if mv.nbytes == 0:
        return b""
    return _native_compress(_native_lib().naf_zstd_compress_part, mv, level, window_log)


def _window_descriptor(window: int) -> int:
    """Smallest zstd Window_Descriptor byte covering ``window`` bytes."""
    for exp in range(0, 32):
        base = 1 << (10 + exp)
        for mantissa in range(8):
            if base + (base >> 3) * mantissa >= window:
                return (exp << 3) | mantissa
    return (21 << 3)                      # 2 GB, unreachable in practice


def stitch_section_frame(chains, part_sizes, level: int = 1, window_log: int = 0) -> bytes:
    """Per-part block chains -> one magic-stripped zstd frame.

    ``chains[i]`` is ``compress_part_native(parts[i])``; ``part_sizes[i]``
    the part's uncompressed length.  The frame is a header (window sized to
    the largest possible offset: min(max part, the level's match window)),
    the chains one after the other, and an empty raw last block.  The
    reference decoder injects exactly one frame magic per section
    (unnaf/src/input.c:278), so independent blocks inside one frame are the
    only parallel layout it decodes.
    """
    lib = _native_lib()
    total = sum(int(s) for s in part_sizes)
    max_part = max((int(s) for s in part_sizes), default=0)
    wlog = int(lib.naf_zstd_window_log_for(int(level), int(window_log)))
    window = min(max_part, 1 << wlog) if max_part else 1024
    out = bytearray()
    out.append(0xC0)                      # FCS_Flag=3 (8 bytes), no flags
    out.append(_window_descriptor(window))
    out += int(total).to_bytes(8, "little")
    for ch in chains:
        out += ch
    out += b"\x01\x00\x00"                # empty raw block, last bit set
    return bytes(out)


def compress_section_parts(parts, level: int = 1, window_log: int = 0,
                           threads: int = 0) -> bytes:
    """Thread-parallel single-frame compression of independent parts.

    Returns a magic-stripped frame that the reference ``unnaf``, the
    library engine and the native decoder all decode.  ``threads`` caps
    the pool (0 = cpu count); the ctypes calls release the GIL, so the
    parts compress in parallel.
    """
    parts = [memoryview(p) for p in parts]
    chains = _pool_map(lambda p: compress_part_native(p, level, window_log), parts, threads)
    return stitch_section_frame(chains, [p.nbytes for p in parts], level, window_log)


# ---------------------------------------------------------------------------
# Device match-finder engine: candidates from ops/matchfind.py (the card's
# kernels, or their plain versions on the CPU), packed by the native
# candidate serializer into one standard zstd frame.
# ---------------------------------------------------------------------------

def _device_chain_depth(level: int) -> int:
    """`-#` -> candidate chain depth proposed per position (the device
    analog of cfg_for's chain-log ladder, naf_zstd.cpp:852)."""
    if level <= 2:
        return 2
    if level <= 12:
        return 4
    if level <= 18:
        return 8
    return 16


def _device_histories(window_log: int, span: int) -> tuple[int, int]:
    """(history, anchor history) of the device engine's spans of ``span``
    bytes: the windowed pass searches ``max(span, min(1 << window_log,
    64 MiB))`` bytes before a span (``span`` without ``--long``), the
    anchor pass ``min(1 << window_log, 128 MiB)`` (none without)."""
    if not window_log:
        return span, 0
    return max(span, min(1 << window_log, 64 << 20)), min(1 << window_log, 128 << 20)


def compress_section_device(data, level: int = 1, window_log: int = 0, k: int = 0, *,
                            device="cuda", timing: Optional[dict] = None) -> bytes:
    """Device-proposed match candidates + host bitstream packing; a
    magic-stripped frame, the same bytes as naf_tpu's engine.

    The section goes to ``device`` once.  For each ``ops.matchfind.SPAN``
    (read at call time) of it, the device proposes the k nearest earlier
    equal-key positions of every position within a sliding history window
    (``span_candidates``); the span's rows come back to one host buffer
    (pinned for a card), and ``naf_zstd_compress_cand_stream`` verifies,
    extends and scores them (repeat offsets included) into the frame's
    blocks.  ``level`` sets the chain depth (``_device_chain_depth``, unless
    ``k``); ``window_log`` (``--long``) widens the history and adds the
    anchor pass (``_device_histories``).  Sections of 2 GiB or more, whose
    positions int32 cannot hold, go to ``compress_section_native`` (route
    ``device_engine_host:over_2gib``).  ``timing={}`` receives per span the
    device ms of each stage (CUDA events; a card only) and the serializer's
    seconds.  Calls on several threads at once (``compress_frames``'s pool)
    each make the card current and launch on its current stream.
    """
    mv = memoryview(data)
    if mv.nbytes >= 1 << 31:
        from ..device import count_route

        count_route("device_engine_host:over_2gib")
        return compress_section_native(data, level=level, window_log=window_log)
    import time
    from contextlib import nullcontext

    import torch

    from ..device import resolve
    from ..ops import matchfind as MF

    dev = resolve(device)
    k = k or _device_chain_depth(level)
    lib = _native_lib()
    arr = np.frombuffer(mv, np.uint8)
    n = arr.size
    cap = n + n // 4 + 4096
    dst = np.empty(cap, np.uint8)
    rep = np.array([1, 4, 8], np.uint32)
    span = MF.SPAN
    hist, ldm_hist = _device_histories(window_log, span)
    rep_p = rep.ctypes.data_as(ct.c_void_p)
    w = 0
    if n == 0:
        w = lib.naf_zstd_compress_cand_stream(None, 0, 0, 0, None, k, rep_p,
                                              dst.ctypes.data_as(ct.c_void_p), cap)
        if w == 0:
            raise RuntimeError("device engine buffer overflow")
    else:
        cuda = dev.type == "cuda"
        with torch.cuda.device(dev) if cuda else nullcontext():
            sec = MF.upload(arr, dev)
            width = k + (1 if ldm_hist else 0)
            if cuda:
                host = torch.empty((min(span, n), width), dtype=torch.int32, pin_memory=True)
            spans = timing.setdefault("spans", []) if timing is not None else None
            for lo in range(0, n, span):
                hi = min(lo + span, n)
                marks = MF.StageTimer(cuda and spans is not None)
                cand = MF.span_candidates(sec, lo, hi, k, hist, ldm_hist, marks=marks)
                if cuda:
                    cand = host[:hi - lo].copy_(cand, non_blocking=True)
                    marks.mark("fetch")
                    torch.cuda.current_stream(dev).synchronize()
                t0 = time.perf_counter()
                wrote = lib.naf_zstd_compress_cand_stream(
                    arr.ctypes.data_as(ct.c_void_p), n, lo, hi,
                    ct.c_void_p(cand.data_ptr()), width, rep_p,
                    ct.c_void_p(dst.ctypes.data + w), cap - w)
                if spans is not None:
                    spans.append({**marks.ms(), "serialize_s": time.perf_counter() - t0})
                if wrote == 0:
                    raise RuntimeError("device engine buffer overflow")
                w += wrote
    frame = dst[:w].tobytes()
    if frame[:4] != ZSTD_FRAME_MAGIC:
        raise RuntimeError("device engine produced an invalid frame")
    return frame[4:]


# ---------------------------------------------------------------------------
# Temp-file spill (parity: ennaf/src/compressor.c:51-61 — compressed section
# output beyond a RAM threshold goes to a temp file and is streamed back
# during container assembly)
# ---------------------------------------------------------------------------

class SpilledPayload:
    """Magic-stripped section bytes living in a temp file."""

    def __init__(self, path: str, size: int, keep: bool):
        self.path = path
        self._size = size
        self._keep = keep

    def __len__(self) -> int:
        return self._size

    def copy_into(self, out) -> None:
        with open(self.path, "rb") as f:
            f.seek(4)                      # skip the stored frame magic
            while True:
                chunk = f.read(1 << 20)
                if not chunk:
                    break
                out.write(chunk)
        if not self._keep:
            try:
                os.unlink(self.path)
            except OSError:
                pass


#: In-RAM budget per compressed section before spilling to the temp dir
#: (override: NAF_TPU_SPILL_MB, read as the JAX package reads it).
_SPILL_THRESHOLD = int(os.environ.get("NAF_TPU_SPILL_MB", "256")) << 20


class SpillingSectionCompressor(SectionCompressor):
    """SectionCompressor that spills compressed output beyond a threshold.

    Temp file naming mirrors the reference (`<prefix>.<section>` in the
    temp dir, `--keep-temp-files` keeps them; files.c:69-103).
    """

    def __init__(self, level: int = 1, window_log: int = 0, threads: int = 0,
                 *, temp_dir: str, name: str, section: str,
                 threshold: int = _SPILL_THRESHOLD, keep: bool = False):
        super().__init__(level, window_log, threads)
        self._path = os.path.join(temp_dir, f"{name}.{section}")
        self._threshold = threshold
        self._keep = keep
        self._file = None

    def write(self, data) -> None:
        super().write(data)
        if self._file is None:
            # the file opens with the first compressed bytes past the
            # threshold, so a section that never spills leaves none behind
            if not self._out.pos or self._out.pos < self._threshold:
                return
            self._file = open(self._path, "wb")
        self._file.write(self._out.take())

    def finish(self, data=b""):
        """A memoryview when everything stayed in RAM, else a SpilledPayload."""
        self.write(data)
        if self._raw is not None or self._file is None:  # never spilled
            return super().finish()
        self._close(b"")
        self._file.write(self._out.take())
        self._file.close()
        self._file = None
        with open(self._path, "rb") as f:
            if f.read(4) != ZSTD_FRAME_MAGIC:
                raise RuntimeError("compression failed")
        return SpilledPayload(self._path, self._out.taken - 4, self._keep)
