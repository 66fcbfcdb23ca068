"""ctypes bridge to the port's native host runtime (``naf_native.cpp``).

The port's copy of ``naf_tpu/native/__init__.py``: a fused single-pass
FASTA/FASTQ scanner, a fused decode renderer, the device render plan's
header lines and the FASTQ grid check of the device encode's block split
on the host, in place of the numpy implementations in ``pipeline.parser``,
``ops``, ``parallel.decode`` and ``parallel.block``, which stay as
the oracle and as the path without a C++ toolchain.  The same library
holds the native entropy engine (``naf_zstd.cpp``, an RFC 8878 encoder and
decoder), which ``codec.zstd_backend`` binds for ``engine="native"``.

At first use g++ builds ``naf_native.cpp`` and ``naf_zstd.cpp`` into one
library under ``build/naf_tpu_torch/host/<hash of the sources and flags>/``
in the checkout (beside the kernels' library), not into the source tree.
The original's multithreaded render is not copied (see the note in
``naf_native.cpp``): ``render`` always takes the one-thread path.
``NAF_TPU_TORCH_NO_NATIVE=1`` turns the library off, and every caller takes
its numpy path (the native entropy engine then raises).
"""

from __future__ import annotations

import ctypes as ct
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from .build import BUILD_ROOT

SOURCES = [Path(__file__).resolve().parent / name for name in ("naf_native.cpp", "naf_zstd.cpp")]
CXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-shared"]

_lib: Optional[ct.CDLL] = None
_lock = threading.Lock()
_tried = False


class _NafScan(ct.Structure):
    _fields_ = [
        ("seq", ct.c_void_p), ("seq_len", ct.c_uint64),
        ("packed", ct.c_void_p), ("packed_len", ct.c_uint64),
        ("ids", ct.c_void_p), ("ids_len", ct.c_uint64),
        ("comments", ct.c_void_p), ("comments_len", ct.c_uint64),
        ("qual", ct.c_void_p), ("qual_len", ct.c_uint64),
        ("lengths", ct.c_void_p), ("n_records", ct.c_uint64),
        ("mask_units", ct.c_void_p), ("n_mask_units", ct.c_uint64),
        ("longest_line", ct.c_uint64),
        ("hist_id", ct.c_uint64 * 257),
        ("hist_comment", ct.c_uint64 * 257),
        ("hist_seq", ct.c_uint64 * 257),
        ("hist_qual", ct.c_uint64 * 257),
        ("error", ct.c_int32),
        ("error_record", ct.c_uint64),
        ("error_char", ct.c_uint32),
        ("error_a", ct.c_uint64), ("error_b", ct.c_uint64),
        # streaming carry state (see naf_native.cpp NAF_F_* flags)
        ("flags", ct.c_int32), ("prev_eol_in", ct.c_int32),
        ("mask_on_in", ct.c_int32), ("mask_run_in", ct.c_uint64),
        ("len_carry_in", ct.c_uint64), ("line_carry_in", ct.c_uint64),
        ("pack_carry_in", ct.c_uint32),
        ("end_state", ct.c_int32), ("mask_tail_on", ct.c_int32),
        ("mask_tail_run", ct.c_uint64), ("consumed", ct.c_uint64),
        ("end_line_len", ct.c_uint64),
    ]


def _build() -> Optional[Path]:
    """Path of the built library (built now if missing), or None when no
    g++ is found or the build fails."""
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        return None
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    out_dir = BUILD_ROOT / "host" / h.hexdigest()[:16]
    so = out_dir / "libnaf_native.so"
    if so.exists():
        return so
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"libnaf_native.{os.getpid()}.tmp.so"
    r = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), *map(str, SOURCES)],
                       capture_output=True)
    if r.returncode != 0 or not tmp.exists():
        return None
    os.replace(tmp, so)
    return so


def _load() -> Optional[ct.CDLL]:
    global _lib, _tried
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("NAF_TPU_TORCH_NO_NATIVE"):
            return None
        so = _build()
        if so is None:
            return None
        try:
            lib = ct.CDLL(str(so))
        except OSError:
            return None
        u8p = ct.c_void_p
        lib.naf_scan_fasta_mt.restype = ct.c_int32
        lib.naf_scan_fasta_mt.argtypes = [
            u8p, ct.c_uint64, ct.c_int32, ct.c_int32, ct.c_int32, ct.c_int32,
            ct.c_int32, ct.c_int32, ct.POINTER(_NafScan)]
        lib.naf_scan_fastq_mt.restype = ct.c_int32
        lib.naf_scan_fastq_mt.argtypes = lib.naf_scan_fasta_mt.argtypes
        lib.naf_render.restype = ct.c_uint64
        lib.naf_render.argtypes = [
            ct.c_int32,
            u8p, ct.c_uint64, ct.c_int32, ct.c_int32, ct.c_int32,
            ct.c_int32,
            u8p, ct.c_uint64,
            u8p, ct.c_uint64,
            u8p, ct.c_uint64,
            u8p, ct.c_uint64,
            u8p, ct.c_uint64,
            ct.c_uint8, ct.c_uint64,
            u8p, u8p]
        lib.naf_render_size.restype = ct.c_uint64
        lib.naf_render_size.argtypes = [
            ct.c_int32, ct.c_uint64,
            u8p, ct.c_uint64,
            u8p, ct.c_uint64,
            u8p, ct.c_uint64,
            ct.c_uint64, ct.c_uint64]
        lib.naf_header_lines.restype = ct.c_int64
        lib.naf_header_lines.argtypes = [
            u8p, ct.c_uint64, u8p, ct.c_uint64, ct.c_uint64, ct.c_uint8,
            u8p, ct.c_uint64, u8p, u8p]
        lib.naf_fastq_grid.restype = ct.c_int64
        lib.naf_fastq_grid.argtypes = [u8p, ct.c_uint64, ct.c_int64, u8p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _ptr(a: Optional[np.ndarray]):
    if a is None or a.size == 0:
        return None
    return a.ctypes.data_as(ct.c_void_p)


# render modes (keep in sync with naf_native.cpp)
MODE_FASTA = 0
MODE_SEQUENCES = 1
MODE_SEQ = 2
MODE_CHARCOUNT = 3
MODE_FASTQ = 4

# scan flags (keep in sync with naf_native.cpp)
F_CONT_SEQ = 1
F_NO_MASK_FLUSH = 2
F_PACK_CARRY = 4
F_ALLOW_PARTIAL = 8


class NativeScan:
    """Result of a native scan, trimmed numpy views over the C buffers."""

    __slots__ = ("seq", "packed", "ids_blob", "comments_blob", "qual",
                 "lengths", "mask_units", "longest_line", "n_sequences",
                 "unexpected_id", "unexpected_comment", "unexpected_seq",
                 "unexpected_qual",
                 # streaming carry outputs
                 "end_state", "mask_tail_on", "mask_tail_run", "consumed",
                 "end_line_len")


class NativeScanError(Exception):
    """Scan-level failure; carries the reference-parity error code/fields."""

    def __init__(self, code: int, record: int, char: int, a: int, b: int):
        self.code, self.record, self.char, self.a, self.b = code, record, char, a, b
        super().__init__(f"native scan error {code}")


def scan(data: bytes, *, fastq: bool, seq_type: int, strict: bool,
         well_formed: bool, do_mask: bool, do_upper: bool,
         marker_pos: int, threads: int = 0,
         flags: int = 0, prev_eol: bool = False,
         mask_on: bool = False, mask_run: int = 0,
         len_carry: int = 0, line_carry: int = 0,
         pack_carry: Optional[int] = None,
         scratch: Optional[dict] = None) -> NativeScan:
    """Run the fused native scanner over ``data[marker_pos+1:]``.

    FASTA inputs >= 2 MB scan multithreaded (record-aligned chunks with
    boundary stitching); FASTQ splits speculatively at record starts and
    verifies, falling back to one thread inside.  The carry arguments
    (``flags``, ``prev_eol``, the mask run, the open record's and line's
    lengths, the held nibble) resume a scan where the previous piece of a
    stream ended; a caller-owned ``scratch`` dict keeps the output buffers
    across pieces.  Raises NativeScanError on reference-fatal input; the
    caller maps codes to the reference's die() messages.
    """
    lib = _load()
    assert lib is not None
    if threads <= 0:
        threads = os.cpu_count() or 1
    buf = np.frombuffer(data, dtype=np.uint8)[marker_pos + 1:]
    n = int(buf.size)

    def _get(key: str, size: int, dtype) -> np.ndarray:
        if scratch is None:
            return np.empty(size, dtype)
        a = scratch.get(key)
        if a is None or a.size < size:
            a = np.empty(size, dtype)
            scratch[key] = a
        return a

    # worst-case output buffers
    seq = _get("seq", n + 2, np.uint8)
    packed = _get("packed", n // 2 + 2, np.uint8)
    ids = _get("ids", n + 2, np.uint8)
    comments = _get("comments", n + 2, np.uint8)
    qual = _get("qual", (n + 2) if fastq else 1, np.uint8)
    lengths = _get("lengths", n // 2 + 4, np.uint64)
    mask = _get("mask", (n + 4) if do_mask else 1, np.uint8)

    r = _NafScan()
    r.seq = seq.ctypes.data
    r.packed = packed.ctypes.data
    r.ids = ids.ctypes.data
    r.comments = comments.ctypes.data
    r.qual = qual.ctypes.data
    r.lengths = lengths.ctypes.data
    r.mask_units = mask.ctypes.data
    if pack_carry is not None:
        flags |= F_PACK_CARRY
        r.pack_carry_in = pack_carry & 0x0F
    r.flags = flags
    r.prev_eol_in = int(prev_eol)
    r.mask_on_in = int(mask_on)
    r.mask_run_in = mask_run
    r.len_carry_in = len_carry
    r.line_carry_in = line_carry

    data_ptr = buf.ctypes.data_as(ct.c_void_p) if n else None
    fn = lib.naf_scan_fastq_mt if fastq else lib.naf_scan_fasta_mt
    code = fn(data_ptr, n, seq_type, int(strict), int(well_formed), int(do_mask),
              int(do_upper), threads, ct.byref(r))
    if code != 0:
        raise NativeScanError(code, int(r.error_record), int(r.error_char),
                              int(r.error_a), int(r.error_b))

    out = NativeScan()
    out.seq = seq[: r.seq_len]
    out.packed = packed[: r.packed_len]
    out.ids_blob = ids[: r.ids_len].tobytes()
    out.comments_blob = comments[: r.comments_len].tobytes()
    out.qual = qual[: r.qual_len] if fastq else np.zeros(0, np.uint8)
    out.lengths = lengths[: r.n_records]
    out.mask_units = mask[: r.n_mask_units] if do_mask else np.zeros(0, np.uint8)
    out.longest_line = int(r.longest_line)
    out.n_sequences = int(r.n_records)
    out.unexpected_id = np.ctypeslib.as_array(r.hist_id).copy()
    out.unexpected_comment = np.ctypeslib.as_array(r.hist_comment).copy()
    out.unexpected_seq = np.ctypeslib.as_array(r.hist_seq).copy()
    out.unexpected_qual = np.ctypeslib.as_array(r.hist_qual).copy()
    out.end_state = int(r.end_state)
    out.mask_tail_on = bool(r.mask_tail_on)
    out.mask_tail_run = int(r.mask_tail_run)
    out.consumed = int(r.consumed)
    out.end_line_len = int(r.end_line_len)
    return out


# Uninitialized-bytes allocator: PyBytes_FromStringAndSize(NULL, n) returns a
# bytes object whose buffer is left uninitialized; the native renderer fills
# every byte (naf_render_size is exact), so the output needs no
# truncate-copy and no memset.
_pyapi = ct.pythonapi
_pyapi.PyBytes_FromStringAndSize.restype = ct.py_object
_pyapi.PyBytes_FromStringAndSize.argtypes = [ct.c_void_p, ct.c_ssize_t]
_pyapi.PyBytes_AsString.restype = ct.c_void_p
_pyapi.PyBytes_AsString.argtypes = [ct.py_object]


def _alloc_bytes(n: int) -> tuple[bytes, ct.c_void_p]:
    buf = _pyapi.PyBytes_FromStringAndSize(None, n)
    return buf, ct.c_void_p(_pyapi.PyBytes_AsString(buf))


def render(mode: int, *, seq_data: np.ndarray, total_chars: int,
           is_packed: bool, is_rna: bool, do_upper: bool,
           mask_units: Optional[np.ndarray],
           lengths: Optional[np.ndarray],
           ids_blob: Optional[bytes], comments_blob: Optional[bytes],
           qual: Optional[np.ndarray],
           name_sep: int, line_len: int,
           out_capacity: int = 0, nibble_off: int = 0) -> bytes | np.ndarray:
    """Fused decode render on one thread: the output bytes, or for
    MODE_CHARCOUNT the u64[256] counts.  ``nibble_off`` 1 starts at the
    high nibble of ``seq_data[0]`` (a record batch beginning mid-byte);
    MODE_SEQ renders into an ``out_capacity`` buffer, every other mode into
    a bytes object of the exact output size."""
    lib = _load()
    assert lib is not None
    ids_a = np.frombuffer(ids_blob, np.uint8) if ids_blob is not None else None
    com_a = np.frombuffer(comments_blob, np.uint8) if comments_blob is not None else None
    lengths = (np.ascontiguousarray(lengths, dtype=np.uint64)
               if lengths is not None else None)
    n_rec = int(lengths.size) if lengths is not None else 0

    qual_len = 0 if qual is None else int(qual.size)
    head = (_ptr(seq_data), ct.c_uint64(total_chars), int(is_packed),
            int(is_rna), int(do_upper), int(nibble_off),
            _ptr(mask_units), 0 if mask_units is None else mask_units.size,
            _ptr(lengths), n_rec,
            _ptr(ids_a), 0 if ids_a is None else ids_a.size,
            _ptr(com_a), 0 if com_a is None else com_a.size,
            _ptr(qual), qual_len, name_sep, line_len)

    if mode == MODE_CHARCOUNT:
        counts = np.zeros(256, np.uint64)
        lib.naf_render(mode, *head, None, counts.ctypes.data_as(ct.c_void_p))
        return counts

    if mode == MODE_SEQ:
        # its paired u16 stores may touch one byte past the stream: render
        # into the caller's slack buffer, not the exact-size bytes
        out = np.empty(out_capacity, np.uint8)
        w = lib.naf_render(mode, *head, out.ctypes.data_as(ct.c_void_p), None)
        if w > out_capacity:
            raise RuntimeError("native render overflowed its buffer")
        return out[:w].tobytes()

    # the check is a hard error so a divergence cannot corrupt the heap
    exact = lib.naf_render_size(
        mode, ct.c_uint64(total_chars), _ptr(lengths), n_rec,
        _ptr(ids_a), 0 if ids_a is None else ids_a.size,
        _ptr(com_a), 0 if com_a is None else com_a.size,
        ct.c_uint64(qual_len), ct.c_uint64(line_len))
    buf, optr = _alloc_bytes(exact)
    w = lib.naf_render(mode, *head, optr, None)
    if w != exact:
        raise RuntimeError(f"native render size mismatch: wrote {w}, sized {exact}")
    return buf


def header_lines(ids_blob: Optional[bytes], comments_blob: Optional[bytes],
                 n_records: int, marker: bytes, sep: bytes
                 ) -> Optional[tuple[np.ndarray, np.ndarray]]:
    """A render plan's header lines in one pass (``naf_header_lines``): the
    u8 lines and the i64 length of each, or None when a blob given is
    empty, not 0-terminated or holds fewer items than records
    (``ops.assemble.split_blob`` names the fault)."""
    lib = _load()
    assert lib is not None
    blobs = [None if b is None else np.frombuffer(b, np.uint8)
             for b in (ids_blob, comments_blob)]
    if n_records and any(b is not None and b.size == 0 for b in blobs):
        return None                       # NULL would read as no blob
    sep_a = np.frombuffer(sep, np.uint8)
    cap = sum(b.size for b in blobs if b is not None) + n_records * (2 + sep_a.size)
    out = np.empty(cap, np.uint8)
    hlens = np.empty(n_records, np.int64)
    ids_a, com_a = blobs
    w = lib.naf_header_lines(
        _ptr(ids_a), 0 if ids_a is None else ids_a.size,
        _ptr(com_a), 0 if com_a is None else com_a.size,
        n_records, marker[0], _ptr(sep_a), sep_a.size, _ptr(out), _ptr(hlens))
    if w < 0:
        return None
    return out[:w], hlens


def fastq_grid(data: np.ndarray, n_blocks: int) -> Optional[tuple[list, int]]:
    """The FASTQ grid check and block cuts of ``make_blocks_fastq`` in one
    pass (``naf_fastq_grid``): the ``n_blocks + 1`` cuts and the record
    count, or None where the text is off the regular 4-line grid."""
    lib = _load()
    assert lib is not None
    data = np.ascontiguousarray(data, np.uint8)
    cuts = np.empty(n_blocks + 1, np.int64)
    n_rec = lib.naf_fastq_grid(_ptr(data), data.size, n_blocks, _ptr(cuts))
    if n_rec < 0:
        return None
    return cuts.tolist(), int(n_rec)
