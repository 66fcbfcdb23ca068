"""The port's section compressor fed in place: libzstd reads each write
from the caller's buffer and writes the frame into one buffer of the
compressor's, whose view ``finish()`` returns.

Every frame is held against naf_tpu's ``SectionCompressor`` (through its
``syszstd.py``, the same system libzstd) on the same bytes: payload sizes
on both sides of one 4 MiB stage, every kind of buffer a caller hands in,
pieces whose buffers are overwritten as soon as ``write()`` returns, and
the spilling compressor.  The ``copied`` counter, and the ``zstd`` span
that carries it, are held to the bytes each path copies on the host.
"""

from __future__ import annotations

import io

import numpy as np
import pytest

from naf_tpu import codec as RCODEC
from naf_tpu.pipeline import encoder as RENC
from naf_tpu_torch import zstd_compat
from naf_tpu_torch.codec import zstd_backend as PZ
from naf_tpu_torch.pipeline import encoder as PENC
from naf_tpu_torch.utils import trace

pytestmark = pytest.mark.skipif(zstd_compat.system_lib() is None,
                                reason="needs the system libzstd")

STAGE = PZ.SectionCompressor._STAGE
SIZES = [0, 1, STAGE - 1, STAGE, STAGE + 1, 3 * STAGE + 17]
KINDS = ["bytes", "bytearray", "memoryview", "ndarray", "strided"]


def _payload(n: int, seed: int = 7) -> np.ndarray:
    """Packed-base-like bytes: random two-bit codes with repeated stretches,
    so level 1 finds matches."""
    rng = np.random.default_rng(seed)
    out = rng.integers(0, 4, n, dtype=np.uint8) * 17
    for lo in range(0, max(n - 8192, 0), 65536):
        out[lo + 4096:lo + 8192] = out[lo:lo + 4096]
    return out


def _as(kind: str, a: np.ndarray):
    if kind == "bytes":
        return a.tobytes()
    if kind == "bytearray":
        return bytearray(a.tobytes())
    if kind == "memoryview":
        return memoryview(a.tobytes())
    if kind == "ndarray":
        return a
    wide = np.zeros(2 * a.size, np.uint8)       # every other byte: not contiguous
    wide[::2] = a
    return wide[::2]


def _ref(data: bytes, **kw) -> bytes:
    return bytes(RCODEC.compress_section(data, **kw))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("threads", [0, 2])
def test_frames_match_naf_tpu(threads, n, kind):
    """Given whole to finish() and through write(): naf_tpu's frame, and
    copies only where the bytes must be kept past the call."""
    a = _payload(n)
    want = _ref(a.tobytes(), level=1, threads=threads)
    strided = n if kind == "strided" and n > 1 else 0     # one byte is contiguous

    whole = PZ.SectionCompressor(level=1, threads=threads)
    got = whole.finish(_as(kind, a))
    assert isinstance(got, memoryview)
    assert got == want
    assert whole.copied == strided

    streamed = PZ.SectionCompressor(level=1, threads=threads)
    streamed.write(_as(kind, a))
    assert streamed.finish() == want
    # below one stage the piece waits for finish(); in MT mode the tail
    # short of a stage waits for the next write
    kept = n if n < STAGE else (n % STAGE if threads else 0)
    assert streamed.copied == strided + kept
    assert PZ.decompress_section(got, n) == a.tobytes()


@pytest.mark.parametrize("end", ["finish", "finish_last"])
@pytest.mark.parametrize("n", [(3 << 20) + 1, (20 << 20) + 5])
@pytest.mark.parametrize("threads", [0, 2])
def test_pieces_in_reused_buffers(threads, n, end):
    """Pieces of 1 B, 3 MiB and 5 MiB in turn, each from one scratch buffer
    overwritten as soon as write() returns: libzstd has read every byte
    by then, and the frame is naf_tpu's of the whole payload."""
    a = _payload(n, seed=11)
    want = _ref(a.tobytes(), level=1, threads=threads)
    scratch = np.empty(5 << 20, np.uint8)
    c = PZ.SectionCompressor(level=1, threads=threads)
    sizes = [1, 3 << 20, 5 << 20]
    off = i = 0
    while off < n:
        k = min(sizes[i % 3], n - off)
        scratch[:k] = a[off:off + k]
        off += k
        i += 1
        if end == "finish_last" and off == n:
            got = c.finish(scratch[:k])
            break
        c.write(scratch[:k])
        scratch.fill(0xAA)
    else:
        got = c.finish()
    assert got == want
    assert c.uncompressed_size == n


def test_spill_past_threshold_writes_the_same_frame(tmp_path):
    """Past its threshold the spilling compressor writes the frame to its
    file, the bytes naf_tpu's compressor makes; copy_into streams them and
    removes the file."""
    a = np.random.default_rng(3).integers(0, 256, (16 << 20) + 3, dtype=np.uint8)
    want = _ref(a.tobytes(), level=1, threads=2)
    c = PZ.SpillingSectionCompressor(level=1, threads=2, temp_dir=str(tmp_path), name="t",
                                     section="seq", threshold=1 << 20)
    for off in range(0, a.size, 3 << 20):
        c.write(a[off:off + (3 << 20)])
    got = c.finish()
    assert isinstance(got, PZ.SpilledPayload)
    path = tmp_path / "t.seq"
    assert path.read_bytes()[4:] == want
    assert len(got) == len(want)
    out = io.BytesIO()
    got.copy_into(out)
    assert out.getvalue() == want
    assert not path.exists()


@pytest.mark.parametrize("n", [1000, (6 << 20) + 9])
def test_spill_below_threshold_leaves_no_file(n, tmp_path):
    """A frame that stays under the threshold comes back in memory, and a
    one-shot payload never spills, whatever the threshold."""
    a = _payload(n, seed=5)
    small = n < STAGE
    c = PZ.SpillingSectionCompressor(level=1, threads=2, temp_dir=str(tmp_path), name="t",
                                     section="seq", threshold=1 if small else 1 << 30)
    c.write(a)
    got = c.finish()
    assert isinstance(got, memoryview)
    assert got == _ref(a.tobytes(), level=1, threads=2)
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("bases", [4 * STAGE, 4 * STAGE + 34])
def test_zstd_spans_note_no_copies(bases, monkeypatch):
    """The host encode in MT mode hands each section to libzstd whole, so
    every zstd span notes 0 bytes copied, stage-aligned packed bases
    (2 stages) or not; the archive is naf_tpu's."""
    rng = np.random.default_rng(9)
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, bases)]
    text = b">r1 c\n" + b"\n".join(seq[i:i + 60].tobytes() for i in range(0, bases, 60)) + b"\n"
    monkeypatch.setattr(trace, "ENABLED", True)
    trace.clear()
    try:
        blob = PENC.encode(text, PENC.EncodeOptions(threads=2), device="cpu")[0]
        spans = [s for s in trace.spans() if s.name == "zstd"]
    finally:
        trace.clear()
    assert blob == RENC.encode(text, RENC.EncodeOptions(threads=2))[0]
    by = {s.fields["section"]: s.fields for s in spans}
    assert by["sequence"]["bytes"] == bases // 2
    assert {k: f["copied"] for k, f in by.items()} == {k: 0 for k in by}


@pytest.mark.parametrize("n", [0, 1, STAGE + 1, 3 * STAGE + 17])
@pytest.mark.parametrize("threads", [0, 2])
def test_package_fallback_frames(threads, n, monkeypatch):
    """Without the system libzstd both packages compress through the
    ``zstandard`` package, and still agree frame for frame."""
    pytest.importorskip("zstandard")
    from naf_tpu.codec import zstd_backend as RZ

    monkeypatch.setattr(zstd_compat, "system_lib", lambda: None)
    monkeypatch.setattr(RZ, "_sys_zstd", lambda: False)
    a = _payload(n, seed=13)
    c = PZ.SectionCompressor(level=1, threads=threads)
    c.write(a)
    got = c.finish()
    assert got == _ref(a.tobytes(), level=1, threads=threads)
    assert PZ.compress_section(a, level=1, threads=threads) == got
    # the package's output is copied into the frame buffer
    assert c.copied >= len(got) + 4
