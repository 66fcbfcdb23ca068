"""naf_tpu_torch's native entropy engine (native/naf_zstd.cpp in the port's
host library) against naf_tpu's.

The cases of naf_tpu's tests/test_native_engine.py that need neither the
reference binaries nor the device match-finder engine (whose are in
test_torch_matchfind.py).  The port's
``compress_section_native``, ``compress_part_native`` and
``compress_section_parts`` give naf_tpu's bytes on seeded inputs across
levels, negative levels and ``--long``; its native decoder gives the
library's bytes (streamed, checksummed and stitched frames) and raises
what naf_tpu's raises on corrupt ones; archives with ``engine="native"``
equal naf_tpu's for FASTA, FASTQ, protein and ``--extended``, with 1 and 4
threads (``PARTS_MIN_BYTES`` lowered in both packages to reach the parts
path); the streaming decode and ``untnaf --engine native`` decode as the
library does.
"""

from __future__ import annotations

import io

import numpy as np
import pytest
import zstandard

from naf_tpu import native as rnative
from naf_tpu.codec import zstd_backend as RZ
from naf_tpu.pipeline import encoder as RENC
from naf_tpu_torch.codec import zstd_backend as PZ
from naf_tpu_torch.format import constants as C
from naf_tpu_torch.native import host
from naf_tpu_torch.pipeline import encoder as PENC
from naf_tpu_torch.pipeline.decoder import DecodeOptions, Decoder
from torch_cases import mixed_fasta, mixed_fastq, protein_fasta

pytestmark = pytest.mark.skipif(not (host.available() and rnative.available()),
                                reason="no native library")


def _native_pair(data, **kw) -> bytes:
    """The port's compress_section_native of ``data``, checked equal to
    naf_tpu's."""
    got = PZ.compress_section_native(data, **kw)
    assert got == RZ.compress_section_native(data, **kw)
    return got


@pytest.mark.parametrize("seed,kind", [(0, "rand4"), (1, "rand256"), (2, "runs"), (3, "empty")])
def test_section_roundtrip(seed, kind):
    rng = np.random.default_rng(seed)
    if kind == "rand4":
        data = rng.integers(0, 4, 300000, dtype=np.uint8).tobytes()
    elif kind == "rand256":
        data = rng.integers(0, 256, 100000, dtype=np.uint8).tobytes()
    elif kind == "runs":
        data = rng.integers(0, 256, 2000, dtype=np.uint8).tobytes() * 100
    else:
        data = b""
    payload = _native_pair(data)
    assert PZ.decompress_section(payload, len(data)) == data
    assert PZ.decompress_section_native(payload, len(data)) == data


def test_fuzz_sections():
    rng = np.random.default_rng(77)
    for trial in range(30):
        n = int(rng.integers(0, 200000))
        data = rng.integers(0, int(rng.integers(2, 257)), n, dtype=np.uint8).tobytes()
        assert PZ.decompress_section(_native_pair(data), n) == data, trial


def _seq_qual_fixtures():
    """SEQ-like (packed 4-bit, repeat structure) and QUAL-like streams."""
    rng = np.random.default_rng(7)
    pool = [rng.integers(0, 4, size=int(rng.integers(200, 2000))).astype(np.uint8)
            for _ in range(40)]
    parts, total = [], 0
    while total < 1 << 20:
        m = pool[int(rng.integers(0, 40))].copy()
        idx = rng.integers(0, m.size, max(1, m.size // 100))
        m[idx] = rng.integers(0, 4, idx.size)
        parts.append(m)
        total += m.size
    codes = np.concatenate(parts)
    codes = codes[: codes.size // 2 * 2]
    nib = np.array([8, 4, 2, 1], np.uint8)[codes]
    packed = (nib[0::2] | (nib[1::2] << 4)).tobytes()
    qual = ((38 + np.cumsum(rng.integers(-1, 2, size=1 << 20)) % 30)
            .astype(np.uint8) + 33).tobytes()
    return packed, qual


@pytest.mark.parametrize("level,bound", [(1, 1.30), (9, 1.25), (16, 1.15), (19, 1.10),
                                         (22, 1.10)])
def test_levels_match_naf_tpu_and_track_zstd(level, bound):
    """-# is honored, byte for byte as naf_tpu's engine; each level's ratio
    tracks library zstd at that level."""
    for data in _seq_qual_fixtures():
        na = _native_pair(data, level=level)
        assert PZ.decompress_section(na, len(data)) == data
        assert PZ.decompress_section_native(na, len(data)) == data
        assert len(na) < len(PZ.compress_section(data, level=level)) * bound


@pytest.mark.parametrize("level", [-1, -100, -131072])
def test_negative_levels(level):
    rng = np.random.default_rng(9)
    data = rng.integers(0, 64, 100000, dtype=np.uint8).tobytes() * 3
    assert PZ.decompress_section(_native_pair(data, level=level), len(data)) == data


def test_long_window():
    """--long finds matches beyond the default window, as naf_tpu's does."""
    rng = np.random.default_rng(8)
    block = rng.integers(0, 256, 3 << 20, dtype=np.uint8).tobytes()
    gap = rng.integers(0, 256, 4 << 20, dtype=np.uint8).tobytes()
    data = block + gap + block          # a repeat 7 MB back (> the 2 MB window)
    short = _native_pair(data, level=5)
    long_ = _native_pair(data, level=5, window_log=24)
    assert PZ.decompress_section_native(long_, len(data)) == data
    assert len(long_) < len(short) * 0.75


def test_level2_repeat_regime():
    rng = np.random.default_rng(7)
    parts = []
    for _ in range(6):
        if rng.random() < 0.35 and parts:
            parts.append(parts[int(rng.integers(0, len(parts)))])
        else:
            parts.append(rng.integers(0, 16, 1 << 20, dtype=np.uint8))
    data = np.concatenate(parts).tobytes()
    lib1 = zstandard.ZstdCompressor(level=1).compress(data)[4:]
    for level in (2, 3):
        na = _native_pair(data, level=level)
        assert PZ.decompress_section_native(na, len(data)) == data
        assert len(na) < len(lib1), (level, len(na), len(lib1))


# ---------------------------------------------------------------------------
# the native decoder
# ---------------------------------------------------------------------------

def _lib_frame(data, **kw):
    return zstandard.ZstdCompressor(**kw).compress(data)[4:]   # magic-stripped


def test_native_decoder_vs_library_levels():
    rng = np.random.default_rng(90)
    for level in (-5, 1, 3, 9, 19, 22):
        for kind in range(5):
            if kind == 0:
                data = rng.integers(0, 256, 60000, dtype=np.uint8).tobytes()
            elif kind == 1:
                data = rng.choice(np.frombuffer(b"ACGTacgtNn", np.uint8), size=200000).tobytes()
            elif kind == 2:
                data = rng.integers(0, 256, 997, dtype=np.uint8).tobytes() * 97
            elif kind == 3:
                data = b"\0" * 150000
            else:
                data = rng.integers(0, 256, int(rng.integers(0, 40)), dtype=np.uint8).tobytes()
            assert PZ.decompress_section_native(_lib_frame(data, level=level), len(data)) == data


def test_native_decoder_streamed_and_checksummed_frames():
    """Windowed multi-block frames, the checksum flag, frames without a
    content size, and two frames one after the other (the MT regime)."""
    rng = np.random.default_rng(91)
    data = rng.choice(np.frombuffer(b"ACGTacgt\n>x", np.uint8), size=1_500_000).tobytes()
    for kw in (dict(level=5), dict(level=19, write_checksum=True),
               dict(level=3, write_content_size=False)):
        buf = io.BytesIO()
        with zstandard.ZstdCompressor(**kw).stream_writer(buf, closefd=False) as w:
            for off in range(0, len(data), 1 << 17):
                w.write(data[off:off + (1 << 17)])
        assert PZ.decompress_section_native(buf.getvalue()[4:], len(data)) == data
    two = (zstandard.ZstdCompressor(level=2).compress(data[:700_000])
           + zstandard.ZstdCompressor(level=8).compress(data[700_000:]))
    assert PZ.decompress_section_native(two[4:], len(data)) == data


def test_native_decoder_decodes_own_engine():
    """Levels up to 9 here; 16-22 decode in test_levels_match_naf_tpu_and_track_zstd
    (on this input of 5000-byte repeats they take about 30 s a call, PERF.md)."""
    rng = np.random.default_rng(92)
    data = (rng.integers(0, 256, 5000, dtype=np.uint8).tobytes() * 60
            + rng.choice(np.frombuffer(b"ACGT", np.uint8), size=400000).tobytes())
    for level in (-50, 1, 2, 9):
        for wlog in (0, 25):
            payload = PZ.compress_section_native(data, level=level, window_log=wlog)
            assert PZ.decompress_section_native(payload, len(data)) == data


def _outcome(fn, *args):
    try:
        return "ok", fn(*args)
    except Exception as e:     # the type and text are what is compared
        return type(e).__name__, str(e)


def test_native_decoder_corruption_raises_as_naf_tpu():
    """Truncated and bit-flipped frames: the port's decoder returns or
    raises exactly what naf_tpu's does, and never crashes."""
    rng = np.random.default_rng(93)
    data = rng.integers(0, 200, 120000, dtype=np.uint8).tobytes()
    base = _lib_frame(data, level=9)
    raised = 0
    for trial in range(200):
        b = bytearray(base)
        if trial % 3 == 0:
            b = b[:int(rng.integers(1, len(b)))]
        else:
            b[int(rng.integers(0, len(b)))] ^= 1 << int(rng.integers(0, 8))
        got = _outcome(PZ.decompress_section_native, bytes(b), len(data))
        assert got == _outcome(RZ.decompress_section_native, bytes(b), len(data)), trial
        raised += got[0] != "ok"
    assert raised > 0


def test_native_decoder_verifies_content_checksum():
    rng = np.random.default_rng(13)
    data = rng.integers(0, 16, 1 << 18, dtype=np.uint8).tobytes() * 3
    c = zstandard.ZstdCompressor(level=3, write_checksum=True).compress(data)
    assert PZ.decompress_section_native(c[4:], len(data)) == data
    for trial in range(20):
        bad = bytearray(c)
        bad[int(rng.integers(20, len(bad) - 5))] ^= 1 << int(rng.integers(8))
        with pytest.raises(RuntimeError):
            PZ.decompress_section_native(bytes(bad)[4:], len(data))


def test_tiny_count_four_stream_literals():
    """A format-valid 4-stream Huffman literals block with tiny per-stream
    counts but long streams; libzstd agrees on the bytes."""
    tree = bytes([128, 0x10])                 # direct weights: 2 symbols, w=1
    stream = bytes(8) + bytes([0x07])         # 9 B: sentinel + two 1-bit codes
    jump = (9).to_bytes(2, "little") * 3
    lits_body = tree + jump + stream * 4
    csize = len(lits_body)
    b0 = 2 | (1 << 2) | ((8 & 0xF) << 4)      # compressed, sf=1, rsize=8
    content = bytes([b0, ((8 >> 4) & 0x3F) | ((csize & 3) << 6), csize >> 2]) + lits_body + b"\0"
    bh = 1 | (2 << 1) | (len(content) << 3)
    frame = bytes([0x00, 0x00]) + bh.to_bytes(3, "little") + content
    assert PZ.decompress_section_native(frame, 8) == b"\x01" * 8
    assert zstandard.ZstdDecompressor().decompress(b"\x28\xb5\x2f\xfd" + frame,
                                                   max_output_size=8) == b"\x01" * 8


# ---------------------------------------------------------------------------
# single-frame block stitching: independent parts -> one frame
# ---------------------------------------------------------------------------

def _parts_pair(parts, **kw) -> bytes:
    got = PZ.compress_section_parts(parts, **kw)
    assert got == RZ.compress_section_parts(parts, **kw)
    return got


def test_stitched_parts_roundtrip_all_levels():
    rng = np.random.default_rng(11)
    base = rng.integers(0, 16, 1 << 19, dtype=np.uint8).tobytes()
    parts = [base[:300_000], base[100_000:400_000], base, b"",
             base[:65_537], rng.integers(0, 256, 333, dtype=np.uint8).tobytes()]
    data = b"".join(parts)
    for level in (1, 5, 19, -7):
        frame = _parts_pair(parts, level=level)
        assert zstandard.ZstdDecompressor().decompress(
            b"\x28\xb5\x2f\xfd" + frame, max_output_size=len(data) + 8) == data
        assert PZ.decompress_section_native(frame, len(data)) == data
        assert [PZ.compress_part_native(p, level) for p in parts] == [
            RZ.compress_part_native(p, level) for p in parts]


def test_stitched_parts_fuzz_boundaries():
    rng = np.random.default_rng(5)
    motif = rng.integers(0, 16, 4096, dtype=np.uint8).tobytes()
    data = motif * 64 + rng.integers(0, 256, 10_000, dtype=np.uint8).tobytes()
    for trial in range(8):
        n_parts = int(rng.integers(1, 7))
        cuts = (np.sort(rng.integers(0, len(data), n_parts - 1)) if n_parts > 1
                else np.asarray([], np.int64))
        bounds = [0, *map(int, cuts), len(data)]
        parts = [data[a:b] for a, b in zip(bounds[:-1], bounds[1:])]
        frame = _parts_pair(parts, level=int(rng.integers(1, 9)), window_log=24 * (trial % 2))
        assert zstandard.ZstdDecompressor().decompress(
            b"\x28\xb5\x2f\xfd" + frame, max_output_size=len(data) + 8) == data, trial


def test_stitched_parts_empty():
    assert PZ.decompress_section_native(_parts_pair([], level=1), 0) == b""
    assert PZ.decompress_section_native(_parts_pair([b"", b""], level=3), 0) == b""


@pytest.mark.parametrize("window", [0, 1000, 1024, 1025, 1 << 20, (1 << 20) + 1, 3 << 29])
def test_window_descriptor(window):
    assert PZ._window_descriptor(window) == RZ._window_descriptor(window)


# ---------------------------------------------------------------------------
# archives and decodes
# ---------------------------------------------------------------------------

ARCHIVE_INPUTS = {
    "fasta": (lambda: mixed_fasta(seed=40, n_rec=30, max_len=8000), {}),
    "fastq": (lambda: mixed_fastq(seed=41, n_rec=400), {}),
    "protein": (lambda: protein_fasta(seed=42, n_rec=60), {"seq_type": C.SEQ_TYPE_PROTEIN}),
    "extended": (lambda: mixed_fasta(seed=43, n_rec=15, max_len=6000),
                 {"extended": True, "block_bytes": 1 << 13}),
    "long": (lambda: mixed_fasta(seed=44, n_rec=20, max_len=8000),
             {"level": 19, "long_window_log": 25}),
}


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("name", list(ARCHIVE_INPUTS))
def test_archive_native_engine_equals_naf_tpu(name, threads, monkeypatch):
    """engine="native" archives equal naf_tpu's, the SEQ section through the
    parts path at 4 threads, and decode to the library engine's output."""
    monkeypatch.setattr(PENC, "PARTS_MIN_BYTES", 1 << 12)
    monkeypatch.setattr(RENC, "PARTS_MIN_BYTES", 1 << 12)
    make, kw = ARCHIVE_INPUTS[name]
    data = make()
    blob, _ = PENC.encode(data, PENC.EncodeOptions(engine="native", threads=threads, **kw))
    ref, _ = RENC.encode(data, RENC.EncodeOptions(engine="native", threads=threads, **kw))
    assert blob == ref
    plain, _ = PENC.encode(data, PENC.EncodeOptions(**kw))
    fastq = name == "fastq"
    out = Decoder(io.BytesIO(blob), DecodeOptions())
    want = Decoder(io.BytesIO(plain), DecodeOptions())
    assert (out.fastq() if fastq else out.fasta()) == (want.fastq() if fastq else want.fasta())


def test_native_engine_ratio_close_to_zstd1():
    data = mixed_fasta(seed=42, n_rec=40, max_len=50_000)
    blob_n, _ = PENC.encode(data, PENC.EncodeOptions(engine="native"))
    blob_z, _ = PENC.encode(data, PENC.EncodeOptions(level=1))
    assert len(blob_n) < len(blob_z) * 1.10


def test_streaming_paths_with_native_engine():
    """The buffered native SectionDecompressor keeps the streaming decodes
    and the record ranges byte-identical."""
    fa = mixed_fasta(seed=97, n_rec=40, max_len=12000)
    fq = mixed_fastq(seed=98, n_rec=700)
    blob, _ = PENC.encode(fa, PENC.EncodeOptions())
    qblob, _ = PENC.encode(fq, PENC.EncodeOptions())
    want = Decoder(io.BytesIO(blob), DecodeOptions()).fasta()
    qwant = Decoder(io.BytesIO(qblob), DecodeOptions()).fastq()
    want_range = Decoder(io.BytesIO(blob), DecodeOptions()).fasta_range(3, 9)
    PZ.set_decode_engine("native")
    try:
        buf = io.BytesIO()
        Decoder(io.BytesIO(blob), DecodeOptions()).stream_fasta(buf)
        assert buf.getvalue() == want
        qbuf = io.BytesIO()
        Decoder(io.BytesIO(qblob), DecodeOptions()).stream_fastq(qbuf)
        assert qbuf.getvalue() == qwant
        assert Decoder(io.BytesIO(blob), DecodeOptions()).fasta_range(3, 9) == want_range
        assert Decoder(io.BytesIO(blob), DecodeOptions()).fasta() == want
    finally:
        PZ.set_decode_engine("zstd")


def test_section_decompressor_native_is_one_shot():
    data = mixed_fasta(seed=99, n_rec=5)
    payload = PZ.compress_section(data)
    PZ.set_decode_engine("native")
    try:
        d = PZ.SectionDecompressor(len(payload), len(data))
        assert d.feed(payload[:10]) == b""
        assert d.feed(payload[10:]) == data
        with pytest.raises(RuntimeError, match="exhausted"):
            d.feed(b"")
        lib = PZ.SectionDecompressor(len(payload), len(data), force_library=True)
        assert lib.feed(payload) == data
    finally:
        PZ.set_decode_engine("zstd")


def test_untnaf_engine_native_cli(tmp_path, monkeypatch):
    """untnaf --engine native writes the library engine's output, FASTA and
    FASTQ, plain and extended archives."""
    from naf_tpu_torch.cli import untnaf as U

    monkeypatch.delenv("TMPDIR", raising=False)
    for i, (data, opts) in enumerate([
        (mixed_fasta(seed=94, n_rec=25, max_len=9000), PENC.EncodeOptions()),
        (mixed_fastq(seed=95, n_rec=400), PENC.EncodeOptions()),
        (mixed_fasta(seed=96, n_rec=25, max_len=9000),
         PENC.EncodeOptions(extended=True, block_bytes=1 << 13)),
    ]):
        blob, _ = PENC.encode(data, opts)
        arc = tmp_path / f"a{i}.naf"
        arc.write_bytes(blob)
        fq = ["--fastq"] if data[:1] == b"@" else []
        assert U.main([*fq, str(arc), "-o", str(tmp_path / "o1")]) == 0
        try:
            assert U.main(["--engine", "native", *fq, str(arc), "-o", str(tmp_path / "o2")]) == 0
            assert PZ.decode_engine() == "native"
        finally:
            PZ.set_decode_engine("zstd")      # the flag sets module state
        assert (tmp_path / "o1").read_bytes() == (tmp_path / "o2").read_bytes()


def test_tnaf_native_engine_honors_level(tmp_path, monkeypatch):
    """tnaf --engine native -19 --long 25 gives a smaller archive than -1,
    each naf_tpu's archive byte for byte, decoding to the input."""
    from naf_tpu.cli import tnaf as RT
    from naf_tpu_torch.cli import tnaf as T

    monkeypatch.delenv("TMPDIR", raising=False)
    rng = np.random.default_rng(44)
    motifs = [rng.choice(np.frombuffer(b"ACGT", np.uint8), size=int(rng.integers(100, 900)))
              for _ in range(12)]
    rows = []
    for i in range(30):
        body = np.concatenate([motifs[int(rng.integers(0, 12))] for _ in range(20)]).tobytes()
        rows.append(b">r%d\n" % i + b"\n".join(body[j:j + 70]
                                               for j in range(0, len(body), 70)) + b"\n")
    data = b"".join(rows)
    src = tmp_path / "x.fa"
    src.write_bytes(data)
    sizes = []
    for flags in (["-1"], ["-19", "--long", "25"]):
        port, ref = tmp_path / "p.naf", tmp_path / "r.naf"
        argv = ["--engine", "native", "--threads", "2", *flags, str(src), "-o"]
        assert T.main([*argv, str(port)]) == 0
        assert RT.main([*argv, str(ref)]) == 0
        assert port.read_bytes() == ref.read_bytes()
        assert Decoder(io.BytesIO(port.read_bytes()), DecodeOptions()).fasta() == data
        sizes.append(port.stat().st_size)
    assert sizes[1] <= sizes[0]


def test_port_native_lib_is_self_contained():
    """The host library is the port's own build of both sources, with the
    device engine's candidate serializers."""
    so = host._build()
    assert so is not None and so != rnative._SO
    assert [p.name for p in host.SOURCES] == ["naf_native.cpp", "naf_zstd.cpp"]
    lib = host._load()
    assert hasattr(lib, "naf_zstd_compress_ex") and hasattr(lib, "naf_zstd_decompress")
    for name in ("naf_zstd_compress_cand_k", "naf_zstd_compress_cand",
                 "naf_zstd_compress_cand_stream"):
        assert hasattr(lib, name), name
