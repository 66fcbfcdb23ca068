"""naf_tpu_torch's device match-finder engine against naf_tpu's, on the CPU.

``ops/matchfind.py``'s plain versions (the path a CPU tensor takes) give
the candidates of ``naf_tpu/ops/matchfind.py`` (XLA on the CPU) exactly:
every chain depth, windows under 16 bytes, runs of equal bytes, random
bytes, windows that wrap (a power-of-two size) or read zero padding, the
span windows at the section's start and in its middle, and the anchor
pass with its history clipped and aligned down to 8.  With ``SPAN``
lowered to 256 KiB in both packages, so that 1-2 MB inputs cross several
spans, ``compress_section_device(device="cpu")`` gives naf_tpu's frames at
levels 1, 9 and 19 with and without ``--long``, and ``encode(...,
engine="device", device="cpu")`` naf_tpu's archives (FASTA, FASTQ, protein,
extended), as ``encode_device`` does.  At the full SPAN, naf_tpu's own
``--long`` case holds (a repeat beyond the span history is found), and a
section of 2 GiB takes the native engine.  Everything is integer or bytes:
tolerance 0.
"""

from __future__ import annotations

import io

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from naf_tpu import native as rnative
from naf_tpu.codec import zstd_backend as RZ
from naf_tpu.ops import matchfind as RMF
from naf_tpu.pipeline import encoder as RENC
from naf_tpu_torch import device as D
from naf_tpu_torch.codec import zstd_backend as PZ
from naf_tpu_torch.format import constants as C
from naf_tpu_torch.native import host
from naf_tpu_torch.ops import matchfind as MF
from naf_tpu_torch.parallel.pipeline import encode_device
from naf_tpu_torch.pipeline import encoder as PENC
from naf_tpu_torch.pipeline.decoder import DecodeOptions, Decoder
from torch_cases import mixed_fasta, mixed_fastq, protein_fasta

needs_native = pytest.mark.skipif(not (host.available() and rnative.available()),
                                  reason="no native library")

#: the span both packages serialize in these tests
SMALL_SPAN = 256 << 10


@pytest.fixture
def small_span(monkeypatch):
    monkeypatch.setattr(MF, "SPAN", SMALL_SPAN)
    monkeypatch.setattr(RMF, "SPAN", SMALL_SPAN)


def _bytes(kind: str, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.integers(0, 256, n, dtype=np.uint8)
    if kind == "equal":
        return np.full(n, 0x41, np.uint8)
    if kind == "acgt":
        return rng.choice(np.frombuffer(b"ACGT", np.uint8), n)
    # packed-nibble-like bytes with 3 KB repeats: long equal-key runs
    unit = rng.integers(0, 16, 3000, dtype=np.uint8)
    return np.tile(unit, -(-n // unit.size))[:n] ^ (rng.random(n) < 0.01).astype(np.uint8)


@pytest.mark.parametrize("k", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("kind,n", [("random", 9), ("random", 15), ("random", 16),
                                    ("equal", 40_000), ("random", 50_001), ("acgt", 65_536),
                                    ("repeats", 70_000)])
def test_find_match_candidates_equals_naf_tpu(kind, n, k):
    data = _bytes(kind, n, seed=n + k)
    got = MF.find_match_candidates(data, k, device="cpu")
    want = RMF.find_match_candidates(data, k)
    assert got.dtype == want.dtype == np.int32 and got.shape == want.shape
    assert got.shape == ((n,) if k == 1 else (n, k))
    np.testing.assert_array_equal(got, want)


#: (lo, hi, hist): the section's start; a window of exactly 2^18 bytes
#: (wraps at its end); a mid-section span whose window pads to 2^19; a
#: short last span; and windows under 16 bytes
WINDOWS = [(0, 1 << 18, 1 << 18), (1 << 18, 1 << 19, 1 << 18), (3 << 18, 1 << 20, 300_000),
           (1 << 20, 1_100_003, 1 << 18), (0, 15, 1 << 18), (100, 110, 5)]


@pytest.mark.parametrize("k", [2, 16])
@pytest.mark.parametrize("lo,hi,hist", WINDOWS)
def test_windowed_candidates_equal_naf_tpu(lo, hi, hist, k):
    data = _bytes("repeats", 1_100_003, seed=7)
    got = MF.find_match_candidates_windowed(data, k, lo, hi, hist=hist, device="cpu")
    want = RMF.find_match_candidates_windowed(data, k, lo, hi, hist=hist)
    assert got.dtype == np.int32 and got.shape == (hi - lo, k)
    np.testing.assert_array_equal(got, want)
    if hi - lo > 16:
        assert (got >= 0).any()


@pytest.mark.parametrize("lo,hi,hist", [
    (0, 1 << 18, 64 << 20),            # history reaches the start
    (1 << 19, 3 << 18, 1 << 18),       # a window of exactly 2^19: wraps
    (300_005, 700_001, 100_003),       # clipped: max(0, lo - hist) & ~7 aligns down
    (1_000_000, 1_100_003, 999_993),   # a ragged end, the history aligned down to 8
    (20, 60, 5),                       # a window under 64 bytes
])
def test_ldm_candidates_equal_naf_tpu(lo, hi, hist):
    data = _bytes("repeats", 1_100_003, seed=8)
    got = MF.find_ldm_candidates(data, lo, hi, hist=hist, device="cpu")
    want = RMF.find_ldm_candidates(data, lo, hi, hist=hist)
    assert got.dtype == np.int32 and got.shape == (hi - lo,)
    np.testing.assert_array_equal(got, want)


def test_span_candidates_fill_both_passes():
    """The span pipeline's columns are the windowed pass's k and the anchor
    pass's one, absolute, for a span in the middle of a section."""
    data = _bytes("repeats", 900_000, seed=9)
    sec = MF.upload(data, "cpu")
    lo, hi = 1 << 19, 800_000
    out = MF.span_candidates(sec, lo, hi, 4, 1 << 18, 1 << 19)
    assert out.shape == (hi - lo, 5) and out.dtype == torch.int32
    np.testing.assert_array_equal(out[:, :4].numpy(),
                                  RMF.find_match_candidates_windowed(data, 4, lo, hi, 1 << 18))
    np.testing.assert_array_equal(out[:, 4].numpy(), RMF.find_ldm_candidates(data, lo, hi, 1 << 19))


def _section(n: int, seed: int) -> bytes:
    """Packed-nibble-like bytes: a repeated 9 KB unit, then long-range
    repeats of 64 KiB pieces, then random nibble pairs."""
    rng = np.random.default_rng(seed)
    unit = rng.integers(0, 256, 9000, dtype=np.uint8)
    piece = rng.integers(0, 256, 1 << 16, dtype=np.uint8)
    body = [np.tile(unit, 40), piece, rng.integers(0, 256, 300_000, dtype=np.uint8), piece]
    tail = rng.integers(0, 16, n, dtype=np.uint8) * 17
    return np.concatenate(body + [tail])[:n].tobytes()


@needs_native
@pytest.mark.parametrize("level,window_log", [(1, 0), (9, 0), (19, 0), (1, 25), (19, 25)])
def test_compress_section_device_equals_naf_tpu(small_span, level, window_log):
    data = _section(1_300_000, seed=level + window_log)
    assert len(data) > 4 * SMALL_SPAN
    got = PZ.compress_section_device(data, level=level, window_log=window_log, device="cpu")
    assert got == RZ.compress_section_device(data, level=level, window_log=window_log)
    assert PZ.decompress_section(got, len(data)) == data
    assert len(got) < len(data) * 0.9


@needs_native
def test_compress_section_device_edges(small_span):
    """The empty section's frame, one short section, an explicit k, and the
    per-span timing record off a card (the serializer's seconds only)."""
    assert PZ.compress_section_device(b"", device="cpu") == RZ.compress_section_device(b"")
    assert PZ.decompress_section(PZ.compress_section_device(b"", device="cpu"), 0) == b""
    short = b"ACGTACGTAC" * 3
    assert (PZ.compress_section_device(short, level=3, device="cpu")
            == RZ.compress_section_device(short, level=3))
    data = _section(600_000, seed=3)
    timing = {}
    got = PZ.compress_section_device(data, level=5, k=3, device="cpu", timing=timing)
    assert got == RZ.compress_section_device(data, level=5, k=3)
    assert len(timing["spans"]) == 3
    assert all(set(s) == {"serialize_s"} for s in timing["spans"])


@needs_native
def test_long_reaches_past_span_history():
    """naf_tpu's own case at the full SPAN: a 1 MB repeat at 9 MB distance
    is out of the default 4 MiB history and found with window_log 25."""
    assert MF.SPAN == RMF.SPAN == 4 << 20
    rng = np.random.default_rng(73)
    motif = rng.integers(0, 16, 1 << 20, dtype=np.uint8)
    filler = rng.integers(0, 16, 8 << 20, dtype=np.uint8)
    data = np.concatenate([motif, filler, motif]).tobytes()
    short = PZ.compress_section_device(data, level=9, device="cpu")
    longw = PZ.compress_section_device(data, level=9, window_log=25, device="cpu")
    assert PZ.decompress_section(short, len(data)) == data
    assert PZ.decompress_section(longw, len(data)) == data
    assert len(longw) < len(short) * 0.95, (len(longw), len(short))


@needs_native
def test_device_engine_over_2gib_takes_native(monkeypatch):
    """A section of 2 GiB or more goes to the native engine, counted as
    ``device_engine_host:over_2gib``, as naf_tpu's does (int32 positions)."""
    calls = []
    monkeypatch.setattr(PZ, "compress_section_native",
                        lambda data, level, window_log: calls.append(
                            (memoryview(data).nbytes, level, window_log)) or b"frame")
    big = np.zeros(1 << 31, np.uint8)          # untouched pages: no memory is used
    D.reset_counts()
    assert PZ.compress_section_device(big, level=7, window_log=27, device="cpu") == b"frame"
    assert calls == [(1 << 31, 7, 27)]
    assert D.ROUTES == {"device_engine_host:over_2gib": 1}


def test_device_engine_needs_a_card_for_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PZ.compress_section_device(b"ACGT" * 10, device="cuda")


ENCODE_INPUTS = {
    "fasta": (lambda: mixed_fasta(seed=50, n_rec=12, max_len=200_000), {}),
    "fasta_long": (lambda: mixed_fasta(seed=51, n_rec=12, max_len=200_000),
                   {"level": 19, "long_window_log": 25}),
    "fastq": (lambda: mixed_fastq(seed=52, n_rec=4000), {"level": 9}),
    "protein": (lambda: protein_fasta(seed=53, n_rec=400), {"seq_type": C.SEQ_TYPE_PROTEIN}),
    "extended": (lambda: mixed_fasta(seed=54, n_rec=12, max_len=200_000),
                 {"extended": True, "block_bytes": 1 << 18, "threads": 3}),
}


@needs_native
@pytest.mark.parametrize("name", list(ENCODE_INPUTS))
def test_encode_device_engine_equals_naf_tpu(small_span, name):
    """engine="device" archives equal naf_tpu's, from the host encode and
    from encode_device's fused or two-pass path, and decode to the library
    engine's output."""
    make, kw = ENCODE_INPUTS[name]
    data = make()
    blob, _ = PENC.encode(data, PENC.EncodeOptions(engine="device", **kw), device="cpu")
    ref, _ = RENC.encode(data, RENC.EncodeOptions(engine="device", **kw))
    assert blob == ref
    assert encode_device(data, PENC.EncodeOptions(engine="device", **kw), device="cpu")[0] == ref
    plain, _ = PENC.encode(data, PENC.EncodeOptions(**kw))
    fastq = name == "fastq"
    out = Decoder(io.BytesIO(blob), DecodeOptions())
    want = Decoder(io.BytesIO(plain), DecodeOptions())
    assert (out.fastq() if fastq else out.fasta()) == (want.fastq() if fastq else want.fasta())
