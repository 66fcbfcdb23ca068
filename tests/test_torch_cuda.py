"""naf_tpu_torch's CUDA kernels on the card against their plain PyTorch
versions, and the encode/decode slice through them.

Every test here needs a CUDA card; without one each skips.  On a machine
with a card:

    python -m pytest tests/test_torch_cuda.py -q -m cuda

The first test to run builds the kernels with nvcc (a few seconds).  The
inputs are the seeded cases of torch_cases.py; everything is integer or
bytes, so the tolerance is 0.  The archives and renders are held against
the port's own host encode() and Decoder, which the CPU tests hold against
naf_tpu's.
"""

from __future__ import annotations

import io

import numpy as np
import pytest
import torch

from naf_tpu_torch import device as D
from naf_tpu_torch.format import constants as C
from naf_tpu_torch.ops import compact as CP
from naf_tpu_torch.codec import zstd_backend as Z
from naf_tpu_torch.ops import emit_fused as EF
from naf_tpu_torch.ops import matchfind as MF
from naf_tpu_torch.ops import pack as PK
from naf_tpu_torch.ops import scan_fused as SF
from naf_tpu_torch.ops import unpack as UP
from naf_tpu_torch.ops.common import Q_TILE, SCAN_TILE, TILE
from naf_tpu_torch.parallel.pipeline import encode_device
from naf_tpu_torch.pipeline.decoder import DecodeOptions, Decoder, fasta_device, fastq_device
from naf_tpu_torch.pipeline.encoder import EncodeOptions, encode
from torch_cases import (CLASSIFY_CASES, COMPACT_CARD_CASES, COMPACT_CASES, FASTA_EMIT_CASES,
                         FASTQ_EMIT_CASES, MASK_PARITY_CASES, MATCH_CHAIN_WINDOWS,
                         MATCH_KEY_CASES, SCAN_CARD_CASES, SCAN_CASES,
                         SEQ_TYPES, START_STATES, STREAM_CASES, case_change_behind_tile_start,
                         classify_case, compact_case, dense_toggles, emit_case, fasta_big_block,
                         fasta_start_states, fastq_big_block, fastq_case,
                         fastq_case_change_behind_tile_start, fastq_masked_reads, fastq_reads,
                         mask_parity_input, match_spans, match_window, mixed_fasta, mixed_fastq,
                         ragged_fasta, ragged_fastq, reads_fasta, scan_case, scan_input,
                         sra_fastq, typed_fasta)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return D.cuda_device()


def _on(a: np.ndarray, dev, k: int = 0) -> torch.Tensor:
    """a (any dtype) on dev, at a data pointer k elements past an aligned one."""
    t = torch.from_numpy(np.ascontiguousarray(a).copy())
    buf = torch.zeros(t.numel() + 16, dtype=t.dtype, device=dev)
    buf[k:k + t.numel()] = t.to(dev)
    return buf[k:k + t.numel()]


def _assert_dicts_equal(got: dict, want: dict) -> None:
    torch.cuda.synchronize()
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("seq_type", SEQ_TYPES)
@pytest.mark.parametrize("case", CLASSIFY_CASES)
def test_classify_kernel_on_card(card, case, seq_type):
    body, prev, sis = classify_case(case)
    for n in (body.size, body.size - 77):
        x = _on(body[:n], card)
        flags, sval = SF.classify_fasta_kernel(x, prev, sis, seq_type=seq_type)
        f_ref, v_ref = SF.classify_fasta_plain(x, prev, sis, seq_type=seq_type)
        assert torch.equal(flags, f_ref) and torch.equal(sval, v_ref)


@pytest.mark.parametrize("prev,sis", START_STATES)
def test_classify_kernel_start_states_on_card(card, prev, sis):
    x = _on(fasta_start_states()[:2 * TILE - 5], card, 5)
    flags, sval = SF.classify_fasta_kernel(x, prev, sis)
    f_ref, v_ref = SF.classify_fasta_plain(x, prev, sis)
    assert torch.equal(flags, f_ref) and torch.equal(sval, v_ref)


@pytest.mark.parametrize("flip_case", [False, True], ids=["upper", "flipped_case"])
def test_classify_fasta_many_tiles_on_card(card, flip_case):
    """Thousands of tiles (140 MB) of short records, where the look-back
    meets tiles that have not published yet.  Three calls, each byte-equal
    to the plain version."""
    x = _on(fasta_big_block(2048, flip_case), card)
    f_ref, v_ref = SF.classify_fasta_plain(x, ord(">"))
    for _ in range(3):
        flags, sval = SF.classify_fasta_kernel(x, ord(">"))
        assert torch.equal(flags, f_ref) and torch.equal(sval, v_ref)


@pytest.mark.parametrize("name", FASTA_EMIT_CASES)
def test_emit_kernel_on_card(card, name):
    body, prev, sis, seq_type = emit_case(name)
    x = _on(body, card)
    _assert_dicts_equal(EF.emit_fasta_kernel(x, prev, sis, seq_type=seq_type),
                        EF.emit_fasta_plain(x, prev, sis, seq_type=seq_type))


@pytest.mark.parametrize("prev,sis", START_STATES)
def test_emit_kernel_start_states_on_card(card, prev, sis):
    x = _on(fasta_start_states(), card, 5)
    _assert_dicts_equal(EF.emit_fasta_kernel(x, prev, sis), EF.emit_fasta_plain(x, prev, sis))


@pytest.mark.parametrize("flip_case", [False, True], ids=["upper", "flipped_case"])
def test_emit_fasta_many_tiles_on_card(card, flip_case):
    """2,048+ tiles (140 MB) of short records near the sparse cap, where both
    look-backs meet tiles that have not published yet; with flip_case, case
    changes at many tile starts.  Three calls, each byte-equal to the plain
    version."""
    x = _on(fasta_big_block(2048, flip_case), card)
    want = EF.emit_fasta_plain(x, ord(">"))
    for _ in range(3):
        _assert_dicts_equal(EF.emit_fasta_kernel(x, ord(">")), want)


def test_emit_kernel_case_change_at_tile_first_kept_byte_on_card(card):
    x = _on(case_change_behind_tile_start(), card)
    _assert_dicts_equal(EF.emit_fasta_kernel(x, ord(">")), EF.emit_fasta_plain(x, ord(">")))


@pytest.mark.parametrize("n", [1, 127, 129, TILE - 1, TILE + 1, 2 * TILE + 333,
                               300 * TILE + 5])
def test_emit_kernel_ragged_lengths_on_card(card, n):
    rng = np.random.default_rng(60 + n)
    pool = np.frombuffer(b">ACGTNacgtn \t\r\n" + b"xyz*\x01", np.uint8)
    body = rng.choice(pool, size=n)
    for k in (0, 3):
        x = _on(body, card, k)
        _assert_dicts_equal(EF.emit_fasta_kernel(x, ord(">")), EF.emit_fasta_plain(x, ord(">")))


@pytest.mark.parametrize("n", [0, 2, 16, 30, 256, 1000, TILE + 18, 64 * TILE + 2])
def test_pack_kernel_on_card(card, n):
    rng = np.random.default_rng(61)
    seq = rng.integers(0, 256, size=n, dtype=np.uint8)
    seq[: min(n, 256)] = np.arange(min(n, 256))
    for shift in (0, 1):
        for out_len in (n // 2, n // 2 + 1, n // 2 + 13):
            for k in (0, 5):
                x = _on(seq, card, k)
                got = PK.pack_4bit_kernel(x, shift=shift, out_len=out_len)
                assert torch.equal(got, PK.pack_4bit_plain(x, shift=shift, out_len=out_len))


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 1000, 4096 + 3, 64 * TILE + 1])
def test_unpack_kernel_on_card(card, n):
    rng = np.random.default_rng(62)
    packed = rng.integers(0, 256, size=n, dtype=np.uint8)
    packed[: min(n, 256)] = np.arange(min(n, 256))
    for rna in (False, True):
        for k in (0, 1):
            x = _on(packed, card, k)
            assert torch.equal(UP.unpack_4bit_kernel(x, rna), UP.unpack_4bit_plain(x, rna))


@pytest.mark.parametrize("case", [1, 128, 1000, TILE - 3, TILE + 5, 2 * TILE + 1, 100 * TILE + 9,
                                  *MASK_PARITY_CASES])
def test_mask_parity_kernel_on_card(card, case):
    chars, tog = mask_parity_input(case)
    for k in (0, 7):
        c, t = _on(chars, card, k), _on(tog, card, k)
        assert torch.equal(EF.apply_mask_parity_kernel(c, t), EF.apply_mask_parity_plain(c, t))


def test_mask_parity_many_tiles_on_card(card):
    """64 MiB of every byte value under dense toggles: 2,048 tiles, where
    the look-back meets tiles that have not published yet and a wrong carry
    flips everything after it.  Three calls, each byte-equal to the plain
    version."""
    n = 64 << 20
    rng = np.random.default_rng(65)
    c = _on(rng.integers(0, 256, n, dtype=np.uint8), card)
    t = _on(dense_toggles(rng, n), card)
    want = EF.apply_mask_parity_plain(c, t)
    for _ in range(3):
        assert torch.equal(EF.apply_mask_parity_kernel(c, t), want)


@pytest.mark.parametrize("seq_type", [C.SEQ_TYPE_DNA, C.SEQ_TYPE_RNA])
@pytest.mark.parametrize("name", FASTQ_EMIT_CASES)
def test_fastq_kernels_on_card(card, name, seq_type):
    x = _on(fastq_case(name), card)
    flags, sval = SF.classify_fastq_kernel(x, ord("@"), seq_type=seq_type)
    f_ref, v_ref = SF.classify_fastq_plain(x, ord("@"), seq_type=seq_type)
    assert torch.equal(flags, f_ref) and torch.equal(sval, v_ref)
    _assert_dicts_equal(EF.emit_fastq_kernel(x, ord("@"), seq_type=seq_type),
                        EF.emit_fastq_plain(x, ord("@"), seq_type=seq_type))


@pytest.mark.parametrize("flip_case", [False, True], ids=["upper", "flipped_case"])
def test_classify_fastq_many_tiles_on_card(card, flip_case):
    """2,136 tiles (70 MB) of ragged reads, where the look-back meets tiles
    that have not published yet.  Three calls, each byte-equal to the plain
    version."""
    x = _on(fastq_big_block(2048, flip_case), card)
    f_ref, v_ref = SF.classify_fastq_plain(x, ord("@"))
    for _ in range(3):
        flags, sval = SF.classify_fastq_kernel(x, ord("@"))
        assert torch.equal(flags, f_ref) and torch.equal(sval, v_ref)


@pytest.mark.parametrize("where", ["header", "quality"])
def test_emit_fastq_case_change_at_tile_first_kept_byte_on_card(card, where):
    x = _on(fastq_case_change_behind_tile_start(where), card)
    _assert_dicts_equal(EF.emit_fastq_kernel(x, ord("@")), EF.emit_fastq_plain(x, ord("@")))


@pytest.mark.parametrize("n", [1, 127, 129, Q_TILE - 1, Q_TILE + 1, 3 * Q_TILE + 333,
                               500 * Q_TILE + 5])
def test_fastq_kernels_ragged_lengths_on_card(card, n):
    body = fastq_reads(np.random.default_rng(64 + n), 2 + n // 150,
                       alphabet=b"ACGTacgtN@+ \x01")[:n]
    for k in (0, 3):
        x = _on(body, card, k)
        f, v = SF.classify_fastq_kernel(x, ord("@"))
        f_ref, v_ref = SF.classify_fastq_plain(x, ord("@"))
        assert torch.equal(f, f_ref) and torch.equal(v, v_ref)
        _assert_dicts_equal(EF.emit_fastq_kernel(x, ord("@")), EF.emit_fastq_plain(x, ord("@")))


@pytest.mark.parametrize("flip_case", [False, True], ids=["upper", "flipped_case"])
def test_emit_fastq_many_tiles_on_card(card, flip_case):
    """4,096 tiles (134 MB) of ragged reads, where the look-back meets tiles
    that have not published yet; with flip_case, case changes at many tile
    starts.  Three calls, each byte-equal to the plain version."""
    x = _on(fastq_big_block(4096, flip_case), card)
    want = EF.emit_fastq_plain(x, ord("@"))
    for _ in range(3):
        _assert_dicts_equal(EF.emit_fastq_kernel(x, ord("@")), want)


def test_wrappers_launch_on_cuda_tensors(card):
    """The public wrappers take the kernel, never the plain version, for a
    CUDA tensor, and count each launch."""
    body, prev, sis, seq_type = emit_case("structured")
    x = _on(body, card)
    D.reset_counts()
    r = EF.emit_fasta_fused(x, prev, sis, seq_type=seq_type)
    SF.classify_fasta(x, prev, sis, seq_type=seq_type)
    packed = PK.pack_4bit(r["sv"])
    chars = UP.unpack_4bit(packed)
    EF.apply_mask_parity(chars, torch.zeros_like(chars))
    q = _on(fastq_case("masked"), card)
    EF.emit_fastq_fused(q, ord("@"))
    SF.classify_fastq(q, ord("@"))
    SF.cumsum_i32(x)
    SF.maxscan_i32(x)
    CP.compact_u8(x, x)
    CP.compact_u8_dense(x, x)
    sk, order = torch.sort(MF.match_keys(x, x.numel()), stable=True)
    MF.match_chain(sk, order, 2, 0, x.numel())
    torch.cuda.synchronize()
    assert D.LAUNCHES == {"emit_fasta": 1, "classify_fasta": 1, "pack_4bit": 1,
                          "unpack_4bit": 1, "apply_mask_parity": 1, "emit_fastq": 1,
                          "classify_fastq": 1, "cumsum_i32": 1, "maxscan_i32": 1,
                          "compact": 1, "compact_dense": 1, "match_keys": 1, "match_chain": 1}


@pytest.mark.parametrize("n", [1, 100, SCAN_TILE - 1, SCAN_TILE + 1, 3 * SCAN_TILE + 17,
                               4000 * SCAN_TILE + 3])
def test_scan_kernel_on_card(card, n):
    for kind in ("bool", "u8", "i32"):
        x = scan_input(n, kind)
        for k in (0, 1):
            t = _on(x, card, k)
            assert torch.equal(SF.scan_i32_kernel(t, "add"), SF.cumsum_i32_plain(t.cpu()).to(card))
            assert torch.equal(SF.scan_i32_kernel(t, "max"), SF.maxscan_i32_plain(t.cpu()).to(card))


@pytest.mark.parametrize("op", ["add", "max"])
@pytest.mark.parametrize("case", [*SCAN_CASES, *SCAN_CARD_CASES])
def test_scan_kernel_cases_on_card(card, case, op):
    """Each call three times: the long cases make the look-back meet tiles
    that have not published yet, in another order each call."""
    plain = SF.cumsum_i32_plain if op == "add" else SF.maxscan_i32_plain
    for x in scan_case(case):
        want = plain(torch.from_numpy(x)).to(card)
        for k in range(4):                          # aligned, and 1-3 elements past
            t = _on(x, card, k)
            for _ in range(3):
                assert torch.equal(SF.scan_i32_kernel(t, op), want)
            del t
        del want
        torch.cuda.empty_cache()


@pytest.mark.parametrize("n", [1, 130, SCAN_TILE + 1, 7 * SCAN_TILE - 5, 3000 * SCAN_TILE + 9,
                               *COMPACT_CASES, *COMPACT_CARD_CASES])
def test_compact_kernel_on_card(card, n):
    """The named long cases make the look-back meet tiles that have not
    published yet, and the zero fill span thousands of tiles."""
    for kind in ("u8", "i32"):
        v, keep = compact_case(n, kind)
        for k in (0, 3):
            vt, kt = _on(v, card, k), _on(keep, card, k)
            want, want_cnt = CP.compact_plain(vt.cpu(), kt.cpu())
            for dense in (False, True):
                out, cnt = CP.compact_kernel(vt, kt, dense=dense)
                assert torch.equal(out.cpu(), want) and int(cnt) == int(want_cnt)


def _records(seed: int, n_rec: int, sl: int, L: int = 70) -> bytes:
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n_rec):
        seq = rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=sl)
        for s in rng.integers(0, sl - 300, size=sl // 2000 + 1):
            seq[s:s + 300] |= 32
        rows.append(b">s%03d chr%d\n" % (i, i) + b"\n".join(
            seq[j:j + L].tobytes() for j in range(0, sl, L)) + b"\n")
    return b"".join(rows)


@pytest.mark.parametrize("name,data,opts", [
    ("records", lambda: _records(1, 20, 200_000), EncodeOptions()),
    ("one_record", lambda: _records(2, 1, 3_000_000), EncodeOptions()),
    ("rna_no_mask", lambda: _records(3, 8, 90_000).replace(b"T", b"U").replace(b"t", b"u"),
     EncodeOptions(seq_type=C.SEQ_TYPE_RNA, no_mask=True)),
])
def test_round_trip_on_card(card, name, data, opts):
    data = data()
    D.reset_counts()
    blob = encode_device(data, opts, device=card)[0]
    assert blob == encode(data, opts)[0]
    out = fasta_device(Decoder(io.BytesIO(blob), DecodeOptions()), device=card)
    assert D.ROUTES == {"encode_device": 1, "decode_device": 1}
    if opts.no_mask:     # sequence lines come back in upper case
        data = b"\n".join(r if r.startswith(b">") else r.upper() for r in data.split(b"\n"))
    assert out == data
    assert min(D.LAUNCHES[k] for k in ("emit_fasta", "pack_4bit", "unpack_4bit")) == 1
    assert D.LAUNCHES["apply_mask_parity"] == (0 if opts.no_mask else 1)


def _fastq_uniform(n: int, read_len: int, seed: int) -> bytes:
    body = fastq_masked_reads(np.random.default_rng(seed), n, read_len)
    return (b"@" + body.tobytes()).replace(b" len%d" % read_len, b"")


@pytest.mark.parametrize("name,data,opts", [
    ("reads", lambda: _fastq_uniform(20_000, 150, 1), EncodeOptions()),
    ("long_reads", lambda: _fastq_uniform(40, 60_000, 2), EncodeOptions()),
    ("rna_no_mask", lambda: _fastq_uniform(5_000, 100, 3).replace(b"T", b"U").replace(b"t", b"u"),
     EncodeOptions(seq_type=C.SEQ_TYPE_RNA, no_mask=True)),
])
def test_fastq_round_trip_on_card(card, name, data, opts):
    data = data()
    D.reset_counts()
    blob = encode_device(data, opts, device=card)[0]
    assert blob == encode(data, opts)[0]
    out = fastq_device(Decoder(io.BytesIO(blob), DecodeOptions()), device=card)
    assert D.ROUTES == {"encode_device": 1, "decode_device": 1}
    assert out == Decoder(io.BytesIO(blob), DecodeOptions()).fastq()
    assert min(D.LAUNCHES[k] for k in ("emit_fastq", "pack_4bit", "unpack_4bit")) == 1
    assert D.LAUNCHES["apply_mask_parity"] == 0     # FASTQ output is never masked


@pytest.mark.parametrize("name,data,opts,why", [
    ("protein", lambda: typed_fasta(np.random.default_rng(1), C.SEQ_TYPE_PROTEIN, 3000),
     EncodeOptions(seq_type=C.SEQ_TYPE_PROTEIN), "text_like"),
    ("reads_fasta", lambda: reads_fasta(np.random.default_rng(2), 20_000), EncodeOptions(),
     "sparse_overflow"),
    ("unexpected", lambda: ragged_fasta(np.random.default_rng(3), 300, 5000,
                                        alphabet=b"ACGTNRY!*"),
     EncodeOptions(), "unexpected_chars"),
    ("sra_fastq", lambda: sra_fastq(np.random.default_rng(4), 20_000), EncodeOptions(),
     "sparse_overflow"),
    ("ragged_fastq", lambda: ragged_fastq(np.random.default_rng(5), 3000) + b"@z\nAZ\n+\n!!\n",
     EncodeOptions(), "unexpected_chars"),
])
def test_two_pass_and_ragged_round_trip_on_card(card, name, data, opts, why):
    data = data()
    fastq = data[:1] == b"@"
    D.reset_counts()
    blob, stats = encode_device(data, opts, device=card)
    host_blob, host_stats = encode(data, opts)
    assert blob == host_blob
    assert np.array_equal(stats.unexpected_seq, host_stats.unexpected_seq)
    assert D.ROUTES == {f"encode_device:two_pass:{why}": 1}
    kernels = ["classify_fastq" if fastq else "classify_fasta", "cumsum_i32", "maxscan_i32",
               "compact", "compact_dense"]
    if opts.seq_type < C.SEQ_TYPE_PROTEIN:
        kernels.append("pack_4bit")
    assert min(D.LAUNCHES[k] for k in kernels) >= 1
    D.reset_counts()
    if fastq:
        out = fastq_device(Decoder(io.BytesIO(blob), DecodeOptions()), device=card)
        want = Decoder(io.BytesIO(blob), DecodeOptions()).fastq()
    else:
        out = fasta_device(Decoder(io.BytesIO(blob), DecodeOptions()), device=card)
        want = Decoder(io.BytesIO(blob), DecodeOptions()).fasta()
    assert out == want
    assert D.ROUTES == {"decode_device:ragged:too_many_groups": 1}
    assert D.LAUNCHES["maxscan_i32"] >= 1      # the record lookups; the add scan is the mask's


# ---- the streamed encode (parallel/stream.py) on the card ---------------------

def _stream(data: bytes, opts, chunk: int, engine) -> bytes:
    from naf_tpu_torch.pipeline.stream import encode_stream

    buf = io.BytesIO()
    encode_stream(io.BytesIO(data), buf, opts, chunk_size=chunk, engine=engine)
    return buf.getvalue()


@pytest.mark.parametrize("chunk", [257, 1 << 20])
@pytest.mark.parametrize("name", list(STREAM_CASES))
def test_stream_engine_on_card(card, name, chunk):
    """The engine on the card gives the archive it gives on the CPU (which
    test_torch_stream.py holds against naf_tpu), each piece by the same
    route."""
    from naf_tpu_torch.parallel.stream import DeviceScanEngine

    make, kw, _, _, _ = STREAM_CASES[name]
    data, opts = make(), EncodeOptions(**kw)
    D.reset_counts()
    cpu = _stream(data, opts, chunk, DeviceScanEngine("cpu"))
    cpu_routes = dict(D.ROUTES)
    D.reset_counts()
    eng = DeviceScanEngine(card)
    assert _stream(data, opts, chunk, eng) == cpu == encode(data, opts)[0]
    assert D.ROUTES == cpu_routes
    if eng.device_chunks:
        assert D.LAUNCHES["emit_fastq" if data[:1] == b"@" else "emit_fasta"] >= 1
        assert D.LAUNCHES["pack_4bit"] >= 1


@pytest.mark.parametrize("name", ["giant_record", "odd_masked_fasta", "odd_masked_fastq",
                                  "reads_fasta"])
def test_stream_engine_many_chunks_on_card(card, name):
    """A few MB in 1 MiB chunks: a chromosome-like record continued across
    chunks, odd parity under mask runs, and a header-dense FASTA whose
    chunks take the two-pass protocol."""
    from naf_tpu_torch.parallel.stream import DeviceScanEngine
    from torch_cases import stream_odd_masked_fasta, stream_odd_masked_fastq

    rng = np.random.default_rng(40)
    data = {
        "giant_record": lambda: b">chr\n" + b"".join(
            rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=80).tobytes()
            + (b"acgt\n" if i % 1000 < 7 else b"\n") for i in range(80_000)),
        "odd_masked_fasta": lambda: stream_odd_masked_fasta(seed=41, n_rec=6000),
        "odd_masked_fastq": lambda: stream_odd_masked_fastq(seed=42, n_rec=20_000),
        "reads_fasta": lambda: reads_fasta(rng, 40_000),
    }[name]()
    opts = EncodeOptions()
    D.reset_counts()
    eng = DeviceScanEngine(card)
    assert _stream(data, opts, 1 << 20, eng) == encode(data, opts)[0]
    assert eng.device_chunks >= 3 and eng.native_chunks == 0
    fastq = data[:1] == b"@"
    assert D.LAUNCHES["emit_fastq" if fastq else "emit_fasta"] >= 3
    assert D.LAUNCHES["pack_4bit"] >= 3
    if name == "reads_fasta":
        assert any(k.startswith("stream_device:two_pass:") for k in D.ROUTES)
        assert D.LAUNCHES["classify_fasta"] >= 1 and D.LAUNCHES["compact_dense"] >= 1


# ---- the device zstd engine's kernels (csrc/matchfind.cu) --------------------

@pytest.mark.parametrize("anchor", [False, True])
@pytest.mark.parametrize("size,cap", [*MATCH_KEY_CASES, (3 << 22, 1 << 24), (1 << 24, 1 << 24)])
def test_match_keys_kernel_on_card(card, size, cap, anchor):
    for kind in ("acgt", "random", "equal"):
        for k in (0, 3):                            # aligned, and 3 bytes past
            x = _on(match_window(size, size + cap, kind), card, k)
            assert torch.equal(MF.match_keys_kernel(x, cap, anchor=anchor),
                               MF.match_keys_plain(x, cap, anchor=anchor))


@pytest.mark.parametrize("k", [1, 2, 3, 8, 16])
@pytest.mark.parametrize("kind,size,cap", [*MATCH_CHAIN_WINDOWS, ("acgt", 3 << 22, 1 << 24)])
def test_match_chain_kernel_on_card(card, kind, size, cap, k):
    """Every depth over the spans of ``match_spans``, and the anchor pass
    (stride 8) into the last column of a wider row buffer."""
    x = _on(match_window(size, k, kind), card)
    sk, order = torch.sort(MF.match_keys_plain(x, cap), stable=True)
    for r0, r1 in match_spans(cap):
        got = MF.match_chain_kernel(sk, order, k, r0, r1, wlo=123_456)
        assert torch.equal(got, MF.match_chain_plain(sk, order, k, r0, r1, wlo=123_456))
    sk, order = torch.sort(MF.match_keys_plain(x, cap, anchor=True), stable=True)
    for r0, r1 in ((0, cap), (3, 29), (cap // 2 + 5, cap - 3)):
        got = torch.full((r1 - r0, k + 1), 7, dtype=torch.int32, device=card)
        want = got.clone()
        MF.match_chain_kernel(sk, order, 1, r0, r1, stride=8, wlo=4096, out=got, col=k)
        MF.match_chain_plain(sk, order, 1, r0, r1, stride=8, wlo=4096, out=want, col=k)
        assert torch.equal(got, want)


def test_device_engine_on_card(card, monkeypatch):
    """compress_section_device on the card gives the CPU's frames (which
    tests/test_torch_matchfind.py holds against naf_tpu's) across spans,
    levels, --long and the blocked sections' threads, and engine="device"
    archives equal the CPU's; the kernels launch."""
    monkeypatch.setattr(MF, "SPAN", 256 << 10)
    rng = np.random.default_rng(45)
    unit = rng.integers(0, 256, 9000, dtype=np.uint8)
    data = np.concatenate([np.tile(unit, 60), rng.integers(0, 16, 900_000, dtype=np.uint8)
                           * 17]).tobytes()
    D.reset_counts()
    for level, wl in ((1, 0), (9, 0), (19, 25)):
        timing = {}
        got = Z.compress_section_device(data, level=level, window_log=wl, device=card,
                                        timing=timing)
        assert got == Z.compress_section_device(data, level=level, window_log=wl, device="cpu")
        assert Z.decompress_section(got, len(data)) == data
        assert len(timing["spans"]) == -(-len(data) // MF.SPAN)
        assert all(set(sp) == {"keys", "sort", "chain", "fetch", "serialize_s"}
                   for sp in timing["spans"])
    assert (Z.compress_section_blocked(data, level=3, threads=4, block_bytes=300_000,
                                       engine="device", device=card)
            == Z.compress_section_blocked(data, level=3, threads=4, block_bytes=300_000,
                                          engine="device", device="cpu"))
    assert D.LAUNCHES["match_keys"] > 0 and D.LAUNCHES["match_chain"] > 0
    opts = EncodeOptions(level=5, engine="device")
    for inp in (mixed_fasta(seed=46, n_rec=10, max_len=200_000),
                mixed_fastq(seed=47, n_rec=3000)):
        assert (encode(inp, opts, device=card)[0] == encode(inp, opts, device="cpu")[0]
                == encode_device(inp, opts, device=card)[0])


# ---- the block mesh (parallel/mesh.py) on the card ---------------------------

@pytest.fixture(scope="module")
def last_card(card) -> torch.device:
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two CUDA cards")
    return torch.device("cuda", n - 1)


def test_every_kernel_on_the_last_card(card, last_card):
    """Each kernel launched on the last card while the first one is current
    (``build.call`` makes the tensor's card current for its launch) equals
    its plain version there, and its output stays on that card."""
    torch.cuda.set_device(card)
    body, prev, sis, seq_type = emit_case("structured")
    x = _on(body, last_card)
    r = EF.emit_fasta_kernel(x, prev, sis, seq_type=seq_type)
    _assert_dicts_equal(r, EF.emit_fasta_plain(x, prev, sis, seq_type=seq_type))
    assert r["sv"].device == last_card
    flags, sval = SF.classify_fasta_kernel(x, prev, sis, seq_type=seq_type)
    f_ref, v_ref = SF.classify_fasta_plain(x, prev, sis, seq_type=seq_type)
    assert torch.equal(flags, f_ref) and torch.equal(sval, v_ref)
    sv = r["sv"]
    for shift in (0, 1):
        assert torch.equal(PK.pack_4bit_kernel(sv, shift=shift, out_len=sv.numel() // 2 + 1),
                           PK.pack_4bit_plain(sv, shift=shift, out_len=sv.numel() // 2 + 1))
    packed = PK.pack_4bit_kernel(sv)
    assert torch.equal(UP.unpack_4bit_kernel(packed, False), UP.unpack_4bit_plain(packed, False))
    chars, tog = (_on(a, last_card) for a in mask_parity_input("tile_span"))
    assert torch.equal(EF.apply_mask_parity_kernel(chars, tog),
                       EF.apply_mask_parity_plain(chars, tog))
    q = _on(fastq_case("masked"), last_card)
    _assert_dicts_equal(EF.emit_fastq_kernel(q, ord("@")), EF.emit_fastq_plain(q, ord("@")))
    flags, sval = SF.classify_fastq_kernel(q, ord("@"))
    f_ref, v_ref = SF.classify_fastq_plain(q, ord("@"))
    assert torch.equal(flags, f_ref) and torch.equal(sval, v_ref)
    s = _on(scan_input(3 * SCAN_TILE + 17, "i32"), last_card)
    assert torch.equal(SF.scan_i32_kernel(s, "add"), SF.cumsum_i32_plain(s))
    assert torch.equal(SF.scan_i32_kernel(s, "max"), SF.maxscan_i32_plain(s))
    v, keep = (_on(a, last_card) for a in compact_case(7 * SCAN_TILE - 5, "u8"))
    want, want_cnt = CP.compact_plain(v, keep)
    for dense in (False, True):
        out, cnt = CP.compact_kernel(v, keep, dense=dense)
        assert torch.equal(out, want) and int(cnt) == int(want_cnt)
    w = _on(match_window(70_001, 5), last_card)
    keys = MF.match_keys_kernel(w, 1 << 17)
    assert keys.device == last_card and torch.equal(keys, MF.match_keys_plain(w, 1 << 17))
    sk, order = torch.sort(keys, stable=True)
    assert torch.equal(MF.match_chain_kernel(sk, order, 4, 1000, 60_000, wlo=7),
                       MF.match_chain_plain(sk, order, 4, 1000, 60_000, wlo=7))
    assert torch.cuda.current_device() == card.index


def _mesh_cases() -> dict:
    """(input, options, encode route) of the mesh tests on the card."""
    rng = np.random.default_rng(44)
    return {
        "records": (_records(4, 12, 150_000), EncodeOptions(), "encode_device"),
        "one_record": (_records(5, 1, 2_000_000), EncodeOptions(), "encode_device"),
        "fastq": (b"@" + fastq_masked_reads(rng, n_reads=20_000).tobytes(), EncodeOptions(),
                  "encode_device"),
        "protein": (typed_fasta(rng, C.SEQ_TYPE_PROTEIN, n_rec=3000),
                    EncodeOptions(seq_type=C.SEQ_TYPE_PROTEIN),
                    "encode_device:two_pass:text_like"),
        "reads_fasta": (reads_fasta(rng, 20_000), EncodeOptions(),
                        "encode_device:two_pass:sparse_overflow"),
        "sra_fastq": (sra_fastq(rng, 8000), EncodeOptions(),
                      "encode_device:two_pass:sparse_overflow"),
    }


@pytest.mark.parametrize("blocks", [2, 4])
@pytest.mark.parametrize("name", list(_mesh_cases()))
def test_mesh_on_one_card(card, name, blocks):
    """The encode over a mesh listing the card ``blocks`` times equals host
    encode() by the one-block route, and the mesh render equals the host
    Decoder."""
    from naf_tpu_torch.parallel.mesh import block_mesh

    data, opts, route = _mesh_cases()[name]
    mesh = block_mesh(devices=[card] * blocks)
    D.reset_counts()
    blob = encode_device(data, opts, mesh=mesh)[0]
    assert blob == encode(data, opts)[0]
    assert D.ROUTES == {route: 1}
    fastq = data[:1] == b"@"
    assert D.LAUNCHES["emit_fastq" if fastq else "emit_fasta"] >= (
        blocks if opts.seq_type < C.SEQ_TYPE_PROTEIN else 0)
    host = Decoder(io.BytesIO(blob), DecodeOptions())
    D.reset_counts()
    d = Decoder(io.BytesIO(blob), DecodeOptions())
    got = fastq_device(d, mesh=mesh) if fastq else fasta_device(d, mesh=mesh)
    assert got == (host.fastq() if fastq else host.fasta())
    assert D.ROUTES == {"decode_device:ragged:mesh": 1}
    assert D.LAUNCHES["maxscan_i32"] >= blocks


def test_mesh_over_every_card(card, last_card):
    """``block_mesh()`` spans every visible card; the encode and the render
    over it equal the host's."""
    from naf_tpu_torch.parallel.mesh import block_mesh

    mesh = block_mesh()
    assert mesh.size == torch.cuda.device_count()
    for data, opts, route in _mesh_cases().values():
        D.reset_counts()
        blob = encode_device(data, opts, mesh=mesh)[0]
        assert blob == encode(data, opts)[0] and D.ROUTES == {route: 1}
        fastq = data[:1] == b"@"
        host = Decoder(io.BytesIO(blob), DecodeOptions())
        d = Decoder(io.BytesIO(blob), DecodeOptions())
        got = fastq_device(d, mesh=mesh) if fastq else fasta_device(d, mesh=mesh)
        assert got == (host.fastq() if fastq else host.fasta())


@pytest.mark.parametrize("name", ["giant_record", "odd_masked_fasta", "odd_masked_fastq"])
def test_stream_engine_mesh_on_one_card(card, name):
    """The stream engine over four blocks of the card, in 1 MiB chunks,
    gives host encode()'s archive, every piece on the card."""
    from naf_tpu_torch.parallel.mesh import block_mesh
    from naf_tpu_torch.parallel.stream import DeviceScanEngine
    from torch_cases import stream_odd_masked_fasta, stream_odd_masked_fastq

    rng = np.random.default_rng(45)
    data = {
        "giant_record": lambda: b">chr\n" + b"".join(
            rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=80).tobytes()
            + (b"acgt\n" if i % 1000 < 7 else b"\n") for i in range(40_000)),
        "odd_masked_fasta": lambda: stream_odd_masked_fasta(seed=46, n_rec=4000),
        "odd_masked_fastq": lambda: stream_odd_masked_fastq(seed=47, n_rec=12_000),
    }[name]()
    opts = EncodeOptions()
    eng = DeviceScanEngine(mesh=block_mesh(devices=[card] * 4))
    assert _stream(data, opts, 1 << 20, eng) == encode(data, opts)[0]
    assert eng.device_chunks >= 2 and eng.native_chunks == 0


def test_dryrun_multichip_on_one_card(card):
    from naf_tpu_torch.parallel.mesh import dryrun_multichip

    out = dryrun_multichip(4, [card] * 4)
    assert out["fasta"]["routes"] == {"encode_device": 1}
