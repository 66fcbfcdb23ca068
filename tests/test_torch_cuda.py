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
from naf_tpu_torch.ops import emit_fused as EF
from naf_tpu_torch.ops import pack as PK
from naf_tpu_torch.ops import scan_fused as SF
from naf_tpu_torch.ops import unpack as UP
from naf_tpu_torch.ops.common import Q_TILE, SCAN_TILE, TILE
from naf_tpu_torch.parallel.pipeline import encode_device
from naf_tpu_torch.pipeline.decoder import DecodeOptions, Decoder, fasta_device, fastq_device
from naf_tpu_torch.pipeline.encoder import EncodeOptions, encode
from torch_cases import (CLASSIFY_CASES, COMPACT_CARD_CASES, COMPACT_CASES, FASTA_EMIT_CASES,
                         FASTQ_EMIT_CASES, MASK_PARITY_CASES, SCAN_CARD_CASES, SCAN_CASES,
                         SEQ_TYPES, START_STATES, case_change_behind_tile_start, classify_case,
                         compact_case, dense_toggles, emit_case, fasta_big_block,
                         fasta_start_states, fastq_big_block, fastq_case,
                         fastq_case_change_behind_tile_start, fastq_masked_reads, fastq_reads,
                         mask_parity_input, ragged_fasta, ragged_fastq, reads_fasta, scan_case,
                         scan_input, sra_fastq, typed_fasta)

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
    torch.cuda.synchronize()
    assert D.LAUNCHES == {"emit_fasta": 1, "classify_fasta": 1, "pack_4bit": 1,
                          "unpack_4bit": 1, "apply_mask_parity": 1, "emit_fastq": 1,
                          "classify_fastq": 1, "cumsum_i32": 1, "maxscan_i32": 1,
                          "compact": 1, "compact_dense": 1}


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
