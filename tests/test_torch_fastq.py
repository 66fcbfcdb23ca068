"""naf_tpu_torch's device FASTQ round trip against the JAX package.

  * classify_fastq equals classify_fastq_fused (Pallas, interpret mode) on
    the generators of test_scan_fused.py;
  * emit_fastq_fused equals the JAX emit_fastq_fused (interpret mode) on the
    cases of test_emit_fused.py, and the scan oracle of that file where the
    port departs from the reference on purpose (a case change at a tile's
    first kept byte behind the tile's first byte);
  * make_blocks_fastq, fused_blocks_fastq_sharded on one block and
    parse_fused_fastq equal their originals;
  * encode_device(device="cpu") on FASTQ equals naf_tpu's host encode(),
    fastq_device(device="cpu") equals naf_tpu's Decoder.fastq(), and every
    route, device or host, is taken by name; Nanopore-shaped long reads
    take the fused route.
Everything is integer or bytes: tolerance 0.
"""

from __future__ import annotations

import io

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from naf_tpu.ops import emit_fused as E
from naf_tpu.ops.scan_fused import classify_fastq_fused
from naf_tpu.parallel import block as RB
from naf_tpu.parallel import pipeline as RP
from naf_tpu.parallel.mesh import block_mesh, block_sharding
from naf_tpu.pipeline import decoder as RDEC
from naf_tpu.pipeline import encoder as RENC
from naf_tpu.pipeline.parser import InputError as RefInputError
from naf_tpu_torch import device as D
from naf_tpu_torch.format import constants as C
from naf_tpu_torch.ops.emit_fused import CS_CAP, emit_fastq_fused
from naf_tpu_torch.ops.scan_fused import classify_fastq
from naf_tpu_torch.parallel import block as PB
from naf_tpu_torch.parallel import decode as PD
from naf_tpu_torch.parallel import pipeline as PP
from naf_tpu_torch.parallel.pipeline import encode_device
from naf_tpu_torch.pipeline.decoder import Decoder, fastq_device
from naf_tpu_torch.pipeline.encoder import EncodeOptions, encode
from naf_tpu_torch.pipeline.parser import InputError

from fused_pipeline_cases import _gen_fq
from torch_cases import assert_rows_equal, ref_block_rows
from test_emit_fused import _oracle_fastq
from torch_cases import (FASTQ_CASES, fastq_case, fastq_case_change_behind_tile_start,
                         fastq_masked_reads, long_read_fastq)

AT = ord("@")


def _ref_opts(opts: EncodeOptions) -> RENC.EncodeOptions:
    return RENC.EncodeOptions(**vars(opts))


def _host(data: bytes, opts: EncodeOptions) -> bytes:
    """naf_tpu's host encode() archive."""
    return RENC.encode(data, _ref_opts(opts))[0]


# ---------------------------------------------------------------------------
# kernels: plain versions against the JAX kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq_type", [C.SEQ_TYPE_DNA, C.SEQ_TYPE_RNA])
@pytest.mark.parametrize("name", ["multi_tile", "long_reads", "weird_bytes", "lf_tail"])
def test_classify_fastq_matches_pallas(name, seq_type):
    body = fastq_case(name)
    f_ref, v_ref = classify_fastq_fused(jnp.asarray(body), jnp.asarray(np.uint8(AT)),
                                        seq_type=seq_type, interpret=True)
    flags, sval = classify_fastq(torch.from_numpy(body.copy()), AT, seq_type=seq_type)
    assert np.array_equal(flags.numpy(), np.asarray(f_ref))
    assert np.array_equal(sval.numpy(), np.asarray(v_ref))


def _ref_emit(body):
    r = E.emit_fastq_fused(jnp.asarray(body), jnp.asarray(np.uint8(AT)), interpret=True)
    return {k: np.asarray(v) for k, v in r.items()}


def _port_emit(body):
    return {k: v.numpy() for k, v in emit_fastq_fused(torch.from_numpy(body.copy()), AT).items()}


@pytest.mark.parametrize("name", FASTQ_CASES)
def test_emit_fastq_matches_pallas(name):
    body = fastq_case(name)
    ref, got = _ref_emit(body), _port_emit(body)
    assert got.keys() == ref.keys()
    if name == "sparse_overflow":
        assert not bool(ref["sp_ok"]) and not bool(got["sp_ok"])
    for k in ref:
        if not bool(ref["sp_ok"]) and k.startswith("sp_"):
            # past the cap the TPU merge leaves its sparse arrays unspecified
            assert got[k].shape == ref[k].shape
            continue
        assert got[k].shape == ref[k].shape, k
        assert np.array_equal(got[k], ref[k]), k


@pytest.mark.parametrize("where", ["header", "quality"])
def test_emit_fastq_case_change_at_tile_first_kept_byte(where):
    """The port keeps the case change the JAX kernel misses (F3): it
    equals the scan oracle, and its archive equals host encode()."""
    body = fastq_case_change_behind_tile_start(where)
    got = _port_emit(body)
    want = _oracle_fastq(body, AT)
    n_sp = int(got["n_sp"])
    assert n_sp == want["tags"].size
    tv = got["sp_tv"][:n_sp]
    assert np.array_equal(tv >> 8, want["tags"])
    assert np.array_equal(tv & 0xFF, want["vals"])
    for k, o in (("sp_a", "avals"), ("sp_b", "bvals"), ("sp_c", "cvals")):
        assert np.array_equal(got[k][:n_sp], want[o]), k
    for k in ("sv", "qv", "iv"):
        assert np.array_equal(got[k][:want[k].size], want[k]), k
    # the JAX kernel drops exactly that one change entry
    assert int(_ref_emit(body)["n_sp"]) == n_sp - 1
    data = b"@" + body.tobytes().rstrip(b"\n") + b"\n"
    D.reset_counts()
    assert encode_device(data, device="cpu")[0] == _host(data, EncodeOptions())
    assert D.ROUTES == {"encode_device": 1}


def test_sparse_cap_and_tile_are_the_reference_ones():
    from naf_tpu_torch.ops.common import Q_TILE

    assert CS_CAP == E._CS_CAP and Q_TILE == E._TILE_Q


# ---------------------------------------------------------------------------
# host helpers and the fused block against their originals
# ---------------------------------------------------------------------------

IRREGULAR = {
    "empty": b"",
    "no_trailing_lf": b"r\nAC\n+\n!!",
    "cr": b"r\r\nAC\n+\n!!\n",
    "three_lines": b"r\nAC\n+\n",
    "empty_line": b"r\n\n+\n\n",
    "no_plus": b"r\nAC\n-\n!!\n",
    "no_at": b"r\nAC\n+\n!!\nr2\nAC\n+\n!!\n",
}


def _regular() -> bytes:
    """300 short reads, the text after the leading '@'."""
    return _gen_fq(300, 90, 4)[1:]


def _put(raw: bytes, pos: int, byte: int) -> bytes:
    return raw[:pos] + bytes([byte]) + raw[pos + 1:]


def _line_start(raw: bytes, line: int) -> int:
    return 0 if line == 0 else [i for i, c in enumerate(raw) if c == 10][line - 1] + 1


def _bad_in_tail() -> bytes:
    """A CR inside the last quality line, behind the last full 32 bytes."""
    raw = _regular()
    assert len(raw) % 32 >= 3
    return _put(raw, len(raw) - 2, 13)


def _long_record() -> bytes:
    """A 100 kb read between short ones: most targets fall deep inside it."""
    rng = np.random.default_rng(8)
    recs = []
    for i, n in enumerate([40, 100_000, 60, 30]):
        seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), n).tobytes()
        recs.append(b"@r%d\n%s\n+\n%s\n" % (i, seq, b"I" * n))
    return b"".join(recs)[1:]


def _even_records() -> bytes:
    """28 records of 25 bytes: every target of 2, 4 and 7 blocks falls on a
    record start."""
    recs = [b"@r%02d\nACGTACGT\n+\nIIIIIIII\n" % i for i in range(1, 28)]
    return b"".join([b"r000\nACGTACGT\n+\nIIIIIIII\n", *recs])


#: texts after the leading '@' that make_blocks_fastq splits into 1, 2, 3, 4
#: and 7 blocks, or refuses
GRID_CASES = {
    "regular": _regular,
    **{k: (lambda v=v: v) for k, v in IRREGULAR.items()},
    "vt_mid_line": lambda: _put(_regular(), 5, 11),
    "ff_mid_line": lambda: _put(_regular(), _line_start(_regular(), 5) + 7, 12),
    "cr_last_byte": lambda: _regular()[:-1] + b"\r",
    "bad_byte_in_tail": _bad_in_tail,
    "cr_at_32": lambda: _put(_regular(), 32, 13),
    "vt_at_64": lambda: _put(_regular(), 64, 11),
    "ff_before_96": lambda: _put(_regular(), 95, 12),
    "no_at_record_2": lambda: _put(_regular(), _line_start(_regular(), 8), ord("r")),
    "no_plus_last_record": lambda: _put(_regular(), _line_start(_regular(), 4 * 299 + 2),
                                        ord("-")),
    "empty_first_line": lambda: b"\nAC\n+\n!!\n@r\nAC\n+\n!!\n",
    "long_record": _long_record,
    "even_records": _even_records,
    "more_blocks_than_records": lambda: b"r\nAC\n+\n!!\n@s\nG\n+\n#\n",
}


def _fuzz(n: int = 300) -> list:
    """Seeded single-byte edits of a valid FASTQ: an LF, CR, '@' or '+'
    inserted, deleted or written over a byte."""
    raw = _gen_fq(40, 20, 9)[1:]
    rng = np.random.default_rng(23)
    out = []
    for _ in range(n):
        pos = int(rng.integers(0, len(raw)))
        byte = int(rng.choice(np.frombuffer(b"\n\r@+", np.uint8)))
        op = int(rng.integers(0, 3))
        if op == 0:
            out.append(raw[:pos] + bytes([byte]) + raw[pos:])
        elif op == 1:
            out.append(raw[:pos] + raw[pos + 1:])
        else:
            out.append(_put(raw, pos, byte))
    return out


def _assert_blocks_match(raw: bytes, n_blocks: int):
    x = np.frombuffer(raw, np.uint8)
    got, want = PB.make_blocks_fastq(x, n_blocks), RB.make_blocks_fastq(x, n_blocks)
    if want is None:
        assert got is None
        return
    (a, na), (b, nb) = got, want
    assert na == nb
    for f in ("data", "prev", "starts_in_seq"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f


@pytest.fixture(params=["native", "numpy"])
def grid_path(request, monkeypatch):
    """make_blocks_fastq held to one grid check: the host library's pass, or
    the numpy fallback (the library off); the other one raises."""
    from naf_tpu_torch.native import host as native

    def other(*a):
        raise AssertionError("the other grid check ran")

    if request.param == "native":
        assert native.available()
        monkeypatch.setattr(PB, "_fastq_grid_np", other)
    else:
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setattr(native, "fastq_grid", other)
    return request.param


@pytest.mark.parametrize("case", [*GRID_CASES, "fuzz"])
def test_make_blocks_fastq_matches(case, grid_path):
    raws = _fuzz() if case == "fuzz" else [GRID_CASES[case]()]
    for raw in raws:
        for n_blocks in (1, 2, 3, 4, 7):
            _assert_blocks_match(raw, n_blocks)
    if case in ("regular", "long_record", "even_records"):
        x = np.frombuffer(raws[0], np.uint8)
        blocks, _ = PB.make_blocks_fastq(x, 7)
        assert (blocks.data != ord("\n")).any(axis=1).sum() > 1       # cut, not one block


def test_fused_block_fastq_and_parse_match():
    data = _gen_fq(500, 100, 6)
    body = np.frombuffer(data, np.uint8)[1:]
    blocks, _ = RB.make_blocks_fastq(body, 1)
    mesh = block_mesh(1)
    sh = block_sharding(mesh)
    ref = [np.asarray(o) for o in RB.fused_blocks_fastq_sharded(
        jax.device_put(jnp.asarray(blocks.data), sh),
        jax.device_put(jnp.asarray(blocks.prev), sh),
        jnp.zeros(1, jnp.int32), seq_type=0, mesh=mesh, interpret=True)]
    x = torch.from_numpy(blocks.data[0].copy())
    got = [torch.stack(o) for o in PB.fused_blocks_fastq_sharded([x], blocks.prev, 0, seq_type=0)]
    for x, y in zip(got, ref):
        assert np.array_equal(x.numpy(), y)
    want = RP.parse_fused_fastq(1, ref[3], ref)
    assert_rows_equal(PP.parse_fused(got[3].numpy(), got, fastq=True), ref_block_rows(want))


# ---------------------------------------------------------------------------
# encode_device and fastq_device
# ---------------------------------------------------------------------------

def _uniform_masked(n=400, read_len=150, seed=30) -> bytes:
    """Fixed-width headers and reads with lowercase runs (one record shape)."""
    body = fastq_masked_reads(np.random.default_rng(seed), n, read_len)
    rows = b"@" + body.tobytes()
    return rows.replace(b" len%d" % read_len, b"")


ENCODE_CASES = {
    "gen_fq": (lambda: _gen_fq(), EncodeOptions()),
    "masked": (lambda: b"@" + fastq_case("masked").tobytes().rstrip(b"\n") + b"\n",
               EncodeOptions()),
    "uniform_masked": (lambda: _uniform_masked(), EncodeOptions()),
    "no_mask": (lambda: _uniform_masked(seed=31), EncodeOptions(no_mask=True)),
    "rna": (lambda: _gen_fq(200, 80, 8).replace(b"T", b"U").replace(b"t", b"u"),
            EncodeOptions(seq_type=C.SEQ_TYPE_RNA)),
    "well_formed_safe": (lambda: _gen_fq(200, 70, 9), EncodeOptions(well_formed=True)),
    "level_threads": (lambda: _gen_fq(300, 120, 10), EncodeOptions(level=5, threads=2)),
    "long_reads": (lambda: _uniform_masked(6, 50_000, 35), EncodeOptions()),
    "case_change_at_tile_edge": (
        lambda: b"@" + fastq_case_change_behind_tile_start("quality").tobytes().rstrip(b"\n")
        + b"\n", EncodeOptions()),
}


@pytest.mark.parametrize("name", list(ENCODE_CASES))
def test_encode_device_fastq_equals_host(name):
    make, opts = ENCODE_CASES[name]
    data = make()
    D.reset_counts()
    blob = encode_device(data, opts, device="cpu")[0]
    assert D.ROUTES == {"encode_device": 1}
    assert blob == _host(data, opts)
    # and the decode: the port's fastq_device against naf_tpu's fastq()
    want = RDEC.Decoder(io.BytesIO(blob), RDEC.DecodeOptions()).fastq()
    D.reset_counts()
    out = fastq_device(Decoder(io.BytesIO(blob)), device="cpu")
    assert out == want
    if not opts.no_mask:         # FASTQ output is never masked (unnaf.c:443)
        assert out == b"\n".join(r.upper() if i % 4 == 1 else r
                                 for i, r in enumerate(data.split(b"\n")))


def test_long_read_fastq_takes_the_fused_route():
    """Nanopore-shaped reads, two of them over two 32 KiB tiles, the ``+``
    line repeating the defline: the fused route, the archive of the port's
    and naf_tpu's host ``encode()``, and the text back with a bare ``+``."""
    data = long_read_fastq(seed=48)
    D.reset_counts()
    blob = encode_device(data, EncodeOptions(), device="cpu")[0]
    assert D.ROUTES == {"encode_device": 1}
    assert blob == encode(data, EncodeOptions())[0] == _host(data, EncodeOptions())
    out = fastq_device(Decoder(io.BytesIO(blob)), device="cpu")
    assert out == b"\n".join(b"+" if i % 4 == 2 else r
                             for i, r in enumerate(data.split(b"\n")))


def test_fastq_device_uniform_takes_the_device():
    data = _uniform_masked(seed=32)
    blob = _host(data, EncodeOptions())
    D.reset_counts()
    out = fastq_device(Decoder(io.BytesIO(blob)), device="cpu")
    assert D.ROUTES == {"decode_device": 1}
    assert out == RDEC.Decoder(io.BytesIO(blob), RDEC.DecodeOptions()).fastq()
    assert out.upper() == data.upper()


#: case -> (input, options, route): protein, a tile past the sparse cap and
#: unexpected characters take the two-pass device encode
ROUTES = {
    "fastq_irregular": (lambda: _gen_fq(30, 40, 15) + b"@last\nACGT\n+\n!!!!",
                        EncodeOptions(), "encode_host:fastq_irregular"),
    "text_like": (lambda: b"@p\nMKV\n+\n!!!\n", EncodeOptions(seq_type=C.SEQ_TYPE_PROTEIN),
                  "encode_device:two_pass:text_like"),
    "well_formed_unsafe": (lambda: b"@r\nAC GT\n+\n!!!!!\n", EncodeOptions(well_formed=True),
                           "encode_host:well_formed_unsafe"),
    "unexpected_chars": (lambda: _gen_fq(100, 50, 11) + b"@z\nACZT\n+\n!!!!\n",
                         EncodeOptions(), "encode_device:two_pass:unexpected_chars"),
    "sparse_overflow": (lambda: b"@" + fastq_case("sparse_overflow").tobytes().rstrip(b"\n")
                        + b"\n", EncodeOptions(), "encode_device:two_pass:sparse_overflow"),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_encode_fastq_routes(route):
    make, opts, taken = ROUTES[route]
    data = make()
    D.reset_counts()
    assert encode_device(data, opts, device="cpu")[0] == _host(data, opts)
    assert D.ROUTES == {taken: 1}


def test_encode_fastq_unexpected_quality_takes_two_pass():
    """An unexpected quality byte: its histogram comes from the two-pass
    stats, on the device."""
    data = _gen_fq(50, 40, 12) + b"@q\nACGT\n+\n!!\x7f!\n"
    D.reset_counts()
    assert encode_device(data, device="cpu")[0] == _host(data, EncodeOptions())
    assert D.ROUTES == {"encode_device:two_pass:unexpected_chars": 1}


def test_encode_fastq_quality_length_mismatch_raises_as_host():
    data = _gen_fq(20, 30, 13) + b"@bad\nACGT\n+\n!!!\n"
    with pytest.raises(RefInputError) as ref:
        RENC.encode(data, RENC.EncodeOptions())
    D.reset_counts()
    with pytest.raises(InputError) as got:
        encode_device(data, device="cpu")
    assert str(got.value) == str(ref.value)
    assert D.ROUTES == {"encode_host:qual_length_mismatch": 1}


def test_fastq_device_decode_routes(monkeypatch):
    ragged = _gen_fq(60, 50, 14)         # comment on 3 headers in 4: many shapes
    blob = _host(ragged, EncodeOptions())
    want = RDEC.Decoder(io.BytesIO(blob), RDEC.DecodeOptions()).fastq()
    D.reset_counts()
    assert fastq_device(Decoder(io.BytesIO(blob)), device="cpu") == want
    assert D.ROUTES == {"decode_device:ragged:too_many_groups": 1}

    uniform = _uniform_masked(50, 60, 33)
    blob = _host(uniform, EncodeOptions())
    want = RDEC.Decoder(io.BytesIO(blob), RDEC.DecodeOptions()).fastq()
    monkeypatch.setattr(PD, "OUT_BATCH", 1024)
    D.reset_counts()
    assert fastq_device(Decoder(io.BytesIO(blob)), device="cpu") == want
    assert D.ROUTES == {"decode_device:ragged:too_large": 1}


def test_fastq_device_spill_quirk_goes_to_host(monkeypatch):
    """An archive whose lengths do not add up to its sequence section (no
    plan) is rendered by the host, as the reference does."""
    data = _uniform_masked(20, 40, 34)
    blob = _host(data, EncodeOptions())
    monkeypatch.setattr(Decoder, "_plan", lambda self, mode, masking: None)
    D.reset_counts()
    assert fastq_device(Decoder(io.BytesIO(blob)), device="cpu") == \
        RDEC.Decoder(io.BytesIO(blob), RDEC.DecodeOptions()).fastq()
    assert D.ROUTES == {"decode_host:spill_quirk": 1}


def test_fastq_decode_without_qualities_raises():
    from naf_tpu_torch.pipeline.decoder import DecodeError

    blob = _host(b">a\nACGT\n", EncodeOptions())
    with pytest.raises(DecodeError, match="no qualities"):
        fastq_device(Decoder(io.BytesIO(blob)), device="cpu")
