"""naf_tpu_torch's own host stack against the naf_tpu modules it copies.

Each copy must give what its original gives: the format constants, VLE
numbers and container; the zstd section codec (one-shot, streaming,
blocked); the parser and host encode() archives on the inputs of
torch_cases.py, test_parallel.py and fused_pipeline_cases.py; the
Decoder's fasta() and fastq(), on the native render and on the numpy path,
its other output modes, its record ranges and its streaming decode;
build_plan; the numpy helpers under ops (the histograms too); the native
scan's carry arguments; and the stream encoder, spill included.  The C++
host runtime is built by the port into its build tree, and its copy does
not drop the tail of a long render (F1 in ROADMAP.md), so what reaches F1's
sizes is held against the input.  Everything is bytes: tolerance 0.
"""

from __future__ import annotations

import io
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import naf_tpu.native as RNATIVE
from naf_tpu import codec as RCODEC
from naf_tpu.format import constants as RC
from naf_tpu.format import container as RCONT
from naf_tpu.format import vle as RVLE
from naf_tpu.ops import assemble as RASM
from naf_tpu.ops import histogram as RHIST
from naf_tpu.ops import mask as RMASK
from naf_tpu.ops import render as RRENDER
from naf_tpu.parallel import decode as RDV
from naf_tpu.pipeline import decoder as RDEC
from naf_tpu.pipeline import encoder as RENC
from naf_tpu.pipeline import parser as RP
from naf_tpu.pipeline import stream as RSTREAM
from naf_tpu_torch import codec as PCODEC
from naf_tpu_torch.format import constants as C
from naf_tpu_torch.format import container as PCONT
from naf_tpu_torch.format import vle as PVLE
from naf_tpu_torch.native import build as kbuild
from naf_tpu_torch.native import host as native
from naf_tpu_torch.ops import assemble as PASM
from naf_tpu_torch.ops import histogram_np as PHIST
from naf_tpu_torch.ops import mask as PMASK
from naf_tpu_torch.ops import render as PRENDER
from naf_tpu_torch.ops.pack import pack_4bit_np
from naf_tpu_torch.ops.unpack import unpack_4bit_np
from naf_tpu_torch.parallel import decode as PDV
from naf_tpu_torch.pipeline import decoder as PDEC
from naf_tpu_torch.pipeline import encoder as PENC
from naf_tpu_torch.pipeline import parser as PP
from naf_tpu_torch.pipeline import stream as PSTREAM

from fused_pipeline_cases import _gen, _gen_fq
from test_parallel import _fasta, _fastq, _typed_fasta
from torch_cases import (EMIT_CASES, emit_case, fastq_case, mixed_fasta, mixed_fastq,
                         protein_fasta, text_fasta)


REPO = Path(__file__).resolve().parent.parent


def _ref_opts(opts: PENC.EncodeOptions) -> RENC.EncodeOptions:
    return RENC.EncodeOptions(**vars(opts))


# ---------------------------------------------------------------------------
# format
# ---------------------------------------------------------------------------

def test_constants_match():
    names = [n for n in dir(RC) if n.isupper()]
    assert names == [n for n in dir(C) if n.isupper()]
    for n in names:
        a, b = getattr(RC, n), getattr(C, n)
        if isinstance(a, np.ndarray):
            assert np.array_equal(a, b), n
        elif isinstance(a, dict):
            assert a.keys() == b.keys(), n
            for k in a:
                assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), (n, k)
        else:
            assert a == b, n


def test_vle_matches():
    values = [0, 1, 127, 128, 255, 16383, 16384, 2**31 - 1, 2**32, 2**63 - 1]
    for v in values:
        enc = PVLE.encode_vle(v)
        assert enc == RVLE.encode_vle(v)
        assert PVLE.decode_vle(enc + b"x", 0) == RVLE.decode_vle(enc + b"x", 0)
    for bad in (b"\x80", b"\x80" * 11):
        with pytest.raises(PVLE.VleError):
            PVLE.decode_vle(bad, 0)


def test_container_reader_matches():
    data = _gen(total=60_000, seed=21)
    blob = RENC.encode(data, RENC.EncodeOptions(title="t"))[0]
    a, b = PCONT.NafReader(io.BytesIO(blob)), RCONT.NafReader(io.BytesIO(blob))
    assert vars(a.header) == vars(b.header)
    assert (a.n_sequences, a.line_length) == (b.n_sequences, b.line_length)
    for key in ("ids", "comments", "lengths", "mask", "sequence"):
        assert a.load_section(key) == b.load_section(key), key


# ---------------------------------------------------------------------------
# codec
# ---------------------------------------------------------------------------

_PAYLOADS = {
    "small": np.random.default_rng(1).integers(0, 4, 50_000, dtype=np.uint8).tobytes(),
    "staged": _gen(total=9_000_000, rec_len=3_000_000, seed=22),   # > one 4 MiB stage
    "empty": b"",
}


@pytest.mark.parametrize("payload", list(_PAYLOADS))
@pytest.mark.parametrize("kw", [dict(level=1), dict(level=7, window_log=22),
                                dict(level=3, threads=2)], ids=["l1", "l7_long", "l3_mt"])
def test_section_codec_matches(payload, kw):
    data = _PAYLOADS[payload]
    got = PCODEC.compress_section(data, **kw)
    assert got == RCODEC.compress_section(data, **kw)
    assert PCODEC.decompress_section(got, len(data)) == data
    assert b"".join(PCODEC.iter_decompress(got, 1 << 16)) == data
    blocked = PCODEC.compress_section_blocked(data, level=kw["level"], block_bytes=1 << 20)
    assert blocked == RCODEC.compress_section_blocked(data, level=kw["level"],
                                                      block_bytes=1 << 20)
    assert PCODEC.decompress_section_blocked(blocked, len(data)) == data


def test_section_codec_streaming_writes():
    data = _PAYLOADS["staged"]
    a, b = PCODEC.SectionCompressor(level=2), RCODEC.SectionCompressor(level=2)
    for off in range(0, len(data), 3 << 20):
        a.write(data[off:off + (3 << 20)])
        b.write(data[off:off + (3 << 20)])
    frame = a.finish()
    assert frame == b.finish()
    d = PCODEC.SectionDecompressor()
    assert b"".join(d.feed(frame[i:i + 4096]) for i in range(0, len(frame), 4096)) == data


@pytest.mark.parametrize("engine", ["native", "device"])
def test_unported_engines_raise(engine):
    """Each of naf_tpu's own entropy engines is ported and writes naf_tpu's
    bytes (the device match finder here on the CPU); only an engine
    neither package has raises."""
    data = b">a\nACGT\n"
    kw = {"device": "cpu"} if engine == "device" else {}
    assert (PCODEC.compress_section_blocked(b"ACGT", engine=engine, **kw)
            == RCODEC.compress_section_blocked(b"ACGT", engine=engine))
    assert (PENC.encode(data, PENC.EncodeOptions(engine=engine), **kw)[0]
            == RENC.encode(data, RENC.EncodeOptions(engine=engine))[0])
    with pytest.raises(ValueError, match="unknown engine"):
        PCODEC.compress_section_blocked(b"ACGT", engine=f"{engine}2")


# ---------------------------------------------------------------------------
# parser, encoder
# ---------------------------------------------------------------------------

def _emit_input(name):
    body, _, _, seq_type = emit_case(name)
    data = b">" + body.tobytes()
    return data, PENC.EncodeOptions(seq_type=seq_type)


def _encode_inputs():
    rng = np.random.default_rng(40)
    cases = {f"emit_{n}": (lambda n=n: _emit_input(n)) for n in EMIT_CASES}
    cases.update({
        "parallel_fasta": lambda: (_fasta(rng), PENC.EncodeOptions(level=1)),
        "parallel_fastq": lambda: (_fastq(rng), PENC.EncodeOptions(level=1)),
        "parallel_fastq_no_mask": lambda: (_fastq(rng), PENC.EncodeOptions(no_mask=True)),
        "parallel_protein": lambda: (_typed_fasta(rng, C.SEQ_TYPE_PROTEIN),
                                     PENC.EncodeOptions(seq_type=C.SEQ_TYPE_PROTEIN)),
        "parallel_text": lambda: (_typed_fasta(rng, C.SEQ_TYPE_TEXT),
                                  PENC.EncodeOptions(seq_type=C.SEQ_TYPE_TEXT, no_mask=True)),
        "fused_fasta": lambda: (_gen(), PENC.EncodeOptions()),
        "fused_fasta_long_title": lambda: (_gen(total=300_000, seed=3), PENC.EncodeOptions(
            level=5, long_window_log=21, title="x y", line_length=61)),
        "fused_fastq": lambda: (_gen_fq(), PENC.EncodeOptions()),
        "fused_fastq_wf": lambda: (_gen_fq(300, 80, 2), PENC.EncodeOptions(well_formed=True)),
        "fastq_weird": lambda: (b"@" + fastq_case("weird_bytes").tobytes().rstrip(b"\n")
                                + b"\n", PENC.EncodeOptions()),
        "extended": lambda: (_gen(total=3_000_000, rec_len=1_000_000, seed=4),
                             PENC.EncodeOptions(extended=True, block_bytes=1 << 18,
                                                threads=2)),
        "strict_clean": lambda: (_gen(total=50_000, seed=5), PENC.EncodeOptions(strict=True)),
    })
    return cases


ENCODE_INPUTS = _encode_inputs()


@pytest.mark.parametrize("name", list(ENCODE_INPUTS))
def test_encode_and_decode_match(name):
    data, opts = ENCODE_INPUTS[name]()
    try:
        ref_blob, ref_stats = RENC.encode(data, _ref_opts(opts))
    except RP.InputError as e:        # the same error, word for word
        with pytest.raises(PP.InputError) as got:
            PENC.encode(data, opts)
        assert str(got.value) == str(e)
        return
    blob, stats = PENC.encode(data, opts)
    assert blob == ref_blob
    assert stats.n_sequences == ref_stats.n_sequences
    assert np.array_equal(stats.unexpected_seq, ref_stats.unexpected_seq)
    fastq = data[:1] == b"@"
    for use_mask in (True, False):
        d = PDEC.Decoder(io.BytesIO(blob), PDEC.DecodeOptions(use_mask=use_mask))
        r = RDEC.Decoder(io.BytesIO(blob), RDEC.DecodeOptions(use_mask=use_mask))
        assert (d.fastq() if fastq else d.fasta()) == (r.fastq() if fastq else r.fasta())


def test_parse_results_match():
    rng = np.random.default_rng(41)
    data = _fasta(rng)
    a = PP.parse_fasta(data, C.SEQ_TYPE_DNA, want_mask=True)
    b = RP.parse_fasta(data, RC.SEQ_TYPE_DNA, want_mask=True)
    for k, v in vars(b).items():
        w = getattr(a, k)
        assert (np.array_equal(w, v) if isinstance(v, np.ndarray) else w == v), k
    fq = _fastq(rng)
    a, b = PP.parse_fastq(fq, C.SEQ_TYPE_DNA), RP.parse_fastq(fq, RC.SEQ_TYPE_DNA)
    for k, v in vars(b).items():
        w = getattr(a, k)
        assert (np.array_equal(w, v) if isinstance(v, np.ndarray) else w == v), k
    for bad in (b"@r\r\nAC\n+\n!!\n", b"@r\nACGT\n+\n!!!\n"):
        with pytest.raises(RP.InputError) as ref:
            RENC.encode(bad, RENC.EncodeOptions())
        with pytest.raises(PP.InputError) as got:
            PENC.encode(bad, PENC.EncodeOptions())
        assert str(got.value) == str(ref.value)


def test_numpy_paths_match(monkeypatch):
    """Without the C++ runtime (NAF_TPU_TORCH_NO_NATIVE's path) the
    parser and the decoder's numpy code give the same bytes."""
    monkeypatch.setattr(native, "available", lambda: False)
    for data, opts in ((_gen(total=200_000, seed=6), PENC.EncodeOptions()),
                       (_gen_fq(200, 90, 7), PENC.EncodeOptions())):
        blob = PENC.encode(data, opts)[0]
        assert blob == RENC.encode(data, _ref_opts(opts))[0]
        d = PDEC.Decoder(io.BytesIO(blob))
        out = d.fastq() if data[:1] == b"@" else d.fasta()
        r = RDEC.Decoder(io.BytesIO(blob), RDEC.DecodeOptions())
        assert out == (r.fastq() if data[:1] == b"@" else r.fasta())


def test_no_native_variable_turns_the_runtime_off():
    code = r"""
import io
from naf_tpu_torch.native import host
from naf_tpu_torch.pipeline import decoder, encoder
assert not host.available()
data = b"@r1 c\nACGTacgt\n+\n!!!!####\n@r2\nGGTT\n+\n$$$$\n"
blob = encoder.encode(data, encoder.EncodeOptions())[0]
print(blob.hex())
print(decoder.Decoder(io.BytesIO(blob)).fastq().hex())
"""
    env = dict(os.environ, PYTHONPATH=str(REPO), NAF_TPU_TORCH_NO_NATIVE="1")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                       cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr
    blob, out = (bytes.fromhex(x) for x in r.stdout.split())
    data = b"@r1 c\nACGTacgt\n+\n!!!!####\n@r2\nGGTT\n+\n$$$$\n"
    assert blob == RENC.encode(data, RENC.EncodeOptions())[0]
    assert out == RDEC.Decoder(io.BytesIO(blob), RDEC.DecodeOptions()).fastq()


@pytest.mark.parametrize("native_off", [False, True], ids=["native", "numpy"])
def test_host_stack_loads_no_torch(native_off, tmp_path):
    """The package, the host encoder, stream encoder and decoder and the
    tracing module import, and a host FASTA and FASTQ round trip (encode(),
    then Decoder.fasta() and fastq(); encode_stream, stream_fasta and
    stream_fastq and the other output modes where the native runtime is on)
    run, traced (NAF_TPU_TRACE, NAF_TPU_PROFILE set), with torch absent
    from sys.modules; on the native runtime and on numpy."""
    code = r"""
import io, sys
import naf_tpu_torch
from naf_tpu_torch import codec, format, version
from naf_tpu_torch.native import host
from naf_tpu_torch.ops import histogram_np
from naf_tpu_torch.pipeline import decoder, encoder, parser, stream
from naf_tpu_torch.utils.trace import device_profile, trace_span
fa = b">r1 c\nACGTacgtNN\nAC\n>r2\nGGTT\n"
fq = b"@q1 c\nACGTacgt\n+\n!!!!####\n@q2 d\nGGTTAAcc\n+\n$$$$%%%%\n"
out = []
for data in (fa, fq):
    blob = encoder.encode(data, encoder.EncodeOptions())[0]
    d = decoder.Decoder(io.BytesIO(blob))
    whole = d.fastq() if data[:1] == b"@" else d.fasta()
    out += [blob.hex(), whole.hex()]
    for mode in ("names", "lengths", "mask", "sequences", "charcount", "four_bit"):
        d = decoder.Decoder(io.BytesIO(blob))
        d.r.read_counters()
        d.r.skip_section("title")
        getattr(d, mode)()
    if host.available():
        s = io.BytesIO()
        stream.encode_stream(io.BytesIO(data), s, encoder.EncodeOptions())
        assert s.getvalue() == blob
        d = decoder.Decoder(io.BytesIO(blob))
        d.r.read_counters()
        d.r.skip_section("title")
        s = io.BytesIO()
        d.stream_fastq(s) if data[:1] == b"@" else d.stream_fasta(s)
        assert s.getvalue() == whole
assert "torch" not in sys.modules, sorted(m for m in sys.modules if m.startswith("torch"))
print(" ".join(out))
"""
    env = {k: v for k, v in os.environ.items() if k != "NAF_TPU_TORCH_NO_NATIVE"}
    env.update(PYTHONPATH=str(REPO), NAF_TPU_TRACE="1",
               NAF_TPU_PROFILE=str(tmp_path / "profile"))
    if native_off:
        env["NAF_TPU_TORCH_NO_NATIVE"] = "1"
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                       cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "[naf-trace] seq-unzstd " in r.stderr
    if not native_off:
        assert "[naf-trace] seq+qual-unzstd " in r.stderr and "[naf-trace] scan " in r.stderr
    fa_blob, fa_out, fq_blob, fq_out = (bytes.fromhex(x) for x in r.stdout.split())
    fa = b">r1 c\nACGTacgtNN\nAC\n>r2\nGGTT\n"
    fq = b"@q1 c\nACGTacgt\n+\n!!!!####\n@q2 d\nGGTTAAcc\n+\n$$$$%%%%\n"
    assert fa_blob == RENC.encode(fa, RENC.EncodeOptions())[0] and fa_out == fa
    assert fq_blob == RENC.encode(fq, RENC.EncodeOptions())[0]
    assert fq_out == RDEC.Decoder(io.BytesIO(fq_blob), RDEC.DecodeOptions()).fastq()


def test_native_runtime_builds_beside_the_kernels():
    assert native.available()
    so = native._build()
    assert so is not None and kbuild.BUILD_ROOT in so.parents
    assert not list((native.SOURCES[0].parent).glob("*.so"))


def test_long_render_keeps_its_tail():
    """Three records of 700,007 chars: the original's multithreaded render
    (taken at 8 threads) ended them in NUL bytes; the port's copy renders
    on one thread and gives back the input."""
    rng = np.random.default_rng(42)
    rows = []
    for i in range(3):
        seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=700_007)
        for s in rng.integers(0, 699_000, size=40):
            seq[s:s + 500] |= 32
        rows.append(b">r%d\n" % i + b"\n".join(seq[j:j + 80].tobytes()
                                             for j in range(0, seq.size, 80)) + b"\n")
    data = b"".join(rows)
    blob = PENC.encode(data, PENC.EncodeOptions(threads=8))[0]
    assert PDEC.Decoder(io.BytesIO(blob)).fasta() == data


# ---------------------------------------------------------------------------
# build_plan and the numpy helpers
# ---------------------------------------------------------------------------

@pytest.fixture(params=["native", "numpy"])
def headers(request, monkeypatch):
    """build_plan's header lines by the native pass or by the numpy path."""
    if request.param == "numpy":
        monkeypatch.setattr(native, "available", lambda: False)
    return request.param


@pytest.mark.parametrize("mode", [0, 1])
def test_build_plan_matches(mode, headers):
    rng = np.random.default_rng(43)
    n = 50
    slens = rng.integers(0, 300, size=n)
    ids = b"".join(b"id%d\0" % i for i in range(n))
    com = b"".join((b"c %d" % i if i % 2 else b"") + b"\0" for i in range(n))
    starts = np.sort(rng.choice(int(slens.sum()), size=20, replace=False))
    spans = (starts[0::2], starts[1::2])
    for blobs in ((ids, com), (ids, None), (None, com), (None, None)):
        kw = dict(mode=mode, line_len=60, rna=False, packed=True, upper=False, slens=slens,
                  ids_blob=blobs[0], comments_blob=blobs[1], name_sep=b" ",
                  mask_spans=spans if mode == 0 else None)
        a, b = PDV.build_plan(**kw), RDV.build_plan(**kw)
        for k, v in vars(b).items():
            w = getattr(a, k)
            assert (np.array_equal(w, v) if isinstance(v, np.ndarray) else w == v), k
    assert (PDV.MODE_FASTA, PDV.MODE_FASTQ, PDV.OUT_BATCH, PDV._REG_MAX_GROUPS) == \
        (RDV.MODE_FASTA, RDV.MODE_FASTQ, RDV.OUT_BATCH, RDV._REG_MAX_GROUPS)


def _sra_deflines(n: int) -> tuple[bytes, bytes]:
    """``fastq-dump``'s ids and comments (the sra-novaseq-150 shape)."""
    rng = np.random.default_rng(47)
    xy = rng.integers(1000, 40000, size=(n, 2))
    tiles = rng.integers(1101, 2679, size=n)
    ids = b"".join(b"SRR6821753.%d\0" % (i + 1) for i in range(n))
    com = b"".join(b"A00123:8:H5KJ3DSXX:1:%d:%d:%d length=150\0" % (t, x, y)
                   for t, (x, y) in zip(tiles, xy))
    return ids, com


_HEADER_CASES = {
    "ids_and_comments": (b"a\0bb\0ccc\0", b"x\0\0zz z\0", 3),
    "ids_only": (b"a\0bb\0ccc\0", None, 3),
    "comments_only": (None, b"x\0\0zz z\0", 3),
    "neither": (None, None, 3),
    "empty_ids": (b"\0\0r3\0", b"c1\0c2\0\0", 3),
    "zero_records": (b"", b"", 0),
    "more_nuls_than_records": (b"a\0b\0c\0d\0", b"1\0\0\02\0\0", 2),
    "sra_2000": (*_sra_deflines(2000), 2000),
}

_CORRUPT_CASES = {
    "ids_empty": (b"", b"c\0", 1, "corrupted ids - not 0-terminated"),
    "ids_unterminated": (b"a\0b", b"c\0d\0", 2, "corrupted ids - not 0-terminated"),
    "ids_too_few": (b"a\0", b"c\0d\0", 2, "corrupted ids - can't read id 1"),
    "comments_empty": (b"a\0", b"", 1, "corrupted names - not 0-terminated"),
    "comments_unterminated": (None, b"c\0d", 2, "corrupted names - not 0-terminated"),
    "comments_too_few": (b"a\0b\0c\0", b"c\0\0", 3, "corrupted names - can't read name 2"),
    "both_bad": (b"a\0", b"c", 2, "corrupted ids - can't read id 1"),
}


def _header_plan(ids, com, n, mode=1, sep=b" "):
    return PDV.build_plan(mode=mode, line_len=60, rna=False, packed=True, upper=False,
                          slens=np.full(n, 5, np.int64), ids_blob=ids, comments_blob=com,
                          name_sep=sep)


@pytest.mark.parametrize("case", list(_HEADER_CASES))
def test_build_plan_header_edges(case, headers):
    """The header lines and their lengths, by either path, against the
    columns' ``ragged_concat``; FASTA's marker and a two-byte separator on
    the defline shape."""
    ids, com, n = _HEADER_CASES[case]
    for mode, lead, sep in ((1, b"@", b" "), (0, b">", b"\xc3\x88")):
        plan = _header_plan(ids, com, n, mode, sep)
        cols = [PASM.const_column(lead, n)]
        if ids is not None and com is not None:
            idc, cc = PASM.split_blob(ids, n), PASM.split_blob(com, n, "names")
            cols += [idc, PASM.const_column(sep, n, present=cc.length > 0), cc]
        elif ids is not None or com is not None:
            cols.append(PASM.split_blob(ids if ids is not None else com, n))
        cols.append(PASM.const_column(b"\n", n))
        want = PASM.ragged_concat(cols, n)
        assert plan.hdr.dtype == np.uint8 and plan.hdr.tobytes() == want.tobytes()
        assert np.array_equal(np.diff(plan.H, prepend=0), sum(c.length for c in cols))
        if case == "sra_2000" and mode == 1:
            assert plan.hdr.tobytes().split(b"\n")[0] == \
                b"@SRR6821753.1 " + com[:com.index(b"\0")]


@pytest.mark.parametrize("case", list(_CORRUPT_CASES))
def test_build_plan_corrupt_blobs(case, headers):
    ids, com, n, msg = _CORRUPT_CASES[case]
    with pytest.raises(ValueError) as got:
        _header_plan(ids, com, n)
    assert str(got.value) == msg


def test_numpy_helpers_match():
    from naf_tpu.ops.pack import pack_4bit as ref_pack
    from naf_tpu.ops.unpack import unpack_4bit as ref_unpack

    rng = np.random.default_rng(44)
    seq = rng.choice(np.frombuffer(b"ACGTacgtNnRY-", np.uint8), size=10_001)
    units = PMASK.mask_units_from_bytes(seq)
    assert np.array_equal(units, RMASK.mask_units_from_bytes(seq))
    runs = PMASK.merge_units(units)
    assert np.array_equal(runs, RMASK.merge_units(units))
    assert np.array_equal(PMASK.runs_to_units(runs), RMASK.runs_to_units(runs))
    m = PMASK.expand_mask_np(runs, seq.size)
    assert np.array_equal(m, RMASK.expand_mask_np(runs, seq.size))
    up = C.TOUPPER[seq]
    assert np.array_equal(PMASK.apply_mask_np(up, m), RMASK.apply_mask_np(up, m))
    for carry in (None, 5):
        got, want = pack_4bit_np(seq, carry), ref_pack(seq, carry)
        assert np.array_equal(got[0], want[0]) and got[1] == want[1]
    packed = pack_4bit_np(seq)[0]
    for rna in (False, True):
        assert np.array_equal(unpack_4bit_np(packed, seq.size - 1, rna),
                              ref_unpack(packed, seq.size - 1, rna))
    lens = rng.integers(0, 200, size=30)
    body = rng.integers(65, 90, size=int(lens.sum()), dtype=np.uint8)
    for L in (0, 1, 60):
        assert np.array_equal(PRENDER.body_length(lens, L), RRENDER.body_length(lens, L))
        assert np.array_equal(PRENDER.wrap_records_np(body, lens, L),
                              RRENDER.wrap_records_np(body, lens, L))
    blob = b"".join(b"n%d\0" % i for i in range(30))
    a, b = PASM.split_blob(blob, 30), RASM.split_blob(blob, 30)
    for f in ("src", "start", "length"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    cols = [PASM.const_column(b">", 30), a, PASM.const_column(b"\n", 30)]
    rcols = [RASM.const_column(b">", 30), b, RASM.const_column(b"\n", 30)]
    assert np.array_equal(PASM.ragged_concat(cols, 30), RASM.ragged_concat(rcols, 30))


def test_histogram_helpers_match():
    rng = np.random.default_rng(45)
    data = rng.integers(0, 256, size=20_000, dtype=np.uint8)
    counts = PHIST.charcount_np(data)
    assert np.array_equal(counts, RHIST.charcount_np(data))
    assert PHIST.format_charcount(counts) == RHIST.format_charcount(counts)
    for bins in (np.zeros(257, np.uint64), np.bincount(data, minlength=257).astype(np.uint64)):
        bins[256] = 3 if bins.any() else 0
        for kind in ("id", "DNA", "quality"):
            assert (PHIST.format_unexpected_report(bins, kind)
                    == RHIST.format_unexpected_report(bins, kind))


# ---------------------------------------------------------------------------
# the native scan's carries
# ---------------------------------------------------------------------------

_SCAN_FIELDS = ("seq", "packed", "ids_blob", "comments_blob", "qual", "lengths", "mask_units",
                "longest_line", "n_sequences", "unexpected_id", "unexpected_comment",
                "unexpected_seq", "unexpected_qual", "end_state", "mask_tail_on",
                "mask_tail_run", "consumed", "end_line_len")


def _scan_pieces():
    """(piece, scan keywords) of a scan that resumes a stream."""
    rng = np.random.default_rng(46)
    seq = rng.choice(np.frombuffer(b"ACGTNacgtnRY", np.uint8), size=3_000_001).tobytes()
    cont = b"\n".join(seq[j:j + 61] for j in range(0, len(seq), 61)) + b"\n>next rec\nAC\n"
    fq = mixed_fastq(seed=9)
    cut = fq[:len(fq) - 37][1:]            # a partial last record, past the first '@'
    base = dict(seq_type=C.SEQ_TYPE_DNA, strict=False, well_formed=False, do_upper=False,
                marker_pos=-1)
    return {
        "fasta_cont": (cont, dict(base, fastq=False, do_mask=True,
                                  flags=native.F_CONT_SEQ | native.F_NO_MASK_FLUSH,
                                  prev_eol=True, mask_on=True, mask_run=40, len_carry=123,
                                  line_carry=17, pack_carry=5)),
        "fasta_cont_mid_line": (cont[5:], dict(base, fastq=False, do_mask=True,
                                               flags=native.F_CONT_SEQ, prev_eol=False,
                                               len_carry=9, line_carry=9, pack_carry=None)),
        "fasta_records": (mixed_fasta(seed=10)[1:], dict(base, fastq=False, do_mask=True,
                                                        flags=native.F_NO_MASK_FLUSH,
                                                        mask_on=False, mask_run=7)),
        "fastq_partial": (cut, dict(base, fastq=True, do_mask=True,
                                    flags=native.F_ALLOW_PARTIAL | native.F_NO_MASK_FLUSH,
                                    pack_carry=3)),
        "fastq_whole": (fq[1:], dict(base, fastq=True, do_mask=False, flags=0)),
    }


@pytest.mark.parametrize("name", list(_scan_pieces()))
def test_scan_carries_match(name):
    piece, kw = _scan_pieces()[name]
    assert (native.F_CONT_SEQ, native.F_NO_MASK_FLUSH, native.F_PACK_CARRY,
            native.F_ALLOW_PARTIAL) == (RNATIVE.F_CONT_SEQ, RNATIVE.F_NO_MASK_FLUSH,
                                        RNATIVE.F_PACK_CARRY, RNATIVE.F_ALLOW_PARTIAL)
    scratch = {}
    for _ in range(2):                  # the second scan reuses the scratch buffers
        got = native.scan(piece, scratch=scratch, **kw)
        want = RNATIVE.scan(piece, **kw)
        for f in _SCAN_FIELDS:
            a, b = getattr(got, f), getattr(want, f)
            assert (np.array_equal(a, b) if isinstance(b, np.ndarray) else a == b), f


# ---------------------------------------------------------------------------
# the Decoder's output modes and streaming decode
# ---------------------------------------------------------------------------

def _mode_archives():
    E = PENC.EncodeOptions
    return {
        "fasta": (mixed_fasta(), E()),
        "fasta_title_lines": (mixed_fasta(seed=4, line=50), E(title="a title", line_length=70)),
        "rna": (mixed_fasta(seed=5).replace(b"T", b"U").replace(b"t", b"u"),
                E(seq_type=C.SEQ_TYPE_RNA)),
        "no_mask": (mixed_fasta(seed=6), E(no_mask=True)),
        "extended": (mixed_fasta(seed=7, n_rec=60), E(extended=True, block_bytes=1 << 12)),
        "fastq": (mixed_fastq(), E()),
        "fastq_extended": (mixed_fastq(seed=8), E(extended=True, block_bytes=1 << 12)),
        "protein": (protein_fasta(), E(seq_type=C.SEQ_TYPE_PROTEIN)),
        "text": (text_fasta(), E(seq_type=C.SEQ_TYPE_TEXT)),
        "empty": (b"", E()),
    }


_ARCHIVES: dict = {}


def _archive(name: str) -> bytes:
    if name not in _ARCHIVES:
        data, opts = _mode_archives()[name]
        blob = PENC.encode(data, opts)[0]
        assert blob == RENC.encode(data, _ref_opts(opts))[0]
        _ARCHIVES[name] = blob
    return _ARCHIVES[name]


#: (method, arguments) of each Decoder output mode untnaf calls
DECODER_MODES = [("format_name", ()), ("part_list", ()), ("part_sizes", ()), ("title", ()),
                 ("number", ()), ("ids", ()), ("names", ()), ("lengths", ()),
                 ("total_length", ()), ("mask", ()), ("total_mask_length", ()),
                 ("four_bit", ()), ("seq_concat", ()), ("seq_concat", (False,)),
                 ("sequences", ()), ("charcount", ()), ("fasta", ()), ("fasta", (False,)),
                 ("fastq", ()), ("fasta_range", (2, 9)), ("fasta_range", (0, 10 ** 6)),
                 ("fastq_range", (3, 40)), ("fastq_range", (5, 5))]


def _mode_output(D, blob: bytes, method: str, args: tuple, **opts):
    """What ``untnaf`` prints for a mode: the counters read and the title
    skipped first, as its ``_render`` does; an error as its name and text."""
    d = D.Decoder(io.BytesIO(blob), D.DecodeOptions(**opts))
    if method not in ("format_name", "part_list"):
        d.r.read_counters()
        if method not in ("number", "part_sizes", "title"):
            d.r.skip_section("title")
    try:
        out = getattr(d, method)(*args)
    except (ValueError, RuntimeError) as e:
        return type(e).__name__, str(e)
    return out


@pytest.mark.parametrize("method,args", DECODER_MODES,
                         ids=[f"{m}{''.join(map(str, a))}" for m, a in DECODER_MODES])
def test_decoder_modes_match(method, args):
    for name in _mode_archives():
        blob = _archive(name)
        for opts in (dict(), dict(use_mask=False), dict(line_length=33)):
            got = _mode_output(PDEC, blob, method, args, **opts)
            assert got == _mode_output(RDEC, blob, method, args, **opts), (name, opts)


def test_decoder_modes_on_numpy_paths(monkeypatch):
    """seq_concat, sequences and charcount without the C++ runtime."""
    monkeypatch.setattr(native, "available", lambda: False)
    for name in ("fasta", "rna", "protein", "text", "empty"):
        blob = _archive(name)
        for method in ("seq_concat", "sequences", "charcount"):
            for opts in (dict(), dict(use_mask=False)):
                got = _mode_output(PDEC, blob, method, (), **opts)
                assert got == _mode_output(RDEC, blob, method, (), **opts), (name, method)


def _streamed(D, blob: bytes, fastq: bool, batch: int, masking=None, **opts) -> bytes:
    d = D.Decoder(io.BytesIO(blob), D.DecodeOptions(**opts))
    d.r.read_counters()
    d.r.skip_section("title")
    out = io.BytesIO()
    if fastq:
        d.stream_fastq(out, batch_chars=batch)
    else:
        d.stream_fasta(out, batch_chars=batch, masking=masking)
    return out.getvalue()


@pytest.mark.parametrize("batch", [1000, 1 << 16, 32 << 20])
@pytest.mark.parametrize("fastq", [False, True], ids=["fasta", "fastq"])
def test_stream_decode_matches(fastq, batch):
    """Below F1's size: the port's stream equals its whole-buffer output and
    naf_tpu's stream, on every archive of the modes."""
    for name in _mode_archives():
        blob = _archive(name)
        if fastq and not PDEC.Decoder(io.BytesIO(blob)).h.has_quality:
            continue
        for opts in (dict(), dict(use_mask=False), dict(line_length=7)):
            got = _streamed(PDEC, blob, fastq, batch, **opts)
            d = PDEC.Decoder(io.BytesIO(blob), PDEC.DecodeOptions(**opts))
            assert got == (d.fastq() if fastq else d.fasta()), (name, opts)
            assert got == _streamed(RDEC, blob, fastq, batch, **opts), (name, opts)
    if not fastq:
        blob = _archive("fasta")
        assert (_streamed(PDEC, blob, False, batch, masking=False)
                == PDEC.Decoder(io.BytesIO(blob)).fasta(False))


@pytest.mark.parametrize("fastq", [False, True], ids=["fasta", "fastq"])
def test_stream_decode_at_the_render_split_returns_the_input(fastq):
    """At and above the size where naf_tpu's render goes multithreaded (F1:
    2**21 chars, 4 threads), the port's stream, in one batch and in many,
    gives back the input."""
    rng = np.random.default_rng(47)
    if fastq:
        seq = rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=(15_000, 150))
        qual = rng.integers(35, 74, size=(15_000, 150), dtype=np.uint8)
        data = b"".join(b"@q%d c\n%s\n+\n%s\n" % (i, seq[i].tobytes(), qual[i].tobytes())
                        for i in range(15_000))
    else:
        data = _gen(total=2_400_000, rec_len=800_000, seed=47)
    blob = PENC.encode(data, PENC.EncodeOptions(threads=8))[0]
    for batch in (32 << 20, 300_001):
        assert _streamed(PDEC, blob, fastq, batch) == data


# ---------------------------------------------------------------------------
# the stream encoder
# ---------------------------------------------------------------------------

def _stream_inputs():
    E = PENC.EncodeOptions
    rng = np.random.default_rng(48)
    giant = rng.choice(np.frombuffer(b"ACGTacgtNn", np.uint8), size=300_000).tobytes()
    odd = rng.choice(np.frombuffer(b"ACGTacgt", np.uint8), size=100_001).tobytes()
    return {
        "fasta": lambda: (mixed_fasta(n_rec=60), E()),
        "giant_record": lambda: (b">giant chromosome\n" + b"\n".join(
            giant[k:k + 70] for k in range(0, len(giant), 70)) + b"\n>tail\nACGT\n", E()),
        "odd_lines": lambda: (b">odd\n" + b"\n".join(
            odd[k:k + 61] for k in range(0, len(odd), 61)) + b"\n", E()),
        "case_runs": lambda: (b"".join(b">m%d\n" % i + (b"acgt" if i % 2 else b"ACGT") * 5000
                                       + b"\n" for i in range(20)), E()),
        "options": lambda: (mixed_fasta(seed=11), E(level=5, long_window_log=20, title="t t",
                                                    line_length=80, threads=2)),
        "rna": lambda: (mixed_fasta(seed=12), E(seq_type=C.SEQ_TYPE_RNA)),
        "dna_no_mask": lambda: (mixed_fasta(seed=13), E(no_mask=True)),
        "protein": lambda: (protein_fasta(n_rec=80), E(seq_type=C.SEQ_TYPE_PROTEIN)),
        "text_no_mask": lambda: (text_fasta(n_rec=40), E(seq_type=C.SEQ_TYPE_TEXT,
                                                         no_mask=True)),
        "fastq": lambda: (mixed_fastq(n_rec=500), E()),
        "fastq_unexpected": lambda: (b"".join(b"@r%d\nAC\x05GT\n+\nII\x02II\n" % i
                                              for i in range(2000)), E()),
        "empty": lambda: (b"", E()),
    }


STREAM_INPUTS = _stream_inputs()


@pytest.mark.parametrize("chunk", [1 << 10, 1 << 16, None], ids=["1KiB", "64KiB", "default"])
@pytest.mark.parametrize("name", list(STREAM_INPUTS))
def test_encode_stream_matches(name, chunk):
    """Archive bytes and stats equal the port's host encode() and naf_tpu's
    encode_stream at the same chunk size (records spanning chunks)."""
    data, opts = STREAM_INPUTS[name]()
    kw = {} if chunk is None else dict(chunk_size=chunk)
    out = io.BytesIO()
    stats = PSTREAM.encode_stream(io.BytesIO(data), out, opts, **kw)
    blob, host_stats = PENC.encode(data, opts)
    assert out.getvalue() == blob
    for f in ("n_sequences", "longest_line", "seq_size_original", "in_format"):
        assert getattr(stats, f) == getattr(host_stats, f), f
    for f in ("unexpected_id", "unexpected_comment", "unexpected_seq", "unexpected_qual"):
        assert np.array_equal(getattr(stats, f), getattr(host_stats, f)), f
    ref = io.BytesIO()
    RSTREAM.encode_stream(io.BytesIO(data), ref, _ref_opts(opts), **kw)
    assert ref.getvalue() == blob


@pytest.mark.parametrize("data,kw", [
    (b"@r\nACGT\n+\n!!!\n", {}),
    (b"@r1\nACGT\n+\n!!!!\nr2\nAC\n+\n!!\n", {}),
    (b">a\nACGTJ\n", dict(strict=True)),
    (b">a\nAC\n", dict(in_format=2)),
    (b">" + b"h" * 5000 + b"\nACGT\n", {}),
], ids=["qual_length", "no_at", "strict", "format_mismatch", "long_header"])
def test_encode_stream_errors_match(data, kw):
    msgs = []
    for stream, E in ((PSTREAM, PENC.EncodeOptions), (RSTREAM, RENC.EncodeOptions)):
        try:
            stream.encode_stream(io.BytesIO(data), io.BytesIO(), E(**kw), chunk_size=1 << 10)
            msgs.append(None)
        except ValueError as e:
            msgs.append(str(e))
    assert msgs[0] == msgs[1]


def test_encode_stream_spills_and_cleans_up():
    """With NAF_TPU_SPILL_MB=0 and a temp dir, a section that streams out
    compressed bytes before its end (one-thread zstd, past one 4 MiB stage)
    goes through a temp file named as the reference names it; the archive
    is the same bytes and no temp file is left, unless asked for."""
    code = r"""
import io, os, sys
from naf_tpu_torch.codec import zstd_backend as Z
from naf_tpu_torch.pipeline.encoder import EncodeOptions, encode
from naf_tpu_torch.pipeline.stream import encode_stream
copied = []
orig = Z.SpilledPayload.copy_into
def copy_into(self, out):
    copied.append(os.path.basename(self.path))
    orig(self, out)
Z.SpilledPayload.copy_into = copy_into
data = open(sys.argv[1], "rb").read()
tmp = sys.argv[2]
for keep in (False, True):
    opts = EncodeOptions(temp_dir=tmp, temp_name="in.fa", keep_temp_files=keep)
    out = io.BytesIO()
    encode_stream(io.BytesIO(data), out, opts, chunk_size=1 << 20)
    assert out.getvalue() == encode(data, EncodeOptions())[0]
    print(keep, sorted(copied), sorted(os.listdir(tmp)))
    copied.clear()
sys.stdout.buffer.write(out.getvalue())
"""
    work = Path(os.environ.get("TMPDIR", "/tmp")) / f"naf_tpu_torch_spill_{os.getpid()}"
    tmp = work / "tmp"
    tmp.mkdir(parents=True)
    data = _gen(total=10_000_000, rec_len=2_500_000, seed=49)
    (work / "in.fa").write_bytes(data)
    try:
        r = subprocess.run([sys.executable, "-c", code, str(work / "in.fa"), str(tmp)],
                           capture_output=True, env=dict(os.environ, PYTHONPATH=str(REPO),
                                                         NAF_TPU_SPILL_MB="0"),
                           cwd=REPO, timeout=300)
        left = sorted(p.name for p in tmp.iterdir())
    finally:
        for p in sorted(work.rglob("*"), reverse=True):
            p.unlink() if p.is_file() else p.rmdir()
        work.rmdir()
    assert r.returncode == 0, r.stderr.decode()
    lines = r.stdout.split(b"\n", 2)
    assert lines[0] == b"False ['in.fa.seq'] []"
    assert lines[1] == b"True ['in.fa.seq'] ['in.fa.seq']"
    assert left == ["in.fa.seq"]
    assert lines[2] == RENC.encode(data, RENC.EncodeOptions())[0]
