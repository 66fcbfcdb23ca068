"""naf_tpu_torch's own host stack against the naf_tpu modules it copies.

Each copy must give what its original gives: the format constants, VLE
numbers and container; the zstd section codec (one-shot, streaming,
blocked); the parser and host encode() archives on the inputs of
torch_cases.py, test_parallel.py and fused_pipeline_cases.py; the
Decoder's fasta() and fastq(), on the native render and on the numpy path;
build_plan; and the numpy helpers under ops.  The C++ host runtime is
built by the port into its build tree, and its copy does not drop the tail
of a long render (F1 in ROADMAP.md).  Everything is bytes: tolerance 0.
"""

from __future__ import annotations

import io
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from naf_tpu import codec as RCODEC
from naf_tpu.format import constants as RC
from naf_tpu.format import container as RCONT
from naf_tpu.format import vle as RVLE
from naf_tpu.ops import assemble as RASM
from naf_tpu.ops import mask as RMASK
from naf_tpu.ops import render as RRENDER
from naf_tpu.parallel import decode as RDV
from naf_tpu.pipeline import decoder as RDEC
from naf_tpu.pipeline import encoder as RENC
from naf_tpu.pipeline import parser as RP
from naf_tpu_torch import codec as PCODEC
from naf_tpu_torch.format import constants as C
from naf_tpu_torch.format import container as PCONT
from naf_tpu_torch.format import vle as PVLE
from naf_tpu_torch.native import build as kbuild
from naf_tpu_torch.native import host as native
from naf_tpu_torch.ops import assemble as PASM
from naf_tpu_torch.ops import mask as PMASK
from naf_tpu_torch.ops import render as PRENDER
from naf_tpu_torch.ops.pack import pack_4bit_np
from naf_tpu_torch.ops.unpack import unpack_4bit_np
from naf_tpu_torch.parallel import decode as PDV
from naf_tpu_torch.pipeline import decoder as PDEC
from naf_tpu_torch.pipeline import encoder as PENC
from naf_tpu_torch.pipeline import parser as PP

from fused_pipeline_cases import _gen, _gen_fq
from test_parallel import _fasta, _fastq, _typed_fasta
from torch_cases import EMIT_CASES, emit_case, fastq_case


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
    with pytest.raises(NotImplementedError, match="not ported"):
        PCODEC.compress_section_blocked(b"ACGT", engine=engine)
    with pytest.raises(NotImplementedError, match="not ported"):
        PENC.encode(b">a\nACGT\n", PENC.EncodeOptions(engine=engine))


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


def test_native_runtime_builds_beside_the_kernels():
    assert native.available()
    so = native._build()
    assert so is not None and kbuild.BUILD_ROOT in so.parents
    assert not list((native.SOURCE.parent).glob("*.so"))


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

@pytest.mark.parametrize("mode", [0, 1])
def test_build_plan_matches(mode):
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
