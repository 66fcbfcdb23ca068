"""naf_tpu_torch's encode and decode slice against the JAX package.

  * the jax-free host helpers in naf_tpu_torch.parallel give the same
    output as their naf_tpu.parallel originals;
  * fused_blocks_sharded on one CPU block equals naf_tpu's on a 1-device
    CPU mesh (interpret mode);
  * encode_device(device="cpu") archives equal naf_tpu's host encode(), on
    the fused and two-pass device paths and on every named host route;
  * fasta_device(device="cpu") gives back the input bytes and equals
    naf_tpu.parallel.decode.render_regular on a 1-device CPU mesh, and a
    ragged archive takes the ragged device render;
  * the port imports neither jax nor naf_tpu (its CLIs and stream encoder
    included), its host modules load no torch, importing it leaves the
    ``zstandard`` module alone, and asking for CUDA without a card raises.
"""

from __future__ import annotations

import io
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from naf_tpu.format import constants as C
from naf_tpu.parallel import block as RB
from naf_tpu.parallel import decode as RD
from naf_tpu.parallel import pipeline as RP
from naf_tpu.parallel.mesh import block_mesh, block_sharding
from naf_tpu.pipeline import decoder as RDEC
from naf_tpu.pipeline import encoder as RENC
from naf_tpu_torch import device as D
from naf_tpu_torch.parallel import block as PB
from naf_tpu_torch.parallel import pipeline as PP
from naf_tpu_torch.parallel.pipeline import encode_device
from naf_tpu_torch.pipeline.decoder import DecodeOptions, Decoder, fasta_device, fastq_device
from naf_tpu_torch.pipeline.encoder import EncodeOptions

from fused_pipeline_cases import _gen, _gen_fq
from torch_cases import assert_rows_equal, ref_block_rows

REPO = Path(__file__).resolve().parent.parent


def encode(data: bytes, opts: EncodeOptions):
    """naf_tpu's host encode() with the port's options."""
    return RENC.encode(data, RENC.EncodeOptions(**vars(opts)))


def _ref_decoder(blob: bytes, **kw) -> RDEC.Decoder:
    return RDEC.Decoder(io.BytesIO(blob), RDEC.DecodeOptions(**kw))


def _body(data: bytes) -> np.ndarray:
    return np.frombuffer(data, np.uint8)[data.index(b">") + 1:]


# ---------------------------------------------------------------------------
# host helpers: copies against their originals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_blocks", [1, 3, 7])
def test_make_blocks_matches(n_blocks):
    body = _body(_gen(total=30_000, rec_len=7_000, seed=1))
    for kw in ({}, {"prev0": ord("A"), "sis0": True}, {"marker": ord(">")}):
        a = PB.make_blocks(body, n_blocks, **kw)
        b = RB.make_blocks(body, n_blocks, **kw)
        assert np.array_equal(a.data, b.data)
        assert np.array_equal(a.prev, b.prev)
        assert np.array_equal(a.starts_in_seq, b.starts_in_seq)
    e = PB.make_blocks(np.zeros(0, np.uint8), n_blocks)
    f = RB.make_blocks(np.zeros(0, np.uint8), n_blocks)
    assert np.array_equal(e.data, f.data) and np.array_equal(e.prev, f.prev)


def test_stitch_helpers_match():
    rng = np.random.default_rng(50)
    for _ in range(20):
        D_ = int(rng.integers(1, 6))
        counts = rng.integers(0, 9, size=D_)
        packed = rng.integers(0, 256, size=(D_, 8), dtype=np.uint8)
        first = rng.integers(0, 16, size=D_, dtype=np.uint8)
        assert np.array_equal(PB.stitch_packed(packed, counts, first),
                              RB.stitch_packed(packed, counts, first))
        per_block = [rng.integers(0, 50, size=int(rng.integers(0, 5))) for _ in range(D_)]
        assert np.array_equal(PB.stitch_lengths(per_block), RB.stitch_lengths(per_block))
        firsts = [bool(b) for b in rng.integers(0, 2, size=D_)]
        ra, fa = PB.stitch_runs(per_block, firsts)
        rb, fb = RB.stitch_runs(per_block, firsts)
        assert np.array_equal(ra, rb) and fa == fb
        lens = rng.integers(0, 6, size=int(rng.integers(1, 8)))
        vals = rng.integers(1, 256, size=int(lens.sum()), dtype=np.uint8)
        assert PB.blob_from_lens(vals, lens) == RB.blob_from_lens(vals, lens)


def _repacked(nibbles: list) -> np.ndarray:
    """Nibbles two to a byte, the first low; a trailing one alone."""
    nib = np.asarray(nibbles + [0] * (len(nibbles) % 2), np.uint8)
    return nib[0::2] | (nib[1::2] << 4)


@pytest.mark.parametrize("held", [None, 0, 7, 15])
def test_stitch_packed_with_a_held_nibble(held):
    """``stitch_packed`` from a held low nibble against the nibbles: the
    held one, then each block's chars (its first from ``first_codes`` where
    the blocks before it end at odd parity, the rest unpacked from its
    row), repacked."""
    rng = np.random.default_rng(51 if held is None else 52 + held)
    for _ in range(40):
        D_ = int(rng.integers(1, 7))
        counts = rng.integers(0, 12, size=D_)
        counts[rng.random(D_) < 0.2] = 0
        packed = rng.integers(0, 256, size=(D_, 8), dtype=np.uint8)
        first = rng.integers(0, 16, size=D_, dtype=np.uint8)
        nibbles = [] if held is None else [held]
        for d in range(D_):
            odd = len(nibbles) % 2 == 1
            n = int(counts[d]) - (odd and counts[d] > 0)
            row = np.stack([packed[d] & 0x0F, packed[d] >> 4], axis=1).reshape(-1)
            nibbles += ([int(first[d])] if odd and counts[d] else []) + row[:n].tolist()
        assert np.array_equal(PB.stitch_packed(packed, counts, first, held), _repacked(nibbles))
        if held is None:
            assert np.array_equal(PB.stitch_packed(packed, counts, first),
                                  RB.stitch_packed(packed, counts, first))


def test_pipeline_helpers_match():
    bodies = [b"h1 x\nACGT\n>h2\nAC GT\n", b"h\tx\nACGT\n", b"h1 c d\nACGT\n>h2 e\nA\n", b""]
    for raw in bodies:
        body = np.frombuffer(raw, np.uint8)
        assert PP._wf_device_safe(body, False) == RP._wf_device_safe(body, False)
        assert PP._wf_device_safe(body, True) == RP._wf_device_safe(body, True)
    rows = [np.arange(3), np.arange(5), np.zeros(0, np.int64)]
    assert np.array_equal(PB.pad_rows(3, rows), RP._pad2d(3, rows))


def _fused_ref(body, seq_type=C.SEQ_TYPE_DNA):
    """naf_tpu's fused_blocks_sharded on a 1-device CPU mesh."""
    mesh = block_mesh(1)
    blocks = RB.make_blocks(body, 1)
    sh = block_sharding(mesh)
    return [np.asarray(o) for o in RB.fused_blocks_sharded(
        jax.device_put(jnp.asarray(blocks.data), sh),
        jax.device_put(jnp.asarray(blocks.prev), sh),
        jax.device_put(jnp.asarray(blocks.starts_in_seq), sh),
        jnp.zeros(1, jnp.int32), seq_type=seq_type, mesh=mesh, interpret=True)]


def test_fused_block_and_parse_match():
    data = _gen(total=100_000, rec_len=9_000, seed=7)
    body = _body(data)
    packed_r, scal_r, tv_r, a_r = _fused_ref(body)
    blocks = PB.make_blocks(body, 1)
    x = torch.from_numpy(blocks.data[0].copy())
    packed, scal, tv, a = (torch.stack(o) for o in PB.fused_blocks_sharded(
        [x], blocks.prev, blocks.starts_in_seq, 0, seq_type=C.SEQ_TYPE_DNA))
    assert np.array_equal(packed.numpy(), packed_r)
    assert np.array_equal(scal.numpy(), scal_r)
    n_sp = int(scal_r[0, 2])
    assert np.array_equal(tv.numpy()[:, :n_sp], tv_r[:, :n_sp])
    assert np.array_equal(a.numpy()[:, :n_sp], a_r[:, :n_sp])

    got = PP.parse_fused(scal.numpy(), (packed, scal, tv, a), fastq=False)
    want = RP.parse_fused_fasta(1, scal_r, packed_r, tv_r, a_r)
    assert_rows_equal(got, ref_block_rows(want))
    args = (want["counts"], want["id_bytes"], want["com_bytes"], np.zeros(1, np.int64),
            want["n_rec"], want["n_runs"], want["first_lower"], want["longest"])
    zero_halves = [np.zeros((1, 256), np.uint32) for _ in range(8)]
    fmt = C.IN_FORMAT_FASTA
    assert (PP._stitch_and_build(fmt, EncodeOptions(), ref_block_rows(want))[0]
            == RP._stitch_and_build(1, fmt, RENC.EncodeOptions(), *args, zero_halves,
                                    want["em_np"], fallback=None)[0]
            == encode(data, EncodeOptions())[0])


# ---------------------------------------------------------------------------
# encode_device: archives equal host encode()
# ---------------------------------------------------------------------------

ENCODE_CASES = {
    "multirecord_masked": (lambda: _gen(), EncodeOptions()),
    "giant_record": (lambda: _gen(total=150_000, rec_len=150_000, seed=1), EncodeOptions()),
    "no_mask": (lambda: _gen(total=100_000, seed=2, mask=False), EncodeOptions(no_mask=True)),
    "no_mask_flag_on_masked": (lambda: _gen(total=90_000, seed=8), EncodeOptions(no_mask=True)),
    "rna": (lambda: _gen(total=80_000, seed=5).replace(b"T", b"U").replace(b"t", b"u"),
            EncodeOptions(seq_type=C.SEQ_TYPE_RNA)),
    "well_formed_safe": (lambda: _gen(total=60_000, seed=9), EncodeOptions(well_formed=True)),
    "level_and_title": (lambda: _gen(total=50_000, seed=10),
                        EncodeOptions(level=3, title="t", line_length=60)),
    "crlf_and_blank_lines": (lambda: b">a b\r\nACGT\r\n\r\nacgtN\r\n>c\r\n\r\n>d\nAC\n",
                             EncodeOptions()),
    "no_trailing_newline": (lambda: b">x\nACGTTGCAacgt", EncodeOptions()),
}


@pytest.mark.parametrize("name", list(ENCODE_CASES))
def test_encode_device_equals_host(name):
    make, opts = ENCODE_CASES[name]
    data = make()
    D.reset_counts()
    assert encode_device(data, opts, device="cpu")[0] == encode(data, opts)[0]
    assert D.ROUTES == {"encode_device": 1}


#: case -> (input, options, the route it takes); protein, text, a tile
#: past the sparse cap and unexpected characters take the two-pass device
#: encode, and only the rest goes to the host
ROUTES = {
    "fastq": (lambda: _gen_fq() + b"@last\nACGT\n+\n!!!!", EncodeOptions(),
              "encode_host:fastq_irregular"),
    "not_fasta": (lambda: b"", EncodeOptions(), "encode_host:not_fasta"),
    "text_like": (lambda: b">p\nMKVLAT*\n", EncodeOptions(seq_type=C.SEQ_TYPE_PROTEIN),
                  "encode_device:two_pass:text_like"),
    "well_formed_unsafe": (lambda: b">a\nAC GT\n", EncodeOptions(well_formed=True),
                           "encode_host:well_formed_unsafe"),
    "unexpected_chars": (lambda: b">r1\nACGTZZACGT\n" + _gen(total=60_000, seed=3),
                         EncodeOptions(), "encode_device:two_pass:unexpected_chars"),
    "sparse_overflow": (lambda: b"".join(b">h%d very long comment line to overflow\nA\n" % i
                                         for i in range(3000)), EncodeOptions(),
                        "encode_device:two_pass:sparse_overflow"),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_encode_routes(case):
    make, opts, route = ROUTES[case]
    data = make()
    D.reset_counts()
    assert encode_device(data, opts, device="cpu")[0] == encode(data, opts)[0]
    assert D.ROUTES == {route: 1}


def test_encode_format_mismatch_raises_as_host():
    from naf_tpu.pipeline.parser import InputError as RefInputError
    from naf_tpu_torch.pipeline.parser import InputError

    opts = EncodeOptions(in_format=C.IN_FORMAT_FASTQ)
    with pytest.raises(RefInputError) as ref:
        encode(b">a\nACGT\n", opts)
    with pytest.raises(InputError) as got:
        encode_device(b">a\nACGT\n", opts, device="cpu")
    assert str(got.value) == str(ref.value)


# ---------------------------------------------------------------------------
# fasta_device: the round trip, and the reference render
# ---------------------------------------------------------------------------

def _uniform(n_rec=12, sl=5000, L=70, seed=0, mask=True, rna=False):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n_rec):
        seq = rng.choice(np.frombuffer(b"ACGU" if rna else b"ACGT", np.uint8), size=sl)
        if mask:
            for s in rng.integers(0, sl - 200, size=6):
                seq[s:s + 200] |= 32
            seq[0] |= 32 if i % 2 else 0
        body = b"\n".join(seq[j:j + L].tobytes() for j in range(0, sl, L))
        rows.append(b">r%02d\n" % i + body + b"\n")
    return b"".join(rows)


DECODE_CASES = {
    "uniform_masked": (lambda: _uniform(), EncodeOptions()),
    "uniform_rna": (lambda: _uniform(rna=True, seed=1), EncodeOptions(seq_type=1)),
    "groups": (lambda: _uniform(5, 3000, 60, 2) + _uniform(7, 4100, 60, 3).replace(b">r", b">q"),
               EncodeOptions()),
    "single_record": (lambda: _gen(total=150_000, rec_len=150_000, seed=1), EncodeOptions()),
    "exact_lines": (lambda: _uniform(4, 700, 70, 4), EncodeOptions()),
    "no_mask": (lambda: _uniform(seed=5), EncodeOptions(no_mask=True)),
}


@pytest.mark.parametrize("name", list(DECODE_CASES))
def test_fasta_device_round_trip(name):
    make, opts = DECODE_CASES[name]
    data = make()
    blob = encode(data, opts)[0]
    D.reset_counts()
    out = fasta_device(Decoder(io.BytesIO(blob), DecodeOptions()), device="cpu")
    assert D.ROUTES == {"decode_device": 1}
    if opts.no_mask:
        assert out == _ref_decoder(blob).fasta()
        assert out.upper() == data.upper()
    else:
        assert out == data
    d = _ref_decoder(blob)
    plan, raw = d._fasta_plan(d.masking)
    assert out == RD.render_regular(plan, raw, None, mesh=block_mesh(1))


def test_fasta_device_ragged_takes_ragged_render():
    rng = np.random.default_rng(11)
    data = b"".join(b">v%d\n" % i + rng.choice(np.frombuffer(b"ACGT", np.uint8),
                                              size=int(rng.integers(1, 900))).tobytes()
                    + b"\n" for i in range(40))
    blob = encode(data, EncodeOptions())[0]
    D.reset_counts()
    out = fasta_device(Decoder(io.BytesIO(blob), DecodeOptions()), device="cpu")
    assert D.ROUTES == {"decode_device:ragged:too_many_groups": 1}
    assert out == data


def test_fasta_device_without_mask_option():
    data = _uniform(seed=6)
    blob = encode(data, EncodeOptions())[0]
    out = fasta_device(Decoder(io.BytesIO(blob), DecodeOptions(use_mask=False)), device="cpu")
    assert out == _ref_decoder(blob, use_mask=False).fasta()
    assert out != data and out.upper() == data.upper()


# ---------------------------------------------------------------------------
# package rules
# ---------------------------------------------------------------------------

def _port_sources() -> list[Path]:
    return sorted((REPO / "naf_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_port_never_imports_naf_tpu_statically():
    """No import or from line of the port, or of chip_smoke.py, names
    naf_tpu (or jax)."""
    import ast

    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("naf_tpu", "jax", "jaxlib"), f"{path}:{node.lineno} {name}"


def test_port_never_imports_jax():
    """Every port module imports, and a FASTA and a FASTQ round trip run on
    the CPU, with neither jax nor any module of naf_tpu loaded."""
    code = r"""
import importlib, io, pkgutil, sys
import naf_tpu_torch
for m in pkgutil.walk_packages(naf_tpu_torch.__path__, "naf_tpu_torch."):
    importlib.import_module(m.name)
from naf_tpu_torch.parallel.pipeline import encode_device
from naf_tpu_torch.pipeline.decoder import Decoder, fasta_device, fastq_device
from naf_tpu_torch.pipeline.stream import encode_stream
from naf_tpu_torch.cli import tnaf, untnaf
data = b">r1 c\nACGTacgtNN\nAC\n>r2\nGGTT\n"
blob = encode_device(data, device="cpu")[0]
assert fasta_device(Decoder(io.BytesIO(blob)), device="cpu") == data
out = io.BytesIO()
encode_stream(io.BytesIO(data), out)
assert out.getvalue() == blob
fq = b"@q1 c\nACGTacgt\n+\n!!!!####\n@q2 d\nGGTTAAcc\n+\n$$$$%%%%\n"
blob = encode_device(fq, device="cpu")[0]
assert fastq_device(Decoder(io.BytesIO(blob)), device="cpu") == fq.replace(b"acgt", b"ACGT").replace(b"cc", b"CC")
open(sys.argv[1] + ".fq", "wb").write(fq)
assert tnaf.main(["-o", sys.argv[1] + ".naf", sys.argv[1] + ".fq"]) == 0
assert open(sys.argv[1] + ".naf", "rb").read() == blob
assert untnaf.main(["-o", sys.argv[1] + ".out", "--names", sys.argv[1] + ".naf"]) == 0
assert open(sys.argv[1] + ".out", "rb").read() == b"q1 c\nq2 d\n"
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "naf_tpu"))
assert not bad, bad
print("ok")
"""
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    env["PYTHONPATH"] = str(REPO)
    stem = Path(env.get("TMPDIR", "/tmp")) / f"naf_tpu_torch_nojax_{os.getpid()}"
    try:
        r = subprocess.run([sys.executable, "-c", code, str(stem)], capture_output=True,
                           text=True, env=env, cwd=REPO, timeout=300)
    finally:
        for ext in (".fq", ".naf", ".out"):
            Path(str(stem) + ext).unlink(missing_ok=True)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


#: the port's modules that the host paths (and the CLIs without --device) run
HOST_MODULES = ["naf_tpu_torch", "naf_tpu_torch.version", "naf_tpu_torch.codec",
                "naf_tpu_torch.format.container", "naf_tpu_torch.native.host",
                "naf_tpu_torch.ops.histogram_np", "naf_tpu_torch.pipeline.parser",
                "naf_tpu_torch.pipeline.encoder", "naf_tpu_torch.pipeline.decoder",
                "naf_tpu_torch.pipeline.stream", "naf_tpu_torch.cli.tnaf",
                "naf_tpu_torch.cli.untnaf"]


@pytest.mark.parametrize("module", HOST_MODULES)
def test_host_module_loads_no_torch(module):
    """Each host module imports with neither torch, nor jax, nor any module
    of naf_tpu loaded."""
    code = ("import importlib, sys\n"
            f"importlib.import_module({module!r})\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('torch', 'jax', 'jaxlib', 'naf_tpu'))\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    env["PYTHONPATH"] = str(REPO)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                       cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr


def test_importing_the_port_leaves_zstandard_alone():
    code = r"""
import sys
sys.modules["zstandard"] = None
import naf_tpu_torch, naf_tpu_torch.codec, naf_tpu_torch.parallel.pipeline
assert sys.modules["zstandard"] is None
print("ok")
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env=dict(os.environ, PYTHONPATH=str(REPO)), cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    data = _gen(total=20_000, seed=13)
    with pytest.raises(RuntimeError, match="CUDA"):
        encode_device(data, device="cuda")
    blob = encode(data, EncodeOptions())[0]
    with pytest.raises(RuntimeError, match="CUDA"):
        fasta_device(Decoder(io.BytesIO(blob), DecodeOptions()), device="cuda")
    fq = _gen_fq(50, 40, 16)
    with pytest.raises(RuntimeError, match="CUDA"):
        encode_device(fq, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        fastq_device(Decoder(io.BytesIO(encode(fq, EncodeOptions())[0])), device="cuda")
    with pytest.raises(ValueError):
        encode_device(data, device=None)


def test_round_trip_without_the_zstandard_package():
    """Where only the system libzstd exists (the CUDA host), the port's own
    codec compresses and decompresses through it; its archives equal
    naf_tpu's and read back with the real package."""
    code = r"""
import io, sys
sys.modules["zstandard"] = None
from naf_tpu_torch.parallel.pipeline import encode_device
from naf_tpu_torch.pipeline.decoder import Decoder, fasta_device
from naf_tpu_torch.pipeline.encoder import EncodeOptions, encode
from naf_tpu_torch.codec import zstd_backend
assert sys.modules["zstandard"] is None and zstd_backend._zstandard is None
data = open(sys.argv[1], "rb").read()
for opts in (EncodeOptions(), EncodeOptions(level=5, long_window_log=20, threads=2)):
    blob = encode_device(data, opts, device="cpu")[0]
    assert blob == encode(data, opts)[0]
    assert fasta_device(Decoder(io.BytesIO(blob)), device="cpu") == data
sys.stdout.buffer.write(blob)
"""
    data = _gen(total=10_000_000, rec_len=2_000_000, seed=14)
    path = Path(os.environ.get("TMPDIR", "/tmp")) / f"naf_tpu_torch_zc_{os.getpid()}.fa"
    path.write_bytes(data)
    try:
        r = subprocess.run([sys.executable, "-c", code, str(path)], capture_output=True,
                           env=dict(os.environ, PYTHONPATH=str(REPO)), cwd=REPO, timeout=300)
    finally:
        path.unlink()
    assert r.returncode == 0, r.stderr.decode()
    assert r.stdout == encode(data, EncodeOptions(level=5, long_window_log=20, threads=2))[0]
    assert _ref_decoder(r.stdout).fasta() == data
