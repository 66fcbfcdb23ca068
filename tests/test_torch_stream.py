"""naf_tpu_torch's streamed device encode (parallel/stream.py
``DeviceScanEngine``) on the CPU, against naf_tpu.

Every case of naf_tpu's tests/test_device_stream.py, and two of odd
nibble parity under mask runs that cross chunk edges (torch_cases.py
``STREAM_CASES``): ``encode_stream(..., engine=DeviceScanEngine("cpu"))``
at each chunk size gives the archive of the port's host ``encode()`` and
of naf_tpu's, byte for byte, and at chunk size 257 that of naf_tpu's
``encode_stream`` with naf_tpu's own engine.  Each piece's route is
counted: the device where naf_tpu's test expects it, the host scanner only
for the reasons the case allows.  Error texts equal naf_tpu's.  A fault on
the device propagates: nothing is requeued to the host scanner, no warning
is given, and ``tnaf --device`` ends with its error and no output file.
"""

from __future__ import annotations

import io
import sys
import warnings

import numpy as np
import pytest
import torch

from naf_tpu.pipeline import encoder as RENC
from naf_tpu.pipeline import stream as RSTREAM
from naf_tpu_torch import device as D
from naf_tpu_torch.parallel import pipeline as PP
from naf_tpu_torch.parallel.stream import DeviceScanEngine
from naf_tpu_torch.pipeline import encoder as PENC
from naf_tpu_torch.pipeline.parser import InputError
from naf_tpu_torch.pipeline.stream import encode_stream
from torch_cases import (STREAM_CASES, em_np_fields, stream_fasta, stream_odd_masked_fasta,
                         stream_odd_masked_fastq)

CASE_CHUNKS = [(name, cs) for name, case in STREAM_CASES.items() for cs in case[2]]


def stream_bytes(data: bytes, opts=None, *, chunk_size: int, engine) -> bytes:
    buf = io.BytesIO()
    encode_stream(io.BytesIO(data), buf, opts or PENC.EncodeOptions(), chunk_size=chunk_size,
                  engine=engine)
    return buf.getvalue()


class _Spy(DeviceScanEngine):
    """The engine, noting the carries each piece arrives with."""

    def __init__(self):
        super().__init__(device="cpu")
        self.carries = []

    def scan(self, data, **kw):
        self.carries.append((kw["pack_carry"] is not None, kw["mask_run"] > 0))
        return super().scan(data, **kw)


@pytest.fixture(scope="module")
def references() -> dict:
    """name -> (input, the port's options, naf_tpu's host encode() archive)."""
    out = {}
    for name, (make, kw, *_rest) in STREAM_CASES.items():
        data = make()
        ref, _ = RENC.encode(data, RENC.EncodeOptions(**kw))
        out[name] = (data, PENC.EncodeOptions(**kw), ref)
    return out


@pytest.mark.parametrize("name,chunk", CASE_CHUNKS)
def test_stream_archive(name, chunk, references):
    data, opts, ref = references[name]
    _, _, _, want_device, host_reasons = STREAM_CASES[name]
    assert PENC.encode(data, opts)[0] == ref
    D.reset_counts()
    eng = _Spy()
    assert stream_bytes(data, opts, chunk_size=chunk, engine=eng) == ref
    routes = dict(D.ROUTES)
    assert eng.device_chunks + eng.native_chunks == len(eng.carries) == sum(routes.values())
    assert sum(v for k, v in routes.items() if k.startswith("stream_device")) == eng.device_chunks
    host = {k.split(":", 1)[1] for k in routes if k.startswith("stream_host:")}
    assert host <= set(host_reasons), routes
    assert not set(routes) - {"stream_device", "stream_device:two_pass:sparse_overflow",
                              "stream_device:two_pass:unexpected_chars"} - {
        f"stream_host:{w}" for w in host}
    if want_device:
        assert eng.device_chunks > 0, f"chunk_size={chunk} never took the device"
    if name.startswith("odd_masked") and chunk < 5000:
        # pieces arrive at odd parity and inside a mask run
        assert any(odd for odd, _ in eng.carries) and any(run for _, run in eng.carries)
    if name == "protein":
        assert eng.device_chunks == 0 and routes == {"stream_host:host_mode": eng.native_chunks}
    if name == "single_giant_line":
        assert eng.native_chunks > 0


@pytest.mark.parametrize("name", list(STREAM_CASES))
def test_stream_archive_matches_naf_tpu_engine(name, references):
    """naf_tpu's encode_stream with its own device engine (on its CPU
    mesh) gives the same archive at chunk size 257."""
    from naf_tpu.parallel.stream import DeviceScanEngine as RefEngine

    data, opts, ref = references[name]
    buf = io.BytesIO()
    RSTREAM.encode_stream(io.BytesIO(data), buf, RENC.EncodeOptions(**STREAM_CASES[name][1]),
                          chunk_size=257, engine=RefEngine())
    assert buf.getvalue() == ref
    assert stream_bytes(data, opts, chunk_size=257, engine=DeviceScanEngine("cpu")) == ref


@pytest.mark.parametrize("fastq", [False, True])
def test_emit_block_at_odd_parity_matches_naf_tpu(fastq):
    """A block's two-pass emit at parity base 1 packs chars[1:] and gives
    chars[0]'s code, as naf_tpu's two-pass emit with ``odd`` set on a
    one-device mesh."""
    import jax
    import jax.numpy as jnp

    from naf_tpu.parallel import block as RB
    from naf_tpu.parallel.mesh import block_mesh, block_sharding
    from naf_tpu.parallel.stream import _bucket
    from naf_tpu_torch.parallel import block as PB

    data = stream_odd_masked_fastq() if fastq else stream_odd_masked_fasta()
    body = np.frombuffer(data, np.uint8)[1:]
    blocks = PB.make_blocks_fastq(body, 1)[0] if fastq else PB.make_blocks(body, 1)
    mesh = block_mesh(1)
    sh = block_sharding(mesh)
    args = [jax.device_put(jnp.asarray(a), sh)
            for a in (blocks.data, blocks.prev, blocks.starts_in_seq)]
    st = [np.asarray(o) for o in RB.stats_blocks_sharded(*args, seq_type=0, fastq=fastq,
                                                          mesh=mesh)]
    counts, _, id_bytes, com_bytes, qual_bytes, n_rec, n_runs = st[:7]
    caps = dict(p_cap=_bucket(int((counts + 1).max() // 2) + 1),
                id_cap=_bucket(max(int(id_bytes.max()), 1)),
                com_cap=_bucket(max(int(com_bytes.max()), 1)),
                r_cap=_bucket(int(n_rec.max()) + 1), m_cap=_bucket(max(int(n_runs.max()), 2)),
                q_cap=_bucket(max(int(qual_bytes.max()), 1)) if fastq else 16)
    odd = jax.device_put(jnp.asarray(np.ones(1, bool)), sh)
    em_r = em_np_fields(RB.emit_blocks_sharded(*args, odd, seq_type=0, fastq=fastq, mesh=mesh,
                                               **caps))
    x = torch.from_numpy(blocks.data[0].copy())
    stats, masks = PB.stats_blocks_sharded([x], blocks.prev, blocks.starts_in_seq, seq_type=0,
                                           fastq=fastq, parity_base=1)
    em = PB.emit_blocks_sharded([x], masks, stats, seq_type=0, fastq=fastq, pack_nibbles=True)
    cnt = stats[0]["count"]
    assert cnt == int(counts[0]) > 1
    assert np.array_equal(em.packed[:, :(cnt + 1) // 2], em_r["packed"][:, :(cnt + 1) // 2])
    assert int(em.first_codes[0]) == int(em_r["first_codes"][0])
    even = PB.emit_blocks_sharded([x], masks, [{**stats[0], "odd": False}], seq_type=0,
                                  fastq=fastq, pack_nibbles=True)
    assert not np.array_equal(even.packed[:, :cnt // 2], em.packed[:, :cnt // 2])


def test_host_stream_strip_regression():
    """The port's host stream: a chunk edge at a record's end left the next
    '@' unstripped."""
    data = b"@r1 c\nACGT\n+\n@AAA\n@r2 c\nGGGG\n+\nBBBB\n"
    ref, _ = RENC.encode(data, RENC.EncodeOptions())
    for cs in range(8, 40):
        buf = io.BytesIO()
        encode_stream(io.BytesIO(data), buf, PENC.EncodeOptions(), chunk_size=cs)
        assert buf.getvalue() == ref, f"chunk_size={cs}"
        assert stream_bytes(data, chunk_size=cs, engine=DeviceScanEngine("cpu")) == ref


@pytest.mark.parametrize("chunk", [8, 64, 257, 5000])
def test_qual_mismatch_error_parity(chunk):
    data = b"@r1\nACGT\n+\nI\n@r2\nGG\n+\nII\n"
    with pytest.raises(ValueError) as e_ref:
        RENC.encode(data, RENC.EncodeOptions())
    D.reset_counts()
    with pytest.raises(InputError) as e_port:
        stream_bytes(data, chunk_size=chunk, engine=DeviceScanEngine("cpu"))
    assert str(e_port.value) == str(e_ref.value)
    assert "stream_host:qual_length_mismatch" in D.ROUTES or "stream_host:no_full_record" in D.ROUTES


def test_engine_defaults_to_the_card():
    """DeviceScanEngine() names the card; without one it raises."""
    import torch

    if torch.cuda.is_available():
        assert DeviceScanEngine().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DeviceScanEngine()


# ---------------------------------------------------------------------------
# no fallback: a fault on the device propagates
# ---------------------------------------------------------------------------

def _boom(*a, **k):
    raise RuntimeError("injected device fault")


@pytest.mark.parametrize("target,data", [
    ("fused_blocks_sharded", stream_fasta(np.random.default_rng(60), 40)),
    ("fused_blocks_fastq_sharded",
     b"".join(b"@r%d c\nACGT\n+\nIIII\n" % i for i in range(40))),
    # unexpected characters decline the fused path, so the stats pass runs
    ("stats_blocks_sharded", b"".join(b">r%d\nACGTJJ\n" % i for i in range(40))),
    ("emit_blocks_sharded", b"".join(b">r%d\nACGTJJ\n" % i for i in range(40))),
])
def test_device_fault_propagates(target, data, monkeypatch):
    monkeypatch.setattr(PP, target, _boom)
    eng = DeviceScanEngine("cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(RuntimeError, match="injected device fault"):
            stream_bytes(data, chunk_size=300, engine=eng)
    assert eng.native_chunks == 0 and eng.device_chunks == 0


def test_fault_on_a_later_chunk_propagates(monkeypatch):
    """The first pieces succeed; the failing one is not requeued."""
    calls = {"n": 0}
    real = PP.fused_blocks_sharded

    def flaky(*a, **k):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("injected device fault")
        return real(*a, **k)

    monkeypatch.setattr(PP, "fused_blocks_sharded", flaky)
    eng = DeviceScanEngine("cpu")
    with pytest.raises(RuntimeError, match="injected device fault"):
        stream_bytes(stream_fasta(np.random.default_rng(61), 60), chunk_size=400, engine=eng)
    assert eng.device_chunks == 2 and eng.native_chunks == 0


# ---------------------------------------------------------------------------
# tnaf --device on a pipe and over the threshold, the card replaced by the CPU
# ---------------------------------------------------------------------------

class _Std:
    def __init__(self, data: bytes = b""):
        self.buffer = io.BytesIO(data)

    def isatty(self) -> bool:
        return False


@pytest.fixture
def cpu_card(monkeypatch):
    import torch

    monkeypatch.setattr(D, "cuda_device", lambda: torch.device("cpu"))
    monkeypatch.setenv("NAF_TPU_STREAM_THRESHOLD", "1024")
    monkeypatch.setenv("NAF_TPU_DEVICE_CHUNK", "4096")
    monkeypatch.delenv("TMPDIR", raising=False)
    monkeypatch.delenv("TMP", raising=False)


def _tnaf(argv, monkeypatch, stdin: bytes = b"") -> tuple:
    """(status, stdout, stderr) of the port's tnaf main in this process."""
    from naf_tpu_torch.cli import tnaf

    io_ = {k: _Std(stdin if k == "stdin" else b"") for k in ("stdin", "stdout", "stderr")}
    for k, v in io_.items():
        monkeypatch.setattr(sys, k, v)
    try:
        rc = tnaf.main(argv)
    except SystemExit as e:
        rc = e.code
    return rc, io_["stdout"].buffer.getvalue(), io_["stderr"].buffer.getvalue()


@pytest.mark.parametrize("how", ["file", "pipe"])
def test_tnaf_device_streams_on_the_engine(how, cpu_card, monkeypatch, tmp_path):
    data = stream_fasta(np.random.default_rng(5), 300)
    ref, _ = RENC.encode(data, RENC.EncodeOptions(threads=1))
    D.reset_counts()
    if how == "file":
        src = tmp_path / "in.fa"
        src.write_bytes(data)
        rc, out, err = _tnaf(["--device", "--threads", "1", "-o", str(tmp_path / "o.naf"),
                              str(src)], monkeypatch)
        out = (tmp_path / "o.naf").read_bytes()
    else:
        rc, out, err = _tnaf(["--device", "--threads", "1", "-c"], monkeypatch, stdin=data)
    assert (rc, err) == (0, b"")
    assert out == ref
    assert D.ROUTES["encode_device:stream"] == 1
    assert D.ROUTES.get("stream_device", 0) > 0
    assert not [k for k in D.ROUTES if k.startswith(("stream_host", "encode_host"))]


@pytest.mark.parametrize("how", ["file", "pipe"])
def test_tnaf_device_stream_fault_ends_with_an_error(how, cpu_card, monkeypatch, tmp_path):
    monkeypatch.setattr(PP, "fused_blocks_sharded", _boom)
    data = stream_fasta(np.random.default_rng(6), 300)
    out_path = tmp_path / "o.naf"
    if how == "file":
        src = tmp_path / "in.fa"
        src.write_bytes(data)
        rc, out, err = _tnaf(["--device", "-o", str(out_path), str(src)], monkeypatch)
    else:
        rc, out, err = _tnaf(["--device", "-c"], monkeypatch, stdin=data)
    assert (rc, out) == (1, b"")
    assert err == b"tnaf error: device encode failed: injected device fault\n"
    assert not out_path.exists()
