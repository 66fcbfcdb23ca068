"""naf_tpu_torch's block mesh on the CPU: its collectives, the per-block
stats, the mesh render, the stream engine over several blocks and the dry
run.

  * ``stats_blocks_sharded`` over D in (2, 3, 8) CPU blocks gives each
    block the counts, ``odd``, the longest line (pmax) and the histograms
    (psum) of naf_tpu's ``stats_blocks_sharded`` on the same blocks;
  * ``fasta_device`` / ``fastq_device`` over a mesh equal the port's host
    ``Decoder`` by the route ``decode_device:ragged:mesh``, also in batches
    small enough that chunk edges fall inside records;
  * ``DeviceScanEngine(mesh=...)`` over 2 and 4 blocks gives naf_tpu's
    host archives on three of test_torch_stream.py's cases in 257-byte
    chunks, and naf_tpu's own engine's over the same number of devices;
  * ``dryrun_multichip`` passes on CPU blocks;
  * ``all_gather``, ``parities``, ``psum``, ``pmax`` and ``block_mesh``.
Tolerance 0.
"""

from __future__ import annotations

import io

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from naf_tpu.parallel import block as RB
from naf_tpu.parallel import pipeline as RP
from naf_tpu.parallel.mesh import block_mesh as ref_mesh, block_sharding
from naf_tpu.pipeline import encoder as RENC
from naf_tpu.pipeline import stream as RSTREAM
from naf_tpu_torch import device as D
from naf_tpu_torch.format import constants as C
from naf_tpu_torch.parallel import decode as PD
from naf_tpu_torch.parallel.block import make_blocks, make_blocks_fastq, stats_blocks_sharded
from naf_tpu_torch.parallel.mesh import (BlockMesh, all_gather, block_mesh, dryrun_multichip,
                                         parities, pmax, psum)
from naf_tpu_torch.parallel.stream import DeviceScanEngine
from naf_tpu_torch.pipeline.decoder import DecodeOptions, Decoder, fasta_device, fastq_device
from naf_tpu_torch.pipeline.encoder import EncodeOptions, encode
from naf_tpu_torch.pipeline.stream import encode_stream

from torch_cases import (MESH_FASTA_CASES, MESH_SIZES, MESH_TWO_PASS_CASES, STREAM_CASES,
                         sra_fastq, typed_fasta)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its plain versions are
    many small ops, and the suite runs several workers on the machine's
    cores, which full thread pools each would oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cpu_mesh(n: int) -> BlockMesh:
    return block_mesh(devices=["cpu"] * n)


# ---------------------------------------------------------------------------
# the collectives and the mesh
# ---------------------------------------------------------------------------

def test_collectives():
    xs = [torch.tensor([k, 10 * k], dtype=torch.int32) for k in range(5)]
    assert all_gather(xs).tolist() == [[k, 10 * k] for k in range(5)]
    assert psum([x.to(torch.uint8) for x in xs]).tolist() == [10, 100]
    assert psum(xs).dtype == np.int64
    counts = [torch.tensor(c) for c in (3, 0, 5, 2, 7)]
    assert parities(counts, 0) == [0, 1, 1, 0, 0]
    assert parities(counts, 1) == [1, 0, 0, 1, 1]
    assert parities(counts[:1], 1) == [1]
    assert pmax(np.asarray([3, 9, 2])) == 9


def test_block_mesh():
    mesh = _cpu_mesh(3)
    assert mesh.size == 3 and all(d == torch.device("cpu") for d in mesh.devices)
    assert block_mesh(2, ["cpu"] * 5).size == 2
    with pytest.raises(ValueError):
        block_mesh(4, ["cpu"] * 3)
    rows = mesh.upload(np.arange(12, dtype=np.uint8).reshape(3, 4))
    assert [r.tolist() for r in rows] == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10, 11]]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            block_mesh()


# ---------------------------------------------------------------------------
# pass 1 against naf_tpu's stats_blocks_sharded
# ---------------------------------------------------------------------------

STATS_CASES = {
    "dirty_fasta": (lambda: typed_fasta(np.random.default_rng(86), C.SEQ_TYPE_DNA, n_rec=30)
                    + b">odd \x01bytes\x7f\nAC*GT!\n>x\nNN\n", False),
    "dirty_fastq": (lambda: sra_fastq(np.random.default_rng(87), 60)
                    + b"@z \x01c\nACZT\n+\n!!\x7f!\n@y\nAC\n+\n!!\n", True),
}


@pytest.mark.parametrize("n", MESH_SIZES)
@pytest.mark.parametrize("name", list(STATS_CASES))
def test_stats_blocks_sharded_matches_naf_tpu(name, n):
    make, fastq = STATS_CASES[name]
    body = np.frombuffer(make(), np.uint8)[1:]
    blocks = make_blocks_fastq(body, n)[0] if fastq else make_blocks(body, n)
    sh = block_sharding(ref_mesh(n))
    args = [jax.device_put(jnp.asarray(a), sh)
            for a in (blocks.data, blocks.prev, blocks.starts_in_seq)]
    ref = [np.asarray(o) for o in RB.stats_blocks_sharded(*args, seq_type=0, fastq=fastq,
                                                           mesh=ref_mesh(n))]
    stats, _ = stats_blocks_sharded(_cpu_mesh(n).upload(blocks.data), blocks.prev,
                                    blocks.starts_in_seq, seq_type=0, fastq=fastq)
    assert len(stats) == n
    for k, st in enumerate(stats):
        for key, col in (("count", 0), ("odd", 1), ("id_bytes", 2), ("com_bytes", 3),
                         ("qual_bytes", 4), ("n_rec", 5), ("n_runs", 6), ("first_lower", 7),
                         ("longest", 8)):
            assert st[key] == ref[col][k], (key, k)
        for got, lo, hi in zip(st["hists"], ref[9::2], ref[10::2]):
            assert np.array_equal(got, RP._merge_hist(lo[k], hi[k]))
    assert any(h.any() for h in stats[0]["hists"])


# ---------------------------------------------------------------------------
# the mesh render against the host Decoder
# ---------------------------------------------------------------------------

DECODE_CASES = {name: MESH_FASTA_CASES[name] for name in ("fused_fasta", "giant_record")} | {
    name: MESH_TWO_PASS_CASES[name] for name in ("fused_fastq", "protein")}


def _host_render(blob: bytes, fastq: bool) -> bytes:
    d = Decoder(io.BytesIO(blob), DecodeOptions())
    return d.fastq() if fastq else d.fasta()


@pytest.mark.parametrize("n", MESH_SIZES)
@pytest.mark.parametrize("name", list(DECODE_CASES))
def test_mesh_render_equals_host_decoder(name, n):
    make, kw, _ = DECODE_CASES[name]
    data = make()
    blob = encode(data, EncodeOptions(**kw))[0]
    fastq = data[:1] == b"@"
    D.reset_counts()
    d = Decoder(io.BytesIO(blob), DecodeOptions())
    got = fastq_device(d, mesh=_cpu_mesh(n)) if fastq else fasta_device(d, mesh=_cpu_mesh(n))
    assert got == _host_render(blob, fastq)
    assert D.ROUTES == {"decode_device:ragged:mesh": 1}


@pytest.mark.parametrize("out_batch", [333, 4096])
def test_mesh_render_in_small_batches(out_batch):
    """Batches of a few hundred bytes cut in 3 chunks: chunk edges fall in
    headers, lines and mask runs, and every chunk is its own render."""
    for name in ("giant_record", "fused_fastq"):
        make, kw, _ = DECODE_CASES[name]
        data = make()
        blob = encode(data, EncodeOptions(**kw))[0]
        fastq = data[:1] == b"@"
        d = Decoder(io.BytesIO(blob), DecodeOptions())
        plan, raw = d._plan(PD.MODE_FASTQ if fastq else PD.MODE_FASTA,
                            False if fastq else d.masking)
        qual = d._load_qual() if fastq else None
        assert len(PD.plan_batches(plan, out_batch)) > 2
        got = PD.render_batched(plan, raw, qual, mesh=_cpu_mesh(3), out_batch=out_batch)
        assert got == _host_render(blob, fastq)


# ---------------------------------------------------------------------------
# the stream engine over several blocks
# ---------------------------------------------------------------------------

#: the stream cases run over a mesh, each at chunk size 257: many pieces, a
#: record continued across them, odd parity under mask runs, FASTQ
MESH_STREAM_CASES = ["giant_single_record", "odd_masked_fasta", "odd_masked_fastq"]


def _stream(data: bytes, opts, chunk: int, engine) -> bytes:
    buf = io.BytesIO()
    encode_stream(io.BytesIO(data), buf, opts, chunk_size=chunk, engine=engine)
    return buf.getvalue()


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", MESH_STREAM_CASES)
def test_stream_engine_mesh_equals_naf_tpu(name, n):
    """The archive of naf_tpu's host encode(), every piece on the device
    path but the reasons the case allows."""
    make, kw, chunks, _, allowed = STREAM_CASES[name]
    assert 257 in chunks
    data = make()
    ref, _ = RENC.encode(data, RENC.EncodeOptions(**kw))
    D.reset_counts()
    eng = DeviceScanEngine(mesh=_cpu_mesh(n))
    assert _stream(data, EncodeOptions(**kw), 257, eng) == ref
    assert eng.device_chunks > 1
    assert not [k for k in D.ROUTES
                if k.startswith("stream_host") and k.split(":")[1] not in allowed]


@pytest.mark.parametrize("n", [2, 4])
def test_stream_engine_mesh_matches_naf_tpu_engine(n):
    """naf_tpu's engine over n CPU devices gives the same archive."""
    from naf_tpu.parallel.stream import DeviceScanEngine as RefEngine

    make, kw, _, _, _ = STREAM_CASES["odd_masked_fasta"]
    data = make()
    buf = io.BytesIO()
    RSTREAM.encode_stream(io.BytesIO(data), buf, RENC.EncodeOptions(**kw), chunk_size=257,
                          engine=RefEngine(mesh=ref_mesh(n)))
    eng = DeviceScanEngine(mesh=_cpu_mesh(n))
    assert _stream(data, EncodeOptions(**kw), 257, eng) == buf.getvalue()


# ---------------------------------------------------------------------------
# the dry run of __graft_entry__.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 8])
def test_dryrun_multichip_on_cpu_blocks(n):
    out = dryrun_multichip(n, ["cpu"] * n)
    assert out["fasta"]["routes"] == {"encode_device": 1}
    assert out["protein"]["routes"] == {"encode_device:two_pass:text_like": 1}
    assert set(out) == {"fasta", "fastq", "protein", "strict", "full"}
