"""naf_tpu_torch's multi-process encode (parallel/multihost.py) on gloo, on
the CPU.

  * One process (world size 1) with 8 CPU blocks: ``encode_multihost``
    gives host ``encode()``'s archive, and ``encode_multihost_parts`` and
    ``encode_multihost_extended`` give naf_tpu's archives byte for byte
    (naf_tpu's run in this process on tests/conftest.py's 8 CPU devices);
    the compressed-traffic paths gather less than the plain one; the
    inputs the device passes do not take go to the host by a named route.
  * 2 and 3 processes spawned as tests/test_multihost.py spawns its
    workers, 2 CPU blocks each, blocks of uneven widths and one record
    over every block: the plain archive equals host ``encode()``, the parts and
    extended archives decode to the input's decode, the extended path
    gathers less than the plain one, and every rank returns the same
    archives.  Each rank runs under a timeout of its own (and its
    rendezvous under another), so a hung rendezvous fails the test.
"""

from __future__ import annotations

import io
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
dist = pytest.importorskip("torch.distributed")

from naf_tpu.parallel import multihost as RMH
from naf_tpu.pipeline import encoder as RENC
from naf_tpu_torch import device as D
from naf_tpu_torch.format import constants as C
from naf_tpu_torch.parallel import multihost as MH
from naf_tpu_torch.parallel.mesh import block_mesh
from naf_tpu_torch.pipeline.decoder import DecodeOptions, Decoder
from naf_tpu_torch.pipeline.encoder import EncodeOptions, encode
from naf_tpu_torch.pipeline.parser import InputError

from torch_cases import mesh_giant_fasta, mixed_fastq, reads_fasta, typed_fasta


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its plain versions are
    many small ops, and the suite runs several workers on the machine's
    cores, which full thread pools each would oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

REPO = Path(__file__).resolve().parent.parent

#: seconds a spawned rank may take, its rendezvous included
RANK_TIMEOUT = 180


def _port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def gloo_world_1():
    """This process as the one rank of a gloo process group."""
    import datetime

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_port()}", world_size=1,
                            rank=0, timeout=datetime.timedelta(seconds=RANK_TIMEOUT))
    yield
    dist.destroy_process_group()


INPUTS = {
    "giant_fasta": (mesh_giant_fasta, {}),
    "fastq": (lambda: mixed_fastq(seed=90, n_rec=150), {}),
    "reads_fasta_block_bytes": (lambda: reads_fasta(np.random.default_rng(91), 300),
                                {"block_bytes": 1 << 12}),
}


def _decode(blob: bytes) -> bytes:
    d = Decoder(io.BytesIO(blob), DecodeOptions())
    return d.fastq() if d.h.has_quality else d.fasta()


@pytest.mark.parametrize("name", list(INPUTS))
def test_one_process_matches_naf_tpu(name, gloo_world_1):
    make, kw = INPUTS[name]
    data, opts = make(), EncodeOptions(level=1, **kw)
    ref_opts = RENC.EncodeOptions(level=1, **kw)
    mesh = block_mesh(devices=["cpu"] * 8)
    D.reset_counts()
    plain_traffic, parts_traffic, ext_traffic = {}, {}, {}
    assert MH.encode_multihost(data, opts, mesh=mesh, traffic=plain_traffic)[0] == \
        encode(data, opts)[0] == RMH.encode_multihost(data, ref_opts)[0]
    parts = MH.encode_multihost_parts(data, opts, parts_traffic, mesh=mesh)[0]
    assert parts == RMH.encode_multihost_parts(data, ref_opts)[0]
    ext = MH.encode_multihost_extended(data, opts, ext_traffic, mesh=mesh)[0]
    assert ext == RMH.encode_multihost_extended(data, ref_opts)[0]
    assert not parts[4] & 0x80 and ext[4] & 0x80          # plain and extended format
    assert _decode(parts) == _decode(ext) == _decode(encode(data, opts)[0])
    assert D.ROUTES == {"encode_multihost": 1, "encode_multihost:parts": 1,
                        "encode_multihost:extended": 1}
    assert ext_traffic["gathered_bytes"] < plain_traffic["gathered_bytes"]
    assert parts_traffic["gathered_bytes"] < plain_traffic["gathered_bytes"]


def test_one_process_host_routes(gloo_world_1):
    """Protein takes the two-pass on the plain path and the host on the
    compressed-traffic ones; --strict with an unexpected byte raises the
    host's message; a FASTQ off the 4-line grid goes to the host."""
    mesh = block_mesh(devices=["cpu"] * 3)
    prot = typed_fasta(np.random.default_rng(92), C.SEQ_TYPE_PROTEIN)
    opts = EncodeOptions(level=1, seq_type=C.SEQ_TYPE_PROTEIN)
    D.reset_counts()
    assert MH.encode_multihost(prot, opts, mesh=mesh)[0] == encode(prot, opts)[0]
    assert MH.encode_multihost_parts(prot, opts, mesh=mesh)[0] == encode(prot, opts)[0]
    assert D.ROUTES == {"encode_multihost": 1, "multihost_host:text_like": 1}
    dirty = b">a\nACGTZGGG\nACGT\n>b\nTTTT\n" * 3
    with pytest.raises(InputError) as want:
        encode(dirty, EncodeOptions(strict=True))
    D.reset_counts()
    with pytest.raises(InputError) as got:
        MH.encode_multihost(dirty, EncodeOptions(strict=True), mesh=mesh)
    assert str(got.value) == str(want.value)
    assert D.ROUTES == {"multihost_host:strict_unexpected": 1}
    crlf = b"@r1\r\nACGT\r\n+\r\nIIII\r\n"       # an error in the reference
    with pytest.raises(InputError) as want:
        encode(crlf, EncodeOptions())
    D.reset_counts()
    with pytest.raises(InputError) as got:
        MH.encode_multihost(crlf, EncodeOptions(), mesh=mesh)
    assert str(got.value) == str(want.value)
    assert D.ROUTES == {"multihost_host:fastq_irregular": 1}



@pytest.mark.parametrize("name", ["giant_fasta", "fastq"])
def test_one_process_device_engine_matches_naf_tpu(name, gloo_world_1, monkeypatch):
    """engine="device" on the multi-process encodes: the plain archive
    (compressed after the gather) and the extended one (each process's
    frames from the device match finder on its mesh's first device, the
    CPU here) equal naf_tpu's, with SPAN lowered to 256 KiB in both
    packages so that the frames cross spans."""
    from naf_tpu.ops import matchfind as RMF
    from naf_tpu_torch.ops import matchfind as MF

    monkeypatch.setattr(MF, "SPAN", 256 << 10)
    monkeypatch.setattr(RMF, "SPAN", 256 << 10)
    data = (mesh_giant_fasta(n_lines=12_000) if name == "giant_fasta"
            else mixed_fastq(seed=93, n_rec=3000))
    kw = {"level": 3, "engine": "device", "block_bytes": 300_000}
    opts, ref_opts = EncodeOptions(**kw), RENC.EncodeOptions(**kw)
    mesh = block_mesh(devices=["cpu"] * 4)
    D.reset_counts()
    plain = MH.encode_multihost(data, opts, mesh=mesh)[0]
    assert plain == RMH.encode_multihost(data, ref_opts)[0] == encode(data, opts, device="cpu")[0]
    ext = MH.encode_multihost_extended(data, opts, mesh=mesh)[0]
    assert ext == RMH.encode_multihost_extended(data, ref_opts)[0]
    assert _decode(ext) == _decode(plain) == _decode(encode(data, EncodeOptions())[0])
    assert D.ROUTES == {"encode_multihost": 1, "encode_multihost:extended": 1}


WORKER = r"""
import datetime, hashlib, io, sys
import torch.distributed as dist

from naf_tpu_torch import device as D
from naf_tpu_torch.parallel import multihost as MH
from naf_tpu_torch.parallel.mesh import block_mesh
from naf_tpu_torch.pipeline.decoder import Decoder, DecodeOptions
from naf_tpu_torch.pipeline.encoder import EncodeOptions, encode
from torch_cases import mesh_giant_fasta, mixed_fastq

port, rank, world, timeout = (int(a) for a in sys.argv[1:5])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                        rank=rank, timeout=datetime.timedelta(seconds=timeout))
mesh = block_mesh(devices=["cpu"] * 2)


def decode(blob):
    d = Decoder(io.BytesIO(blob), DecodeOptions())
    return d.fastq() if d.h.has_quality else d.fasta()


digest = hashlib.md5()
for data, kw in ((mesh_giant_fasta(), {"block_bytes": 1 << 12}),
                 (mixed_fastq(seed=93, n_rec=151), {})):
    opts = EncodeOptions(level=1, **kw)
    host = encode(data, opts)[0]
    plain_t, parts_t, ext_t = {}, {}, {}
    assert MH.encode_multihost(data, opts, mesh=mesh, traffic=plain_t)[0] == host
    parts = MH.encode_multihost_parts(data, opts, parts_t, mesh=mesh)[0]
    ext = MH.encode_multihost_extended(data, opts, ext_t, mesh=mesh)[0]
    assert decode(parts) == decode(ext) == decode(host)
    assert ext_t["gathered_bytes"] < plain_t["gathered_bytes"]
    digest.update(parts + ext)
assert D.ROUTES == {"encode_multihost": 2, "encode_multihost:parts": 2,
                    "encode_multihost:extended": 2}, D.ROUTES
dist.destroy_process_group()
print(f"rank{rank}: OK DIGEST={digest.hexdigest()}")
"""


@pytest.mark.parametrize("nproc", [2, 3])
def test_multi_process_gloo(tmp_path, nproc):
    w = tmp_path / "worker.py"
    w.write_text(WORKER)
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    env["PYTHONPATH"] = os.pathsep.join([str(REPO), str(REPO / "tests")])
    env["OMP_NUM_THREADS"] = "1"
    port = _port()
    procs = [subprocess.Popen([sys.executable, str(w), str(port), str(r), str(nproc),
                               str(RANK_TIMEOUT // 2)], env=env, cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for r in range(nproc)]
    outs = []
    try:
        for p in procs:
            try:
                out, err = p.communicate(timeout=RANK_TIMEOUT)
            except subprocess.TimeoutExpired:
                pytest.fail("a multihost rank timed out")
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    digests = []
    for rc, out, err in outs:
        assert rc == 0, (out.decode()[-500:], err.decode()[-2000:])
        assert b": OK DIGEST=" in out
        digests.append(out.split(b"DIGEST=")[1].split()[0])
    assert len(set(digests)) == 1, "the ranks' archives differ"
