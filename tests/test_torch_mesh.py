"""naf_tpu_torch's encode over a block mesh (parallel/mesh.py) against
naf_tpu's, on the CPU.

At D in (2, 3, 8) blocks (a mesh listing the CPU D times),
``encode_device(mesh=...)`` gives the archive of naf_tpu's
``encode_sharded`` on its D-device CPU mesh (tests/conftest.py's virtual
devices; the two-pass protocol there) and of the port's host ``encode()``,
and the same ``EncodeStats``, by the route each input takes at every D:
the fused FASTA path, ``unexpected_chars``, a clean ``--strict`` input,
and one record over every block whose blocks start inside mask runs and
at odd nibble parity (torch_cases.py ``MESH_FASTA_CASES``; the FASTQ and
two-pass inputs are in test_torch_mesh_two_pass.py).  ``--strict`` on a
dirty input raises naf_tpu's message.
Everything is bytes and integers: tolerance 0.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from naf_tpu.parallel import pipeline as RP
from naf_tpu.parallel.mesh import block_mesh as ref_mesh
from naf_tpu.pipeline import encoder as RENC
from naf_tpu.pipeline.parser import InputError as RefInputError
from naf_tpu_torch import device as D
from naf_tpu_torch.parallel.block import make_blocks
from naf_tpu_torch.parallel.mesh import block_mesh
from naf_tpu_torch.parallel.pipeline import encode_device
from naf_tpu_torch.pipeline.encoder import EncodeOptions, encode
from naf_tpu_torch.pipeline.parser import InputError

from torch_cases import MESH_FASTA_CASES, MESH_SIZES, mesh_giant_fasta


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its plain versions are
    many small ops, and the suite runs several workers on the machine's
    cores, which full thread pools each would oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cpu_mesh(n: int):
    return block_mesh(devices=["cpu"] * n)


@pytest.mark.parametrize("n", MESH_SIZES)
@pytest.mark.parametrize("name", list(MESH_FASTA_CASES))
def test_mesh_encode_equals_sharded_and_host(name, n):
    make, kw, route = MESH_FASTA_CASES[name]
    data, opts = make(), EncodeOptions(**kw)
    D.reset_counts()
    blob, stats = encode_device(data, opts, mesh=_cpu_mesh(n))
    assert D.ROUTES == {route: 1}
    host_blob, host_stats = encode(data, opts)
    ref_blob, ref_stats = RP.encode_sharded(data, RENC.EncodeOptions(**kw), mesh=ref_mesh(n))
    assert blob == host_blob == ref_blob
    for field in ("n_sequences", "longest_line", "seq_size_original", "in_format"):
        assert getattr(stats, field) == getattr(host_stats, field) == getattr(ref_stats, field)
    for field in ("unexpected_id", "unexpected_comment", "unexpected_seq", "unexpected_qual"):
        assert np.array_equal(getattr(stats, field), getattr(ref_stats, field)), field


@pytest.mark.parametrize("n", MESH_SIZES)
def test_giant_record_blocks_start_in_mask_runs_at_odd_parity(n):
    """Some cut of the giant record falls inside a lowercase run, and some
    block after the first starts at odd nibble parity."""
    data = mesh_giant_fasta()
    header, rest = data[1:].split(b"\n", 1)
    seq = rest.split(b">tail1")[0].replace(b"\n", b"")
    blocks = make_blocks(np.frombuffer(data, np.uint8)[1:], n)
    # sequence chars before each block: its rows' bytes but the LFs and the header
    before = np.cumsum([(row != ord("\n")).sum() for row in blocks.data])[:-1] - len(header)
    assert any(int(p) % 2 for p in before)
    assert any(seq[p - 1:p + 1].islower() for p in before if 0 < p < len(seq))


@pytest.mark.parametrize("n", MESH_SIZES)
def test_mesh_strict_dirty_raises_as_naf_tpu(n):
    data = b">a\nACGTZGGG\nACGT\n>b\nTTTT\n" * 4
    opts = EncodeOptions(strict=True)
    with pytest.raises(RefInputError) as ref:
        RP.encode_sharded(data, RENC.EncodeOptions(strict=True), mesh=ref_mesh(n))
    D.reset_counts()
    with pytest.raises(InputError) as got:
        encode_device(data, opts, mesh=_cpu_mesh(n))
    assert str(got.value) == str(ref.value)
    assert D.ROUTES == {"encode_host:strict_unexpected": 1}
