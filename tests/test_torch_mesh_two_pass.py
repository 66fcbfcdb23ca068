"""naf_tpu_torch's encode over a block mesh against naf_tpu's, on the CPU:
the FASTQ and two-pass inputs (torch_cases.py ``MESH_TWO_PASS_CASES``).

At D in (2, 3, 8) CPU blocks, ``encode_device(mesh=...)`` gives the archive
and ``EncodeStats`` of naf_tpu's ``encode_sharded`` on its D-device CPU
mesh and of the port's host ``encode()``, by the route each input takes at
every D: the fused FASTQ path, the protein two-pass, and FASTA and FASTQ
past the fused emits' sparse cap.  Tolerance 0.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from naf_tpu.parallel import pipeline as RP
from naf_tpu.parallel.mesh import block_mesh as ref_mesh
from naf_tpu.pipeline import encoder as RENC
from naf_tpu_torch import device as D
from naf_tpu_torch.parallel.mesh import block_mesh
from naf_tpu_torch.parallel.pipeline import encode_device
from naf_tpu_torch.pipeline.encoder import EncodeOptions, encode

from torch_cases import MESH_SIZES, MESH_TWO_PASS_CASES


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its plain versions are
    many small ops, and the suite runs several workers on the machine's
    cores, which full thread pools each would oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n", MESH_SIZES)
@pytest.mark.parametrize("name", list(MESH_TWO_PASS_CASES))
def test_mesh_encode_equals_sharded_and_host(name, n):
    make, kw, route = MESH_TWO_PASS_CASES[name]
    data, opts = make(), EncodeOptions(**kw)
    D.reset_counts()
    blob, stats = encode_device(data, opts, mesh=block_mesh(devices=["cpu"] * n))
    assert D.ROUTES == {route: 1}
    host_blob, host_stats = encode(data, opts)
    ref_blob, ref_stats = RP.encode_sharded(data, RENC.EncodeOptions(**kw), mesh=ref_mesh(n))
    assert blob == host_blob == ref_blob
    for field in ("n_sequences", "longest_line", "seq_size_original", "in_format"):
        assert getattr(stats, field) == getattr(host_stats, field) == getattr(ref_stats, field)
    for field in ("unexpected_id", "unexpected_comment", "unexpected_seq", "unexpected_qual"):
        assert np.array_equal(getattr(stats, field), getattr(ref_stats, field)), field
