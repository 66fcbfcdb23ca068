"""naf_tpu_torch's fused FASTA emit against the JAX package's
emit_fasta_fused (Pallas in interpret mode).

Inputs come from a seed with numpy; every case is LF-padded to one length
so the JAX kernel compiles once per sequence type.  Comparisons are exact:
sv[:cnt], sp_tv[:n_sp], sp_a[:n_sp], every scalar, and zeros past the
counts.  One input shows where the port departs from the reference on
purpose (a case change at a tile's first kept byte when that byte is not
the tile's first byte): there the port is held against the scan-based
oracle of test_emit_fused.py and the archive against host encode().
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from naf_tpu.format import constants as C
from naf_tpu.ops import emit_fused as E
from naf_tpu.pipeline.encoder import EncodeOptions, encode
from naf_tpu_torch.ops.emit_fused import CS_CAP, emit_fasta_fused
from naf_tpu_torch.parallel.pipeline import encode_device
from test_emit_fused import _oracle
from torch_cases import EMIT_CASES, case_change_behind_tile_start, emit_case



def _ref(body, prev, sis, seq_type):
    r = E.emit_fasta_fused(jnp.asarray(body), jnp.asarray(np.uint8(prev)), sis,
                           seq_type=seq_type, interpret=True)
    return {k: np.asarray(v) for k, v in r.items()}


def _port(body, prev, sis, seq_type):
    r = emit_fasta_fused(torch.from_numpy(body.copy()), prev, sis, seq_type=seq_type)
    return {k: v.numpy() for k, v in r.items()}


SCALARS = ("cnt", "cnt_seq", "n_sp", "sp_ok", "unex_id", "unex_com", "unex_seq", "longest",
           "first_lower", "first_sval")


def _assert_same(ref, got, *, sparse=True):
    for k in SCALARS:
        assert int(got[k]) == int(ref[k]), k
    cnt, n_sp = int(ref["cnt"]), int(ref["n_sp"])
    assert got["sv"].shape == ref["sv"].shape
    assert np.array_equal(got["sv"][:cnt], ref["sv"][:cnt])
    assert not got["sv"][cnt:].any()
    assert got["sp_tv"].shape == ref["sp_tv"].shape
    if sparse:
        assert np.array_equal(got["sp_tv"][:n_sp], ref["sp_tv"][:n_sp])
        assert np.array_equal(got["sp_a"][:n_sp], ref["sp_a"][:n_sp])
    assert not got["sp_tv"][n_sp:].any() and not got["sp_a"][n_sp:].any()


@pytest.mark.parametrize("name", EMIT_CASES)
def test_emit_matches_pallas(name):
    body, prev, sis, seq_type = emit_case(name)
    ref = _ref(body, prev, sis, seq_type)
    got = _port(body, prev, sis, seq_type)
    if name == "sparse_overflow":
        assert not bool(ref["sp_ok"])
    # past the cap the TPU merge leaves its sparse arrays unspecified
    _assert_same(ref, got, sparse=bool(ref["sp_ok"]))


def test_case_change_at_tile_first_kept_byte():
    body = case_change_behind_tile_start()
    got = _port(body, ord(">"), False, C.SEQ_TYPE_DNA)
    want = _oracle(body, ord(">"))
    n_sp = int(got["n_sp"])
    tv = got["sp_tv"][:n_sp]
    assert np.array_equal(tv >> 8, want["tags"])
    assert np.array_equal(tv & 0xFF, want["vals"])
    assert np.array_equal(got["sp_a"][:n_sp], want["avals"])
    assert int(got["cnt"]) == want["cnt"]
    assert np.array_equal(got["sv"][:want["cnt"]], want["sv"])
    data = b">" + body.tobytes()
    assert encode_device(data, device="cpu")[0] == encode(data, EncodeOptions())[0]


def test_sparse_cap_is_the_reference_cap():
    assert CS_CAP == E._CS_CAP
