"""naf_tpu_torch per-byte ops against the JAX package: pack, unpack, mask
parity and the FASTA classify.

Inputs are made from a seed with numpy and go through the JAX function
(Pallas in interpret mode) and the port's plain PyTorch version on the
CPU.  Everything is integer or bytes, so the tolerance is 0.  The kernels
themselves are held against these plain versions in test_torch_emu.py
(host emulation) and test_torch_cuda.py (on the card).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from naf_tpu.format import constants as C
from naf_tpu.ops.emit_fused import apply_mask_parity_pallas
from naf_tpu.ops.pack import pack_4bit_pallas
from naf_tpu.ops.scan_fused import _TILE, classify_fasta_fused
from naf_tpu.ops.unpack import unpack_4bit_pallas
from naf_tpu_torch.ops.emit_fused import apply_mask_parity
from naf_tpu_torch.ops.pack import pack_4bit
from naf_tpu_torch.ops.scan_fused import classify_fasta
from naf_tpu_torch.ops.tables import device_tables
from naf_tpu_torch.ops.unpack import unpack_4bit
from torch_cases import CLASSIFY_CASES, classify_case

CPU = torch.device("cpu")


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.uint8).copy())


def test_tables_match_the_jax_package():
    from naf_tpu.ops import tables as T

    for seq_type in (C.SEQ_TYPE_DNA, C.SEQ_TYPE_RNA):
        tabs = device_tables(seq_type, CPU)
        cls = tabs["cls"].numpy()
        assert np.array_equal((cls & 1) != 0, T.UNEXPECTED_BY_TYPE[seq_type][:256])
        assert np.array_equal((cls & 2) != 0, T.IS_UNEXPECTED_TEXT[:256])
        assert np.array_equal((cls & 4) != 0, T.IS_UNEXPECTED_COMMENT[:256])
        assert np.array_equal((cls & 8) != 0, T.IS_EOL[:256])
        assert np.array_equal(tabs["nuc_code"].numpy(), T.NUC_CODE)
        want = T.CODE_TO_NUC_RNA if seq_type == C.SEQ_TYPE_RNA else T.CODE_TO_NUC_DNA
        assert np.array_equal(tabs["code_to_nuc"].numpy(), want)
        assert tabs["repl_seq"] == C.REPLACEMENT_SEQ[seq_type]
        assert tabs["repl_name"] == C.REPLACEMENT_NAME


@pytest.mark.parametrize("alphabet", [b"ACGTacgtNnRYKMSWBDHVrykmswbdhv-Uu", None])
def test_pack_matches_pallas(alphabet):
    rng = np.random.default_rng(10)
    n = 4096
    if alphabet is None:            # all 256 byte values
        seq = rng.integers(0, 256, size=n, dtype=np.uint8)
        seq[:256] = np.arange(256)
    else:
        seq = rng.choice(np.frombuffer(alphabet, np.uint8), size=n)
    want = np.asarray(pack_4bit_pallas(jnp.asarray(seq), interpret=True))
    assert np.array_equal(pack_4bit(_t(seq)).numpy(), want)


@pytest.mark.parametrize("shift", [0, 1])
def test_pack_roll_and_fit_match_the_parallel_encoder(shift):
    """The roll on odd parity and the _fit padding of parallel/block.py."""
    rng = np.random.default_rng(11)
    sv = rng.choice(np.frombuffer(b"ACGTacgtN", np.uint8), size=2048)
    shifted = np.roll(sv, -shift)
    ref = np.asarray(pack_4bit_pallas(jnp.asarray(shifted), interpret=True))
    want = np.concatenate([ref, np.zeros(1, np.uint8)])
    got = pack_4bit(_t(sv), shift=shift, out_len=sv.size // 2 + 1).numpy()
    assert np.array_equal(got, want)


def test_pack_rejects_odd_length():
    with pytest.raises(ValueError):
        pack_4bit(torch.zeros(3, dtype=torch.uint8))


@pytest.mark.parametrize("rna", [False, True])
def test_unpack_matches_pallas(rna):
    rng = np.random.default_rng(12)
    packed = rng.integers(0, 256, size=2048, dtype=np.uint8)
    packed[:256] = np.arange(256)
    want = np.asarray(unpack_4bit_pallas(jnp.asarray(packed), rna=rna, interpret=True))
    assert np.array_equal(unpack_4bit(_t(packed), rna).numpy(), want)


@pytest.mark.parametrize("n", [_TILE - 3, _TILE + 5])
def test_mask_parity_matches_pallas(n):
    rng = np.random.default_rng(13)
    chars = rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=n)
    bounds = np.sort(rng.choice(n, size=300, replace=False))
    tog = np.zeros(n, np.uint8)
    np.add.at(tog, bounds, 1)
    tog[n // 2] += 2                # a collision keeps the parity
    tog[_TILE - 4] = 1              # single-char run across the tile edge
    tog[_TILE - 3 if n > _TILE else n - 1] += 1
    want = np.asarray(apply_mask_parity_pallas(jnp.asarray(chars), jnp.asarray(tog),
                                               interpret=True))
    assert np.array_equal(apply_mask_parity(_t(chars), _t(tog)).numpy(), want)


@pytest.mark.parametrize("seq_type", [C.SEQ_TYPE_DNA, C.SEQ_TYPE_RNA])
@pytest.mark.parametrize("case", CLASSIFY_CASES)
def test_classify_matches_pallas(case, seq_type):
    body, prev, sis = classify_case(case)
    f_ref, v_ref = classify_fasta_fused(jnp.asarray(body), jnp.asarray(np.uint8(prev)), sis,
                                        seq_type=seq_type, interpret=True)
    flags, sval = classify_fasta(_t(body), prev, sis, seq_type=seq_type)
    assert np.array_equal(flags.numpy(), np.asarray(f_ref))
    assert np.array_equal(sval.numpy(), np.asarray(v_ref))
