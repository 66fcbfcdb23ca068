"""The FASTA emit (csrc/emit_fasta.cu) under host emulation against its
plain PyTorch version (emu_build.py): every case, the start states, a case
change at a tile's first kept byte, and ragged lengths on aligned and
unaligned blocks.  Everything is integer or bytes: tolerance 0."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from emu_build import assert_dicts_equal, emu_library, host_tensor, offset_tensor
from naf_tpu_torch.ops import emit_fused as EF
from naf_tpu_torch.ops.common import TILE
from torch_cases import (FASTA_EMIT_CASES, START_STATES, case_change_behind_tile_start, emit_case,
                         fasta_start_states)


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    return emu_library(tmp_path_factory, "emit_fasta")


@pytest.mark.parametrize("name", FASTA_EMIT_CASES)
def test_emit_kernel_matches_plain(emu, name):
    body, prev, sis, seq_type = emit_case(name)
    x = host_tensor(body)
    got = EF.emit_fasta_kernel(x, prev, sis, seq_type=seq_type, lib=emu)
    want = EF.emit_fasta_plain(x, prev, sis, seq_type=seq_type)
    assert_dicts_equal(got, want)
    if name == "sparse_overflow":
        assert not bool(got["sp_ok"])


@pytest.mark.parametrize("prev,sis", START_STATES)
def test_emit_kernel_start_states(emu, prev, sis):
    """A block whose first byte is '>': a marker only after a line end."""
    x = offset_tensor(fasta_start_states(), 5)
    assert_dicts_equal(EF.emit_fasta_kernel(x, prev, sis, lib=emu),
                        EF.emit_fasta_plain(x, prev, sis))


def test_emit_kernel_case_change_at_tile_first_kept_byte(emu):
    x = host_tensor(case_change_behind_tile_start())
    assert_dicts_equal(EF.emit_fasta_kernel(x, ord(">"), lib=emu),
                        EF.emit_fasta_plain(x, ord(">")))


@pytest.mark.parametrize("n", [1, 127, 129, TILE - 1, TILE + 1, 2 * TILE + 333])
def test_emit_kernel_ragged_lengths(emu, n):
    rng = np.random.default_rng(60 + n)
    pool = np.frombuffer(b">ACGTNacgtn \t\r\n" + b"xyz*\x01", np.uint8)
    body = rng.choice(pool, size=n)
    for k in (0, 3):                               # aligned and unaligned input
        x = offset_tensor(body, k)
        assert_dicts_equal(EF.emit_fasta_kernel(x, ord(">"), lib=emu),
                            EF.emit_fasta_plain(x, ord(">")))
