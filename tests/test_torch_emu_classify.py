"""The standalone FASTA classify (csrc/classify.cu) under host emulation
against its plain PyTorch version (emu_build.py): every case and sequence
type, a ragged last tile, and each start state on an unaligned block.
Everything is integer or bytes: tolerance 0."""

from __future__ import annotations

import pytest
import torch

from emu_build import emu_library, host_tensor, offset_tensor
from naf_tpu_torch.ops import scan_fused as SF
from naf_tpu_torch.ops.common import TILE
from torch_cases import CLASSIFY_CASES, SEQ_TYPES, START_STATES, classify_case, fasta_start_states


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    return emu_library(tmp_path_factory, "classify")


@pytest.mark.parametrize("seq_type", SEQ_TYPES)
@pytest.mark.parametrize("case", CLASSIFY_CASES)
def test_classify_kernel_matches_plain(emu, case, seq_type):
    body, prev, sis = classify_case(case)
    for n in (body.size, body.size - 77):          # a ragged last tile too
        x = host_tensor(body[:n])
        flags, sval = SF.classify_fasta_kernel(x, prev, sis, seq_type=seq_type, lib=emu)
        f_ref, v_ref = SF.classify_fasta_plain(x, prev, sis, seq_type=seq_type)
        assert torch.equal(flags, f_ref) and torch.equal(sval, v_ref)


@pytest.mark.parametrize("prev,sis", START_STATES)
def test_classify_kernel_start_states(emu, prev, sis):
    """A block whose first byte is '>', 5 bytes past an aligned pointer and
    of a length that is not a multiple of 16."""
    x = offset_tensor(fasta_start_states()[:2 * TILE - 5], 5)
    flags, sval = SF.classify_fasta_kernel(x, prev, sis, lib=emu)
    f_ref, v_ref = SF.classify_fasta_plain(x, prev, sis)
    assert torch.equal(flags, f_ref) and torch.equal(sval, v_ref)
