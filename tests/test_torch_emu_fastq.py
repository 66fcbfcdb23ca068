"""The FASTQ classify and emit (csrc/classify_fastq.cu, csrc/emit_fastq.cu)
under host emulation against their plain PyTorch versions (emu_build.py):
every case and sequence type, a case change at a tile's first kept byte,
and ragged lengths.  Everything is integer or bytes: tolerance 0."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from emu_build import assert_dicts_equal, emu_library, host_tensor, offset_tensor
from naf_tpu_torch.format import constants as C
from naf_tpu_torch.ops import emit_fused as EF
from naf_tpu_torch.ops import scan_fused as SF
from naf_tpu_torch.ops.common import Q_TILE
from torch_cases import (FASTQ_EMIT_CASES, fastq_case, fastq_case_change_behind_tile_start,
                         fastq_reads)


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    return emu_library(tmp_path_factory, "fastq")


@pytest.mark.parametrize("seq_type", [C.SEQ_TYPE_DNA, C.SEQ_TYPE_RNA])
@pytest.mark.parametrize("name", FASTQ_EMIT_CASES)
def test_fastq_kernels_match_plain(emu, name, seq_type):
    body = fastq_case(name)
    x = host_tensor(body)
    flags, sval = SF.classify_fastq_kernel(x, ord("@"), seq_type=seq_type, lib=emu)
    f_ref, v_ref = SF.classify_fastq_plain(x, ord("@"), seq_type=seq_type)
    assert torch.equal(flags, f_ref) and torch.equal(sval, v_ref)
    got = EF.emit_fastq_kernel(x, ord("@"), seq_type=seq_type, lib=emu)
    assert_dicts_equal(got, EF.emit_fastq_plain(x, ord("@"), seq_type=seq_type))
    if name == "sparse_overflow":
        assert not bool(got["sp_ok"])


@pytest.mark.parametrize("where", ["header", "quality"])
def test_emit_fastq_kernel_case_change_at_tile_first_kept_byte(emu, where):
    x = host_tensor(fastq_case_change_behind_tile_start(where))
    assert_dicts_equal(EF.emit_fastq_kernel(x, ord("@"), lib=emu),
                        EF.emit_fastq_plain(x, ord("@")))


@pytest.mark.parametrize("n", [1, 127, 129, Q_TILE - 1, Q_TILE + 1, 3 * Q_TILE + 333,
                               6 * Q_TILE + 16 * 99 + 5])
def test_fastq_kernels_ragged_lengths(emu, n):
    body = fastq_reads(np.random.default_rng(64 + n), 2 + n // 150,
                       alphabet=b"ACGTacgtN@+ \x01")[:n]
    for k in (0, 3):                               # aligned and unaligned input
        x = offset_tensor(body, k)
        for prev in (ord("@"), ord("\n")):
            f, v = SF.classify_fastq_kernel(x, prev, lib=emu)
            f_ref, v_ref = SF.classify_fastq_plain(x, prev)
            assert torch.equal(f, f_ref) and torch.equal(v, v_ref)
            assert_dicts_equal(EF.emit_fastq_kernel(x, prev, lib=emu),
                                EF.emit_fastq_plain(x, prev))
