"""The pack, unpack and mask parity kernels (csrc/pack.cu, csrc/unpack.cu,
csrc/mask_parity.cu) under host emulation against their plain PyTorch
versions (emu_build.py); every launcher's refusal of host tensors without
the emulation; and the emulation families' cover of every kernel source.
Everything is integer or bytes: tolerance 0."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

from emu_build import FAMILIES, emu_library, offset_tensor
from naf_tpu_torch.native import build
from naf_tpu_torch.ops import compact as CP
from naf_tpu_torch.ops import emit_fused as EF
from naf_tpu_torch.ops import matchfind as MF
from naf_tpu_torch.ops import pack as PK
from naf_tpu_torch.ops import scan_fused as SF
from naf_tpu_torch.ops import unpack as UP
from naf_tpu_torch.ops.common import TILE
from torch_cases import MASK_PARITY_CASES, mask_parity_input


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    return emu_library(tmp_path_factory, "render")


@pytest.mark.parametrize("n", [0, 2, 16, 30, 256, 1000, TILE + 18])
def test_pack_kernel_matches_plain(emu, n):
    rng = np.random.default_rng(61)
    seq = rng.integers(0, 256, size=n, dtype=np.uint8)
    seq[: min(n, 256)] = np.arange(min(n, 256))
    for shift in (0, 1):
        for out_len in (n // 2, n // 2 + 1, n // 2 + 13):
            for k in (0, 5):
                x = offset_tensor(seq, k)
                got = PK.pack_4bit_kernel(x, shift=shift, out_len=out_len, lib=emu)
                assert torch.equal(got, PK.pack_4bit_plain(x, shift=shift, out_len=out_len))


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 1000, 4096 + 3])
def test_unpack_kernel_matches_plain(emu, n):
    rng = np.random.default_rng(62)
    packed = rng.integers(0, 256, size=n, dtype=np.uint8)
    packed[: min(n, 256)] = np.arange(min(n, 256))
    for rna in (False, True):
        for k in (0, 1):
            x = offset_tensor(packed, k)
            assert torch.equal(UP.unpack_4bit_kernel(x, rna, lib=emu),
                               UP.unpack_4bit_plain(x, rna))


@pytest.mark.parametrize("case", [1, 128, 1000, TILE - 3, TILE + 5, 2 * TILE + 1,
                                  *MASK_PARITY_CASES])
def test_mask_parity_kernel_matches_plain(emu, case):
    chars, tog = mask_parity_input(case)
    for k in (0, 7):                               # aligned, and 7 bytes past
        c, t = offset_tensor(chars, k), offset_tensor(tog, k)
        assert torch.equal(EF.apply_mask_parity_kernel(c, t, lib=emu),
                           EF.apply_mask_parity_plain(c, t))


def test_launchers_refuse_host_tensors_without_the_emulation():
    x = torch.zeros(256, dtype=torch.uint8)
    keys, order = torch.zeros(256, dtype=torch.int32), torch.arange(256)
    for launch in (lambda: PK.pack_4bit_kernel(x), lambda: UP.unpack_4bit_kernel(x),
                   lambda: SF.classify_fasta_kernel(x, ord(">")),
                   lambda: EF.emit_fasta_kernel(x, ord(">")),
                   lambda: EF.apply_mask_parity_kernel(x, x),
                   lambda: SF.classify_fastq_kernel(x, ord("@")),
                   lambda: EF.emit_fastq_kernel(x, ord("@")),
                   lambda: SF.scan_i32_kernel(x, "add"), lambda: SF.scan_i32_kernel(x, "max"),
                   lambda: CP.compact_kernel(x, x), lambda: CP.compact_kernel(x, x, dense=True),
                   lambda: MF.match_keys_kernel(x, 256),
                   lambda: MF.match_chain_kernel(keys, order, 2, 0, 256)):
        with pytest.raises(ValueError, match="CUDA tensors"):
            launch()


def test_emulation_families_cover_every_kernel_source():
    """Every csrc/*.cu is built and run by one test_torch_emu_<family>.py."""
    stems = [s for family in FAMILIES.values() for s in family]
    assert sorted(stems) == sorted(p.stem for p in build.sources() if p.suffix == ".cu")
    for family in FAMILIES:
        assert (Path(__file__).parent / f"test_torch_emu_{family}.py").exists(), family
