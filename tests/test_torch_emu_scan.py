"""The i32 add and max scan (csrc/scan.cu) under host emulation against
its plain PyTorch versions (emu_build.py): ragged lengths over tile edges
and the shared cases, aligned and unaligned.  Everything is integer:
tolerance 0."""

from __future__ import annotations

import pytest
import torch

from emu_build import emu_library, offset_tensor
from naf_tpu_torch.ops import scan_fused as SF
from naf_tpu_torch.ops.common import SCAN_TILE
from torch_cases import SCAN_CASES, scan_case, scan_input


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    return emu_library(tmp_path_factory, "scan")


@pytest.mark.parametrize("n", [1, SCAN_TILE - 1, SCAN_TILE + 1, 2 * SCAN_TILE + 17])
def test_scan_kernel_matches_plain(emu, n):
    for kind in ("bool", "u8", "i32"):
        x = scan_input(n, kind)
        for k in (0, 1):                            # aligned and unaligned input
            t = offset_tensor(x, k)
            assert torch.equal(SF.scan_i32_kernel(t, "add", lib=emu), SF.cumsum_i32_plain(t))
            assert torch.equal(SF.scan_i32_kernel(t, "max", lib=emu), SF.maxscan_i32_plain(t))


@pytest.mark.parametrize("op", ["add", "max"])
@pytest.mark.parametrize("case", SCAN_CASES)
def test_scan_kernel_cases(emu, case, op):
    plain = SF.cumsum_i32_plain if op == "add" else SF.maxscan_i32_plain
    for x in scan_case(case):
        for k in range(4):                          # aligned, and 1-3 elements past
            t = offset_tensor(x, k)
            assert torch.equal(SF.scan_i32_kernel(t, op, lib=emu), plain(t))
