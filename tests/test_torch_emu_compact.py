"""The stream compaction (csrc/compact.cu) under host emulation against
its plain PyTorch version (emu_build.py): u8 and i32 values over tile
edges, aligned, unaligned and unaligned apart.  Everything is integer or
bytes: tolerance 0."""

from __future__ import annotations

import pytest
import torch

from emu_build import emu_library, offset_tensor
from naf_tpu_torch.ops import compact as CP
from naf_tpu_torch.ops.common import SCAN_TILE
from torch_cases import COMPACT_CASES, compact_case


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    return emu_library(tmp_path_factory, "compact")


@pytest.mark.parametrize("n", [1, 130, SCAN_TILE + 1, 3 * SCAN_TILE - 5, *COMPACT_CASES])
def test_compact_kernel_matches_plain(emu, n):
    for kind in ("u8", "i32"):
        v, keep = compact_case(n, kind)
        # aligned, unaligned, and values and flags unaligned apart
        for kv, kk in ((0, 0), (3, 3), (1, 6)):
            vt, kt = offset_tensor(v, kv), offset_tensor(keep, kk)
            # both wrappers launch the one kernel; only the counter differs
            out, cnt = CP.compact_kernel(vt, kt, dense=kv > 0, lib=emu)
            want, want_cnt = CP.compact_plain(vt, kt)
            assert torch.equal(out, want) and int(cnt) == int(want_cnt)
