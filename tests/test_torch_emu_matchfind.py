"""The match-candidate kernels (csrc/matchfind.cu) under host emulation
against their plain PyTorch versions (emu_build.py): the keys in both
modes over ragged window sizes, zero padding and the wrap at the padded
size, and the chain at depths 1-16 over span edges, runs longer than the
depth, the anchors' stride of 8 and a column of a wider row buffer.
Everything is integer: tolerance 0."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from emu_build import emu_library, offset_tensor
from naf_tpu_torch.ops import matchfind as MF
from torch_cases import MATCH_CHAIN_WINDOWS, MATCH_KEY_CASES, match_spans, match_window


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    return emu_library(tmp_path_factory, "matchfind")


@pytest.mark.parametrize("anchor", [False, True])
@pytest.mark.parametrize("size,cap", MATCH_KEY_CASES)
def test_match_keys_kernel_matches_plain(emu, size, cap, anchor):
    for kind in ("acgt", "random", "equal"):
        for k in (0, 3):                            # aligned, and 3 bytes past
            x = offset_tensor(match_window(size, size + cap, kind), k)
            got = MF.match_keys_kernel(x, cap, anchor=anchor, lib=emu)
            want = MF.match_keys_plain(x, cap, anchor=anchor)
            assert got.dtype == torch.int32 and got.numel() == (cap // 8 if anchor else cap)
            assert torch.equal(got, want)


def test_match_keys_wrap_and_padding(emu):
    """The last three keys read the window's start when it fills its
    padded size, and zeros when it does not; all-ones anchors."""
    x = torch.from_numpy(np.arange(1, 33, dtype=np.uint8))
    wrap = MF.match_keys_kernel(x, 32, lib=emu)
    pad = MF.match_keys_kernel(x, 40, lib=emu)
    assert torch.equal(wrap[:29], pad[:29]) and not torch.equal(wrap[29:32], pad[29:32])
    w = 31 | 32 << 8 | 1 << 16 | 2 << 24                      # position 30, wrapped
    assert int(wrap[30]) == (w * 2654435761 & 0xFFFFFFFF) >> 15
    ones = torch.full((64,), 0xFF, dtype=torch.uint8)
    assert torch.equal(MF.match_keys_kernel(ones, 64, anchor=True, lib=emu),
                       MF.match_keys_plain(ones, 64, anchor=True))


def _sorted_keys(size: int, cap: int, anchor: bool, kind: str, seed: int):
    x = torch.from_numpy(match_window(size, seed, kind))
    return torch.sort(MF.match_keys_plain(x, cap, anchor=anchor), stable=True)


@pytest.mark.parametrize("k", [1, 2, 3, 8, 16])
@pytest.mark.parametrize("kind,size,cap", MATCH_CHAIN_WINDOWS)
def test_match_chain_kernel_matches_plain(emu, kind, size, cap, k):
    sk, order = _sorted_keys(size, cap, False, kind, seed=k)
    for r0, r1 in match_spans(cap):
        for wlo in (0, 123_456):
            got = MF.match_chain_kernel(sk, order, k, r0, r1, wlo=wlo, lib=emu)
            want = MF.match_chain_plain(sk, order, k, r0, r1, wlo=wlo)
            assert got.shape == (r1 - r0, k) and torch.equal(got, want)
    if kind == "equal":            # one run of size - 3 positions, longer than the depth
        full = MF.match_chain_kernel(sk, order, k, 0, cap, lib=emu)
        assert (full[k:size - 3] >= 0).all() and (full[:k].min(1).values < 0).all()


@pytest.mark.parametrize("kind,size,cap", MATCH_CHAIN_WINDOWS)
def test_match_chain_kernel_anchors_and_columns(emu, kind, size, cap):
    """The anchor pass (stride 8, depth 1) into the last column of a row
    buffer whose other columns the kernel must leave alone, over spans that
    begin and end inside an anchor."""
    sk, order = _sorted_keys(size, cap, True, kind, seed=size)
    for r0, r1 in ((0, cap), (3, 29), (cap // 2 + 5, cap - 3)):
        got = torch.full((r1 - r0, 5), 7, dtype=torch.int32)
        want = got.clone()
        MF.match_chain_kernel(sk, order, 1, r0, r1, stride=8, wlo=4096, out=got, col=4, lib=emu)
        MF.match_chain_plain(sk, order, 1, r0, r1, stride=8, wlo=4096, out=want, col=4)
        assert torch.equal(got, want) and (got[:, :4] == 7).all()
