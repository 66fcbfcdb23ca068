"""The match-candidate kernels (csrc/matchfind.cu) under host emulation
against their plain PyTorch versions (emu_build.py): the keys in both
modes over ragged window sizes, zero padding and the wrap at the padded
size, and the chain at depths 1-16 over span edges, runs longer than the
depth, the anchors' stride of 8 and a column of a wider row buffer; then
the edges of the kernels' own tiles (every src offset from a 16-byte
boundary, runs across chain tiles, order 8 bytes off).  Everything is
integer: tolerance 0."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from emu_build import emu_library, offset_tensor
from naf_tpu_torch.ops import matchfind as MF
from torch_cases import (MATCH_CHAIN_TILE, MATCH_CHAIN_WINDOWS, MATCH_KEY_CASES, MATCH_KEYS_TILE,
                         match_sorted_runs, match_spans, match_tile_spans, match_window)


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


@pytest.mark.parametrize("anchor", [False, True])
def test_match_keys_tile_edges(emu, anchor):
    """src 0-15 bytes past a 16-byte boundary over three keys tiles and a
    ragged end: a size that is no multiple of 16 filling its padded size
    (mode 0 wraps at cap) or padded past it, with a tile wholly in the pad."""
    t = MATCH_KEYS_TILE
    size = 2 * t + 21
    caps = (2 * t + 24, 2 * t + 40, 5 * t) if anchor else (size, 5 * t)
    for cap in caps:
        n = min(size, cap)
        for off in range(16):
            x = offset_tensor(match_window(n, off, "random"), off)
            assert torch.equal(MF.match_keys_kernel(x, cap, anchor=anchor, lib=emu),
                               MF.match_keys_plain(x, cap, anchor=anchor))


def _edge_input(shuffled: bool, off: int):
    sk, order = match_sorted_runs(2 * MATCH_CHAIN_TILE + 1000, 17, shuffled)
    return offset_tensor(sk, off), offset_tensor(order, off)


@pytest.mark.parametrize("shuffled", [False, True])
@pytest.mark.parametrize("k", [5, 16, 40])
def test_match_chain_tile_edges(emu, shuffled, k):
    """Runs across chain tiles, spans inside one tile or across an edge,
    tiles with no span entry, order 8 bytes past a 16-byte boundary (its
    tiles then start one entry early); unshuffled, the rows just past the
    first edge reach back into the tile before it.  A depth over 32 takes
    the kernel's columns 32 at a time."""
    for off in (0, 1):
        sk, order = _edge_input(shuffled, off)
        for r0, r1 in match_tile_spans(sk.numel()):
            got = MF.match_chain_kernel(sk, order, k, r0, r1, wlo=77, lib=emu)
            assert torch.equal(got, MF.match_chain_plain(sk, order, k, r0, r1, wlo=77))
            if not shuffled and r0 == MATCH_CHAIN_TILE - 8:
                e = MATCH_CHAIN_TILE - r0
                assert got[e, k - 1] == MATCH_CHAIN_TILE - k + 77


@pytest.mark.parametrize("shuffled", [False, True])
@pytest.mark.parametrize("k", [1, 3])
def test_match_chain_anchor_columns_tile_edges(emu, shuffled, k):
    """Stride 8 into columns 2..2+k of a wider row buffer over the same tile
    edges, spans starting and ending inside an anchor; the other columns
    keep their values."""
    for off in (0, 1):
        sk, order = _edge_input(shuffled, off)
        for r0, r1 in match_tile_spans(sk.numel(), 8):
            got = torch.full((r1 - r0, k + 4), 7, dtype=torch.int32)
            want = got.clone()
            MF.match_chain_kernel(sk, order, k, r0, r1, stride=8, wlo=4096, out=got, col=2,
                                  lib=emu)
            MF.match_chain_plain(sk, order, k, r0, r1, stride=8, wlo=4096, out=want, col=2)
            assert torch.equal(got, want)
            assert (got[:, :2] == 7).all() and (got[:, 2 + k:] == 7).all()
