"""Device LZ match-candidate finding: the port of ``naf_tpu/ops/matchfind.py``.

For every position of a window, the k nearest earlier positions whose
4-byte window hashes to the same key, found with a sort instead of a hash
table:

    keys      = hash32(window4(data))        # naf_match_keys
    sk, order = torch.sort(keys, stable)     # the one library call
    cand[p,j] = j-th previous position in p's equal-key run   # naf_match_chain

Hash collisions are harmless: the host serializer
(``native/naf_zstd.cpp:naf_zstd_compress_cand_stream``) verifies the bytes
of every candidate before it uses one.  ``--long`` adds an anchor pass: one
key per 8-byte anchor, each anchor proposing its nearest equal-key
predecessor, the positions inside an anchor inheriting it plus their
offset.  ``codec.zstd_backend.compress_section_device`` runs the span
pipeline (``span_candidates``) on the card.

Each step has a plain PyTorch version (``*_plain``) and a kernel launcher
(``*_kernel``, ``csrc/matchfind.cu``); a CUDA tensor runs the kernel and a
CPU tensor the plain version.  The numpy entry points take the JAX
package's signatures and results (int32, absolute positions, -1 for none)
plus ``device=``.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..device import LAUNCHES, resolve
from ..native import build
from .common import check_1d

#: candidate chain depth proposed per position
TOP_K = 4

#: serialized span; must be a multiple of the zstd 128 KB block size
SPAN = 4 << 20

_MUL0, _MUL1, _MASK = 2654435761, 2246822519, 0xFFFFFFFF


def _pow2(n: int, lo: int = 1 << 16) -> int:
    m = lo
    while m < n:
        m *= 2
    return m


# ---------------------------------------------------------------------------
# keys
# ---------------------------------------------------------------------------

def _check_keys(win: torch.Tensor, cap: int, anchor: bool) -> int:
    check_1d(win, torch.uint8, "win")
    if not win.numel() <= cap or anchor and cap % 8:
        raise ValueError(f"a window of {win.numel()} bytes cannot pad to {cap}"
                         + (" (anchors need a multiple of 8)" if anchor else ""))
    return cap // 8 if anchor else cap


def _as_i32(k: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the int32 with the same 32 bits."""
    return (k - ((k >> 31) << 32)).to(torch.int32)


def match_keys_plain(win: torch.Tensor, cap: int, *, anchor: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the keys kernel."""
    _check_keys(win, cap, anchor)
    d = torch.zeros(cap, dtype=torch.int64, device=win.device)
    d[:win.numel()] = win
    if anchor:
        d = d.view(-1, 8)
        w0 = d[:, 0] | d[:, 1] << 8 | d[:, 2] << 16 | d[:, 3] << 24
        w1 = d[:, 4] | d[:, 5] << 8 | d[:, 6] << 16 | d[:, 7] << 24
        # int64 products wrap in two's complement: the low word is exact
        return _as_i32(((w0 * _MUL0) ^ (w1 * _MUL1)) & _MASK)
    w = d | torch.roll(d, -1) << 8 | torch.roll(d, -2) << 16 | torch.roll(d, -3) << 24
    return _as_i32(((w * _MUL0) & _MASK) >> 15)


def match_keys_kernel(win: torch.Tensor, cap: int, *, anchor: bool = False,
                      lib=None) -> torch.Tensor:
    """Launch the keys kernel (``lib`` as in ``scan_fused.classify_fasta_kernel``)."""
    n_keys = _check_keys(win, cap, anchor)
    lib = build.kernel_lib(win, lib)
    keys = torch.empty(n_keys, dtype=torch.int32, device=win.device)
    if n_keys:
        build.call(lib, "naf_match_keys", win, win.data_ptr(), win.numel(), cap, int(anchor),
                   keys.data_ptr(), build.stream_of(win))
        LAUNCHES["match_keys"] += 1
    return keys


def match_keys(win: torch.Tensor, cap: int, *, anchor: bool = False) -> torch.Tensor:
    """int32 keys of the window ``win`` zero-padded to ``cap`` bytes: one a
    position (its 4-byte window, wrapping at ``cap``, hashed to 17 bits),
    or with ``anchor`` one an 8-byte anchor (the uint32 hash's bits).  A
    CUDA tensor runs the kernel; a CPU tensor the plain version."""
    if win.is_cuda:
        return match_keys_kernel(win, cap, anchor=anchor)
    return match_keys_plain(win, cap, anchor=anchor)


# ---------------------------------------------------------------------------
# candidate chains
# ---------------------------------------------------------------------------

def _check_chain(sk, order, k: int, r0: int, r1: int, stride: int, out, col: int):
    check_1d(sk, torch.int32, "sk")
    check_1d(order, torch.int64, "order")
    if order.numel() != sk.numel() or order.device != sk.device:
        raise ValueError("sk and order must be one sort's values and indices")
    if k < 1 or stride < 1 or not 0 <= r0 <= r1 <= sk.numel() * stride:
        raise ValueError(f"bad chain arguments k={k} stride={stride} span=[{r0}, {r1})")
    if out is None:
        return torch.empty((r1 - r0, k), dtype=torch.int32, device=sk.device)
    if (out.dtype != torch.int32 or out.dim() != 2 or not out.is_contiguous()
            or out.shape[0] != r1 - r0 or col + k > out.shape[1] or out.device != sk.device):
        raise ValueError(f"out must be a contiguous int32 [{r1 - r0}, >= {col + k}] tensor "
                         f"on {sk.device}")
    return out


def match_chain_plain(sk: torch.Tensor, order: torch.Tensor, k: int, r0: int, r1: int, *,
                      stride: int = 1, wlo: int = 0, out: torch.Tensor | None = None,
                      col: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the chain kernel."""
    out = _check_chain(sk, order, k, r0, r1, stride, out, col)
    idx = torch.nonzero(((order + 1) * stride > r0) & (order * stride < r1)).squeeze(1)
    key = sk[idx]
    cols = []
    for j in range(1, k + 1):
        prev = (idx - j).clamp(min=0)
        same = (idx >= j) & (sk[prev] == key)
        cols.append(torch.where(same, order[prev], -1))
    c = torch.stack(cols, 1)[:, None, :]                              # [rows, 1, k]
    o = torch.arange(stride, device=sk.device)
    q = (order[idx][:, None] * stride + o).reshape(-1)               # [rows * stride]
    v = torch.where(c >= 0, c * stride + o[None, :, None] + wlo, -1).reshape(-1, k)
    inside = (q >= r0) & (q < r1)
    out[q[inside] - r0, col:col + k] = v[inside].to(torch.int32)
    return out


def match_chain_kernel(sk: torch.Tensor, order: torch.Tensor, k: int, r0: int, r1: int, *,
                       stride: int = 1, wlo: int = 0, out: torch.Tensor | None = None,
                       col: int = 0, lib=None) -> torch.Tensor:
    """Launch the chain kernel (``lib`` as in ``scan_fused.classify_fasta_kernel``)."""
    out = _check_chain(sk, order, k, r0, r1, stride, out, col)
    lib = build.kernel_lib(sk, lib)
    if sk.numel() and r1 > r0:
        build.call(lib, "naf_match_chain", sk, sk.data_ptr(), order.data_ptr(), sk.numel(), k,
                   stride, r0, r1, wlo, out.data_ptr() + 4 * col, out.shape[1],
                   build.stream_of(sk))
        LAUNCHES["match_chain"] += 1
    return out


def match_chain(sk: torch.Tensor, order: torch.Tensor, k: int, r0: int, r1: int, *,
                stride: int = 1, wlo: int = 0, out: torch.Tensor | None = None,
                col: int = 0) -> torch.Tensor:
    """Candidates of the positions [r0, r1) of a window from the stable
    sort (``sk``, ``order``) of its keys, each key standing for ``stride``
    positions: int32[r1 - r0, k] (or columns ``col:col+k`` of ``out``),
    the k nearest earlier equal-key positions plus ``wlo``, nearest first,
    -1 padded.  A CUDA tensor runs the kernel; a CPU tensor the plain
    version."""
    fn = match_chain_kernel if sk.is_cuda else match_chain_plain
    return fn(sk, order, k, r0, r1, stride=stride, wlo=wlo, out=out, col=col)


# ---------------------------------------------------------------------------
# windows and spans
# ---------------------------------------------------------------------------

class StageTimer:
    """CUDA events between the stages of ``span_candidates`` on the current
    stream (nothing when off): ``ms()`` is each stage's device ms, summed
    over the stages of that name."""

    def __init__(self, on: bool):
        self._events: list = []
        if on:
            self.mark(None)

    def mark(self, name) -> None:
        if self._events or name is None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._events.append((name, ev))

    def ms(self) -> dict:
        out: dict = {}
        if self._events:
            self._events[-1][1].synchronize()
        for (_, a), (name, b) in zip(self._events, self._events[1:]):
            out[name] = out.get(name, 0.0) + a.elapsed_time(b)
        return out


_OFF = StageTimer(False)


def upload(data, device) -> torch.Tensor:
    """The bytes of ``data`` as a u8 tensor on ``device`` (read only: on the
    CPU it shares the buffer)."""
    mv = memoryview(data).cast("B")
    if not mv.nbytes:
        return torch.zeros(0, dtype=torch.uint8, device=device)
    with warnings.catch_warnings():     # a read-only buffer: nothing writes it
        warnings.simplefilter("ignore", UserWarning)
        t = torch.frombuffer(mv, dtype=torch.uint8)
    return t.to(device)


def _window_chain(win: torch.Tensor, cap: int, k: int, r0: int, r1: int, *, anchor: bool,
                  wlo: int, out=None, col: int = 0, marks: StageTimer = _OFF,
                  plain: bool = False) -> torch.Tensor:
    keys = (match_keys_plain if plain else match_keys)(win, cap, anchor=anchor)
    marks.mark("keys")
    sk, order = torch.sort(keys, stable=True)
    del keys
    marks.mark("sort")
    out = (match_chain_plain if plain else match_chain)(
        sk, order, k, r0, r1, stride=8 if anchor else 1, wlo=wlo, out=out, col=col)
    marks.mark("chain")
    return out


def span_candidates(sec: torch.Tensor, lo: int, hi: int, k: int, hist: int, ldm_hist: int = 0,
                    *, marks: StageTimer = _OFF, plain: bool = False) -> torch.Tensor:
    """int32[hi-lo, k (+1 with ``ldm_hist``)] absolute candidates of the
    positions [lo, hi) of the section ``sec`` (a u8 tensor): k from the
    window ``sec[max(0, lo-hist):hi]``, then the anchor pass's one over
    ``sec[max(0, lo-ldm_hist) & ~7:hi]`` when ``ldm_hist``.  The columns
    of ``find_match_candidates_windowed`` and ``find_ldm_candidates``.
    ``plain`` runs the plain versions whatever the device (the card's
    check of its kernels)."""
    out = torch.empty((hi - lo, k + (1 if ldm_hist else 0)), dtype=torch.int32,
                      device=sec.device)
    wlo = max(0, lo - hist)
    if hi - wlo < 16:
        out[:, :k] = -1
    else:
        _window_chain(sec[wlo:hi], _pow2(hi - wlo), k, lo - wlo, hi - wlo, anchor=False,
                      wlo=wlo, out=out, marks=marks, plain=plain)
    if ldm_hist:
        wlo = max(0, lo - ldm_hist) & ~7
        if hi - wlo < 64:
            out[:, k] = -1
        else:
            _window_chain(sec[wlo:hi], _pow2(hi - wlo), 1, lo - wlo, hi - wlo, anchor=True,
                          wlo=wlo, out=out, col=k, marks=marks, plain=plain)
    return out


def find_match_candidates(data: np.ndarray, k: int = 1, *, device="cuda") -> np.ndarray:
    """int32[n, k] (or [n] when k == 1): closest earlier same-window
    positions, nearest first, -1 padded; the windows wrap at n."""
    data = np.ascontiguousarray(data, dtype=np.uint8)
    if data.size < 16:
        out = np.full((data.size, k), -1, np.int32)
    else:
        x = upload(data, resolve(device))
        out = _window_chain(x, data.size, k, 0, data.size, anchor=False, wlo=0).cpu().numpy()
    return out[:, 0] if k == 1 else out


def _rebase(rel: torch.Tensor, wlo: int) -> np.ndarray:
    """Window-relative candidates -> absolute, -1 kept."""
    a = rel.cpu().numpy()
    return np.where(a >= 0, a.astype(np.int64) + wlo, -1).astype(np.int32) if wlo else a


def find_match_candidates_windowed(data: np.ndarray, k: int, lo: int, hi: int,
                                   hist: int = SPAN, *, device="cuda") -> np.ndarray:
    """Absolute int32[hi-lo, k] candidates for positions [lo, hi), matched
    within ``data[max(0, lo-hist):hi]`` zero-padded to a power of two."""
    wlo = max(0, lo - hist)
    x = upload(np.ascontiguousarray(data[wlo:hi], dtype=np.uint8), resolve(device))
    return _rebase(span_candidates(x, lo - wlo, hi - wlo, k, hist), wlo)


def find_ldm_candidates(data: np.ndarray, lo: int, hi: int, hist: int = 64 << 20, *,
                        device="cuda") -> np.ndarray:
    """Absolute int32[hi-lo] long-range candidate per position for
    [lo, hi): each 8-byte-aligned anchor of ``data[max(0, lo-hist) & ~7:hi]``
    proposes its closest equal-hash predecessor, and the positions inside
    it inherit anchor + offset (the serializer verifies every proposal)."""
    wlo = max(0, lo - hist) & ~7
    x = upload(np.ascontiguousarray(data[wlo:hi], dtype=np.uint8), resolve(device))
    out = torch.empty((hi - lo, 1), dtype=torch.int32, device=x.device)
    if hi - wlo < 64:
        out[:] = -1
    else:
        _window_chain(x, _pow2(hi - wlo), 1, lo - wlo, hi - wlo, anchor=True, wlo=0, out=out)
    return _rebase(out[:, 0], wlo)
