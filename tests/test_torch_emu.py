"""naf_tpu_torch's CUDA kernels, run on the CPU under host emulation,
against their plain PyTorch versions.

g++ compiles ``naf_tpu_torch/csrc/*.cu`` as C++ against
``tests/cuda_emu/cuda_emu.h`` (every block's threads are host threads that
meet at a barrier for ``__syncthreads``), and the kernels' launchers run on
host tensors through that library.  This checks the kernels' logic (tile
and thread carries, compaction offsets, the sparse cap, ragged edges and
unaligned pointers) where there is no card; ``test_torch_cuda.py`` checks
the real build on one.  Everything is integer or bytes: tolerance 0.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from naf_tpu_torch.format import constants as C
from naf_tpu_torch.native import build
from naf_tpu_torch.ops import compact as CP
from naf_tpu_torch.ops import emit_fused as EF
from naf_tpu_torch.ops import pack as PK
from naf_tpu_torch.ops import scan_fused as SF
from naf_tpu_torch.ops import unpack as UP
from naf_tpu_torch.ops.common import Q_TILE, SCAN_TILE, TILE

from torch_cases import (CLASSIFY_CASES, COMPACT_CASES, FASTA_EMIT_CASES, FASTQ_EMIT_CASES,
                         MASK_PARITY_CASES, SCAN_CASES, SEQ_TYPES, START_STATES,
                         case_change_behind_tile_start, classify_case, compact_case, emit_case,
                         fasta_start_states, fastq_case, fastq_case_change_behind_tile_start,
                         fastq_reads, mask_parity_input, scan_case, scan_input)

EMU_DIR = Path(__file__).resolve().parent / "cuda_emu"


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is needed to build the host emulation of the kernels")
    so = tmp_path_factory.mktemp("naf_emu") / "libnaf_tpu_torch_emu.so"
    cmd = [gxx, "-std=c++20", "-O1", "-x", "c++", "-DNAF_CPU_EMU", f"-I{EMU_DIR}",
           "-shared", "-fPIC", "-pthread", "-o", str(so),
           *(str(p) for p in build.sources() if p.suffix == ".cu")]
    r = subprocess.run(cmd, capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    return build.bind(ctypes.CDLL(str(so)))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.uint8).copy())


def _offset(a: np.ndarray, k: int) -> torch.Tensor:
    """A tensor of a (any dtype) whose data pointer is k elements past an
    aligned one."""
    t = torch.from_numpy(np.ascontiguousarray(a).copy())
    buf = torch.zeros(t.numel() + 16, dtype=t.dtype)
    buf[k:k + t.numel()] = t
    return buf[k:k + t.numel()]


def _assert_dicts_equal(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("seq_type", SEQ_TYPES)
@pytest.mark.parametrize("case", CLASSIFY_CASES)
def test_classify_kernel_matches_plain(emu, case, seq_type):
    body, prev, sis = classify_case(case)
    for n in (body.size, body.size - 77):          # a ragged last tile too
        x = _t(body[:n])
        flags, sval = SF.classify_fasta_kernel(x, prev, sis, seq_type=seq_type, lib=emu)
        f_ref, v_ref = SF.classify_fasta_plain(x, prev, sis, seq_type=seq_type)
        assert torch.equal(flags, f_ref) and torch.equal(sval, v_ref)


@pytest.mark.parametrize("prev,sis", START_STATES)
def test_classify_kernel_start_states(emu, prev, sis):
    """A block whose first byte is '>', 5 bytes past an aligned pointer and
    of a length that is not a multiple of 16."""
    x = _offset(fasta_start_states()[:2 * TILE - 5], 5)
    flags, sval = SF.classify_fasta_kernel(x, prev, sis, lib=emu)
    f_ref, v_ref = SF.classify_fasta_plain(x, prev, sis)
    assert torch.equal(flags, f_ref) and torch.equal(sval, v_ref)


@pytest.mark.parametrize("name", FASTA_EMIT_CASES)
def test_emit_kernel_matches_plain(emu, name):
    body, prev, sis, seq_type = emit_case(name)
    x = _t(body)
    got = EF.emit_fasta_kernel(x, prev, sis, seq_type=seq_type, lib=emu)
    want = EF.emit_fasta_plain(x, prev, sis, seq_type=seq_type)
    _assert_dicts_equal(got, want)
    if name == "sparse_overflow":
        assert not bool(got["sp_ok"])


@pytest.mark.parametrize("prev,sis", START_STATES)
def test_emit_kernel_start_states(emu, prev, sis):
    """A block whose first byte is '>': a marker only after a line end."""
    x = _offset(fasta_start_states(), 5)
    _assert_dicts_equal(EF.emit_fasta_kernel(x, prev, sis, lib=emu),
                        EF.emit_fasta_plain(x, prev, sis))


def test_emit_kernel_case_change_at_tile_first_kept_byte(emu):
    x = _t(case_change_behind_tile_start())
    _assert_dicts_equal(EF.emit_fasta_kernel(x, ord(">"), lib=emu),
                        EF.emit_fasta_plain(x, ord(">")))


@pytest.mark.parametrize("n", [1, 127, 129, TILE - 1, TILE + 1, 2 * TILE + 333])
def test_emit_kernel_ragged_lengths(emu, n):
    rng = np.random.default_rng(60 + n)
    pool = np.frombuffer(b">ACGTNacgtn \t\r\n" + b"xyz*\x01", np.uint8)
    body = rng.choice(pool, size=n)
    for k in (0, 3):                               # aligned and unaligned input
        x = _offset(body, k)
        _assert_dicts_equal(EF.emit_fasta_kernel(x, ord(">"), lib=emu),
                            EF.emit_fasta_plain(x, ord(">")))


@pytest.mark.parametrize("n", [0, 2, 16, 30, 256, 1000, TILE + 18])
def test_pack_kernel_matches_plain(emu, n):
    rng = np.random.default_rng(61)
    seq = rng.integers(0, 256, size=n, dtype=np.uint8)
    seq[: min(n, 256)] = np.arange(min(n, 256))
    for shift in (0, 1):
        for out_len in (n // 2, n // 2 + 1, n // 2 + 13):
            for k in (0, 5):
                x = _offset(seq, k)
                got = PK.pack_4bit_kernel(x, shift=shift, out_len=out_len, lib=emu)
                assert torch.equal(got, PK.pack_4bit_plain(x, shift=shift, out_len=out_len))


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 1000, 4096 + 3])
def test_unpack_kernel_matches_plain(emu, n):
    rng = np.random.default_rng(62)
    packed = rng.integers(0, 256, size=n, dtype=np.uint8)
    packed[: min(n, 256)] = np.arange(min(n, 256))
    for rna in (False, True):
        for k in (0, 1):
            x = _offset(packed, k)
            assert torch.equal(UP.unpack_4bit_kernel(x, rna, lib=emu),
                               UP.unpack_4bit_plain(x, rna))


@pytest.mark.parametrize("case", [1, 128, 1000, TILE - 3, TILE + 5, 2 * TILE + 1,
                                  *MASK_PARITY_CASES])
def test_mask_parity_kernel_matches_plain(emu, case):
    chars, tog = mask_parity_input(case)
    for k in (0, 7):                               # aligned, and 7 bytes past
        c, t = _offset(chars, k), _offset(tog, k)
        assert torch.equal(EF.apply_mask_parity_kernel(c, t, lib=emu),
                           EF.apply_mask_parity_plain(c, t))


@pytest.mark.parametrize("seq_type", [C.SEQ_TYPE_DNA, C.SEQ_TYPE_RNA])
@pytest.mark.parametrize("name", FASTQ_EMIT_CASES)
def test_fastq_kernels_match_plain(emu, name, seq_type):
    body = fastq_case(name)
    x = _t(body)
    flags, sval = SF.classify_fastq_kernel(x, ord("@"), seq_type=seq_type, lib=emu)
    f_ref, v_ref = SF.classify_fastq_plain(x, ord("@"), seq_type=seq_type)
    assert torch.equal(flags, f_ref) and torch.equal(sval, v_ref)
    got = EF.emit_fastq_kernel(x, ord("@"), seq_type=seq_type, lib=emu)
    _assert_dicts_equal(got, EF.emit_fastq_plain(x, ord("@"), seq_type=seq_type))
    if name == "sparse_overflow":
        assert not bool(got["sp_ok"])


@pytest.mark.parametrize("where", ["header", "quality"])
def test_emit_fastq_kernel_case_change_at_tile_first_kept_byte(emu, where):
    x = _t(fastq_case_change_behind_tile_start(where))
    _assert_dicts_equal(EF.emit_fastq_kernel(x, ord("@"), lib=emu),
                        EF.emit_fastq_plain(x, ord("@")))


@pytest.mark.parametrize("n", [1, 127, 129, Q_TILE - 1, Q_TILE + 1, 3 * Q_TILE + 333,
                               6 * Q_TILE + 16 * 99 + 5])
def test_fastq_kernels_ragged_lengths(emu, n):
    body = fastq_reads(np.random.default_rng(64 + n), 2 + n // 150,
                       alphabet=b"ACGTacgtN@+ \x01")[:n]
    for k in (0, 3):                               # aligned and unaligned input
        x = _offset(body, k)
        for prev in (ord("@"), ord("\n")):
            f, v = SF.classify_fastq_kernel(x, prev, lib=emu)
            f_ref, v_ref = SF.classify_fastq_plain(x, prev)
            assert torch.equal(f, f_ref) and torch.equal(v, v_ref)
            _assert_dicts_equal(EF.emit_fastq_kernel(x, prev, lib=emu),
                                EF.emit_fastq_plain(x, prev))


@pytest.mark.parametrize("n", [1, SCAN_TILE - 1, SCAN_TILE + 1, 2 * SCAN_TILE + 17])
def test_scan_kernel_matches_plain(emu, n):
    for kind in ("bool", "u8", "i32"):
        x = scan_input(n, kind)
        for k in (0, 1):                            # aligned and unaligned input
            t = _offset(x, k)
            assert torch.equal(SF.scan_i32_kernel(t, "add", lib=emu), SF.cumsum_i32_plain(t))
            assert torch.equal(SF.scan_i32_kernel(t, "max", lib=emu), SF.maxscan_i32_plain(t))


@pytest.mark.parametrize("op", ["add", "max"])
@pytest.mark.parametrize("case", SCAN_CASES)
def test_scan_kernel_cases(emu, case, op):
    plain = SF.cumsum_i32_plain if op == "add" else SF.maxscan_i32_plain
    for x in scan_case(case):
        for k in range(4):                          # aligned, and 1-3 elements past
            t = _offset(x, k)
            assert torch.equal(SF.scan_i32_kernel(t, op, lib=emu), plain(t))


@pytest.mark.parametrize("n", [1, 130, SCAN_TILE + 1, 3 * SCAN_TILE - 5, *COMPACT_CASES])
def test_compact_kernel_matches_plain(emu, n):
    for kind in ("u8", "i32"):
        v, keep = compact_case(n, kind)
        # aligned, unaligned, and values and flags unaligned apart
        for kv, kk in ((0, 0), (3, 3), (1, 6)):
            vt, kt = _offset(v, kv), _offset(keep, kk)
            # both wrappers launch the one kernel; only the counter differs
            out, cnt = CP.compact_kernel(vt, kt, dense=kv > 0, lib=emu)
            want, want_cnt = CP.compact_plain(vt, kt)
            assert torch.equal(out, want) and int(cnt) == int(want_cnt)


def test_launchers_refuse_host_tensors_without_the_emulation():
    x = torch.zeros(256, dtype=torch.uint8)
    for launch in (lambda: PK.pack_4bit_kernel(x), lambda: UP.unpack_4bit_kernel(x),
                   lambda: SF.classify_fasta_kernel(x, ord(">")),
                   lambda: EF.emit_fasta_kernel(x, ord(">")),
                   lambda: EF.apply_mask_parity_kernel(x, x),
                   lambda: SF.classify_fastq_kernel(x, ord("@")),
                   lambda: EF.emit_fastq_kernel(x, ord("@")),
                   lambda: SF.scan_i32_kernel(x, "add"), lambda: SF.scan_i32_kernel(x, "max"),
                   lambda: CP.compact_kernel(x, x), lambda: CP.compact_kernel(x, x, dense=True)):
        with pytest.raises(ValueError, match="CUDA tensors"):
            launch()
