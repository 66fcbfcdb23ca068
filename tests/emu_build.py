"""The host emulation build of naf_tpu_torch's CUDA kernels, shared by the
``test_torch_emu_<family>.py`` files.

g++ compiles a family's ``naf_tpu_torch/csrc/*.cu`` as C++ against
``tests/cuda_emu/cuda_emu.h`` (every block's threads are host threads that
meet at a barrier for ``__syncthreads``), and the kernels' launchers run on
host tensors through that library.  This checks the kernels' logic (tile
and thread carries, compaction offsets, the sparse cap, ragged edges and
unaligned pointers) where there is no card; ``test_torch_cuda.py`` checks
the real build on one.  Each family's file builds only its own sources,
so the files run on separate workers; ``FAMILIES`` covers every source.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from naf_tpu_torch.native import build

EMU_DIR = Path(__file__).resolve().parent / "cuda_emu"

#: the sources of each test_torch_emu_<family>.py
FAMILIES = {
    "classify": ("classify",),
    "emit_fasta": ("emit_fasta",),
    "fastq": ("classify_fastq", "emit_fastq"),
    "render": ("pack", "unpack", "mask_parity"),
    "scan": ("scan",),
    "compact": ("compact",),
    "matchfind": ("matchfind",),
}


def emu_library(tmp_path_factory, family: str) -> ctypes.CDLL:
    """The family's kernels built for the host emulation, every C entry it
    holds bound as ``build.bind`` binds the CUDA build's."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is needed to build the host emulation of the kernels")
    srcs = [build.CSRC / f"{stem}.cu" for stem in FAMILIES[family]]
    so = tmp_path_factory.mktemp(f"naf_emu_{family}") / "libnaf_tpu_torch_emu.so"
    cmd = [gxx, "-std=c++20", "-O1", "-x", "c++", "-DNAF_CPU_EMU", f"-I{EMU_DIR}",
           "-shared", "-fPIC", "-pthread", "-o", str(so), *map(str, srcs)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    lib = ctypes.CDLL(str(so))
    for name, argtypes in build.SIGNATURES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def host_tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.uint8).copy())


def offset_tensor(a: np.ndarray, k: int) -> torch.Tensor:
    """A tensor of a (any dtype) whose data pointer is k elements past an
    aligned one."""
    t = torch.from_numpy(np.ascontiguousarray(a).copy())
    buf = torch.zeros(t.numel() + 16, dtype=t.dtype)
    buf[k:k + t.numel()] = t
    return buf[k:k + t.numel()]


def assert_dicts_equal(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
