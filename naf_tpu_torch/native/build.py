"""Build and load the port's CUDA kernels.

At first use, nvcc compiles every ``naf_tpu_torch/csrc/*.cu`` (one nvcc
per source, all at once) and links them into one shared library with a
plain C interface, under
``build/naf_tpu_torch/<hash of the sources>/`` in the checkout, and
``ctypes`` loads it.  A later call in the same process, or a later process
with the same sources, reuses it.  A failed build raises with nvcc's output;
there is no fallback.

Each C entry launches on the stream it is given and returns
``cudaGetLastError()``; ``call`` raises when that is not 0.
"""

from __future__ import annotations

import ctypes as ct
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent.parent / "build" / "naf_tpu_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _L = ct.c_void_p, ct.c_int, ct.c_longlong

#: argument types of each C entry (see csrc/*.cu); the last is the stream, but for
#: the emits' scratch sizes, which launch nothing
SIGNATURES = {
    "naf_classify_fasta": [_P, _L, _I, _I, _P, _I, _I, _P, _P, _P, _I, _P],
    "naf_emit_fasta_scratch": [_I],
    "naf_emit_fasta": [_P, _L, _I, _I, _P, _I, _I, _I, _P, _P, _P, _P, _P, _I, _P],
    "naf_pack_4bit": [_P, _L, _L, _P, _P, _L, _P],
    "naf_unpack_4bit": [_P, _L, _P, _P, _P],
    "naf_mask_parity": [_P, _P, _L, _P, _P, _I, _P],
    "naf_classify_fastq": [_P, _L, _I, _P, _I, _I, _I, _P, _P, _P, _I, _P],
    "naf_emit_fastq_scratch": [_I],
    "naf_emit_fastq": [_P, _L, _I, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                       _P],
    "naf_scan_i32": [_P, _I, _L, _I, _P, _P, _I, _P],
    "naf_compact": [_P, _I, _P, _L, _P, _P, _I, _P],
}

_lib = None
_lock = threading.Lock()
#: what the build of this process did: seconds, library path, nvcc output
BUILD_INFO: dict = {}


def sources() -> list[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (neither under CUDA_HOME nor on PATH)")
    return found


def bind(lib: ct.CDLL) -> ct.CDLL:
    """Declare the argument and result types of every C entry."""
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ct.c_int
    return lib


def library() -> ct.CDLL:
    """The kernel library, built from the checkout's sources if needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        srcs = sources()
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        h.update(b"-shared")
        for p in srcs:
            h.update(p.name.encode())
            h.update(p.read_bytes())
        out_dir = BUILD_ROOT / h.hexdigest()[:16]
        so = out_dir / "libnaf_tpu_torch.so"
        t0 = time.perf_counter()
        log = ""
        if not so.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            tag = f"{os.getpid()}.tmp"
            cus = [p for p in srcs if p.suffix == ".cu"]
            objs = [out_dir / f"{p.stem}.{tag}.o" for p in cus]
            procs = [subprocess.Popen([nvcc_path(), *NVCC_FLAGS, "-c", "-o", str(o), str(p)],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                     for p, o in zip(cus, objs)]
            log = "".join(p.communicate()[0] for p in procs)
            failed = [c.name for c, p in zip(cus, procs) if p.returncode != 0]
            if failed:
                raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
            tmp = out_dir / f"libnaf_tpu_torch.{tag}.so"
            r = subprocess.run([nvcc_path(), *ARCH_FLAGS, "-shared", "-o", str(tmp),
                                *map(str, objs)], capture_output=True, text=True)
            log += r.stdout + r.stderr
            for o in objs:
                o.unlink()
            if r.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({r.returncode}):\n{log}")
            os.replace(tmp, so)
        BUILD_INFO.update(seconds=time.perf_counter() - t0, path=str(so), log=log)
        _lib = bind(ct.CDLL(str(so)))
        return _lib


def kernel_lib(t, lib: ct.CDLL | None = None) -> ct.CDLL:
    """The library a launch on ``t`` goes through: the CUDA build for a CUDA
    tensor; a host tensor only with the host-emulation build the tests pass."""
    if lib is not None:
        return lib
    if not t.is_cuda:
        raise ValueError(f"the CUDA kernels take CUDA tensors, got one on {t.device}")
    return library()


def call(lib: ct.CDLL, name: str, *args) -> None:
    """Call a C entry and raise on a CUDA error."""
    err = getattr(lib, name)(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


def stream_of(t) -> int | None:
    """The handle of the current stream on t's device (None for host
    tensors, which only the host-emulation build of the tests takes)."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream if t.is_cuda else None
