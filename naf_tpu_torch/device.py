"""Device selection and the run counters of the port.

An entry point runs on the one device a caller names (the current card by
default), or over the blocks of a ``parallel/mesh.py:BlockMesh``, one
device each, which the CLIs span over every visible card
(``cuda_devices``).  The CPU is used only when asked for, and asking for
CUDA without a card raises.

``LAUNCHES`` counts kernel launches, one entry per hand kernel; a wrapper
adds one where it launches its kernel and nowhere else.  The fused paths
run each classify as device code inside its emit kernel, counted as the
emit; the two-pass encode launches the standalone classifies.
``ROUTES`` counts which way the encode and decode entry points went: the
fused or two-pass device encode, the uniform or ragged device render, or a
named host route.  A streamed encode (``tnaf --device`` on a pipe or a
large file) counts ``encode_device:stream`` once, and each of its pieces
``stream_device``, ``stream_device:two_pass:<why>`` or
``stream_host:<why>`` (``parallel/stream.py`` names the reasons).  A
render over a mesh of several blocks counts ``decode_device:ragged:mesh``;
the multi-process encodes count ``encode_multihost``,
``encode_multihost:parts`` or ``encode_multihost:extended``, or
``multihost_host:<why>`` (``parallel/multihost.py``); the device zstd
engine counts ``device_engine_host:over_2gib`` for a section it leaves
to the native engine.  Each route is also the ``route`` field of the
traced call's root span (``utils/trace.py``).
"""

from __future__ import annotations

import torch

from .utils.trace import note_root

LAUNCHES: dict[str, int] = {
    "emit_fasta": 0,
    "classify_fasta": 0,
    "pack_4bit": 0,
    "unpack_4bit": 0,
    "apply_mask_parity": 0,
    "emit_fastq": 0,
    "classify_fastq": 0,
    "cumsum_i32": 0,
    "maxscan_i32": 0,
    "compact": 0,
    "compact_dense": 0,
    "match_keys": 0,
    "match_chain": 0,
}

ROUTES: dict[str, int] = {}


def resolve(device) -> torch.device:
    """The torch device a caller named, with its index; raises if it is
    CUDA and no card is present, or if it is neither CUDA nor the CPU."""
    if device is None:
        raise ValueError("naf_tpu_torch needs an explicit device ('cuda' or 'cpu')")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but no CUDA device is available")
        return dev if dev.index is not None else torch.device("cuda", torch.cuda.current_device())
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def cuda_device() -> torch.device:
    """The current CUDA device; raises when there is none."""
    return resolve("cuda")


def cuda_devices() -> list[torch.device]:
    """Every visible card, or the one ``cuda_device`` names when there are
    fewer than two; raises when there is none."""
    n = torch.cuda.device_count()
    if n < 2:
        return [cuda_device()]
    return [torch.device("cuda", i) for i in range(n)]


def count_route(name: str) -> None:
    """Count a route, and name it on the traced call's root span."""
    ROUTES[name] = ROUTES.get(name, 0) + 1
    note_root(route=name)


def reset_counts() -> None:
    """Zero every launch and route count."""
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    ROUTES.clear()
