"""The block mesh: the port's counterpart of ``naf_tpu/parallel/mesh.py``.

A ``BlockMesh`` is an ordered list of torch devices, one block of the input
each.  ``block_mesh()`` spans every visible card; the CPU is used only when
it is named.  A mesh may list a device more than once: the tests run D
blocks on the CPU that way, and one card can carry D blocks.  Blocks are
byte ranges cut at line starts, so a single record spanning every block
works as any other (the nibble parity, the mask runs and the line-length
max stitch across block edges).

The collectives the sharded functions of ``block.py`` need run in this
process, on the tensors the blocks left on their devices:

- ``all_gather``: every block's value copied to the first block's device
  (a peer copy across cards), stacked, and fetched to the host at once;
- ``parities``: the exclusive prefix of the gathered char counts, which
  sets each block's nibble parity;
- ``psum``: histograms summed in int64 on the first block's device (the
  TPU's u32 lo/hi halves are not needed);
- ``pmax``: the longest line, over the gathered rows.

Nothing here synchronises a card but the fetch at the end of a gather, so
the launches of one phase on different cards overlap.  Each upload and each
``fetch`` is a span (``utils/trace.py``) with the bytes it copies.
``dryrun_multichip`` is the counterpart of ``__graft_entry__.py``'s.
"""

from __future__ import annotations

import io
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..device import cuda_devices, resolve
from ..utils.trace import trace_span


@dataclass(frozen=True)
class BlockMesh:
    """Block k of an input runs on ``devices[k]``."""

    devices: tuple

    @property
    def size(self) -> int:
        return len(self.devices)

    def upload(self, rows: np.ndarray) -> list[torch.Tensor]:
        """Row k of a host array [D, ...] as a tensor on block k's device."""
        with trace_span("upload", bytes=rows.nbytes):
            return [torch.from_numpy(np.ascontiguousarray(r)).to(d)
                    for r, d in zip(rows, self.devices)]


def block_mesh(n_devices: int | None = None, devices=None) -> BlockMesh:
    """A mesh over ``devices`` (every visible card by default), cut to its
    first ``n_devices``; each device is resolved as ``device.resolve``
    does, so a CUDA device without a card raises."""
    devs = [resolve(d) for d in (cuda_devices() if devices is None else devices)]
    if n_devices is not None:
        if not 0 < n_devices <= len(devs):
            raise ValueError(f"a mesh of {n_devices} blocks over {len(devs)} devices")
        devs = devs[:n_devices]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return BlockMesh(tuple(devs))


def fetch(t: torch.Tensor) -> torch.Tensor:
    """``t`` copied to the host: a ``fetch`` span, whose time holds the
    wait for the work queued before the copy."""
    with trace_span("fetch", bytes=t.numel() * t.element_size()):
        return t.cpu()


def all_gather(values: Sequence[torch.Tensor]) -> np.ndarray:
    """The blocks' tensors (one shape and dtype) stacked in block order on
    the host, with one fetch."""
    dev = values[0].device
    return fetch(torch.stack([v.to(dev) for v in values])).numpy()


def parities(counts: Sequence[torch.Tensor], base: int) -> list[int]:
    """Each block's nibble parity: ``base`` plus the chars of every block
    before it, mod 2.  Block 0 needs no count, so the last block's count is
    not gathered, and one block fetches nothing."""
    before = (all_gather(counts[:-1]).astype(np.int64) if len(counts) > 1
              else np.zeros(0, np.int64))
    prefix = np.concatenate([[0], np.cumsum(before)])
    return [int((base + p) % 2) for p in prefix]


def psum(values: Sequence[torch.Tensor]) -> np.ndarray:
    """The elementwise sum of the blocks' tensors, in int64, with one fetch."""
    dev = values[0].device
    return fetch(torch.stack([v.to(dev, torch.int64) for v in values]).sum(0)).numpy()


def pmax(values: np.ndarray) -> int:
    """The largest of the gathered per-block values."""
    return int(np.max(values, initial=0))


# ---------------------------------------------------------------------------
# the multi-block dry run
# ---------------------------------------------------------------------------

def _dryrun_inputs(n: int) -> dict:
    """The inputs of ``__graft_entry__.py``'s dry run for an n-block mesh."""
    rng = np.random.default_rng(1)
    rows = []
    for i in range(4 * n):
        rows.append(b">r%d note\n" % i)
        seq = rng.choice(np.frombuffer(b"ACGTacgt", np.uint8), size=int(rng.integers(10, 80)))
        rows.append(seq.tobytes() + b"\n")
    giant = rng.choice(np.frombuffer(b"ACGTacgtNn", np.uint8), size=4000)
    rows.append(b">giant spans blocks\n")
    for j in range(0, giant.size, 61):
        rows.append(giant[j:j + 61].tobytes() + b"\n")
    fq = []
    for i in range(6 * n):
        ln = int(rng.integers(5, 60))
        s = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=ln).tobytes()
        q = rng.integers(33, 74, size=ln, dtype=np.uint8).tobytes()
        fq.append(b"@rd%d x\n%s\n+\n%s\n" % (i, s, q))
    rng = np.random.default_rng(2)
    full = []
    for i in range(3 * n):
        seq = rng.choice(np.frombuffer(b"ACGTacgtNn", np.uint8), size=int(rng.integers(20, 120)))
        full.append(b">s%d c%d\n" % (i, i) + seq.tobytes() + b"\n")
    return {"fasta": b"".join(rows), "fastq": b"".join(fq),
            "protein": b"".join(b">p%d c\nMKVLND*AEFGHIKW-\n" % i for i in range(2 * n)),
            "full": b"".join(full)}


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """The checks of ``__graft_entry__.py:dryrun_multichip`` on an
    ``n_devices``-block mesh over ``devices`` (every visible card by
    default; a device may repeat): FASTA records over the mesh with a giant
    record spanning blocks, FASTQ (and its decode), protein and
    ``--strict``, each archive byte-equal to host ``encode()``; then the
    full encode and the mesh decode of another FASTA, equal to the host
    ``Decoder``.  Returns each input's encode route and archive size;
    raises AssertionError on the first difference."""
    from .. import device as D
    from ..format import constants as C
    from ..pipeline.decoder import DecodeOptions, Decoder, fasta_device, fastq_device
    from ..pipeline.encoder import EncodeOptions, encode
    from .pipeline import encode_device

    mesh = block_mesh(n_devices, devices)
    inputs = _dryrun_inputs(n_devices)
    cases = [("fasta", inputs["fasta"], EncodeOptions(level=1)),
             ("fastq", inputs["fastq"], EncodeOptions(level=1)),
             ("protein", inputs["protein"], EncodeOptions(level=1, seq_type=C.SEQ_TYPE_PROTEIN)),
             ("strict", inputs["fasta"], EncodeOptions(level=1, strict=True)),
             ("full", inputs["full"], EncodeOptions(level=1))]
    out = {}
    for name, data, opts in cases:
        routes = dict(D.ROUTES)
        blob, _ = encode_device(data, opts, mesh=mesh)
        if blob != encode(data, opts)[0]:
            raise AssertionError(f"dryrun_multichip({n_devices}): {name} archive != host archive")
        out[name] = {"archive": len(blob),
                     "routes": {k: v - routes.get(k, 0) for k, v in D.ROUTES.items()
                                if v != routes.get(k, 0)}}
        if name in ("fastq", "full"):
            host = Decoder(io.BytesIO(blob), DecodeOptions())
            want = host.fastq() if name == "fastq" else host.fasta()
            d = Decoder(io.BytesIO(blob), DecodeOptions())
            got = fastq_device(d, mesh=mesh) if name == "fastq" else fasta_device(d, mesh=mesh)
            if got != want or (name == "fastq" and got != data):
                raise AssertionError(f"dryrun_multichip({n_devices}): {name} mesh decode differs")
    return out
