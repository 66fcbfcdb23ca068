"""Multi-process sharded encode on ``torch.distributed``: the port of
``naf_tpu/parallel/multihost.py``.

Every process of the caller's process group (``init_process_group``
before the call) calls with the same input bytes and its local mesh
(``mesh.block_mesh``; every visible card by default).  The global mesh is
the local meshes in rank order: a process owns the blocks from its offset
(the blocks of the ranks before it) on.  Each process runs the two-pass
device encode of ``pipeline.encode_device`` on its own blocks; the
collectives of pass 1 cross the processes (the rows of every block
gathered, the histograms summed), and pass 2's compacted rows are
gathered to every process (``encode_multihost``: O(payload) traffic), or
each process compresses its own packed sequence and quality bytes and
only the compressed parts (``encode_multihost_parts``, one standard zstd
frame a section) or frames (``encode_multihost_extended``, the extended
format) cross the processes.  Every process returns the same archive;
``encode_multihost``'s equals host ``encode()``, the others decode to its
bytes.

The gathers carry CUDA tensors under NCCL and CPU tensors under gloo, as
``dist.get_backend()`` says: a choice of transport, not a fallback.  The
reference's ``_local_row`` read one replica of a psum'd row; here the
histograms are summed by ``all_reduce`` (``_psum``), so every process holds
the total.  Inputs the device passes do not take re-encode on the host in
every process, each by a named route counted in ``device.ROUTES``
(``multihost_host:<why>``): not FASTA or FASTQ, an unsafe
``--well-formed`` input, a FASTQ off the 4-line grid, ``--strict`` with
unexpected characters, a FASTQ record whose quality length differs from
its sequence length (the host raises the reference's messages), and
protein or text on the compressed-traffic paths, which stitch nibbles.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..device import count_route
from ..format import constants as C
from ..pipeline import parser as P
from ..pipeline.encoder import EncodeOptions, EncodeStats, encode
from .block import (ROW_FIELDS, BlockRows, block_stats, emit_blocks_sharded, make_blocks,
                    make_blocks_fastq, stats_columns, stats_rows, stitch_packed_range)
from .mesh import BlockMesh, block_mesh
from .pipeline import _stitch_and_build, _wf_device_safe

_HEAD = 3 * 8        # a gathered row block's span: start, rows, width (int64 each)


def _count(traffic: Optional[dict], nbytes: int) -> None:
    if traffic is not None:
        traffic["gathered_bytes"] = traffic.get("gathered_bytes", 0) + nbytes


def _transport(mesh: BlockMesh) -> torch.device:
    """Where the collectives' tensors live: a card under NCCL (the local
    mesh's first, or the current one), the CPU under any other backend."""
    if dist.get_backend() == "nccl":
        d = mesh.devices[0]
        return d if d.type == "cuda" else torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _allgather_bytes(buf: np.ndarray, dev: torch.device, traffic: Optional[dict] = None
                     ) -> list[np.ndarray]:
    """Gather one variable-length u8 payload per process, in rank order."""
    buf = np.ascontiguousarray(buf, dtype=np.uint8).reshape(-1)
    if not buf.flags.writeable:
        buf = buf.copy()
    world = dist.get_world_size()
    n = torch.tensor([buf.size], dtype=torch.int64, device=dev)
    lens = [torch.empty_like(n) for _ in range(world)]
    dist.all_gather(lens, n)
    lens = [int(t) for t in torch.cat(lens).cpu()]
    cap = max(max(lens), 1)
    padded = torch.zeros(cap, dtype=torch.uint8, device=dev)
    padded[:buf.size] = torch.from_numpy(buf).to(dev)
    outs = [torch.empty_like(padded) for _ in range(world)]
    dist.all_gather(outs, padded)
    _count(traffic, world * (cap + 8))
    return [o[:ln].cpu().numpy() for o, ln in zip(outs, lens)]


def _gather_rows(local: np.ndarray, k0: int, D: int, dev: torch.device,
                 traffic: Optional[dict] = None) -> np.ndarray:
    """This process's rows (blocks k0, k0+1, ... of a [n] or [n, w] array)
    gathered with every other process's into one [D] or [D, w'] array in
    global block order.  Each process's rows travel with their span
    (start, rows, width), so uneven and reordered shards come out in
    order; 2-D rows are zero-padded to the widest process's; every block
    must be covered."""
    local = np.ascontiguousarray(local)
    width = local.shape[1] if local.ndim == 2 else -1
    head = np.asarray([k0, local.shape[0], width], np.int64)
    payload = np.concatenate([head.view(np.uint8), local.reshape(-1).view(np.uint8)])
    parts = _allgather_bytes(payload, dev, traffic)
    spans = []
    for p in parts:
        start, n, w = (int(v) for v in p[:_HEAD].view(np.int64))
        vals = p[_HEAD:].view(local.dtype)
        spans.append((start, n, w, vals.reshape(n, w) if w >= 0 else vals))
    if width < 0:
        out = np.zeros(D, local.dtype)
    else:
        out = np.zeros((D, max(w for _, _, w, _ in spans)), local.dtype)
    seen = np.zeros(D, bool)
    for start, n, w, rows in spans:
        if w < 0:
            out[start:start + n] = rows
        else:
            out[start:start + n, :w] = rows
        seen[start:start + n] = True
    if not seen.all():
        raise RuntimeError("the gather missed block rows")
    return out


def _psum(local: np.ndarray, dev: torch.device) -> np.ndarray:
    """The sum over every process of an int64 array (``all_reduce``)."""
    t = torch.from_numpy(np.ascontiguousarray(local, np.int64)).to(dev)
    dist.all_reduce(t)
    return t.cpu().numpy()


class _HostFallback(Exception):
    """An input the device passes do not take; every process re-encodes on
    the host (the input bytes are the same everywhere, so the archives are
    too), by the named route ``multihost_host:<why>``."""


def _run_passes(data: bytes, opts: EncodeOptions, traffic: Optional[dict], mesh: BlockMesh,
                *, allow_text: bool):
    """The two-pass body the three encodes share: (D, fmt, per-block stats
    of every block, this process's pass-2 ``BlockRows``, its first block
    k0, the collectives' device).  The big rows (packed sequence, FASTQ
    quality) stay local, so each caller decides whether to gather them
    (plain) or compress them here (parts, extended)."""
    fmt, marker = P.detect_format(data)
    if (opts.in_format != C.IN_FORMAT_UNKNOWN and fmt != C.IN_FORMAT_UNKNOWN
            and opts.in_format != fmt):
        raise P.InputError(
            "input format is different from format specified in the command line")
    fastq = fmt == C.IN_FORMAT_FASTQ
    if not fastq and fmt != C.IN_FORMAT_FASTA:
        raise _HostFallback("not_fasta")
    text_like = opts.seq_type >= C.SEQ_TYPE_PROTEIN
    if text_like and not allow_text:
        # the compressed-traffic paths stitch packed-nibble byte ranges
        raise _HostFallback("text_like")
    body = np.frombuffer(data, np.uint8)[marker + 1:]
    if opts.well_formed and not _wf_device_safe(body, fastq):
        raise _HostFallback("well_formed_unsafe")

    dev = _transport(mesh)
    sizes = [int(p.view(np.int64)[0]) for p in
             _allgather_bytes(np.asarray([mesh.size], np.int64).view(np.uint8), dev, traffic)]
    k0, D = sum(sizes[:dist.get_rank()]), sum(sizes)
    if fastq:
        mb = make_blocks_fastq(body, D)
        if mb is None:
            raise _HostFallback("fastq_irregular")
        blocks = mb[0]
    else:
        blocks = make_blocks(body, D)
    own = slice(k0, k0 + mesh.size)
    xs = mesh.upload(blocks.data[own])
    rows, hists, masks = stats_rows(xs, blocks.prev[own], blocks.starts_in_seq[own],
                                    seq_type=opts.seq_type, fastq=fastq)
    rows = _gather_rows(rows, k0, D, dev, traffic)
    hists = _psum(hists.astype(np.int64), dev).astype(np.uint64)
    stats = block_stats(rows, hists)
    # --strict: the summed histograms prove cleanliness; any unexpected
    # byte re-parses on the host for the reference's error (or archive)
    if opts.strict and hists.any():
        raise _HostFallback("strict_unexpected")
    rows = emit_blocks_sharded(xs, masks, stats[own], seq_type=opts.seq_type, fastq=fastq,
                               pack_nibbles=not text_like)
    return D, fmt, stats, rows, k0, dev


def _host(why: str, data: bytes, opts: EncodeOptions, mesh: BlockMesh):
    count_route(f"multihost_host:{why}")
    return encode(data, opts, device=mesh.devices[0])


def _build(fmt, opts, rows: BlockRows, data: bytes, mesh: BlockMesh, route: str,
           prebuilt=None):
    """The archive of every block's rows, counted under ``route``, or the
    host's when a quality length mismatch sends it there.  The device
    engine (``opts.engine == "device"``) runs on the local mesh's first
    device."""
    out = _stitch_and_build(fmt, opts, rows, prebuilt=prebuilt, device=mesh.devices[0])
    if out is None:
        return _host("qual_length_mismatch", data, opts, mesh)
    count_route(route)
    return out


def _gathered(rows: BlockRows, stats: list, k0: int, D: int, dev, traffic,
              local: tuple = ()) -> BlockRows:
    """Every block's ``BlockRows``: the first codes and each row field of
    this process's ``rows`` gathered with every other process's, but those
    in ``local``, left zero-width (they leave compressed); the columns from
    pass 1's dicts of every block."""
    return BlockRows(
        **stats_columns(stats), first_codes=_gather_rows(rows.first_codes, k0, D, dev, traffic),
        **{f: (np.zeros((D, 0), getattr(rows, f).dtype) if f in local
               else _gather_rows(getattr(rows, f), k0, D, dev, traffic)) for f in ROW_FIELDS})


def encode_multihost(data: bytes, opts: Optional[EncodeOptions] = None, *,
                     mesh: Optional[BlockMesh] = None, traffic: Optional[dict] = None
                     ) -> tuple[bytes, EncodeStats]:
    """Collective: every process calls with the same input bytes; returns
    the archive, the same on every process and byte-identical to host
    ``encode()``.  ``traffic={}`` receives the bytes gathered."""
    opts = opts or EncodeOptions()
    mesh = mesh if mesh is not None else block_mesh()
    try:
        D, fmt, stats, rows, k0, dev = _run_passes(data, opts, traffic, mesh, allow_text=True)
    except _HostFallback as e:
        return _host(str(e), data, opts, mesh)
    return _build(fmt, opts, _gathered(rows, stats, k0, D, dev, traffic), data, mesh,
                  "encode_multihost")


#: the rows the compressed-traffic paths compress where they live
_PAYLOAD = ("packed", "qual_vals")


def _local_bytes(rows: BlockRows, first_codes: np.ndarray, stats: list, k0: int,
                 fastq: bool) -> tuple:
    """(sequence, quality) of this process, whose blocks from ``k0`` on
    have ``rows``: each [(k0, chars, bytes)], the packed bytes its blocks
    own (``stitch_packed_range`` with every block's ``first_codes``) and
    their quality bytes."""
    counts = np.asarray([st["count"] for st in stats])
    k1 = k0 + rows.packed.shape[0]
    seq = [(k0, counts[k0:k1].sum(), stitch_packed_range(
        dict(enumerate(rows.packed, k0)), counts, first_codes, k0, k1))]
    if not fastq:
        return seq, []
    quals = [stats[k]["qual_bytes"] for k in range(k0, k1)]
    return seq, [(k0, sum(quals), np.concatenate([q[:n] for q, n in zip(rows.qual_vals, quals)]))]


def _gather_parts(local_parts: list, dev, traffic: Optional[dict]) -> tuple[list, list]:
    """Gather every process's (k0, part_size, chain) triples; (part sizes,
    chains) in global block order.  Only the compressed chains and
    O(parts) integers travel."""
    metas, blobs = [], []
    for k0, psize, chain in local_parts:
        metas.extend((int(k0), int(psize), len(chain)))
        blobs.append(chain)
    meta = np.asarray(metas, np.int64)
    blob = np.frombuffer(b"".join(blobs), np.uint8)
    entries = []
    for pm, pb in zip(_allgather_bytes(meta.view(np.uint8), dev, traffic),
                      _allgather_bytes(blob, dev, traffic)):
        m = pm.view(np.int64)
        off = 0
        for i in range(0, m.size, 3):
            k0, ps, cl = int(m[i]), int(m[i + 1]), int(m[i + 2])
            entries.append((k0, ps, pb[off:off + cl].tobytes()))
            off += cl
    entries.sort(key=lambda e: e[0])
    return [e[1] for e in entries], [e[2] for e in entries]


def encode_multihost_parts(data: bytes, opts: Optional[EncodeOptions] = None,
                           traffic: Optional[dict] = None, *, mesh: Optional[BlockMesh] = None
                           ) -> tuple[bytes, EncodeStats]:
    """O(compressed)-traffic multi-process encode into the plain format:
    every process compresses its own blocks' packed sequence (and FASTQ
    quality) bytes into history-free zstd block chains
    (``compress_part_native``); only the chains and O(blocks + records)
    rows are gathered, and every process stitches them into one standard
    zstd frame a section (``stitch_section_frame``), which the reference
    ``unnaf`` decodes.  The frame internals follow the block layout, so the
    archive is not host ``encode()``'s; its decoded bytes are."""
    from ..codec.zstd_backend import compress_part_native, stitch_section_frame
    from ..format.container import Section

    opts = opts or EncodeOptions()
    mesh = mesh if mesh is not None else block_mesh()
    try:
        D, fmt, stats, rows, k0, dev = _run_passes(data, opts, traffic, mesh, allow_text=False)
    except _HostFallback as e:
        return _host(str(e), data, opts, mesh)
    fastq = fmt == C.IN_FORMAT_FASTQ
    every = _gathered(rows, stats, k0, D, dev, traffic, local=_PAYLOAD)
    seq, qual = _local_bytes(rows, every.first_codes, stats, k0, fastq)
    sizes, chains = _gather_parts(
        [(r0, b.size, compress_part_native(b.tobytes(), level=opts.level,
                                           window_log=opts.long_window_log))
         for r0, _, b in seq if b.size], dev, traffic)
    total_chars = sum(st["count"] for st in stats)
    if sum(sizes) != (total_chars + 1) // 2:
        raise RuntimeError(f"part bytes {sum(sizes)} != packed size {(total_chars + 1) // 2}")
    prebuilt = {"sequence": Section(uncompressed_size=total_chars, payload=stitch_section_frame(
        chains, sizes, opts.level, opts.long_window_log))}
    if fastq:
        qsizes, qchains = _gather_parts(
            [(r0, b.size, compress_part_native(b.tobytes(), level=opts.level))
             for r0, _, b in qual if b.size], dev, traffic)
        total_qual = sum(st["qual_bytes"] for st in stats)
        if sum(qsizes) != total_qual:
            raise RuntimeError(f"part bytes {sum(qsizes)} != quality size {total_qual}")
        prebuilt["quality"] = Section(uncompressed_size=total_qual,
                                      payload=stitch_section_frame(qchains, qsizes, opts.level))
    return _build(fmt, opts, every, data, mesh, "encode_multihost:parts", prebuilt=prebuilt)


def _gather_framed(local_runs: list, dev, traffic: Optional[dict]) -> tuple[bytes, int]:
    """Gather every process's (k0, raw_lens, frames) runs and assemble the
    blocked section payload (VLE index + frames in block order); only the
    frames and O(frames) integers travel.  Returns (payload, raw bytes)."""
    from ..codec import blocked_payload, compress_section

    metas, blobs = [], []
    for k0, raw_lens, frames in local_runs:
        metas.append([k0, len(frames)])
        metas.extend([r, len(f)] for r, f in zip(raw_lens, frames))
        blobs.extend(frames)
    meta = np.asarray([x for m in metas for x in m], np.int64)
    blob = np.frombuffer(b"".join(blobs), np.uint8)
    entries = []
    for pm, pb in zip(_allgather_bytes(meta.view(np.uint8), dev, traffic),
                      _allgather_bytes(blob, dev, traffic)):
        m = pm.view(np.int64)
        off = i = 0
        while i < m.size:
            k0, nf = int(m[i]), int(m[i + 1])
            i += 2
            raws, frames = [], []
            for _ in range(nf):
                r, c = int(m[i]), int(m[i + 1])
                i += 2
                frames.append(pb[off:off + c].tobytes())
                raws.append(r)
                off += c
            entries.append((k0, raws, frames))
    entries.sort(key=lambda e: e[0])
    raw_lens = [r for _, raws, _ in entries for r in raws]
    frames = [f for _, _, fs in entries for f in fs]
    if not frames:
        raw_lens, frames = [0], [compress_section(b"")]
    return blocked_payload(raw_lens, frames), sum(raw_lens)


def encode_multihost_extended(data: bytes, opts: Optional[EncodeOptions] = None,
                              traffic: Optional[dict] = None, *,
                              mesh: Optional[BlockMesh] = None) -> tuple[bytes, EncodeStats]:
    """O(compressed)-traffic multi-process encode into the extended format:
    every process compresses its own blocks' packed sequence (and FASTQ
    quality) bytes into independent frames (``compress_frames``); only the
    frames and O(blocks + records) rows are gathered.  The archive differs
    from the one-process blocked layout in framing only."""
    from ..codec import compress_frames
    from ..format.container import Section

    opts = replace(opts or EncodeOptions(), extended=True)
    mesh = mesh if mesh is not None else block_mesh()
    try:
        D, fmt, stats, rows, k0, dev = _run_passes(data, opts, traffic, mesh, allow_text=False)
    except _HostFallback as e:
        return _host(str(e), data, opts, mesh)
    fastq = fmt == C.IN_FORMAT_FASTQ
    every = _gathered(rows, stats, k0, D, dev, traffic, local=_PAYLOAD)

    def frames_of(byts: np.ndarray):
        return compress_frames(byts, level=opts.level, window_log=opts.long_window_log,
                               threads=opts.threads, block_bytes=opts.block_bytes,
                               engine=opts.engine, device=mesh.devices[0])

    seq, qual = _local_bytes(rows, every.first_codes, stats, k0, fastq)
    seq_payload, seq_raw = _gather_framed(
        [(r0, *frames_of(b)) for r0, n, b in seq if b.size or n], dev, traffic)
    total_chars = sum(st["count"] for st in stats)
    if seq_raw != (total_chars + 1) // 2:
        raise RuntimeError(f"framed SEQ bytes {seq_raw} != packed size {(total_chars + 1) // 2}")
    prebuilt = {"sequence": Section(uncompressed_size=total_chars, payload=seq_payload)}
    if fastq:
        qual_payload, qual_raw = _gather_framed(
            [(r0, *frames_of(b)) for r0, n, b in qual if b.size or n], dev, traffic)
        total_qual = sum(st["qual_bytes"] for st in stats)
        if qual_raw != total_qual:
            raise RuntimeError(f"framed QUAL bytes {qual_raw} != {total_qual}")
        prebuilt["quality"] = Section(uncompressed_size=total_qual, payload=qual_payload)
    return _build(fmt, opts, every, data, mesh, "encode_multihost:extended", prebuilt=prebuilt)
