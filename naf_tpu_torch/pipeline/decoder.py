"""FASTA decode on the device: the counterpart of
``naf_tpu.pipeline.decoder.Decoder.fasta_device``.

The archive is read by ``naf_tpu``'s ``Decoder`` (container, zstd, render
plan); the port renders its sequence on the device.  Archives the device
render does not take go to ``decoder.fasta()`` on the host by a named route
counted in ``device.ROUTES``: spill quirks (chars beyond the sum of the
lengths), as the reference does, and what the uniform-group render
declines (``parallel.decode.decline_reason``).
"""

from __future__ import annotations

from typing import Optional

from naf_tpu.pipeline.decoder import Decoder

from ..device import count_route, resolve
from ..parallel.decode import decline_reason, render_regular


def fasta_device(decoder: Decoder, masking: Optional[bool] = None, *, device) -> bytes:
    """FASTA output of an open archive, rendered on ``device``; the same
    bytes as ``decoder.fasta(masking)``."""
    dev = resolve(device)
    if not decoder.h.has_sequence:
        count_route("decode_host:no_sequence")
        return b""
    masking = decoder.masking if masking is None else masking
    built = decoder._fasta_plan(masking)
    if built is None:
        count_route("decode_host:spill_quirk")
        return decoder.fasta(masking)
    plan, raw = built
    reason = decline_reason(plan)
    if reason is not None:
        count_route(f"decode_host:{reason}")
        return decoder.fasta(masking)
    count_route("decode_device")
    return render_regular(plan, raw, device=dev)
