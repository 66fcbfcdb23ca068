"""Sequence-case mask: RLE extraction (encode) and expansion (decode).

Reference semantics (ennaf/src/encoders.c:98-146, unnaf/src/output.c:295-322):
  * a byte is "masked" iff its value >= 96 (lowercase ASCII range and above);
  * the mask section is a u8 run-length stream alternating unmasked/masked,
    starting unmasked (a leading masked region emits a 0-length first run);
  * runs >= 255 split into 255-prefixed units whose sum is the run length —
    crucially a 255 unit does NOT flip the state (decoder: output.c:315).

A frozen copy of ``naf_tpu_torch/ops/mask.py``, for the benchmark's reference.
"""

from __future__ import annotations

import numpy as np

MASK_THRESHOLD = 96


def runs_to_units(runs: np.ndarray) -> np.ndarray:
    """Vectorized run lengths -> u8 unit stream (255-continuation).

    Each run of length L emits floor(L/255) 255-units and one (L%255) unit
    (parity: ennaf/src/encoders.c:98-123).
    """
    runs = np.asarray(runs, dtype=np.int64)
    if runs.size == 0:
        return np.zeros(0, np.uint8)
    n255 = runs // 255
    total = int(n255.sum()) + runs.size
    out = np.full(total, 255, np.uint8)
    ends = np.cumsum(n255 + 1) - 1
    out[ends] = (runs % 255).astype(np.uint8)
    return out


def mask_units_from_bytes(seq_bytes: np.ndarray) -> np.ndarray:
    """Unit stream of a complete sequence stream (the runs of bytes >= 96
    and below, starting with an unmasked run, as the reference's encoder)."""
    seq = np.ascontiguousarray(seq_bytes, dtype=np.uint8)
    if seq.size == 0:
        return np.zeros(0, np.uint8)
    lower = seq >= MASK_THRESHOLD
    change = np.flatnonzero(lower[1:] != lower[:-1]) + 1
    runs = np.diff(np.concatenate([[0], change, [lower.size]]))
    if lower[0]:
        runs = np.concatenate([[0], runs])      # leading masked run
    return runs_to_units(runs)


# ---------------------------------------------------------------------------
# Decode side
# ---------------------------------------------------------------------------

def merge_units(units: np.ndarray) -> np.ndarray:
    """u8 unit stream -> array of actual run lengths (u64), 255s merged.

    A unit terminates its run iff it is != 255 (output.c:315).
    """
    units = np.ascontiguousarray(units, dtype=np.uint8)
    if units.size == 0:
        return np.zeros(0, dtype=np.uint64)
    u = units.astype(np.uint64)
    terminal = units != 255
    csum = np.concatenate([np.zeros(1, np.uint64), np.cumsum(u)])
    term_idx = np.flatnonzero(terminal)
    ends = csum[term_idx + 1]
    starts = np.concatenate([np.zeros(1, np.uint64), ends[:-1]])
    out = ends - starts
    # trailing 255s with no terminator form a final (malformed) run; the
    # reference would read past the buffer — we clamp instead.
    if term_idx.size == 0 or term_idx[-1] != units.size - 1:
        tail_start = ends[-1] if term_idx.size else 0
        out = np.concatenate([out, np.asarray([csum[-1] - tail_start], np.uint64)])
    return out


def expand_mask_np(run_lengths: np.ndarray, total: int) -> np.ndarray:
    """Run lengths (starting unmasked) -> bool[total] is-masked."""
    rl = np.asarray(run_lengths, dtype=np.int64)
    states = (np.arange(rl.size) % 2).astype(bool)
    expanded = np.repeat(states, rl)
    if expanded.size < total:
        # runs exhausted: reference keeps reading garbage; we extend last state
        expanded = np.concatenate(
            [expanded, np.full(total - expanded.size, expanded[-1] if expanded.size else False)]
        )
    return expanded[:total]


def apply_mask_np(seq_upper: np.ndarray, is_masked: np.ndarray) -> np.ndarray:
    """Add 32 inside masked regions (output.c:309)."""
    return (seq_upper + np.where(is_masked, 32, 0).astype(np.uint8)).astype(np.uint8)
