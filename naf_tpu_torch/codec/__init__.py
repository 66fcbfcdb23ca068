"""The zstd section codec (the port's copy of ``naf_tpu/codec``: the
library engine, the native engine and the device match-finder engine)."""

from .zstd_backend import (
    MAX_CLEVEL,
    MIN_CLEVEL,
    WINDOWLOG_MAX,
    WINDOWLOG_MIN,
    SectionCompressor,
    SectionDecompressor,
    SpilledPayload,
    SpillingSectionCompressor,
    blocked_payload,
    check_engine,
    compress_frames,
    compress_part_native,
    compress_section,
    compress_section_blocked,
    compress_section_device,
    compress_section_native,
    compress_section_parts,
    decode_engine,
    decompress_section,
    decompress_section_blocked,
    decompress_section_native,
    iter_decompress,
    parse_blocked_index,
    set_decode_engine,
    stitch_section_frame,
)

__all__ = [
    "MAX_CLEVEL", "MIN_CLEVEL", "WINDOWLOG_MAX", "WINDOWLOG_MIN",
    "SectionCompressor", "SectionDecompressor", "SpilledPayload",
    "SpillingSectionCompressor", "check_engine",
    "compress_section", "compress_section_blocked", "compress_frames", "blocked_payload",
    "decompress_section", "decompress_section_blocked",
    "iter_decompress", "parse_blocked_index",
    "compress_section_native", "compress_section_device", "compress_part_native",
    "compress_section_parts",
    "stitch_section_frame", "decompress_section_native",
    "set_decode_engine", "decode_engine",
]
