"""The zstd section codec (the port's copy of ``naf_tpu/codec``, library
engine only)."""

from .zstd_backend import (
    MAX_CLEVEL,
    MIN_CLEVEL,
    WINDOWLOG_MAX,
    WINDOWLOG_MIN,
    SectionCompressor,
    SectionDecompressor,
    SpilledPayload,
    SpillingSectionCompressor,
    check_engine,
    compress_section,
    compress_section_blocked,
    decompress_section,
    decompress_section_blocked,
    iter_decompress,
    parse_blocked_index,
)

__all__ = [
    "MAX_CLEVEL", "MIN_CLEVEL", "WINDOWLOG_MAX", "WINDOWLOG_MIN",
    "SectionCompressor", "SectionDecompressor", "SpilledPayload",
    "SpillingSectionCompressor", "check_engine",
    "compress_section", "compress_section_blocked",
    "decompress_section", "decompress_section_blocked",
    "iter_decompress", "parse_blocked_index",
]
