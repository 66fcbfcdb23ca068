"""The zstd section codec (the port's copy of ``naf_tpu/codec``, library
engine only)."""

from .zstd_backend import (
    SectionCompressor,
    SectionDecompressor,
    check_engine,
    compress_section,
    compress_section_blocked,
    decompress_section,
    decompress_section_blocked,
    iter_decompress,
)

__all__ = [
    "SectionCompressor", "SectionDecompressor", "check_engine",
    "compress_section", "compress_section_blocked",
    "decompress_section", "decompress_section_blocked",
    "iter_decompress",
]
