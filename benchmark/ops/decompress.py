"""Decompress: the reference's archive of the cell's records opened with
``Decoder`` and rendered by ``fasta_device`` / ``fastq_device`` over the
cell's mesh, returning the text (``untnaf --device``).  Opening the archive
is part of the call, as it is for users.  The reference's rendering of the
same records is what it must equal, byte for byte."""

from __future__ import annotations

import io

from benchmark.reference import encoder as RE
from benchmark.reference import records


class Op:
    direction = "decompress"
    SPANS = [("naf_tpu_torch.pipeline.decoder", "Decoder._plan", "plan"),
             ("naf_tpu_torch.pipeline.decoder", "Decoder._load_qual", "qual-unzstd"),
             ("naf_tpu_torch.pipeline.decoder", "_render", "render")]

    def __init__(self, ds, cfg: dict, mesh, spans):
        self.ds, self.mesh, self.spans = ds, mesh, spans
        self.archive = records.archive(ds, RE.EncodeOptions(level=cfg["level"],
                                                            threads=cfg["threads"]))
        self.input = self.archive

    def call(self) -> bytes:
        from naf_tpu_torch.pipeline import decoder

        with self.spans.span("open"):
            dec = decoder.Decoder(io.BytesIO(self.archive))
        if self.ds.fmt == "fastq":
            return decoder.fastq_device(dec, mesh=self.mesh)
        return decoder.fasta_device(dec, mesh=self.mesh)

    @staticmethod
    def device_route(name: str) -> bool:
        return name.startswith("decode_device")

    def expected(self, ds=None) -> bytes:
        """The reference's text of ``ds`` (the cell's records by default)."""
        return records.render(ds or self.ds)

    def work(self, expected: bytes) -> tuple[int, bytes]:
        return len(expected), self.archive
