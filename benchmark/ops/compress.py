"""Compress: one whole file in memory through ``encode_device`` over the
cell's mesh, returning the archive bytes (``tnaf --device`` on a file under
256 MiB).  The reference's archive of the same records is what it must
equal, byte for byte."""

from __future__ import annotations

from benchmark.reference import encoder as RE
from benchmark.reference import records


class Op:
    direction = "compress"
    #: program attributes the traced run times (module, attribute, span)
    SPANS = [("naf_tpu_torch.parallel.pipeline", "make_blocks", "split"),
             ("naf_tpu_torch.parallel.pipeline", "make_blocks_fastq", "split"),
             ("naf_tpu_torch.parallel.mesh", "BlockMesh.upload", "upload"),
             ("naf_tpu_torch.parallel.pipeline", "_stitch_and_build", "stitch")]

    def __init__(self, ds, cfg: dict, mesh, spans):
        from naf_tpu_torch.pipeline.encoder import EncodeOptions

        self.ds, self.mesh = ds, mesh
        self.level, self.threads = cfg["level"], cfg["threads"]
        self.opts = EncodeOptions(level=self.level, threads=self.threads)
        self.input = ds.text

    def call(self) -> bytes:
        from naf_tpu_torch.parallel import pipeline

        return pipeline.encode_device(self.input, self.opts, mesh=self.mesh)[0]

    @staticmethod
    def device_route(name: str) -> bool:
        return name == "encode_device" or name.startswith("encode_device:two_pass:")

    def expected(self, ds=None) -> bytes:
        """The reference's archive of ``ds`` (the cell's records by default)."""
        return records.archive(ds or self.ds, RE.EncodeOptions(level=self.level,
                                                               threads=self.threads))

    def work(self, expected: bytes) -> tuple[int, bytes]:
        """(text bytes, archive) of one call, for the roofline's count."""
        return len(self.input), expected
