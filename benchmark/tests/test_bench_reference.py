"""The reference: it round-trips FASTA and FASTQ, its archives equal the
program's host ``encode()`` byte for byte, and its archives and texts made
from records equal those of a parse of the file."""

import io

import pytest
from bench_cases import REPO, SMALL

from benchmark.generators import assembly, sra_fastq
from benchmark.harness import load_json
from benchmark.reference import decoder as RD
from benchmark.reference import encoder as RE
from benchmark.reference import records

FASTA = b">r1 first\nACGTacgtNNRY\nAC\n>r2\n\n>r3 x z\nggccGGCC\n"
FASTQ = b"@r1 x\nACGTN\n+\nFF:,#\n@r2\nGG\n+r2\n##\n"


def small(name, gen, seed=5):
    cfg = load_json(REPO / "benchmark" / "configs" / f"{name}.json")
    cfg.update(SMALL[name])
    return gen.generate(cfg, seed)


@pytest.mark.parametrize("text,fastq", [(FASTA, False), (FASTQ, True)])
def test_round_trip(text, fastq):
    archive = RE.encode(text, RE.EncodeOptions(level=3))[0]
    dec = RD.Decoder(io.BytesIO(archive))
    want = text.replace(b"+r2\n", b"+\n") if fastq else text.replace(b"\n\n", b"\n")
    assert (dec.fastq() if fastq else dec.fasta()) == want


@pytest.mark.parametrize("text", [FASTA, FASTQ])
@pytest.mark.parametrize("level", [1, 5])
def test_equals_program_host_encode(text, level):
    from naf_tpu_torch.pipeline.encoder import EncodeOptions, encode

    assert (RE.encode(text, RE.EncodeOptions(level=level, threads=2))[0]
            == encode(text, EncodeOptions(level=level, threads=2), device="cpu")[0])


@pytest.mark.parametrize("name,gen", [("hg38-chr1.l1", assembly),
                                      ("sra-novaseq-150.l1", sra_fastq)])
def test_records_equal_parse(name, gen):
    """The archive built from a data set's records equals the reference's
    and the program's encode of its file; the text rendered from the
    records equals the reference decoder's."""
    from naf_tpu_torch.pipeline.encoder import EncodeOptions, encode

    ds = small(name, gen)
    opts = RE.EncodeOptions(level=1, threads=2)
    archive = records.archive(ds, opts)
    assert archive == RE.encode(ds.text, opts)[0]
    assert archive == encode(ds.text, EncodeOptions(level=1, threads=2), device="cpu")[0]
    dec = RD.Decoder(io.BytesIO(archive))
    text = dec.fastq() if ds.fmt == "fastq" else dec.fasta()
    assert records.render(ds) == text
    if ds.fmt == "fasta":
        assert text == ds.text
