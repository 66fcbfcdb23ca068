"""The generators: the same bytes for the same seed, and the shapes the
configurations state."""

import json

import numpy as np
import pytest
from bench_cases import REPO, SMALL

from benchmark.generators import assembly, sra_fastq


def config(name: str, small: bool = True) -> dict:
    cfg = json.loads((REPO / "benchmark" / "configs" / f"{name}.json").read_text())
    if small:
        cfg.update(SMALL[name])
    return cfg


@pytest.mark.parametrize("gen,name", [(assembly, "hg38-chr1.l1"),
                                      (sra_fastq, "sra-novaseq-150.l1")])
def test_same_seed_same_bytes(gen, name):
    cfg = config(name)
    a, b = gen.generate(cfg, 2**31 + 11), gen.generate(cfg, 2**31 + 11)
    c = gen.generate(cfg, 2**31 + 12)
    assert a.text == b.text and a.ids_blob == b.ids_blob and np.array_equal(a.seq, b.seq)
    assert a.text != c.text
    assert gen.generate(cfg, -3).text == gen.generate(cfg, -3).text


def test_chr1_shape():
    """The whole chr1 configuration: one record of 248,956,422 bases in
    lines of 50, about half soft-masked, GRCh38 chr1's 18,475,410 N."""
    cfg = config("hg38-chr1.l1", small=False)
    ds = assembly.generate(cfg, 7)
    n = 248_956_422
    assert ds.lengths.tolist() == [n] and ds.seq.size == n
    lines = ds.text.split(b"\n")
    assert lines[0] == b">chr1" and lines[-1] == b""
    assert {len(x) for x in lines[1:-2]} == {50} and len(lines[-2]) == n % 50
    assert len(ds.text) == 253_935_557 < 256 << 20
    assert int(np.count_nonzero(ds.seq == ord("N"))) == 18_475_410
    masked = float(np.mean(ds.seq >= 97))
    assert 0.4 < masked < 0.6
    runs = np.count_nonzero(np.diff((ds.seq >= 97).astype(np.int8)) == 1)
    assert 100_000 < runs < 1_000_000                   # runs of hundreds of bases
    assert set(np.unique(ds.seq).tobytes()) <= set(b"ACGTNacgt")


def test_sra_deflines_and_qualities():
    cfg = config("sra-novaseq-150.l1")
    ds = sra_fastq.generate(cfg, 99)
    lines = ds.text.split(b"\n")[:-1]
    assert len(lines) == 4 * 1500
    for i in (0, 1, 1499):
        head, seq, plus, qual = lines[4 * i:4 * i + 4]
        run, inst = head[1:].split(b" ", 1)
        assert run == b"SRR6821753.%d" % (i + 1)
        parts = inst.split(b":")
        assert parts[:4] == [b"A00123", b"8", b"H5KJ3DSXX", b"1"] and len(parts) == 7
        assert 1101 <= int(parts[4]) < 2679
        assert parts[6].endswith(b" length=150")
        assert plus == b"+" + head[1:]
        assert len(seq) == len(qual) == 150
    assert set(np.unique(ds.qual).tobytes()) == set(b"F:,#")
    assert set(np.unique(ds.seq).tobytes()) <= set(b"ACGTN")
    assert ds.ids_blob.count(b"\0") == ds.comments_blob.count(b"\0") == 1500


def test_sra_full_size_is_in_memory():
    """400,000 spots: about 174.5 MB, under the CLI's 256 MiB."""
    ds = sra_fastq.generate(config("sra-novaseq-150.l1", small=False), 1)
    assert 174_000_000 < len(ds.text) < 175_000_000
