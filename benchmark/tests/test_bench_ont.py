"""The Nanopore configuration (``sra-ont-r94.l1``) and its cell,
``ont.compress``: the generator's bytes and shapes, the size and the sparse
entries that keep the full file on the fused FASTQ route whatever the seed,
a whole small run on the CPU (sound, and the control), and the cell on the
card."""

import json
import subprocess
import sys

import numpy as np
import pytest
from bench_cases import REPO

from benchmark import harness
from benchmark.generators import ont_fastq

NAME = "sra-ont-r94.l1"
#: the keys the small copy replaces
SMALL = {"reads": 24, "threads": 2}
RUN = b"SRR7990034."


def config(root=REPO) -> dict:
    return json.loads((root / "benchmark" / "configs" / f"{NAME}.json").read_text())


@pytest.fixture
def ont_root(small_root):
    """The small copy of the benchmark, with the Nanopore configuration cut
    to ``SMALL``."""
    path = small_root / "benchmark" / "configs" / f"{NAME}.json"
    cfg = json.loads(path.read_text())
    cfg.update(SMALL)
    path.write_text(json.dumps(cfg))
    return small_root


def test_same_seed_same_bytes(ont_root):
    cfg = config(ont_root)
    assert cfg["reads"] == SMALL["reads"]
    a, b = ont_fastq.generate(cfg, 2**31 + 11), ont_fastq.generate(cfg, 2**31 + 11)
    c = ont_fastq.generate(cfg, 2**31 + 12)
    assert a.text == b.text and a.comments_blob == b.comments_blob
    assert np.array_equal(a.qual, b.qual) and np.array_equal(a.lengths, b.lengths)
    assert a.text != c.text
    assert ont_fastq.generate(cfg, -3).text == ont_fastq.generate(cfg, -3).text


def test_deflines_and_qualities(ont_root):
    """``@<run>.<spot> <uuid> length=<L>``, the ``+`` line repeating it,
    each line of the record's length; bases ACGT; qualities Phred 1-40
    (``"`` to ``I``), ``:`` among them; the records the reference gets."""
    cfg = dict(config(ont_root), reads=400)
    ds = ont_fastq.generate(cfg, 2**31 + 13)
    lines = ds.text.split(b"\n")
    assert lines[-1] == b"" and len(lines) == 4 * 400 + 1
    ids, comments = ds.ids_blob.split(b"\0")[:-1], ds.comments_blob.split(b"\0")[:-1]
    for i in range(400):
        head, seq, plus, qual = lines[4 * i:4 * i + 4]
        ident, read_id, length = head[1:].split(b" ")
        assert head[:1] == b"@" and ident == RUN + b"%d" % (i + 1) == ids[i]
        parts = read_id.split(b"-")
        assert [len(x) for x in parts] == [8, 4, 4, 4, 12] and parts[2][:1] == b"4"
        assert length == b"length=%d" % len(seq) and comments[i] == read_id + b" " + length
        assert plus == b"+" + head[1:] and len(qual) == len(seq) == ds.lengths[i]
    assert set(np.unique(ds.seq).tobytes()) == set(b"ACGT")
    assert ds.qual.min() >= ord('"') and ds.qual.max() <= ord("I")
    assert 0.001 < float(np.mean(ds.qual == ord(":"))) < 0.006
    assert ds.longest_line == int(ds.lengths.max())


def _sparse_entries_per_tile(text: bytes, tile: int) -> np.ndarray:
    """The fused FASTQ emit's sparse entries in each tile of the one-block
    body (the text after its first ``@``): every comment byte of a defline
    (after its first space) and every record start; no case changes."""
    body = np.frombuffer(text, np.uint8)[1:]
    lf = np.flatnonzero(body == 10)
    line_start = np.concatenate([[0], lf[:-1] + 1])
    head_end = lf[0::4]
    sp = np.flatnonzero(body == 32)
    line = np.searchsorted(lf, sp)
    sp, line = sp[line % 4 == 0], line[line % 4 == 0]
    first = sp[np.concatenate([[True], line[1:] != line[:-1]])]
    n_com = head_end - first - 1
    com = np.repeat(first + 1 - np.concatenate([[0], np.cumsum(n_com)[:-1]]), n_com)
    com += np.arange(int(n_com.sum()))
    entries = np.concatenate([com, line_start[4::4]])
    return np.bincount(entries // tile, minlength=body.size // tile + 1)


def test_sparse_count_is_the_emits(ont_root):
    """The count above equals the plain FASTQ emit's ``n_sp``."""
    import torch

    from naf_tpu_torch.ops.common import Q_TILE
    from naf_tpu_torch.ops.emit_fused import emit_fastq_plain

    ds = ont_fastq.generate(config(ont_root), 2**31 + 14)
    block = torch.from_numpy(np.frombuffer(ds.text, np.uint8)[1:].copy())
    out = emit_fastq_plain(block, ord("@"))
    assert int(out["sp_ok"]) == 1
    assert int(out["n_sp"]) == int(_sparse_entries_per_tile(ds.text, Q_TILE).sum())


@pytest.mark.parametrize("seed", [2**31 + 15, 16])
def test_full_size_stays_on_the_fused_route(seed):
    """18,000 reads: about 234 MB, under the CLI's 256 MiB, and no 32 KiB
    tile holds half the fused emit's sparse cap, so no seed sends the file
    to the two-pass encode."""
    from naf_tpu_torch.ops.common import Q_TILE
    from naf_tpu_torch.ops.emit_fused import CS_CAP

    ds = ont_fastq.generate(config(), seed)
    assert 229_000_000 < len(ds.text) < 239_000_000 and len(ds.text) < 268_435_456
    assert _sparse_entries_per_tile(ds.text, Q_TILE).max() < CS_CAP // 2
    assert 50_000 < ds.longest_line < 1_000_000


def _run(root, cell, capsys, seed, **kw):
    rc = harness.main(["--workload", cell, "--seed", str(seed), "--seconds", "0.2",
                       "--trace", "0"], root=root, devices=["cpu"], **kw)
    out, err = capsys.readouterr()
    assert rc == 0
    return json.loads(out.strip().splitlines()[-1]), err


@pytest.mark.parametrize("cell,route", [("ont.compress", "encode_device")])
def test_small_run_is_correct_and_control_is_not(ont_root, capsys, cell, route):
    res, err = _run(ont_root, cell, capsys, 2**31 + 17)
    assert res["correct"] is True and res["checks"]["bytes_off"]["value"] == 0
    routes = json.loads(next(x for x in err.splitlines() if x.startswith("routes: "))[8:])
    assert list(routes) == [route]
    res, _ = _run(ont_root, cell, capsys, 2**31 + 18, wrap_op=harness.control_op)
    assert res["correct"] is False and res["checks"]["bytes_off"]["value"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["ont.compress"])
def test_cell_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                        str(2**31 + 31), "--seconds", "1", "--trace", "0"], cwd=REPO,
                       capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-4000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
    assert res["device"]["count"] == 1
