"""The metrics read from the program's own spans (``program_spans.py``), on
the CPU at small sizes: a traced run of a compress and of the decompress
cell reports each of them, the times above 0 and the copied bytes equal
to the arithmetic of the cell's sizes; the control's traced run, which
never calls the program, reports none."""

import json

import numpy as np
import pytest
import torch

from benchmark import harness

CPU = ["cpu"]
SEED = 2**31 + 11
NEW = {"compress": ("carry_ms.compress", "zstd_ms.compress", "fetch_ms.compress",
                    "copy_MB.compress"),
       "decompress": ("unzstd_ms.decompress", "build_plan_ms.decompress", "fetch_ms.decompress",
                      "copy_MB.decompress")}


@pytest.fixture
def traced(monkeypatch):
    from naf_tpu_torch.utils import trace

    # a run is a fresh process, which reads NAF_TPU_TRACE at the import
    monkeypatch.setattr(trace, "ENABLED", True)
    trace.clear()
    yield
    trace.clear()


def traced_run(root, cell, capsys, **kw) -> dict:
    rc = harness.main(["--workload", cell, "--seed", str(SEED), "--seconds", "0.2",
                       "--trace", "1"], root=root, devices=CPU, **kw)
    out, _ = capsys.readouterr()
    assert rc == 0
    res = json.loads(out.strip().splitlines()[-1])
    return {k: v["value"] for k, v in res["metrics"].items()}


def chr1_copy_bytes(root) -> int:
    """One call's uploads and fetches on the fused FASTA path: the block up;
    the scalars, the used prefix of the packed row and of the two sparse
    rows back."""
    from naf_tpu_torch.parallel.block import FASTA_SCALARS, fused_blocks_sharded, make_blocks

    text = harness.Cell(root, "chr1.compress").generate(SEED).text
    blocks = make_blocks(np.frombuffer(text, np.uint8)[1:], 1)
    xs = [torch.from_numpy(blocks.data[0].copy())]
    scal = fused_blocks_sharded(xs, blocks.prev, blocks.starts_in_seq, 0, seq_type=0)[1][0]
    cnt, n_sp = int(scal[0]), int(scal[FASTA_SCALARS.index("n_sp")])
    return blocks.data.nbytes + 4 * len(FASTA_SCALARS) + (cnt + 1) // 2 + 1 + 2 * 4 * n_sp


def reads_copy_bytes(root) -> int:
    """One call's uploads and fetches on the ragged render of one batch: the
    packed bases, the qualities, three i32 prefix sums a record and the
    header lines up; the text back (the '+' line bare, as unnaf writes it)."""
    from benchmark.reference import records

    text = records.render(harness.Cell(root, "reads.decompress").generate(SEED))
    lines = text.split(b"\n")[:-1]
    bases = sum(len(s) for s in lines[1::4])
    headers = sum(len(h) + 1 for h in lines[0::4])
    return (bases + 1) // 2 + bases + 3 * 4 * len(lines) // 4 + headers + len(text)


@pytest.mark.parametrize("cell,direction,copied", [
    ("chr1.compress", "compress", chr1_copy_bytes),
    ("reads.decompress", "decompress", reads_copy_bytes),
])
def test_traced_run_reads_the_program_spans(cell, direction, copied, small_root, capsys,
                                            traced):
    m = traced_run(small_root, cell, capsys)
    assert set(NEW[direction]) <= set(m)
    for name in NEW[direction]:
        assert m[name] > 0, name
    assert m[f"copy_MB.{direction}"] == pytest.approx(copied(small_root) / 1e6, rel=1e-12)
    if direction == "compress":
        # the carry and the sections' zstd lie inside _stitch_and_build
        assert m["carry_ms.compress"] + m["zstd_ms.compress"] <= m["stitch_ms.compress"]
    else:
        assert m["build_plan_ms.decompress"] <= m["plan_ms.decompress"]


@pytest.mark.parametrize("cell,direction", [("chr1.compress", "compress"),
                                            ("reads.decompress", "decompress")])
def test_control_reports_no_program_span(cell, direction, small_root, capsys, traced):
    m = traced_run(small_root, cell, capsys, wrap_op=harness.control_op)
    assert not set(NEW[direction]) & set(m)
