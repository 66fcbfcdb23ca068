"""The check has to fail what it exists to catch.  On the CPU at small
sizes, each cell runs whole with the program's output replaced: by the
control (the reference with a guarantee of the configuration broken), and
by each fault a cell can have: the call returns its input unchanged, half
of the batch left out, one byte of the answer altered where it is made,
and, on a mesh, the exchange between the blocks left out.  Each has to come
out not correct; the sound run has to come out correct."""

import json

import numpy as np
import pytest

from benchmark import harness

CELLS = {"chr1.compress": 1, "reads.decompress": 1, "reads.compress": 1,
         "chr1.compress.mesh4": 4}


class Faulty:
    """The cell's op with ``call`` replaced."""

    def __init__(self, op, call):
        self._op, self._call = op, call

    def __getattr__(self, name):
        return getattr(self._op, name)

    def call(self):
        return self._call(self._op)


def unchanged(op, ds, cell):
    return Faulty(op, lambda o: o.input)


def _half_cut(text: bytes, fastq: bool) -> int:
    mid = len(text) // 2
    return text.index(b"\n@" if fastq else b"\n", mid) + 1


def half(op, ds, cell):
    """A compress given the first half of the file; a decompress that
    renders only the first half of the text."""
    fastq = ds.fmt == "fastq"
    if op.direction == "compress":
        from naf_tpu_torch.parallel import pipeline

        part = op.input[:_half_cut(op.input, fastq)]
        return Faulty(op, lambda o: pipeline.encode_device(part, o.opts, mesh=o.mesh)[0])
    return Faulty(op, lambda o: (lambda out: out[:_half_cut(out, fastq)])(o.call()))


def altered(op, ds, cell):
    rng = np.random.default_rng(3)

    def call(o):
        out = bytearray(o.call())
        out[int(rng.integers(0, len(out)))] ^= 1
        return bytes(out)

    return Faulty(op, call)


def run(root, cell, capsys, seed, **kw):
    rc = harness.main(["--workload", cell, "--seed", str(seed), "--seconds", "0.2",
                       "--trace", "0"], root=root, devices=["cpu"] * CELLS[cell], **kw)
    out, _ = capsys.readouterr()
    assert rc == 0
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(small_root, capsys, cell):
    res = run(small_root, cell, capsys, 2**31 + 21)
    assert res["correct"] is True and res["checks"]["bytes_off"]["value"] == 0


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [1, 2**31 + 2, 77])
def test_control_is_not_correct(small_root, capsys, cell, seed):
    res = run(small_root, cell, capsys, seed, wrap_op=harness.control_op)
    assert res["correct"] is False and res["checks"]["bytes_off"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [unchanged, half, altered], ids=lambda f: f.__name__)
def test_fault_is_not_correct(small_root, capsys, cell, fault):
    res = run(small_root, cell, capsys, 2**31 + 22, wrap_op=fault)
    assert res["correct"] is False and res["checks"]["outputs_off"]["value"] > 0


def test_exchange_left_out_is_not_correct(small_root, capsys, monkeypatch):
    """Over the mesh, every block handed block 0's gathered values in place
    of the others'."""
    from naf_tpu_torch.parallel import block, mesh, pipeline

    def first_only(values):
        v = values[0].cpu().numpy()
        return np.stack([v] * len(values))

    for mod in (mesh, block, pipeline):
        monkeypatch.setattr(mod, "all_gather", first_only)
    res = run(small_root, "chr1.compress.mesh4", capsys, 2**31 + 23)
    assert res["correct"] is False and res["checks"]["outputs_off"]["value"] > 0
