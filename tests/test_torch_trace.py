"""naf_tpu_torch's tracing (``utils/trace.py``) against naf_tpu's.

``NAF_TPU_TRACE``: both packages' CLIs run as subprocesses on the same
seeded inputs (``untnaf -c`` of a FASTA and of a FASTQ archive on the host
path, ``tnaf -c`` of a pipe that streams in at least three pieces); once
the times and rates are masked, their stderr lines are equal: the same
stages (``seq-unzstd``, ``seq+qual-unzstd``, ``render``, ``scan``) in the
same order with the same ``bytes=`` and ``mode=`` fields.  Any non-empty
value turns tracing on in both, ``0`` included.  The port's host FASTQ
render decompresses the sequence and quality on two threads when neither
is loaded, and its output equals the input and naf_tpu's
``Decoder.fastq()``.  ``NAF_TPU_PROFILE=dir``: ``tnaf --device`` and
``untnaf --device``, the card replaced by the CPU, write one parseable
torch.profiler trace each and the same bytes as without it; a profiler
fault ends the CLI with its device error; without ``--device`` the CLIs
load no torch, with the span record on.  The span record: the device
encode and decode on the CPU record naf_tpu_torch's span tree (names,
parents, children inside their parents, byte counts equal to the sizes
copied and stored; the fused FASTA and long-read FASTQ parses' ``sparse``
span with the emit's sparse entries and the archive's records; a FASTQ
split's ``grid`` span with its records and the check that ran), spans
opened on the section pool's and the two-thread decompress's threads name
their submitter, nothing is recorded with tracing off, the record keeps
its last ``CAP`` spans, and under a CPU profiler the spans are ranges that
name an idle gap.  Decoded inputs stay under 2**21 chars, below naf_tpu's
multithreaded render (F1 in ROADMAP.md).
"""

from __future__ import annotations

import io
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from naf_tpu.pipeline import decoder as RDEC
from naf_tpu.pipeline import stream as RSTREAM
from naf_tpu_torch import device as D
from naf_tpu_torch.format.container import NafReader
from naf_tpu_torch.parallel import pipeline as PPIPE
from naf_tpu_torch.parallel.block import (FASTA_SCALARS, FASTQ_SCALARS,
                                          fused_blocks_fastq_sharded, fused_blocks_sharded,
                                          make_blocks, make_blocks_fastq)
from naf_tpu_torch.pipeline import decoder as PDEC
from naf_tpu_torch.pipeline import encoder as PENC
from naf_tpu_torch.pipeline import stream as PSTREAM
from naf_tpu_torch.utils import trace

from torch_cases import long_read_fastq, mixed_fasta, mixed_fastq

REPO = Path(__file__).resolve().parent.parent
#: a span's time and rate, the only parts of a trace line that may differ
_TIMES = re.compile(rb"\s+\d+\.\d\d ms( \(\d+ MB/s\))?")


def _env(tmp: Path, **extra) -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("NAF_TPU", "JAX", "XLA"))}
    env.update(PYTHONPATH=str(REPO), TMPDIR=str(tmp), JAX_PLATFORMS="cpu", **extra)
    return env


def _run(pkg: str, tool: str, args: list, tmp: Path, stdin: bytes = b"", **env):
    return subprocess.run([sys.executable, "-m", f"{pkg}.cli.{tool}", *args], input=stdin,
                          capture_output=True, env=_env(tmp, **env), cwd=tmp, timeout=300)


def _spans(stderr: bytes) -> list:
    """The trace lines of ``stderr``, times and rates masked."""
    return [_TIMES.sub(b" <t>", line) for line in stderr.splitlines()
            if line.startswith(b"[naf-trace] ")]


def _stages(stderr: bytes) -> list:
    return [line.split()[1].decode() for line in _spans(stderr)]


def _long_fasta(n: int, seed: int = 30) -> bytes:
    """About ``n`` bytes of FASTA: records of 0.2-2 Mbp, 60-char lines,
    soft-masked stretches."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGTACGTACGTNacgt", np.uint8)
    out, size, i = [], 0, 0
    while size < n:
        ln = int(rng.integers(200_000, 2_000_000)) // 60 * 60
        lines = rng.choice(alpha, size=(ln // 60, 61))
        lines[:, 60] = ord("\n")
        rec = b">chr%d sample\n" % i + lines.tobytes()
        out.append(rec)
        size += len(rec)
        i += 1
    return b"".join(out)


@pytest.fixture(scope="module")
def archives(tmp_path_factory) -> Path:
    d = tmp_path_factory.mktemp("trace_archives")
    for name, data in (("dna", mixed_fasta(seed=31, n_rec=60)),
                       ("reads", mixed_fastq(seed=32, n_rec=400))):
        (d / f"{name}.naf").write_bytes(PENC.encode(data, PENC.EncodeOptions())[0])
    return d


# ---------------------------------------------------------------------------
# (a) the two CLIs trace the same stages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("archive,stages", [
    ("dna", ["seq-unzstd", "render"]),
    ("reads", ["seq+qual-unzstd", "render"]),
], ids=["untnaf_fasta", "untnaf_fastq"])
def test_untnaf_traces_as_naf_tpu(archive, stages, archives, tmp_path):
    args = ["-c", str(archives / f"{archive}.naf")]
    port = _run("naf_tpu_torch", "untnaf", args, tmp_path, NAF_TPU_TRACE="1")
    ref = _run("naf_tpu", "untnaf", args, tmp_path, NAF_TPU_TRACE="1")
    assert port.returncode == ref.returncode == 0, port.stderr + ref.stderr
    assert port.stdout == ref.stdout
    assert _spans(port.stderr) == _spans(ref.stderr)
    assert _stages(port.stderr) == stages
    assert [line for line in port.stderr.splitlines() if not line.startswith(b"[naf-trace]")] \
        == []


def test_streamed_tnaf_traces_as_naf_tpu(tmp_path):
    """A pipe streams: one ``scan`` span a piece, at least three pieces."""
    assert PSTREAM.DEFAULT_CHUNK == RSTREAM.DEFAULT_CHUNK
    data = _long_fasta(3 * PSTREAM.DEFAULT_CHUNK + PSTREAM.DEFAULT_CHUNK // 2)
    port = _run("naf_tpu_torch", "tnaf", ["-c"], tmp_path, data, NAF_TPU_TRACE="1")
    ref = _run("naf_tpu", "tnaf", ["-c"], tmp_path, data, NAF_TPU_TRACE="1")
    assert port.returncode == ref.returncode == 0, port.stderr + ref.stderr
    assert port.stdout == ref.stdout
    assert _spans(port.stderr) == _spans(ref.stderr)
    stages = _stages(port.stderr)
    assert set(stages) == {"scan"} and len(stages) >= 3


# ---------------------------------------------------------------------------
# (b) which values turn tracing on
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("value,on", [(None, False), ("", False), ("0", True), ("1", True)],
                         ids=["unset", "empty", "zero", "one"])
@pytest.mark.parametrize("pkg", ["naf_tpu_torch", "naf_tpu"])
def test_trace_variable(pkg, value, on, archives, tmp_path):
    env = {} if value is None else {"NAF_TPU_TRACE": value}
    r = _run(pkg, "untnaf", ["-c", str(archives / "dna.naf")], tmp_path, **env)
    assert r.returncode == 0, r.stderr
    assert (b"[naf-trace]" in r.stderr) == on
    if not on:
        assert r.stderr == b""


# ---------------------------------------------------------------------------
# (c) the two-thread FASTQ decompress
# ---------------------------------------------------------------------------

@pytest.fixture
def traced(monkeypatch, capsys):
    """Tracing on in this process; returns a reader of the stages printed
    since the last read, with their fields."""
    monkeypatch.setattr(trace, "ENABLED", True)
    capsys.readouterr()

    def read() -> list:
        return [(line.split()[1], dict(f.split("=") for f in line.split() if "=" in f))
                for line in capsys.readouterr().err.splitlines()
                if line.startswith("[naf-trace] ")]
    return read


def _counting_decodes(monkeypatch) -> list:
    calls = []
    real = PDEC.Decoder._decode_payload

    def counted(self, payload, expect):
        calls.append(expect)
        return real(self, payload, expect)
    monkeypatch.setattr(PDEC.Decoder, "_decode_payload", counted)
    return calls


@pytest.mark.parametrize("masked", [False, True], ids=["upper", "masked"])
def test_fastq_decompresses_on_two_threads(masked, traced, monkeypatch):
    data = mixed_fastq(seed=33, n_rec=500)
    if not masked:
        data = data.upper()
    blob = PENC.encode(data, PENC.EncodeOptions())[0]
    total = sum(len(line) for line in data.split(b"\n")[1::4])
    calls = _counting_decodes(monkeypatch)
    d = PDEC.Decoder(io.BytesIO(blob))
    out = d.fastq()
    assert out == RDEC.Decoder(io.BytesIO(blob), RDEC.DecodeOptions()).fastq()
    if not masked:
        assert out == data
    assert traced() == [("seq+qual-unzstd", {"bytes": str((total + 1) // 2 + total)}),
                        ("render", {"bytes": str(total), "mode": "4"})]
    assert sorted(calls) == sorted([(total + 1) // 2, total])
    assert d._seq_raw is not None and d._qual.size == total
    assert d._load_qual() is d._qual and len(calls) == 2     # no second decompress


def test_fastq_with_its_sequence_loaded_takes_the_serial_loads(traced, monkeypatch):
    data = mixed_fastq(seed=34, n_rec=300)
    blob = PENC.encode(data, PENC.EncodeOptions())[0]
    total = sum(len(line) for line in data.split(b"\n")[1::4])
    d = PDEC.Decoder(io.BytesIO(blob))
    d._batch_metadata(False)
    d._load_seq_raw()
    calls = _counting_decodes(monkeypatch)
    out = d.fastq()
    assert out == RDEC.Decoder(io.BytesIO(blob), RDEC.DecodeOptions()).fastq()
    assert [s for s, _ in traced()] == ["seq-unzstd", "render"]
    assert calls == [total]                  # the quality alone, after the sequence


@pytest.mark.parametrize("fastq", [False, True], ids=["fasta", "fastq"])
def test_device_decodes_trace_the_sequence_load(fastq, traced):
    """``fasta_device`` / ``fastq_device`` load the sequence through
    ``_load_seq_raw``, as naf_tpu's do: one ``seq-unzstd`` span, and no
    two-thread load (the quality follows the plan)."""
    data = mixed_fastq(seed=35, n_rec=200) if fastq else mixed_fasta(seed=35, n_rec=30)
    blob = PENC.encode(data, PENC.EncodeOptions())[0]
    d = PDEC.Decoder(io.BytesIO(blob))
    out = (PDEC.fastq_device(d, device="cpu") if fastq
           else PDEC.fasta_device(d, device="cpu"))
    ref = RDEC.Decoder(io.BytesIO(blob), RDEC.DecodeOptions())
    assert out == (ref.fastq() if fastq else ref.fasta())
    assert [s for s, _ in traced()] == ["seq-unzstd"]


# ---------------------------------------------------------------------------
# (d) NAF_TPU_PROFILE around the CLI's --device paths, the card replaced by the CPU
# ---------------------------------------------------------------------------

class _Std:
    def __init__(self, data: bytes = b""):
        self.buffer = io.BytesIO(data)

    def isatty(self) -> bool:
        return False


@pytest.fixture
def cpu_card(monkeypatch):
    monkeypatch.setattr(D, "cuda_device", lambda: torch.device("cpu"))
    monkeypatch.setenv("NAF_TPU_STREAM_THRESHOLD", "1024")
    monkeypatch.setenv("NAF_TPU_DEVICE_CHUNK", "4096")
    monkeypatch.delenv("NAF_TPU_PROFILE", raising=False)
    monkeypatch.delenv("TMPDIR", raising=False)
    monkeypatch.delenv("TMP", raising=False)


def _main(tool: str, argv: list, monkeypatch, stdin: bytes = b"") -> tuple:
    """(status, stdout, stderr) of the port's ``tool`` main in this process."""
    from importlib import import_module

    io_ = {k: _Std(stdin if k == "stdin" else b"") for k in ("stdin", "stdout", "stderr")}
    for k, v in io_.items():
        monkeypatch.setattr(sys, k, v)
    try:
        rc = import_module(f"naf_tpu_torch.cli.{tool}").main(argv)
    except SystemExit as e:
        rc = e.code
    return rc, io_["stdout"].buffer.getvalue(), io_["stderr"].buffer.getvalue()


def _one_trace(directory: Path) -> list:
    files = list(directory.iterdir())
    assert [f.name for f in files] == [f"naf_tpu_torch.{os.getpid()}.trace.json"]
    events = json.loads(files[0].read_text())["traceEvents"]
    assert events
    return events


@pytest.mark.parametrize("kind", ["fasta", "fastq", "fasta_pipe"])
def test_profile_writes_one_trace_a_call(kind, cpu_card, monkeypatch, tmp_path):
    data = (mixed_fastq(seed=36, n_rec=200) if kind == "fastq"
            else mixed_fasta(seed=36, n_rec=20))
    src = tmp_path / ("in.fq" if kind == "fastq" else "in.fa")
    src.write_bytes(data)
    if kind == "fasta_pipe":      # a pipe: tnaf --device streams, 4096-byte pieces
        enc = lambda: _main("tnaf", ["--device", "-c"], monkeypatch, stdin=data)  # noqa: E731
    else:
        enc = lambda: _main("tnaf", ["--device", "-c", str(src)], monkeypatch)  # noqa: E731
    rc, plain, err = enc()
    assert (rc, err) == (0, b"")
    monkeypatch.setenv("NAF_TPU_PROFILE", str(tmp_path / "enc"))
    rc, blob, err = enc()
    assert (rc, err) == (0, b"") and blob == plain
    assert blob == PENC.encode(data, PENC.EncodeOptions())[0]
    assert any(e.get("ph") == "X" for e in _one_trace(tmp_path / "enc"))

    (tmp_path / "in.naf").write_bytes(blob)
    dec = ["--device", "-c", str(tmp_path / "in.naf")]
    monkeypatch.delenv("NAF_TPU_PROFILE")
    rc, plain, err = _main("untnaf", dec, monkeypatch)
    assert (rc, err) == (0, b"")
    monkeypatch.setenv("NAF_TPU_PROFILE", str(tmp_path / "dec"))
    rc, out, err = _main("untnaf", dec, monkeypatch)
    assert (rc, err) == (0, b"") and out == plain
    ref = RDEC.Decoder(io.BytesIO(blob), RDEC.DecodeOptions())
    assert out == (ref.fastq() if kind == "fastq" else ref.fasta())
    assert any(e.get("ph") == "X" for e in _one_trace(tmp_path / "dec"))


@pytest.mark.parametrize("tool", ["tnaf", "untnaf"])
def test_profile_fault_ends_with_the_device_error(tool, cpu_card, monkeypatch, tmp_path):
    """A trace directory that cannot be made ends the CLI as any device
    fault does: its error line, status 1, no output file."""
    data = mixed_fasta(seed=37, n_rec=10)
    (tmp_path / "in.fa").write_bytes(data)
    (tmp_path / "in.naf").write_bytes(PENC.encode(data, PENC.EncodeOptions())[0])
    (tmp_path / "taken").write_bytes(b"")
    monkeypatch.setenv("NAF_TPU_PROFILE", str(tmp_path / "taken"))
    src = tmp_path / ("in.fa" if tool == "tnaf" else "in.naf")
    rc, out, err = _main(tool, ["--device", "-o", str(tmp_path / "out"), str(src)], monkeypatch)
    what = "encode" if tool == "tnaf" else "decode"
    assert rc == 1 and out == b""
    assert err.startswith(f"{tool} error: device {what} failed: ".encode()), err
    if tool == "tnaf":
        assert not (tmp_path / "out").exists()


# ---------------------------------------------------------------------------
# (e) the host paths load no torch, traced and under NAF_TPU_PROFILE
# ---------------------------------------------------------------------------

_NO_TORCH = r"""
import io, sys
from naf_tpu_torch.cli import {tool}
sys.stdin = io.TextIOWrapper(io.BytesIO(open(sys.argv[1], "rb").read()))
try:
    rc = {tool}.main(sys.argv[2:])
except SystemExit as e:
    rc = e.code
from naf_tpu_torch.utils.trace import device_profile, spans
assert spans(), "nothing recorded"
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("torch", "jax", "naf_tpu"))
assert not bad, bad
print(rc, file=sys.stderr)
"""


@pytest.mark.parametrize("tool,args", [
    ("tnaf", ["-o", "{out}", "{in}"]), ("tnaf", ["-c"]),
    ("untnaf", ["-c", "{naf}"]), ("untnaf", ["-c", "{fq}"]),
], ids=["tnaf_file", "tnaf_pipe_stream", "untnaf_fasta", "untnaf_fastq"])
def test_traced_host_cli_loads_no_torch(tool, args, archives, tmp_path):
    src = tmp_path / "in.fa"
    src.write_bytes(mixed_fasta(seed=38, n_rec=20))
    subs = {"{in}": str(src), "{out}": str(tmp_path / "o.naf"),
            "{naf}": str(archives / "dna.naf"), "{fq}": str(archives / "reads.naf")}
    r = subprocess.run([sys.executable, "-c", _NO_TORCH.format(tool=tool), str(src),
                        *[subs.get(a, a) for a in args]],
                       capture_output=True, cwd=tmp_path, timeout=300,
                       env=_env(tmp_path, NAF_TPU_TRACE="1", NAF_TPU_PROFILE=str(tmp_path / "prof"),
                                **({"NAF_TPU_STREAM_THRESHOLD": "1"} if tool == "tnaf" else {})))
    assert r.returncode == 0, r.stderr.decode()
    assert r.stderr.splitlines()[-1] == b"0"
    assert b"[naf-trace]" in r.stderr
    assert not (tmp_path / "prof").exists()


# ---------------------------------------------------------------------------
# (f) the span record: the device encode and decode on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture
def recorded(traced):
    """Tracing on and the record empty; returns the stderr reader."""
    trace.clear()
    yield traced
    trace.clear()


def _checked_tree(spans: list) -> dict:
    """The spans by id, each child held inside its parent's interval and
    root."""
    by_id = {s.id: s for s in spans}
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent is None:
            assert s.root == s.id
            continue
        p = by_id[s.parent]
        assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns, (p, s)
        assert s.root == p.root
    return by_id


def _path(s, by_id: dict) -> str:
    names = [s.name]
    while s.parent is not None:
        s = by_id[s.parent]
        names.append(s.name)
    return "/".join(reversed(names))


def _payload_sizes(blob: bytes) -> dict:
    """Each section's compressed payload bytes in an archive."""
    r = NafReader(io.BytesIO(blob))
    out = {}
    for key in r._ORDER[1:]:
        if r._present(key):
            _, c = r.section_sizes(key)
            r._skip_ahead(c)
            out[key] = c
    return out


def _dense_header_fastq(n: int) -> bytes:
    """Reads whose comments overflow the fused emit's sparse channel."""
    return b"".join(b"@h%d very long comment line to overflow\nACGT\n+\nIIII\n" % i
                    for i in range(n))


_ENCODE_CASES = {
    "fasta_fused": (lambda: mixed_fasta(seed=40, n_rec=30), "encode_device",
                    {"encode", "encode/split", "encode/upload", "encode/emit", "encode/fetch",
                     "encode/parse", "encode/parse/fetch", "encode/parse/sparse", "encode/carry",
                     "encode/sections", "encode/sections/zstd", "encode/container"}),
    "fastq_fused": (lambda: long_read_fastq(seed=40), "encode_device",
                    {"encode", "encode/split", "encode/split/grid", "encode/upload",
                     "encode/emit", "encode/fetch",
                     "encode/parse", "encode/parse/fetch", "encode/parse/sparse", "encode/carry",
                     "encode/sections", "encode/sections/zstd", "encode/container"}),
    "fastq_two_pass": (lambda: _dense_header_fastq(3000), "encode_device:two_pass:sparse_overflow",
                       {"encode", "encode/split", "encode/split/grid", "encode/upload",
                        "encode/emit", "encode/fetch", "encode/emit/fetch", "encode/parse", "encode/carry",
                        "encode/sections",
                        "encode/sections/zstd", "encode/container"}),
}


@pytest.mark.parametrize("case", list(_ENCODE_CASES))
def test_device_encode_records_its_span_tree(case, recorded):
    make, route, paths = _ENCODE_CASES[case]
    data = make()
    blob = PPIPE.encode_device(data, PENC.EncodeOptions(), device="cpu")[0]
    spans = trace.spans()
    assert blob == PENC.encode(data, PENC.EncodeOptions())[0]
    by_id = _checked_tree(spans)
    root = spans[-1]
    assert root.name == "encode" and {s.root for s in spans} == {root.id}
    assert root.fields == {"bytes": len(data), "blocks": 1, "route": route}
    assert {_path(s, by_id) for s in spans} == paths
    # the upload is the block, byte for byte; the fetches count their tensors
    body = np.frombuffer(data, np.uint8)[1:]
    blocks = make_blocks_fastq(body, 1)[0] if case.startswith("fastq") else make_blocks(body, 1)
    assert [s.fields for s in spans if s.name == "upload"] == [{"bytes": blocks.data.nbytes}]
    assert [s.fields for s in spans if s.name == "split"] == [{"bytes": body.size}]
    assert all(s.fields["bytes"] > 0 for s in spans if s.name == "fetch")
    # each section's zstd: its name, and the payload the archive stores
    zstd = {s.fields["section"]: s.fields for s in spans if s.name == "zstd"}
    assert {k: f["out"] for k, f in zstd.items()} == _payload_sizes(blob)
    assert [s.fields for s in spans if s.name == "container"] == [{"out": len(blob)}]
    assert recorded() == []                # every encode span is silent on stderr


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_fastq_split_records_its_grid_check(path, recorded, monkeypatch):
    """A FASTQ encode's ``split`` holds one ``grid`` span: the bytes
    checked, the records found and which check ran (``native`` 1 for the
    host library's pass, 0 for the numpy fallback)."""
    from naf_tpu_torch.native import host as native

    if path == "numpy":
        monkeypatch.setattr(native, "available", lambda: False)
    data = mixed_fastq(seed=48, n_rec=120)
    PPIPE.encode_device(data, PENC.EncodeOptions(), device="cpu")
    spans = trace.spans()
    by_id = _checked_tree(spans)
    (grid,) = [s for s in spans if s.name == "grid"]
    assert by_id[grid.parent].name == "split"
    assert grid.fields == {"bytes": len(data) - 1, "records": data.count(b"\n") // 4,
                           "native": int(path == "native")}


def test_fasta_split_records_no_grid_check(recorded):
    PPIPE.encode_device(mixed_fasta(seed=48, n_rec=20), PENC.EncodeOptions(), device="cpu")
    names = {s.name for s in trace.spans()}
    assert "split" in names and "grid" not in names


def test_fused_fetches_count_the_used_prefixes(recorded):
    """The fused FASTA path's fetches: the scalars, then the used prefix of
    the packed row and of the two sparse rows (``parse_fused_fasta``)."""
    data = mixed_fasta(seed=41, n_rec=25)
    PPIPE.encode_device(data, PENC.EncodeOptions(), device="cpu")
    fetched = [s.fields["bytes"] for s in trace.spans() if s.name == "fetch"]
    blocks = make_blocks(np.frombuffer(data, np.uint8)[1:], 1)
    xs = [torch.from_numpy(blocks.data[0].copy())]
    _, scal_d, _, _ = fused_blocks_sharded(xs, blocks.prev, blocks.starts_in_seq, 0, seq_type=0)
    scal = scal_d[0].numpy()
    cnt, n_sp = int(scal[0]), int(scal[FASTA_SCALARS.index("n_sp")])
    assert fetched == [4 * len(FASTA_SCALARS), (cnt + 1) // 2 + 1, 4 * n_sp, 4 * n_sp]


@pytest.mark.parametrize("fastq", [False, True], ids=["fasta", "fastq"])
def test_sparse_span_counts_the_channel(fastq, recorded):
    """The fused parse's ``sparse`` span: the entries the emit's scalars
    count (``n_sp``) and the records the archive holds."""
    data = long_read_fastq(seed=47) if fastq else mixed_fasta(seed=47, n_rec=30)
    blob = PPIPE.encode_device(data, PENC.EncodeOptions(), device="cpu")[0]
    (sparse,) = [s for s in trace.spans() if s.name == "sparse"]
    body = np.frombuffer(data, np.uint8)[1:]
    if fastq:
        blocks = make_blocks_fastq(body, 1)[0]
        xs = [torch.from_numpy(blocks.data[0].copy())]
        scal = fused_blocks_fastq_sharded(xs, blocks.prev, 0, seq_type=0)[3][0].numpy()
        names = FASTQ_SCALARS
    else:
        blocks = make_blocks(body, 1)
        xs = [torch.from_numpy(blocks.data[0].copy())]
        scal = fused_blocks_sharded(xs, blocks.prev, blocks.starts_in_seq, 0,
                                    seq_type=0)[1][0].numpy()
        names = FASTA_SCALARS
    n_sp = int(scal[names.index("n_sp")])
    assert n_sp > 0 and int(scal[names.index("sp_ok")])
    records = PDEC.Decoder(io.BytesIO(blob)).r.n_sequences
    assert sparse.fields == {"entries": n_sp, "records": records}


@pytest.mark.parametrize("fastq", [False, True], ids=["fasta", "fastq"])
def test_device_decode_records_its_span_tree(fastq, recorded):
    data = mixed_fastq(seed=42, n_rec=200) if fastq else mixed_fasta(seed=42, n_rec=30)
    blob = PENC.encode(data, PENC.EncodeOptions())[0]
    trace.clear()
    d = PDEC.Decoder(io.BytesIO(blob))
    out = PDEC.fastq_device(d, device="cpu") if fastq else PDEC.fasta_device(d, device="cpu")
    assert [s for s, _ in recorded()] == ["seq-unzstd"]
    spans = trace.spans()
    by_id = _checked_tree(spans)
    root = spans[-1]
    assert root.name == "decode" and root.fields["route"].startswith("decode_device")
    assert {s.root for s in spans} == {root.id}
    under = {_path(s, by_id) for s in spans}
    assert under == {"decode", "decode/unzstd", "decode/seq-unzstd", "decode/build-plan",
                     "decode/device-render", "decode/device-render/upload",
                     "decode/device-render/fetch"}
    sections = [s.fields["section"] for s in spans if s.name == "unzstd"]
    sizes = _payload_sizes(blob)
    # a FASTQ render applies no mask; a FASTA has no quality
    assert sections == [k for k in ("ids", "comments", "lengths", "mask", "quality")
                        if k in sizes and k != ("mask" if fastq else "quality")]
    render = next(s for s in spans if s.name == "device-render")
    assert render.fields == {"bytes": len(out)}
    assert sum(s.fields["bytes"] for s in spans if s.name == "fetch") == len(out)
    # the header lines the plan laid out: each record's first line
    n = d.r.n_sequences
    lines = out.split(b"\n")
    heads = lines[0:4 * n:4] if fastq else [x for x in lines if x.startswith(b">")]
    plan = next(s for s in spans if s.name == "build-plan")
    assert plan.fields == {"records": n, "headers": "native",
                           "bytes": sum(len(x) + 1 for x in heads)}


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_build_plan_names_its_header_path(path, recorded, monkeypatch):
    from naf_tpu_torch.native import host as native
    from naf_tpu_torch.parallel import decode as PDV

    if path == "numpy":
        monkeypatch.setattr(native, "available", lambda: False)
    n = 300
    plan = PDV.build_plan(mode=PDV.MODE_FASTQ, line_len=0, rna=False, packed=True,
                          upper=False, slens=np.full(n, 7, np.int64),
                          ids_blob=b"".join(b"r%d\0" % i for i in range(n)),
                          comments_blob=b"".join(b"c%d\0" % (i % 3) for i in range(n)),
                          name_sep=b" ")
    (span,) = trace.spans()
    assert span.name == "build-plan"
    assert span.fields == {"records": n, "headers": path, "bytes": plan.hdr.size}
    assert plan.hdr.size > 0 and recorded() == []


def test_section_pool_spans_name_their_submitter(recorded):
    """A section compress on ``build_archive``'s pool names ``sections``,
    opened on the caller's thread, as its parent."""
    import threading

    rng = np.random.default_rng(43)
    lines = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(70_000, 61))
    lines[:, 60] = ord("\n")
    PENC.encode(b">big\n" + lines.tobytes(), PENC.EncodeOptions())   # over the pool's 4 MiB
    spans = trace.spans()
    _checked_tree(spans)
    (sections,) = [s for s in spans if s.name == "sections"]
    zstd = [s for s in spans if s.name == "zstd"]
    assert len(zstd) == 5 and {s.parent for s in zstd} == {sections.id}
    assert sections.thread == threading.get_ident()
    assert all(s.thread != sections.thread for s in zstd)


def test_two_thread_decompress_spans_name_their_submitter(recorded):
    data = mixed_fastq(seed=44, n_rec=300)
    blob = PENC.encode(data, PENC.EncodeOptions())[0]
    trace.clear()
    PDEC.Decoder(io.BytesIO(blob)).fastq()
    spans = trace.spans()
    _checked_tree(spans)
    (both,) = [s for s in spans if s.name == "seq+qual-unzstd"]
    workers = [s for s in spans if s.parent == both.id]
    assert sorted(s.fields["section"] for s in workers) == ["quality", "sequence"]
    assert all(s.name == "unzstd" and s.thread != both.thread for s in workers)
    assert sum(s.fields["bytes"] for s in workers) == both.fields["bytes"]


def test_nothing_recorded_with_tracing_off(monkeypatch, capsys):
    monkeypatch.setattr(trace, "ENABLED", False)
    trace.clear()
    data = mixed_fastq(seed=45, n_rec=100)
    blob = PPIPE.encode_device(data, PENC.EncodeOptions(), device="cpu")[0]
    PDEC.fastq_device(PDEC.Decoder(io.BytesIO(blob)), device="cpu")
    PDEC.Decoder(io.BytesIO(blob)).fastq()
    assert trace.spans() == [] and trace.dropped() == 0
    assert capsys.readouterr().err == ""


def test_record_keeps_its_last_spans(recorded):
    extra = 7
    for i in range(trace.CAP + extra):
        with trace.trace_span("x", i=i):
            pass
    spans = trace.spans()
    assert len(spans) == trace.CAP and trace.dropped() == extra
    assert spans[0].fields == {"i": extra} and spans[-1].fields == {"i": trace.CAP + extra - 1}
    trace.clear()
    assert trace.spans() == [] and trace.dropped() == 0


@pytest.mark.parametrize("on", [False, True], ids=["untraced", "traced"])
def test_spans_are_profiler_ranges(on, monkeypatch, tmp_path):
    """Under a CPU profiler the program's spans are ``user_annotation``
    ranges inside the benchmark's call range, traced or not, and the
    benchmark's trace reduction names an idle gap by one of them."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark.devtrace import CALL, reduce

    monkeypatch.setattr(trace, "ENABLED", on)
    data = mixed_fasta(seed=46, n_rec=20)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(CALL):
            PPIPE.encode_device(data, PENC.EncodeOptions(), device="cpu")
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    events = json.loads((tmp_path / "t.json").read_text())["traceEvents"]
    ranges = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    (call,) = [e for e in ranges if e["name"] == CALL]
    ours = {"encode", "split", "upload", "emit", "fetch", "parse", "carry", "sections", "zstd",
            "container"}
    inside = {e["name"] for e in ranges
              if call["ts"] <= e["ts"] and e["ts"] + e["dur"] <= call["ts"] + call["dur"]}
    assert ours - {"zstd"} <= inside          # the pool's zstd spans are on other threads
    gaps = dict(reduce(events, 1, [0]).idle_gaps)
    assert set(gaps) & ours
