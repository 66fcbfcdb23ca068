"""naf_tpu_torch's tnaf and untnaf against naf_tpu's host CLI.

Both CLIs run as subprocesses (``python -m naf_tpu_torch.cli.*`` and
``python -m naf_tpu.cli.*``) on seeded inputs: a FASTA with soft masks and
IUPAC codes, a FASTQ, protein, text, an empty file and inputs with
unexpected characters.  Standard output, standard error and the exit
status must be equal, byte for byte, for every tnaf option case, every
untnaf output type and every error case below; only ``-V``/``--version``
differs, naming the port.  The stream path (``NAF_TPU_STREAM_THRESHOLD=1``,
and pipes) gives the same archive bytes at two chunk sizes, and neither
CLI's default path loads torch.  The inputs stay under 2**21 chars, below
the size where naf_tpu's multithreaded render drops the tail of its output
(F1 in ROADMAP.md).
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import pytest

from naf_tpu.pipeline import encoder as RENC
from naf_tpu_torch.format import constants as C
from naf_tpu_torch.pipeline import encoder as PENC

from torch_cases import mixed_fasta, mixed_fastq, protein_fasta, text_fasta

REPO = Path(__file__).resolve().parent.parent


def _env(tmp: Path, **extra) -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("NAF_TPU", "JAX", "XLA"))}
    env.update(PYTHONPATH=str(REPO), TMPDIR=str(tmp), JAX_PLATFORMS="cpu", **extra)
    return env


def _cmd(pkg: str, tool: str) -> list:
    return [sys.executable, "-m", f"{pkg}.cli.{tool}"]


def _both(tool: str, args: list, tmp: Path, stdin: bytes = b"", **env) -> tuple:
    """(port's, naf_tpu's) CompletedProcess of one command line, run side
    by side, each in a directory of its own (outputs named by ``-o`` stay
    apart)."""
    procs = []
    for pkg in ("naf_tpu_torch", "naf_tpu"):
        cwd = tmp / pkg
        cwd.mkdir(exist_ok=True)
        procs.append((subprocess.Popen(_cmd(pkg, tool) + args, stdin=subprocess.PIPE,
                                       stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                       cwd=cwd, env=_env(tmp, **env)), cwd))
    out = []
    for p, cwd in procs:
        so, se = p.communicate(stdin, timeout=300)
        out.append(subprocess.CompletedProcess(p.args, p.returncode, so, se))
    return tuple(out)


def _same(port, ref) -> None:
    assert (port.returncode, port.stderr) == (ref.returncode, ref.stderr)
    assert port.stdout == ref.stdout


def _unexpected_fasta() -> bytes:
    return (b">a\x01b c\x02d\nACJGTacgt!!NN\nAC\n>r2\nGGTT*XZ\n>r3 \xe9t\xe9\nacgt\n"
            + mixed_fasta(seed=20, n_rec=5))


#: name -> bytes of the input files
INPUTS = {
    "dna.fa": lambda: mixed_fasta(),
    "reads.fq": lambda: mixed_fastq(),
    "prot.fa": lambda: protein_fasta(),
    "text.txt": lambda: text_fasta(),
    "empty.fa": lambda: b"",
    "odd.fa": _unexpected_fasta,
    "reads_named.fa": lambda: mixed_fastq(seed=21, n_rec=20),
}


@pytest.fixture(scope="module")
def files(tmp_path_factory) -> Path:
    d = tmp_path_factory.mktemp("cli_inputs")
    for name, make in INPUTS.items():
        (d / name).write_bytes(make())
    return d


# ---------------------------------------------------------------------------
# tnaf
# ---------------------------------------------------------------------------

#: (id, input file, arguments; "{in}" is the input's path, "stdin:" feeds it
#: on standard input)
TNAF_CASES = [
    ("fasta", "dna.fa", ["-c", "{in}"]),
    ("fasta_stdin", "stdin:dna.fa", ["-c"]),
    ("fasta_out_file", "dna.fa", ["-o", "out.naf", "{in}"]),
    ("fasta_options", "dna.fa", ["-c", "--no-mask", "-5", "--title", "My title",
                                 "--line-length", "70", "--verbose", "{in}"]),
    ("fasta_long_warning", "dna.fa", ["-c", "--long", "9", "--level", "3", "{in}"]),
    ("fasta_rna", "dna.fa", ["-c", "--rna", "{in}"]),
    ("fasta_extended", "dna.fa", ["-c", "--extended", "--block-size", "1", "{in}"]),
    ("fasta_threads_engine_zstd", "dna.fa", ["-c", "--threads", "2", "--engine", "zstd",
                                             "--in-format", "fa", "{in}"]),
    ("fastq", "reads.fq", ["-c", "{in}"]),
    ("fastq_stdin_level", "stdin:reads.fq", ["-c", "-19", "--fastq"]),
    ("protein", "prot.fa", ["-c", "--protein", "{in}"]),
    ("text", "text.txt", ["-c", "--text", "--no-mask", "{in}"]),
    ("empty", "empty.fa", ["-c", "{in}"]),
    ("unexpected_report", "odd.fa", ["-c", "{in}"]),
    ("unexpected_well_formed", "odd.fa", ["-c", "--well-formed", "{in}"]),
    ("extension_mismatch", "reads_named.fa", ["-c", "{in}"]),
    ("error_strict", "odd.fa", ["-c", "--strict", "{in}"]),
    ("error_strict_and_well_formed", "dna.fa", ["-c", "--strict", "--well-formed", "{in}"]),
    ("error_fastq_flag_on_fasta", "dna.fa", ["-c", "--fastq", "{in}"]),
    ("error_fasta_flag_on_fastq", "stdin:reads.fq", ["-c", "--fasta"]),
    ("error_format_twice", "dna.fa", ["-c", "--fasta", "--fastq", "{in}"]),
    ("error_bad_flag", "dna.fa", ["-c", "--bogus", "{in}"]),
    ("error_c_and_o", "dna.fa", ["-c", "-o", "x.naf", "{in}"]),
    ("error_level", "dna.fa", ["-c", "--level", "30", "{in}"]),
    ("error_line_length", "dna.fa", ["-c", "--line-length", "7x", "{in}"]),
    ("error_two_inputs", "dna.fa", ["-c", "{in}", "{in}"]),
    ("error_missing_input", "dna.fa", ["-c", "no_such.fa"]),
    ("error_temp_dir", "dna.fa", ["-c", "--temp-dir", "no_such_dir", "{in}"]),
    ("help", "dna.fa", ["-h"]),
    # the native entropy engine; 'device' is demoted to it with a line on stderr
    ("native_engine", "dna.fa", ["-c", "--engine", "native", "{in}"]),
    ("native_engine_out_file", "dna.fa", ["--engine", "native", "-o", "out.naf", "{in}"]),
    ("native_engine_fastq_level", "reads.fq", ["-c", "--engine", "native", "-19", "{in}"]),
    ("native_engine_stdin_long_threads", "stdin:dna.fa",
     ["-c", "--engine", "native", "--long", "24", "--threads", "4"]),
    ("native_engine_protein", "prot.fa", ["-c", "--engine", "native", "--protein", "{in}"]),
    ("native_engine_extended", "dna.fa",
     ["-c", "--engine", "native", "--extended", "--block-size", "1", "{in}"]),
    ("device_engine_demoted", "dna.fa", ["-c", "--engine", "device", "{in}"]),
    ("device_engine_demoted_fastq", "stdin:reads.fq", ["-c", "--engine", "device", "-3"]),
]


@pytest.mark.parametrize("args", [c[1:] for c in TNAF_CASES], ids=[c[0] for c in TNAF_CASES])
def test_tnaf_matches(args, files, tmp_path):
    src, argv = args
    stdin = b""
    if src.startswith("stdin:"):
        stdin = (files / src[6:]).read_bytes()
    argv = [a.replace("{in}", str(files / src)) for a in argv]
    port, ref = _both("tnaf", argv, tmp_path, stdin)
    _same(port, ref)
    if "-o" in argv and port.returncode == 0:
        out = argv[argv.index("-o") + 1]
        assert (tmp_path / "naf_tpu_torch" / out).read_bytes() == \
            (tmp_path / "naf_tpu" / out).read_bytes()


def test_version_names_the_port(tmp_path):
    for tool in ("tnaf", "untnaf"):
        port, ref = _both(tool, ["-V"], tmp_path)
        assert port.returncode == ref.returncode == 0 and port.stdout == ref.stdout == b""
        assert b"naf_tpu_torch" in port.stderr and port.stderr.startswith(tool.encode())
        assert port.stderr.split(b"version")[1] == ref.stderr.split(b"version")[1]


# ---------------------------------------------------------------------------
# untnaf
# ---------------------------------------------------------------------------

def _archives() -> dict:
    E = PENC.EncodeOptions
    return {
        "dna": (mixed_fasta(), E()),
        "dna_title": (mixed_fasta(seed=22, line=50), E(title="the title", line_length=80)),
        "fastq": (mixed_fastq(), E()),
        "protein": (protein_fasta(), E(seq_type=C.SEQ_TYPE_PROTEIN)),
        "text": (text_fasta(), E(seq_type=C.SEQ_TYPE_TEXT)),
        "empty": (b"", E()),
        "extended": (mixed_fasta(seed=23, n_rec=60), E(extended=True, block_bytes=1 << 12)),
    }


@pytest.fixture(scope="module")
def archives(tmp_path_factory) -> Path:
    d = tmp_path_factory.mktemp("cli_archives")
    for name, (data, opts) in _archives().items():
        blob = PENC.encode(data, opts)[0]
        assert blob == RENC.encode(data, RENC.EncodeOptions(**vars(opts)))[0]
        (d / f"{name}.naf").write_bytes(blob)
    (d / "truncated.naf").write_bytes((d / "dna.naf").read_bytes()[:5000])
    (d / "junk.naf").write_bytes(b"this is not an archive\n")
    return d


_TYPES = ["--format", "--part-list", "--sizes", "--title", "--number", "--ids", "--names",
          "--lengths", "--total-length", "--mask", "--total-mask-length", "--4bit", "--dna",
          "--masked-dna", "--unmasked-dna", "--seq", "--sequences", "--charcount", "--fasta",
          "--masked-fasta", "--unmasked-fasta", "--fastq"]

#: (archive, arguments before "-c <archive>")
UNTNAF_CASES = (
    [("dna", [t]) for t in _TYPES]
    + [("dna", []), ("dna", ["--range", "3:11"]), ("dna", ["--range", "0:1000"]),
       ("dna", ["--no-mask"]), ("dna", ["--no-mask", "--seq"]),
       ("dna", ["--line-length", "13"]), ("dna", ["--line-length", "0", "--masked-fasta"]),
       ("dna_title", ["--title"]), ("dna_title", ["--sizes"]), ("dna_title", []),
       ("dna_title", ["--range", "1:4", "--line-length", "20"])]
    + [("fastq", t) for t in ([], ["--fasta"], ["--range", "2:7"], ["--names"], ["--lengths"],
                              ["--sequences"], ["--charcount"], ["--4bit"], ["--mask"],
                              ["--seq"], ["--sizes"], ["--format"], ["--ids"],
                              ["--no-mask", "--fasta"])]
    + [("protein", t) for t in ([], ["--no-mask"], ["--seq"], ["--charcount"], ["--sequences"],
                                ["--4bit"], ["--dna"], ["--range", "1:3"], ["--fastq"],
                                ["--total-mask-length"])]
    + [("text", t) for t in ([], ["--no-mask"], ["--format"], ["--part-list"])]
    + [("empty", t) for t in ([], ["--number"], ["--sizes"], ["--names"], ["--fastq"],
                              ["--charcount"])]
    + [("extended", t) for t in ([], ["--range", "5:17"], ["--sizes"], ["--format"],
                                 ["--4bit"])]
    + [("dna", ["--bogus"]), ("dna", ["-o", "x.fa"]), ("truncated", []), ("junk", []),
       ("dna", ["--fasta", "--seq"]), ("dna", ["--engine", "bogus"]),
       ("dna", ["--range", "x:y"]), ("dna", ["--line-length", "-3"]),
       ("dna", ["--engine", "zstd", "--binary", "--verbose"])]
    + [(n, ["--engine", "native", *t]) for n, t in (
        ("dna", []), ("dna", ["--range", "3:11"]), ("dna", ["--sequences"]), ("fastq", []),
        ("fastq", ["--range", "2:7"]), ("protein", []), ("extended", []))]
)


@pytest.mark.parametrize("name,args", UNTNAF_CASES,
                         ids=[f"{n}{''.join(a) or '-default'}" for n, a in UNTNAF_CASES])
def test_untnaf_matches(name, args, archives, tmp_path):
    port, ref = _both("untnaf", [*args, "-c", str(archives / f"{name}.naf")], tmp_path)
    _same(port, ref)


@pytest.mark.parametrize("name,args", [("dna", []), ("dna", ["--unmasked-fasta"]),
                                       ("dna_title", ["--line-length", "7"]), ("fastq", []),
                                       ("protein", []), ("extended", []),
                                       ("dna", ["--engine", "native"]),
                                       ("fastq", ["--engine", "native"])])
def test_untnaf_stream_path_matches(name, args, archives, tmp_path):
    """``NAF_TPU_STREAM_THRESHOLD=1``: every file takes stream_fasta /
    stream_fastq, which must give what the whole-buffer render gives."""
    argv = [*args, "-c", str(archives / f"{name}.naf")]
    port, ref = _both("untnaf", argv, tmp_path, NAF_TPU_STREAM_THRESHOLD="1")
    _same(port, ref)
    whole = subprocess.run(_cmd("naf_tpu_torch", "untnaf") + argv, capture_output=True,
                           env=_env(tmp_path), timeout=300)
    assert port.stdout == whole.stdout and port.returncode == 0


# ---------------------------------------------------------------------------
# the stream path of tnaf
# ---------------------------------------------------------------------------

#: the port's tnaf with encode_stream's chunk size set (argv[1]), to hold the
#: stream path at more than the default chunk
_CHUNKED = ("import functools, sys\n"
            "from naf_tpu_torch.cli import tnaf\n"
            "from naf_tpu_torch.pipeline import stream\n"
            "tnaf.encode_stream = functools.partial(stream.encode_stream,"
            " chunk_size=int(sys.argv[1]))\n"
            "sys.exit(tnaf.main(sys.argv[2:]))\n")


@pytest.mark.parametrize("src,args", [("dna.fa", []), ("reads.fq", []),
                                      ("prot.fa", ["--protein"]),
                                      ("dna.fa", ["--title", "t", "-3", "--no-mask"]),
                                      ("dna.fa", ["--engine", "native"])])
def test_tnaf_stream_path_matches(src, args, files, tmp_path):
    """A file at NAF_TPU_STREAM_THRESHOLD=1 and a pipe take encode_stream:
    at the default chunk and at 1 KiB and 64 KiB chunks the archive is the
    bytes of naf_tpu's stream path and of the in-memory encode."""
    path = str(files / src)
    in_memory = subprocess.run(_cmd("naf_tpu_torch", "tnaf") + ["-c", *args, path],
                               capture_output=True, env=_env(tmp_path), timeout=300)
    assert in_memory.returncode == 0, in_memory.stderr
    port, ref = _both("tnaf", ["-c", *args, path], tmp_path, NAF_TPU_STREAM_THRESHOLD="1")
    _same(port, ref)
    assert port.stdout == in_memory.stdout
    for chunk in (1 << 10, 1 << 16):
        for argv, stdin in (([path], b""), ([], (files / src).read_bytes())):
            r = subprocess.run([sys.executable, "-c", _CHUNKED, str(chunk), "-c", *args, *argv],
                               input=stdin, capture_output=True, timeout=300,
                               env=_env(tmp_path, NAF_TPU_STREAM_THRESHOLD="1"))
            assert (r.returncode, r.stderr, r.stdout) == (0, ref.stderr, in_memory.stdout)


# ---------------------------------------------------------------------------
# cold start and --device without a card
# ---------------------------------------------------------------------------

_NO_TORCH = r"""
import io, sys
from naf_tpu_torch.cli import {tool}
sys.stdin = io.TextIOWrapper(io.BytesIO(open(sys.argv[1], "rb").read()))
try:
    rc = {tool}.main(sys.argv[2:])
except SystemExit as e:
    rc = e.code
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("torch", "jax", "naf_tpu"))
assert not bad, bad
print(rc, file=sys.stderr)
"""


@pytest.mark.parametrize("tool,args", [
    ("tnaf", ["-o", "{out}", "{in}"]), ("tnaf", ["-c"]), ("tnaf", ["-c", "--extended", "{in}"]),
    ("untnaf", ["-c", "{naf}"]), ("untnaf", ["--sequences", "-c", "{naf}"]),
    ("untnaf", ["--fastq", "-c", "{naf}"]),
], ids=["tnaf_file", "tnaf_pipe_stream", "tnaf_extended", "untnaf_fasta", "untnaf_sequences",
        "untnaf_error"])
def test_default_path_loads_no_torch(tool, args, files, archives, tmp_path):
    """The CLIs without --device, on their in-memory, stream and error
    paths, never put torch (nor jax, nor naf_tpu) in sys.modules."""
    subs = {"{in}": str(files / "dna.fa"), "{out}": str(tmp_path / "o.naf"),
            "{naf}": str(archives / "dna.naf")}
    argv = [subs.get(a, a) for a in args]
    r = subprocess.run([sys.executable, "-c", _NO_TORCH.format(tool=tool), subs["{in}"], *argv],
                       capture_output=True, env=_env(tmp_path), cwd=tmp_path, timeout=300)
    assert r.returncode == 0, r.stderr.decode()
    assert r.stderr.splitlines()[-1] == (b"1" if args[0] == "--fastq" else b"0")


@pytest.mark.parametrize("tool,args,stdin", [
    ("tnaf", ["--device", "-o", "out.naf", "{in}"], None),
    ("tnaf", ["--device", "-c"], "dna.fa"),
    ("untnaf", ["--device", "-c", "{naf}"], None),
    ("untnaf", ["--device", "--fastq", "-c", "{fq}"], None),
])
def test_device_without_a_card_fails(tool, args, stdin, files, archives, tmp_path):
    """--device never carries on on the host: without a card the CLI ends
    with an error line and status 1, and leaves no output file."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    subs = {"{in}": str(files / "dna.fa"), "{naf}": str(archives / "dna.naf"),
            "{fq}": str(archives / "fastq.naf")}
    r = subprocess.run(_cmd("naf_tpu_torch", tool) + [subs.get(a, a) for a in args],
                       input=(files / stdin).read_bytes() if stdin else b"",
                       capture_output=True, env=_env(tmp_path), cwd=tmp_path, timeout=300)
    assert r.returncode == 1 and r.stdout == b""
    assert r.stderr == (f"{tool} error: device {'encode' if tool == 'tnaf' else 'decode'} "
                        "failed: device 'cuda' requested but no CUDA device is available\n"
                        ).encode()
    assert not (tmp_path / "out.naf").exists()
