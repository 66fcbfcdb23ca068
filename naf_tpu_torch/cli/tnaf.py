"""tnaf — NAF compressor CLI (ennaf-compatible flag surface), the port's
copy of ``naf_tpu/cli/tnaf.py``.

Flag parity target: ennaf/src/ennaf.c:329-430.  Its standard output,
standard error, exit status and archives equal the JAX package's host
CLI's, but for the version line.  Inputs under
``NAF_TPU_STREAM_THRESHOLD`` (256 MiB) are encoded in memory, larger files
and pipes by the bounded-memory ``encode_stream``, whose sections spill to
the temp dir past ``NAF_TPU_SPILL_MB``.  ``--device`` runs the port's CUDA
kernels, one block on every visible card (``parallel.mesh.block_mesh``):
an input under the threshold in memory (``encode_device``), a pipe or a
larger file through ``encode_stream`` with the device scan engine
(``parallel.stream.DeviceScanEngine``) in chunks of
``NAF_TPU_DEVICE_CHUNK`` (64 MiB), counted in ``device.ROUTES`` as
``encode_device:stream``.  ``--extended`` and an ``--engine`` other than
``zstd`` always encode in memory.  A failure on the card ends the CLI with
an error.  Under ``NAF_TPU_PROFILE=dir`` the ``--device`` work runs in
``utils.trace.device_profile``, which writes one torch.profiler trace into
``dir``.  ``--engine native`` compresses with the package's own RFC 8878
encoder; ``--engine device`` is demoted to it, as in the reference CLI.
Without ``--device`` nothing here loads torch.
"""

from __future__ import annotations

import os
import sys

from ..codec import MAX_CLEVEL, MIN_CLEVEL, WINDOWLOG_MAX, WINDOWLOG_MIN
from ..format import constants as C
from ..ops.histogram_np import format_unexpected_report
from ..pipeline.encoder import EncodeOptions
from ..pipeline.stream import encode_stream
from ..pipeline.parser import InputError
from ..version import TOOL_DATE, __version__

PROG = "tnaf"


def _msg(s: str) -> None:
    sys.stderr.buffer.write(s.encode("latin-1", errors="replace"))
    sys.stderr.buffer.flush()


def _die(s: str) -> "NoReturn":  # noqa: F821
    _msg(f"{PROG} error: {s}\n")
    sys.exit(1)


HELP = """Usage: tnaf [OPTIONS] [infile]
Options:
  -o FILE            - Write compressed output to FILE
  -c                 - Write to standard output
  -#, --level #      - Use compression level # (from %d to %d, default: 1)
  --long N           - Use window of size 2^N for sequence stream (from %d to %d)
  --temp-dir DIR     - Use DIR as temporary directory
  --name NAME        - Use NAME as prefix for temporary files
  --title TITLE      - Store TITLE as dataset title
  --fasta            - Input is in FASTA format
  --fastq            - Input is in FASTQ format
  --dna              - Input sequence is DNA (default)
  --rna              - Input sequence is RNA
  --protein          - Input sequence is protein
  --text             - Input sequence is text
  --strict           - Fail on unexpected input characters
  --line-length N    - Override line length to N
  --verbose          - Verbose mode
  --keep-temp-files  - Keep temporary files
  --no-mask          - Don't store mask
  --extended         - tnaf extended format: blocked sequence section with
                       index for parallel + seekable decode (NOT readable
                       by the reference unnaf; flag bit 0x80, spec 2.4)
  --block-size N     - Extended-format block size in MB (default 4)
  --engine NAME      - Entropy engine: 'zstd' (library, default) or
                       'native' (tnaf's own RFC 8878 encoder; honors -# and
                       --long); all archives remain decodable by the
                       reference unnaf.  'device' is accepted but routes to
                       'native': the JAX match-finder measured a strict
                       loss on v5e (slower AND larger; BENCH device_engine
                       row) — per-element sorts/gathers don't fit the TPU
                       cost model, so the judgment is recorded, not shipped
  --threads N        - zstd worker threads per section (default: all
                       cores; 0 = single-threaded). The output is still
                       one reference-decodable frame per section
  --device           - Run the block-sharded device pipeline (JAX mesh
                       over all visible TPU/CPU devices); archives are
                       byte-identical to the host pipeline's
  -h, --help         - Show help
  -V, --version      - Show version
""" % (MIN_CLEVEL, MAX_CLEVEL, WINDOWLOG_MIN, WINDOWLOG_MAX)


def _parse_int_strict(s: str, what: str) -> int:
    try:
        v = int(s)
    except ValueError:
        _die(f"can't parse the value of {what} parameter")
    if str(v) != s:
        _die(f"can't parse the value of {what} parameter")
    return v


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)

    opts = EncodeOptions()
    in_path: str | None = None
    out_path: str | None = None
    force_stdout = False
    verbose = False
    print_version = False
    fmt_cli = C.IN_FORMAT_UNKNOWN

    def set_format(name: str) -> None:
        nonlocal fmt_cli
        if fmt_cli != C.IN_FORMAT_UNKNOWN:
            _die("input format specified more than once")
        ln = name.lower()
        if ln in ("fasta", "fa", "fna"):
            fmt_cli = C.IN_FORMAT_FASTA
        elif ln in ("fastq", "fq"):
            fmt_cli = C.IN_FORMAT_FASTQ
        else:
            _die(f'unknown input format specified: "{name}"')

    i = 0
    n = len(argv)
    title = None
    line_length = None
    threads_set = False
    use_device = False
    while i < n:
        a = argv[i]
        if a.startswith("-") and a != "-":
            if a.startswith("--"):
                if i < n - 1:
                    if a == "--temp-dir":
                        i += 1
                        opts.temp_dir = argv[i]
                        i += 1
                        continue
                    if a == "--name":
                        i += 1
                        opts.temp_name = argv[i]
                        i += 1
                        continue
                    if a == "--title":
                        i += 1
                        if title is not None:
                            _die("double --title parameter")
                        if argv[i] == "":
                            _die("empty --title parameter")
                        title = argv[i]
                        i += 1
                        continue
                    if a == "--level":
                        i += 1
                        try:
                            lvl = int(argv[i])
                        except ValueError:
                            lvl = None
                        if lvl is None or lvl < MIN_CLEVEL or lvl > MAX_CLEVEL:
                            _die(f"invalid value of --level, should be from {MIN_CLEVEL} to {MAX_CLEVEL}")
                        opts.level = lvl
                        i += 1
                        continue
                    if a == "--line-length":
                        i += 1
                        v = _parse_int_strict(argv[i], "--line-length")
                        if v < 0:
                            _die("negative line length specified")
                        line_length = v
                        i += 1
                        continue
                    if a == "--long":
                        i += 1
                        v = _parse_int_strict(argv[i], "--long")
                        if v < WINDOWLOG_MIN:
                            _msg(f"{PROG} warning: --long value of is {v} is smaller than the lowest supported value {WINDOWLOG_MIN}, using {WINDOWLOG_MIN} instead\n")
                            v = WINDOWLOG_MIN
                        elif v > WINDOWLOG_MAX:
                            _msg(f"{PROG} warning: --long value of is {v} is larger than the largest supported value {WINDOWLOG_MAX}, using {WINDOWLOG_MAX} instead\n")
                            v = WINDOWLOG_MAX
                        opts.long_window_log = v
                        i += 1
                        continue
                    if a == "--out":
                        i += 1
                        out_path = argv[i]
                        i += 1
                        continue
                    if a == "--in":
                        i += 1
                        in_path = argv[i]
                        i += 1
                        continue
                    if a == "--in-format":
                        i += 1
                        set_format(argv[i])
                        i += 1
                        continue
                if a == "--help":
                    _msg(HELP)
                    return 0
                if a == "--version":
                    print_version = True
                    i += 1
                    continue
                if a == "--verbose":
                    verbose = True
                    i += 1
                    continue
                if a == "--binary-stderr":
                    i += 1
                    continue
                if a == "--keep-temp-files":
                    opts.keep_temp_files = True
                    i += 1
                    continue
                if a == "--no-mask":
                    opts.no_mask = True
                    i += 1
                    continue
                if a == "--extended":
                    opts.extended = True
                    i += 1
                    continue
                if a == "--engine" and i < n - 1:
                    i += 1
                    if argv[i] not in ("zstd", "native", "device"):
                        _die(f'unknown engine "{argv[i]}"')
                    opts.engine = argv[i]
                    if opts.engine == "device":
                        # measured strict loss on v5e (slower AND larger;
                        # BENCH device_engine row) — route to the native
                        # engine rather than ship a known regression
                        sys.stderr.write(
                            "tnaf: --engine device is demoted to 'native' "
                            "(measured loss on TPU; see README)\n")
                        opts.engine = "native"
                    i += 1
                    continue
                if a == "--device":
                    use_device = True
                    i += 1
                    continue
                if a == "--threads" and i < n - 1:
                    i += 1
                    v = _parse_int_strict(argv[i], "--threads")
                    if v < 0:
                        _die("invalid --threads")
                    opts.threads = v
                    threads_set = True
                    i += 1
                    continue
                if a == "--block-size" and i < n - 1:
                    i += 1
                    v = _parse_int_strict(argv[i], "--block-size")
                    if v < 1:
                        _die("invalid --block-size")
                    opts.block_bytes = v << 20
                    i += 1
                    continue
                if a == "--fasta":
                    set_format("fasta")
                    i += 1
                    continue
                if a == "--fastq":
                    set_format("fastq")
                    i += 1
                    continue
                if a == "--dna":
                    opts.seq_type = C.SEQ_TYPE_DNA
                    i += 1
                    continue
                if a == "--rna":
                    opts.seq_type = C.SEQ_TYPE_RNA
                    i += 1
                    continue
                if a == "--protein":
                    opts.seq_type = C.SEQ_TYPE_PROTEIN
                    i += 1
                    continue
                if a == "--text":
                    opts.seq_type = C.SEQ_TYPE_TEXT
                    i += 1
                    continue
                if a == "--well-formed":
                    opts.well_formed = True
                    i += 1
                    continue
                if a == "--strict":
                    opts.strict = True
                    i += 1
                    continue
                _die(f'unknown or incomplete argument "{a}"')
            if i < n - 1 and a == "-o":
                i += 1
                if out_path is not None:
                    _die("double --out parameter")
                out_path = argv[i]
                i += 1
                continue
            if a == "-c":
                force_stdout = True
                i += 1
                continue
            if len(a) >= 2 and a[1].isdigit() or (len(a) >= 3 and a[1] == "-" and a[2].isdigit()):
                try:
                    lvl = int(a[1:])
                except ValueError:
                    _die(f'unknown or incomplete argument "{a}"')
                if lvl < MIN_CLEVEL or lvl > MAX_CLEVEL:
                    _die(f"invalid value of --level, should be from {MIN_CLEVEL} to {MAX_CLEVEL}")
                opts.level = lvl
                i += 1
                continue
            if a == "-h":
                _msg(HELP)
                return 0
            if a == "-V":
                print_version = True
                i += 1
                continue
            _die(f'unknown or incomplete argument "{a}"')
        else:
            if in_path is not None:
                _die("can compress only one file at a time")
            if a == "":
                _die("empty input file name")
            in_path = a
            i += 1

    if print_version:
        _msg(f"{PROG} - NAF compressor (naf_tpu_torch, PyTorch + CUDA), version {__version__}, "
             f"{TOOL_DATE}\n")
        return 0

    if force_stdout and out_path is not None:
        _die("'-c' and '-o' can't be used together")
    if opts.well_formed and opts.strict:
        _die("'--well-formed' and '--strict' can't be used together")

    if in_path is None and sys.stdin.isatty():
        _msg(f'{PROG} error: no input specified, use "{PROG} -h" for help\n')
        return 0

    if opts.temp_dir is not None and not os.path.isdir(opts.temp_dir):
        _die(f'temporary directory "{opts.temp_dir}" does not exist')
    if opts.temp_dir is None:
        # spill only when the environment provides a temp dir (the
        # reference *requires* one, ennaf.c:309-319; we work in RAM without)
        env_tmp = os.environ.get("TMPDIR") or os.environ.get("TMP")
        if env_tmp and os.path.isdir(env_tmp):
            opts.temp_dir = env_tmp
    if opts.temp_dir and in_path is not None and opts.temp_name == "tnaf":
        opts.temp_name = os.path.basename(in_path)

    opts.in_format = fmt_cli
    opts.title = title
    opts.line_length = line_length
    if not threads_set:
        # zstd multithreading pipelines job compression with input buffering
        # and (with >=1 worker) pledges per-job sizes, which lets zstd
        # right-size its window: 2-3x faster at high levels, identical frames
        opts.threads = os.cpu_count() or 1

    # format-from-extension check (warn only; ennaf.c:296-306,571-582)
    ext_fmt = C.IN_FORMAT_UNKNOWN
    if in_path:
        ext = os.path.splitext(in_path)[1].lstrip(".").lower()
        if ext in ("fasta", "fa", "fna"):
            ext_fmt = C.IN_FORMAT_FASTA
        elif ext in ("fastq", "fq"):
            ext_fmt = C.IN_FORMAT_FASTQ

    if in_path is not None:
        try:
            inf = open(in_path, "rb")
        except OSError:
            _die("can't open input file")
    else:
        inf = sys.stdin.buffer

    if not force_stdout and out_path is None and sys.stdout.isatty():
        if in_path is None:
            _die("output file is not specified")
        out_path = in_path + ".naf"

    # stream-encode straight to the destination (bounded memory); an
    # incomplete output file is removed on any failure, like the
    # reference's atexit(done) (ennaf.c:154-157)
    if out_path is not None and not force_stdout:
        try:
            outf = open(out_path, "wb")
        except OSError:
            _die("can't create output file")
    else:
        outf = sys.stdout.buffer
    # small regular files take the in-memory path (fastest); large inputs
    # and pipes stream with bounded memory (reference behavior)
    stream_threshold = int(os.environ.get("NAF_TPU_STREAM_THRESHOLD",
                                          str(256 << 20)))
    in_size = None
    if in_path is not None:
        try:
            in_size = os.fstat(inf.fileno()).st_size
        except OSError:
            pass
    in_memory = (opts.extended or opts.engine != "zstd"
                 or (in_size is not None and in_size < stream_threshold))
    try:
        if use_device:
            # torch is imported only here, keeping the default CLI's cold
            # start torch-free
            stats = _encode_device(inf, outf, opts, in_memory)
        elif in_memory:
            from ..pipeline.encoder import encode as _encode

            blob, stats = _encode(inf.read(), opts)
            outf.write(blob)
        else:
            stats = encode_stream(inf, outf, opts)
    except (InputError, _DeviceError) as e:
        if outf is not sys.stdout.buffer:
            outf.close()
            try:
                os.unlink(out_path)
            except OSError:
                pass
        _die(str(e))
    finally:
        if inf is not sys.stdin.buffer:
            inf.close()

    if ext_fmt != C.IN_FORMAT_UNKNOWN and stats.in_format != C.IN_FORMAT_UNKNOWN and ext_fmt != stats.in_format:
        _msg(f"{PROG} warning: input file extension does not match its actual format\n")
    if (ext_fmt != C.IN_FORMAT_UNKNOWN and fmt_cli != C.IN_FORMAT_UNKNOWN
            and ext_fmt != fmt_cli):
        _msg(f"{PROG} warning: input file extension does not match format specified in the command line\n")

    if outf is not sys.stdout.buffer:
        outf.close()
        if in_path is not None:
            # metadata transfer parity: files.c:114-156
            try:
                st = os.stat(in_path)
                os.chmod(out_path, st.st_mode & 0o777)
                os.utime(out_path, ns=(st.st_atime_ns, st.st_mtime_ns))
            except OSError:
                _msg(f"{PROG} error: can't transfer permissions from input to output file\n")
    else:
        sys.stdout.buffer.flush()

    if not opts.well_formed:
        for counts, name in (
            (stats.unexpected_id, "id"),
            (stats.unexpected_comment, "comment"),
            (stats.unexpected_seq, C.SEQ_TYPE_NAMES[opts.seq_type]),
            (stats.unexpected_qual, "quality"),
        ):
            if counts is not None:
                _msg(format_unexpected_report(counts, name))

    if verbose:
        _msg(f"Processed {stats.n_sequences} sequences\n")
    return 0


class _DeviceError(Exception):
    """The card is missing, or a kernel build or launch failed."""


def _encode_device(inf, outf, opts: EncodeOptions, in_memory: bool):
    """``--device``: the input in memory through the CUDA kernels, or a
    pipe or large file streamed through them in chunks by the device scan
    engine (route ``encode_device:stream``), one block on every visible
    card."""
    from ..device import count_route
    from ..parallel.mesh import block_mesh
    from ..parallel.pipeline import encode_device
    from ..parallel.stream import DeviceScanEngine
    from ..utils.trace import device_profile

    try:
        with device_profile():
            mesh = block_mesh()
            if in_memory:
                blob, stats = encode_device(inf.read(), opts, mesh=mesh)
                outf.write(blob)
                return stats
            count_route("encode_device:stream")
            chunk = int(os.environ.get("NAF_TPU_DEVICE_CHUNK", str(64 << 20)))
            return encode_stream(inf, outf, opts, chunk_size=chunk,
                                 engine=DeviceScanEngine(mesh=mesh))
    except (RuntimeError, OSError) as e:
        raise _DeviceError(f"device encode failed: {e}") from None


if __name__ == "__main__":
    sys.exit(main())
