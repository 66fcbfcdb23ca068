"""untnaf — NAF decompressor CLI (unnaf-compatible flag surface), the
port's copy of ``naf_tpu/cli/untnaf.py``.

Flag parity target: unnaf/src/unnaf.c:249-353.  Its standard output,
standard error and exit status equal the JAX package's host CLI's for
every output type, but for the version line.  ``--device`` renders FASTA
and FASTQ with the port's CUDA kernels (``fasta_device``,
``fastq_device`` over every visible card); a failure there ends the CLI
with an error,
it never carries on on the host; under ``NAF_TPU_PROFILE=dir`` the render
runs in ``utils.trace.device_profile``, which writes one torch.profiler
trace into ``dir``.  ``--engine native`` decompresses with the
package's own RFC 8878 decoder (``codec.set_decode_engine``), also under
``--device``, whose render then takes what it decompressed.  Without
``--device`` nothing here loads torch.
"""

from __future__ import annotations

import io
import os
import sys

from ..format import constants as C
from ..format.container import NafFormatError
from ..format.vle import VleError
from ..pipeline.decoder import DecodeError, Decoder, DecodeOptions, fasta_device, fastq_device
from ..version import TOOL_DATE, __version__

PROG = "untnaf"
_RANGE_ARG: "tuple[int, int] | None" = None

# output types
(UNDECIDED, FORMAT_NAME, PART_LIST, PART_SIZES, NUMBER_OF_SEQUENCES, TITLE,
 IDS, NAMES, LENGTHS, TOTAL_LENGTH, MASK, TOTAL_MASK_LENGTH, FOUR_BIT,
 DNA, MASKED_DNA, UNMASKED_DNA, SEQ, SEQUENCES, CHARCOUNT,
 FASTA, MASKED_FASTA, UNMASKED_FASTA, FASTQ, RANGE) = range(24)

_TYPE_FLAGS = {
    "--format": FORMAT_NAME, "--part-list": PART_LIST, "--sizes": PART_SIZES,
    "--number": NUMBER_OF_SEQUENCES, "--title": TITLE, "--ids": IDS,
    "--names": NAMES, "--lengths": LENGTHS, "--total-length": TOTAL_LENGTH,
    "--mask": MASK, "--total-mask-length": TOTAL_MASK_LENGTH,
    "--4bit": FOUR_BIT, "--seq": SEQ, "--sequences": SEQUENCES,
    "--charcount": CHARCOUNT, "--fasta": FASTA, "--fastq": FASTQ,
    # deprecated, undocumented (unnaf.c:322-326)
    "--dna": DNA, "--masked-dna": MASKED_DNA, "--unmasked-dna": UNMASKED_DNA,
    "--masked-fasta": MASKED_FASTA, "--unmasked-fasta": UNMASKED_FASTA,
}

_LARGE_OUTPUTS = {IDS, NAMES, LENGTHS, MASK, FOUR_BIT, DNA, MASKED_DNA,
                  UNMASKED_DNA, SEQ, FASTA, MASKED_FASTA, UNMASKED_FASTA, FASTQ}

HELP = """Usage: untnaf [OUTPUT-TYPE] [file.naf]
Options for selecting output type:
  --format        - File format version
  --part-list     - List of parts
  --sizes         - Part sizes
  --number        - Number of sequences
  --title         - Dataset title
  --ids           - Sequence ids (accession numbers)
  --names         - Full sequence names (including ids)
  --lengths       - Sequence lengths
  --total-length  - Sum of sequence lengths
  --mask          - Masked region lengths
  --4bit          - 4bit-encoded nucleotide sequence (binary data)
  --seq           - Continuous concatenated sequence
  --sequences     - One sequence per line, no names
  --fasta         - FASTA-formatted sequences
  --fastq         - FASTQ-formatted sequences
  --range A:B     - FASTA/FASTQ records [A, B) only (tnaf extension;
                    random access on extended-format archives)
Other options:
  --device        - Render FASTA/FASTQ on the attached device mesh (tnaf
                    extension; sharded gather render, same bytes)
  --engine NAME   - Entropy decoder: 'zstd' (library, default), 'native'
                    (this package's from-scratch RFC 8878 decoder)
  -o FILE         - Decompress into FILE
  -c              - Write to standard output
  --line-length N - Use lines of width N for FASTA output
  --no-mask       - Ignore mask
  --binary-stdout - Set stdout stream to binary mode.
  --binary-stderr - Set stderr stream to binary mode.
  --binary        - Shortcut for "--binary-stdout --binary-stderr"
  -h, --help      - Show help
  -V, --version   - Show version
"""


def _msg(s: str) -> None:
    sys.stderr.buffer.write(s.encode("latin-1", errors="replace"))
    sys.stderr.buffer.flush()


def _die(s: str) -> "NoReturn":  # noqa: F821
    _msg(f"{PROG} error: {s}\n")
    sys.exit(1)


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)

    out_type = UNDECIDED
    rng_arg: tuple[int, int] | None = None
    in_path: str | None = None
    out_path: str | None = None
    force_stdout = False
    print_version = False
    use_mask = True
    use_device = False
    line_length: int | None = None

    def set_out_type(t: int) -> None:
        nonlocal out_type
        if out_type != UNDECIDED:
            _die("only one output type should be specified")
        out_type = t

    i, n = 0, len(argv)
    while i < n:
        a = argv[i]
        if a.startswith("-") and a != "-":
            if a.startswith("--"):
                if a == "--line-length" and i < n - 1:
                    i += 1
                    try:
                        v = int(argv[i])
                    except ValueError:
                        _die("can't parse the value of --line-length parameter")
                    if str(v) != argv[i]:
                        _die("can't parse the value of --line-length parameter")
                    if v < 0:
                        _die("negative line length specified")
                    line_length = v
                    i += 1
                    continue
                if a in _TYPE_FLAGS:
                    set_out_type(_TYPE_FLAGS[a])
                    i += 1
                    continue
                if a == "--range" and i < n - 1:
                    i += 1
                    try:
                        a0, _, b0 = argv[i].partition(":")
                        rng_arg = (int(a0), int(b0))
                    except ValueError:
                        _die("can't parse the value of --range parameter")
                    set_out_type(RANGE)
                    i += 1
                    continue
                if a == "--no-mask":
                    use_mask = False
                    i += 1
                    continue
                if a == "--device":
                    use_device = True
                    i += 1
                    continue
                if a == "--engine" and i < n - 1:
                    i += 1
                    if argv[i] not in ("zstd", "native"):
                        _die(f'unknown engine "{argv[i]}"')
                    from ..codec import set_decode_engine

                    set_decode_engine(argv[i])
                    i += 1
                    continue
                if a in ("--binary-stdout", "--binary-stderr", "--binary"):
                    i += 1
                    continue
                if a == "--help":
                    _msg(HELP)
                    return 0
                if a == "--verbose":
                    i += 1
                    continue
                if a == "--version":
                    print_version = True
                    i += 1
                    continue
                _die(f'unknown or incomplete argument "{a}"')
            if a == "-o" and i < n - 1:
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
                _die("can process only one file at a time")
            if a == "":
                _die("empty input path specified")
            in_path = a
            i += 1

    if print_version:
        _msg(f"{PROG} - NAF decompressor (naf_tpu_torch, PyTorch + CUDA), version {__version__}, "
             f"{TOOL_DATE}\n")
        return 0

    if force_stdout and out_path is not None:
        _die("-c and -o arguments can't be used together")

    if in_path is None and sys.stdin.isatty():
        _msg(f'{PROG} error: no input specified, use "{PROG} -h" for help\n')
        return 0

    if in_path is not None:
        try:
            f = open(in_path, "rb")
        except OSError:
            _die("can't open input file")
    else:
        f = sys.stdin.buffer

    opts = DecodeOptions(use_mask=use_mask, line_length=line_length)
    try:
        dec = Decoder(f, opts)
    except (NafFormatError, VleError) as e:
        _die(str(e))

    h = dec.h
    if out_type == UNDECIDED:
        out_type = FASTQ if h.has_quality else FASTA

    if out_type in (DNA, MASKED_DNA, UNMASKED_DNA) and h.seq_type != C.SEQ_TYPE_DNA:
        _die(f"input has not DNA, but {h.seq_type_name} data")
    if out_type == FOUR_BIT and h.seq_type >= C.SEQ_TYPE_PROTEIN:
        _die(f"input has no 4-bit encoded data, but {h.seq_type_name} sequences")

    # output file selection (unnaf/src/files.c:38-86)
    extracting_original = (out_type == FASTQ) if h.has_quality else (out_type == FASTA)
    if (extracting_original and not force_stdout and in_path is not None
            and out_path is None and sys.stdout.isatty()):
        if in_path.endswith(".naf") and len(in_path) > 4 and in_path[-5] not in "/\\":
            out_path = in_path[:-4]

    if out_path is not None and not force_stdout:
        try:
            out_f = open(out_path, "wb")
        except OSError:
            _die("can't create output file")
    else:
        out_f = sys.stdout.buffer
        if out_type in _LARGE_OUTPUTS and not force_stdout and sys.stdout.isatty():
            _die("output file not specified - please either specify output file with '-o' or '>', or use '-c' option to force writing to console")

    global _RANGE_ARG
    _RANGE_ARG = rng_arg
    try:
        if use_device and out_type in (FASTA, MASKED_FASTA, UNMASKED_FASTA,
                                       FASTQ):
            dec.r.read_counters()
            dec.r.skip_section("title")
            out_f.write(_render_device(dec, out_type))
        else:
            streamed = _maybe_stream(dec, out_type, out_f)
            if not streamed:
                out_f.write(_render(dec, out_type))
    except (NafFormatError, VleError, DecodeError, ValueError) as e:
        _die(str(e))

    out_f.flush()
    if out_path is not None and not force_stdout:
        out_f.close()
        if in_path is not None:
            try:
                st = os.stat(in_path)
                os.chmod(out_path, st.st_mode & 0o777)
                os.utime(out_path, ns=(st.st_atime_ns, st.st_mtime_ns))
            except OSError:
                pass
    return 0


def _render_device(dec: Decoder, out_type: int) -> bytes:
    """FASTA or FASTQ rendered by the CUDA kernels over every visible card;
    a missing card, a kernel build or a launch that fails ends the CLI."""
    from ..parallel.mesh import block_mesh
    from ..utils.trace import device_profile

    try:
        with device_profile():
            mesh = block_mesh()
            if out_type == FASTQ:
                return fastq_device(dec, mesh=mesh)
            return fasta_device(dec, None if out_type != UNMASKED_FASTA else False, mesh=mesh)
    except (RuntimeError, OSError) as e:
        _die(f"device decode failed: {e}")


def _maybe_stream(dec: Decoder, out_type: int, out_f) -> bool:
    """Large sequence outputs decode in bounded-memory record batches."""
    h = dec.h
    dec.r.read_counters()
    if dec.r.n_sequences == 0:
        return False
    # small archives render whole-buffer (fastest); large ones stream in
    # record batches with bounded memory
    threshold = int(os.environ.get("NAF_TPU_STREAM_THRESHOLD", str(256 << 20)))
    small = False
    try:
        small = os.fstat(dec.r.f.fileno()).st_size < threshold // 4
    except (OSError, AttributeError, ValueError, io.UnsupportedOperation):
        pass
    if small:
        return False
    if out_type in (FASTA, MASKED_FASTA, UNMASKED_FASTA):
        dec.r.skip_section("title")
        dec.stream_fasta(out_f, masking=None if out_type != UNMASKED_FASTA
                         else False)
        return True
    if out_type == FASTQ:
        if not h.has_quality:
            raise DecodeError("FASTQ output requested, but input has no qualities")
        dec.r.skip_section("title")
        dec.stream_fastq(out_f)
        return True
    return False


def _render(dec: Decoder, out_type: int) -> bytes:
    h = dec.h
    if out_type == FORMAT_NAME:
        return dec.format_name()
    if out_type == PART_LIST:
        return dec.part_list()

    dec.r.read_counters()
    N = dec.r.n_sequences

    if out_type == NUMBER_OF_SEQUENCES:
        return dec.number()
    if out_type == PART_SIZES:
        return dec.part_sizes()
    if out_type == TITLE:
        return dec.title()
    if N == 0:
        return b""

    dec.r.skip_section("title")

    if out_type == IDS:
        return dec.ids()
    if out_type == NAMES:
        return dec.names()
    if out_type == LENGTHS:
        return dec.lengths()
    if out_type == TOTAL_LENGTH:
        return dec.total_length()
    if out_type == MASK:
        return dec.mask()
    if out_type == TOTAL_MASK_LENGTH:
        return dec.total_mask_length()
    if out_type == FOUR_BIT:
        return dec.four_bit()
    if out_type in (DNA, SEQ, MASKED_DNA):
        return dec.seq_concat()
    if out_type == UNMASKED_DNA:
        return dec.seq_concat(masking=False)
    if out_type == CHARCOUNT:
        return dec.charcount()
    if out_type == SEQUENCES:
        return dec.sequences()
    if out_type == RANGE:
        if h.has_quality:
            return dec.fastq_range(*_RANGE_ARG)
        return dec.fasta_range(*_RANGE_ARG)
    if out_type in (FASTA, MASKED_FASTA):
        return dec.fasta()
    if out_type == UNMASKED_FASTA:
        return dec.fasta(masking=False)
    if out_type == FASTQ:
        if not h.has_quality:
            raise DecodeError("FASTQ output requested, but input has no qualities")
        return dec.fastq()
    raise DecodeError("unknown output requested")


if __name__ == "__main__":
    sys.exit(main())
