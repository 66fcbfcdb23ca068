"""Seeded byte inputs shared by the naf_tpu_torch kernel tests (numpy and
the port only, so the tests on the card need neither jax nor naf_tpu).

Classify cases are LF-padded to N_CLASSIFY bytes (but the three long ones
they share with the FASTA emit), emit cases to N_EMIT and FASTQ cases to
N_FASTQ, so the JAX kernels they are held against compile once per
length.  LF padding is inert: it only closes the open line (in FASTQ, it
adds empty lines that keep nothing).
"""

from __future__ import annotations

import numpy as np

from naf_tpu_torch.format import constants as C
from naf_tpu_torch.ops.common import CLASSIFY_TILE, COMPACT_TILE, Q_TILE, SCAN_TILE, TILE

#: one padded length for every classify case
N_CLASSIFY = 2 * TILE + 64
#: one padded length for every emit case
N_EMIT = 3 * TILE - 6


def pad_lf(body, n: int) -> np.ndarray:
    """Trailing LF padding (inert: it only closes the open line)."""
    body = np.asarray(body, np.uint8)
    assert body.size <= n
    return np.concatenate([body, np.full(n - body.size, 0x0A, np.uint8)])


def classify_case(name: str):
    """(body, prev_byte, starts_in_seq) of one classify case."""
    made = {"many_tiles": fasta_many_tiles, "long_header": fasta_long_header,
            "long_line": fasta_long_line}
    if name in made:
        return made[name](), ord(">"), False
    rng = np.random.default_rng(14)
    if name == "fuzz":
        pool = np.frombuffer(b">ACGTNacgtn \t\r\n\x0b\x0c" + b"xyz*-@!", np.uint8)
        return rng.choice(pool, size=N_CLASSIFY), ord(">"), False
    if name == "all_bytes":
        return (np.tile(np.arange(256, dtype=np.uint8), N_CLASSIFY // 256 + 1)[:N_CLASSIFY],
                ord("\n"), False)
    if name == "tile_edge_header":
        edge = np.full(N_CLASSIFY, ord("A"), np.uint8)
        hdr = np.frombuffer(b"\n>h x\x7fy\n", np.uint8)
        edge[TILE - 5:TILE - 5 + hdr.size] = hdr
        return edge, ord(">"), False
    rows = []
    for i in range(400):
        rows.append(b">id%d c\x01m%d\tx\n" % (i, i))
        rows.append(rng.choice(np.frombuffer(b"ACGTacgtRY>*", np.uint8),
                               size=int(rng.integers(1, 600))).tobytes() + b"\r\n")
    body = pad_lf(np.frombuffer(b"".join(rows), np.uint8)[1:N_CLASSIFY + 1], N_CLASSIFY)
    if name == "mid_record":
        return body, ord("A"), True
    if name == "structured":
        return body, ord(">"), False
    raise KeyError(name)


#: the cases padded to N_CLASSIFY, and the FASTA emit's long cases (tens of
#: tiles, a header and a line across tiles; their own lengths)
CLASSIFY_CASES = ["fuzz", "all_bytes", "structured", "mid_record", "tile_edge_header",
                  "many_tiles", "long_header", "long_line"]
#: every sequence type a FASTA block can be classified as
SEQ_TYPES = [C.SEQ_TYPE_DNA, C.SEQ_TYPE_RNA, C.SEQ_TYPE_PROTEIN, C.SEQ_TYPE_TEXT]


def _records(rng, n_rec, max_len, alphabet=b"ACGTNn", runs=50):
    rows = []
    for i in range(n_rec):
        com = b" comment %d" % i if i % 3 else b""
        rows.append(b">rec%d%s\n" % (i, com))
        seq = rng.choice(np.frombuffer(alphabet, np.uint8), size=int(rng.integers(1, max_len)))
        for s in rng.integers(0, max(1, seq.size - runs), size=max(1, seq.size // 500)):
            seq[s:s + runs] |= 32
        rows.append(seq.tobytes() + b"\n")
    return np.frombuffer(b"".join(rows), np.uint8)[1:]


def emit_case(name: str):
    """(body, prev_byte, starts_in_seq, seq_type) of one emit case."""
    rng = np.random.default_rng(40)
    if name == "structured":
        return pad_lf(_records(rng, 50, 3000), N_EMIT), ord(">"), False, C.SEQ_TYPE_DNA
    if name == "rna":
        return (pad_lf(_records(rng, 40, 3000, b"ACGUNn"), N_EMIT), ord(">"), False,
                C.SEQ_TYPE_RNA)
    if name == "wrapped_masked":
        seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=150_000)
        for s in rng.integers(0, 149_000, size=60):
            seq[s:s + 400] |= 32
        lines = b"\n".join(seq[i:i + 70].tobytes() for i in range(0, seq.size, 70))
        return (pad_lf(np.frombuffer(b"r1 big record\n" + lines + b"\n", np.uint8), N_EMIT),
                ord(">"), False, C.SEQ_TYPE_DNA)
    if name == "unexpected":
        body = b"x\x01y bad\x02com\xffx\nAC!GT*acg\n>n2 \x7f\nACGT\n>\x01\nZZ\n"
        return pad_lf(np.frombuffer(body, np.uint8), N_EMIT), ord(">"), False, C.SEQ_TYPE_DNA
    if name == "mid_record":
        body = b"acGTACgt\nACGT\n>n2 c\nTTTT\n" * 50
        return pad_lf(np.frombuffer(body, np.uint8), N_EMIT), ord("\n"), True, C.SEQ_TYPE_DNA
    if name == "single_char_runs":
        body = b"r\n" + b"Aa" * 900 + b"\n"
        return pad_lf(np.frombuffer(body, np.uint8), N_EMIT), ord(">"), False, C.SEQ_TYPE_DNA
    if name == "space_classes":
        body = b"h1\tt c\x0bx\nAC GT\tac\x0cgt\r\n>h2 \r\nA\x0bC\n"
        return pad_lf(np.frombuffer(body, np.uint8), N_EMIT), ord(">"), False, C.SEQ_TYPE_DNA
    if name == "tile_edges":
        # records and mask runs straddling the tile edges
        rows = []
        for i in range(3):
            rows.append(b">r%d\n" % i)
            n = TILE - 7 + int(rng.integers(0, 13))
            seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=n)
            for s in rng.integers(0, n - 300, size=n // 800):
                seq[s:s + 300] |= 32
            rows.append(seq.tobytes() + b"\n")
        body = np.frombuffer(b"".join(rows), np.uint8)[1:N_EMIT + 1]
        return pad_lf(body, N_EMIT), ord(">"), False, C.SEQ_TYPE_DNA
    if name == "sparse_overflow":
        rows = [b">h%d very long comment line to overflow\nA\n" % i for i in range(3000)]
        body = np.frombuffer(b"".join(rows), np.uint8)[1:N_EMIT + 1]
        return pad_lf(body, N_EMIT), ord(">"), False, C.SEQ_TYPE_DNA
    if name == "fuzz":
        pool = np.frombuffer(b">ACGTNACGT \t\r\nacgt" + b"xyz*-", np.uint8)
        return rng.choice(pool, size=N_EMIT), ord(">"), False, C.SEQ_TYPE_DNA
    made = {"many_tiles": fasta_many_tiles, "long_header": fasta_long_header,
            "long_line": fasta_long_line}
    if name in made:
        return made[name](), ord(">"), False, C.SEQ_TYPE_DNA
    raise KeyError(name)


EMIT_CASES = ["structured", "rna", "wrapped_masked", "unexpected", "mid_record",
              "single_char_runs", "space_classes", "tile_edges", "sparse_overflow", "fuzz"]
#: the emit cases, and those the FASTA emit's look-backs and bit masks need
#: besides (run under host emulation and on the card; not padded to N_EMIT)
FASTA_EMIT_CASES = EMIT_CASES + ["many_tiles", "long_header", "long_line"]
#: (prev_byte, starts_in_seq) of a block: after an id byte, after a line
#: end in a header or in a sequence, inside a sequence line
START_STATES = [(ord(">"), False), (ord("\n"), False), (ord("\n"), True), (ord("A"), True),
                (ord("A"), False)]


def _seq_lines(rng, n: int, line: int = 60, runs: int = 0, alphabet=b"ACGT") -> bytes:
    """n bases in lines of `line`, with `runs` lower-case runs of 1 to 3000."""
    seq = rng.choice(np.frombuffer(alphabet, np.uint8), size=n)
    for s, ln in zip(rng.integers(0, n, size=runs), rng.integers(1, 3000, size=runs)):
        seq[s:s + ln] |= 32
    return b"\n".join(seq[i:i + line].tobytes() for i in range(0, n, line)) + b"\n"


def fasta_many_tiles() -> np.ndarray:
    """30 tiles (past the leading '>'): records whose headers, comments and
    lower-case runs cross tile edges; a tile of blank and whitespace-only
    sequence lines (no kept byte); a tile of headers whose ids are all
    unexpected bytes (it keeps only those); a tile of long comments (past
    the sparse cap); CR LF line ends and unexpected bases here and there."""
    rng = np.random.default_rng(41)
    out = bytearray()
    i = 0

    def records(until: int):
        nonlocal i
        while len(out) < until:
            com = b" comment\t%d" % i if i % 3 else b""
            seq = _seq_lines(rng, int(rng.integers(1, 6000)), runs=2,
                             alphabet=b"ACGTN" + (b"*" if i % 7 == 0 else b""))
            out.extend(b">r%d%s\n" % (i, com) + (seq.replace(b"\n", b"\r\n") if i % 5 == 0
                                                  else seq))
            i += 1

    for k, what in enumerate(["id", "comment", "case", "id", "comment"]):
        edge = (2 + 2 * k) * TILE
        records(edge - 3000)
        if what == "case":                  # a lower-case run across the edge
            out.extend(b">r%d\n" % i + _seq_lines(rng, edge + 2000 - len(out)).lower())
            i += 1
            continue
        out.extend(_seq_lines(rng, edge - 40 - len(out)))
        head = b">h%d" % i + b"x" * 60 if what == "id" else b">h%d cc" % i + b"c" * 80
        out.extend(head + b"\n")
        i += 1
    records(12 * TILE)
    out.extend(b">blank\n" + b"\n  \t \n\n \r\n" * (2 * TILE // 9))    # no kept byte
    records(15 * TILE)
    unex = np.frombuffer(b"\x01\x02\x7f\xff\x1f", np.uint8)
    while len(out) < 17 * TILE:             # kept bytes: unexpected id bytes only
        out.extend(b">" + rng.choice(unex, size=int(rng.integers(1, 200))).tobytes() + b"\n")
    records(20 * TILE)
    while len(out) < 22 * TILE:             # past the sparse cap
        out.extend(b">c%d %s\nA\n" % (i, b"long comment " * 30))
        i += 1
    records(30 * TILE)
    return np.frombuffer(bytes(out), np.uint8)[1:30 * TILE + 1].copy()


def fasta_long_header() -> np.ndarray:
    """A header longer than two tiles: an id of 150,000 bytes (unexpected
    bytes but one in 50, so its tiles stay under the sparse cap) and a
    comment of 100,000 bytes, then records."""
    rng = np.random.default_rng(42)
    ident = np.full(150_000, 0x01, np.uint8)
    ident[::50] = ord("x")
    com = rng.choice(np.frombuffer(b"abc \tXYZ\x01", np.uint8), size=100_000)
    out = bytearray(b">" + ident.tobytes() + b" " + com.tobytes() + b"\n")
    out += _seq_lines(rng, 30_000, runs=3)
    for i in range(20):
        out += b">r%d c\n" % i + _seq_lines(rng, int(rng.integers(1, 5000)), runs=1)
    return pad_lf(np.frombuffer(bytes(out), np.uint8)[1:], 7 * TILE)


def fasta_long_line() -> np.ndarray:
    """One sequence line of 250,000 bases with lower-case runs (the longest
    line spans four tiles), then records of 70-column lines."""
    rng = np.random.default_rng(43)
    out = bytearray(b">one line\n" + _seq_lines(rng, 250_000, line=250_000, runs=20))
    for i in range(15):
        out += b">r%d\n" % i + _seq_lines(rng, int(rng.integers(1, 9000)), line=70, runs=1)
    return pad_lf(np.frombuffer(bytes(out), np.uint8)[1:], 6 * TILE)


def fasta_start_states() -> np.ndarray:
    """Two tiles of short records whose first byte is '>' (a marker only
    after a line end), for START_STATES."""
    rng = np.random.default_rng(44)
    rows = [b">s%d x\t%d\n" % (i, i) + _seq_lines(rng, int(rng.integers(1, 400)), runs=1)
            for i in range(700)]
    return pad_lf(np.frombuffer(b"".join(rows), np.uint8)[:2 * TILE], 2 * TILE)


def fasta_big_block(tiles: int, flip_case: bool, seed: int = 27) -> np.ndarray:
    """A FASTA block (past the leading '>') of at least ``tiles`` 64 KiB
    tiles of one-line records of 1 to 600 bases, comments on one header in
    three (near the sparse cap in most tiles); with ``flip_case``, each
    record in lower case with probability 1/2, so that case changes sit at
    many tile starts."""
    rng = np.random.default_rng(seed)
    n_rec = tiles * TILE // 300 + 1
    lens = rng.integers(1, 601, n_rec)
    pool = rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=int(lens.sum()))
    if flip_case:
        pool |= np.repeat((rng.random(n_rec) < 0.5).astype(np.uint8) * 32, lens)
    seq = pool.tobytes()
    rows, o = [], 0
    for i, ln in enumerate(lens.tolist()):
        com = b" x:%d" % i if i % 3 == 0 else b""
        rows.append(b">r%d%s\n%s\n" % (i, com, seq[o:o + ln]))
        o += ln
    body = np.frombuffer(b"".join(rows), np.uint8)[1:]
    assert body.size >= tiles * TILE
    return body


def case_change_behind_tile_start() -> np.ndarray:
    """One record of 70-column lines whose second tile starts at an EOL,
    upper case before it and lower case after."""
    p = TILE % 71                       # header "r" * p + LF puts an EOL at TILE
    seq = np.full(2 * TILE, ord("A"), np.uint8)
    lines = b"\n".join(seq[i:i + 70].tobytes() for i in range(0, seq.size, 70)) + b"\n"
    body = np.frombuffer(b"r" * p + b"\n" + lines, np.uint8)[:N_EMIT].copy()
    assert body[TILE] == 0x0A
    tail = body[TILE + 1:]
    tail[tail != 0x0A] |= 32
    return pad_lf(body, N_EMIT)


# ---------------------------------------------------------------------------
# FASTQ
# ---------------------------------------------------------------------------

#: one padded length for every FASTQ case (ten 32 KiB emit tiles)
N_FASTQ = 10 * Q_TILE - 10


def fastq_reads(rng, n_rec, max_len=200, alphabet=b"ACGTNacgtZz "):
    """Reads of random length with comments on two in three headers (the
    generator of test_scan_fused.py), without the leading '@'."""
    rows = []
    for i in range(n_rec):
        ln = int(rng.integers(1, max_len))
        seq = rng.choice(np.frombuffer(alphabet, np.uint8), size=ln).tobytes()
        qual = rng.integers(28, 94, size=ln, dtype=np.uint8).tobytes()
        com = b" c%d @x" % i if i % 3 else b""
        rows.append(b"@read%d%s\n%s\n+\n%s\n" % (i, com, seq, qual))
    return np.frombuffer(b"".join(rows), np.uint8)[1:]


def fastq_masked_reads(rng, n_reads=300, read_len=90, masked=True):
    """Fixed-length reads, a lowercase run in one read of three (the
    generator of test_emit_fused.py), without the leading '@'."""
    out = []
    for i in range(n_reads):
        seq = rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=read_len)
        if masked and i % 3 == 0:
            seq[10:60] |= 32
        qual = rng.integers(35, 74, size=read_len, dtype=np.uint8)
        com = b" len%d" % read_len if i % 4 else b""
        out.append(b"@rd%04d%s\n%s\n+\n%s\n" % (i, com, seq.tobytes(), qual.tobytes()))
    return np.frombuffer(b"".join(out), np.uint8)[1:]


def fastq_case(name: str) -> np.ndarray:
    """The body (past the leading '@') of one FASTQ case, LF-padded to
    N_FASTQ (many_tiles to 41 tiles; ragged_16 not padded)."""
    if name == "multi_tile":
        return pad_lf(fastq_reads(np.random.default_rng(11), 1200), N_FASTQ)
    if name == "long_reads":             # reads longer than a tile
        return pad_lf(fastq_reads(np.random.default_rng(12), 4, max_len=2 * TILE // 3), N_FASTQ)
    if name == "weird_bytes":            # '@'/'+' in qualities, unexpected chars everywhere
        return pad_lf(fastq_reads(np.random.default_rng(13), 300,
                                  alphabet=b"ACGT@+>\x01~ acgt"), N_FASTQ)
    if name == "lf_tail":
        return pad_lf(np.frombuffer(b"r1\nACGT\n+\n!!!!\n" + b"\n" * 37, np.uint8), N_FASTQ)
    if name == "masked":
        return pad_lf(fastq_masked_reads(np.random.default_rng(20), 900, 120), N_FASTQ)
    if name == "tiny_unexpected":
        return pad_lf(np.frombuffer(b"r1 c\nACGT\n+\n!!!!\n@r2\nNNZA\n+\n!!\x7f!\n", np.uint8),
                      N_FASTQ)
    if name == "varied":
        rng = np.random.default_rng(21)
        out = []
        for i in range(200):
            ln = int(rng.integers(1, 200))
            seq = rng.choice(np.frombuffer(b"ACGTacgt", np.uint8), size=ln)
            qual = rng.integers(33, 100, size=ln, dtype=np.uint8)
            out.append(b"@x%d\n%s\n+\n%s\n" % (i, seq.tobytes(), qual.tobytes()))
        return pad_lf(np.frombuffer(b"".join(out), np.uint8)[1:], N_FASTQ)
    if name == "sparse_overflow":        # a tile of comment bytes past the cap
        rows = [b"@r%d %s\nA\n+\n!\n" % (i, b"c" * 300) for i in range(300)]
        return pad_lf(np.frombuffer(b"".join(rows), np.uint8)[1:], N_FASTQ)
    if name == "many_tiles":             # 41 tiles, a lower-case run in one read of three
        return pad_lf(fastq_masked_reads(np.random.default_rng(24), 4200, 150), 41 * Q_TILE)
    if name == "line_edges":
        return fastq_line_edges()
    if name == "unexpected_lanes":
        return fastq_unexpected_lanes()
    if name == "long_header":
        return fastq_long_header()
    if name == "warp_edges":
        return fastq_warp_edges()
    if name == "ragged_16":              # reads to a length not a multiple of 16
        body = fastq_reads(np.random.default_rng(25), 900, alphabet=b"ACGTacgt")
        return body[: 3 * Q_TILE + 16 * 37 + 9]
    raise KeyError(name)


FASTQ_CASES = ["multi_tile", "long_reads", "weird_bytes", "lf_tail", "masked",
               "tiny_unexpected", "varied", "sparse_overflow"]


def _fastq_record(rng, i: int, h: int, s: int, qual_first: bytes = b"") -> bytes:
    """One record with an h-byte header and s bases (and quality bytes)."""
    head = (b"r%d" % i + b"c" * h)[:h]
    seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=s).tobytes()
    qual = (qual_first + rng.integers(35, 74, size=s, dtype=np.uint8).tobytes())[:s]
    return b"@%s\n%s\n+\n%s\n" % (head, seq, qual)


def fastq_line_edges() -> np.ndarray:
    """Reads placed so that a header, a sequence and a quality line each
    cross a 32 KiB tile edge and a 128-byte chunk edge inside a tile."""
    rng = np.random.default_rng(22)
    out = bytearray()
    edges = [(Q_TILE, "header"), (Q_TILE + 128 * 37, "sequence"), (2 * Q_TILE, "quality"),
             (2 * Q_TILE + 128 * 101, "header"), (3 * Q_TILE, "sequence"),
             (3 * Q_TILE + 128 * 200, "quality")]
    i = 0
    for edge, line in edges:
        while len(out) < edge - 700:
            out += _fastq_record(rng, i, int(rng.integers(5, 40)), int(rng.integers(50, 150)))
            i += 1
        room = edge - len(out)                      # bytes before the edge, 300 to 700
        if line == "header":                        # '@' + header crosses the edge
            rec = _fastq_record(rng, i, room + 9, 80)
        elif line == "sequence":
            rec = _fastq_record(rng, i, 20, room - 22 + 11)
        else:                                       # quality from room // 2 on, past the
            rec = _fastq_record(rng, i, 20, room // 2)  # edge
        out += rec
        i += 1
    return pad_lf(np.frombuffer(bytes(out), np.uint8)[1:], N_FASTQ)


def fastq_unexpected_lanes() -> np.ndarray:
    """Unexpected bytes in every lane: id, comment, sequence, the '+' line
    and quality; quality lines that start with '@', a space or a tab."""
    rng = np.random.default_rng(23)
    rows = []
    for i in range(700):
        k = i % 7
        head = [b"r%d" % i, b"r\x01%d" % i, b"r%d c\x01m" % i, b"r%d\x80 x\tz" % i,
                b"r%d" % i, b"r%d c" % i, b"\x7fr%d" % i][k]
        seq = bytearray(rng.choice(np.frombuffer(b"ACGTacgtN", np.uint8),
                                   size=int(rng.integers(1, 120))).tobytes())
        if k in (2, 3, 6):
            seq[int(rng.integers(0, len(seq)))] = b"Z\x01\x80\xff"[i % 4]
        qual = bytearray(rng.integers(35, 74, size=len(seq), dtype=np.uint8).tobytes())
        if k in (1, 4):
            qual[int(rng.integers(0, len(qual)))] = b"\x01\x7f\xff "[i % 4]
        if k in (0, 4, 5):
            qual[0] = b"@ \t"[k % 3]
        plus = [b"+", b"+r\x01", b"+\x80x"][i % 3]
        rows.append(b"@%s\n%s\n%s\n%s\n" % (head, bytes(seq), plus, bytes(qual)))
    return pad_lf(np.frombuffer(b"".join(rows), np.uint8)[1:], N_FASTQ)


def fastq_long_header() -> np.ndarray:
    """A header line longer than two 32 KiB tiles, its first space in the
    first tile and unexpected comment bytes in the tiles after (a tile that
    holds neither a space nor a line end gets COMMENT only from the tiles
    before it), then a sequence and a quality line of the header's length,
    the quality line starting with a space."""
    rng = np.random.default_rng(27)
    out = bytearray()
    for i in range(30):
        out += _fastq_record(rng, i, int(rng.integers(5, 40)), int(rng.integers(50, 150)))
    ln = 2 * Q_TILE + 3000
    head = bytearray(rng.choice(np.frombuffer(b"abcxyz:0123456789", np.uint8), size=ln).tobytes())
    head[:8] = b"longread"
    head[Q_TILE // 2] = ord(" ")
    pos = rng.integers(Q_TILE, ln, size=40)
    head[Q_TILE - len(out) + 9] = 0x7F              # the second tile's first bytes
    for k, p in enumerate(pos.tolist()):
        head[p] = b"\x01\x7f\xff"[k % 3]
    seq = rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=ln).tobytes()
    qual = b" " + rng.integers(35, 74, size=ln - 1, dtype=np.uint8).tobytes()
    out += b"@%s\n%s\n+\n%s\n" % (bytes(head), seq, qual)
    for i in range(30, 60):
        out += _fastq_record(rng, i, int(rng.integers(5, 40)), int(rng.integers(50, 150)))
    return pad_lf(np.frombuffer(bytes(out), np.uint8)[1:], N_FASTQ)


def fastq_warp_edges() -> np.ndarray:
    """A header, a sequence line, a '+' line, a quality line (its first
    byte a space) and a record's '@' each starting exactly at a 4,096-byte
    warp-run boundary inside a 32 KiB tile, where the byte before a run is
    read from memory; and a quality line whose second byte, a space, sits
    at such a boundary."""
    rng = np.random.default_rng(28)
    out = bytearray()                               # body position p is out[p + 1]
    i = 0
    # (boundary, line, offset of the line in its record); records of a
    # 20-byte header and 100 bases
    edges = [(Q_TILE + 4096, "header", 1), (Q_TILE + 5 * 4096, "sequence", 22),
             (2 * Q_TILE + 3 * 4096, "plus", 123), (3 * Q_TILE + 7 * 4096, "quality", 125),
             (4 * Q_TILE + 2 * 4096, "at", 0), (5 * Q_TILE + 6 * 4096, "quality_rest", 126)]
    for edge, line, off in edges:
        o = edge + 1 - off                          # where the record's '@' goes in out
        while o - len(out) > 700:
            out += _fastq_record(rng, i, int(rng.integers(5, 40)), int(rng.integers(50, 150)))
            i += 1
        room = o - len(out)                         # one record of exactly this length
        s = (room - 16) // 2
        out += _fastq_record(rng, i, room - 6 - 2 * s, s)
        assert len(out) == o
        out += _fastq_record(rng, i + 1, 20, 100, qual_first=b"  ")
        i += 2
    body = np.frombuffer(bytes(out), np.uint8)[1:]
    # the byte before each edge and the first bytes from it
    want = {"header": b"@r", "sequence": b"\n", "plus": b"\n+", "quality": b"\n ", "at": b"\n@",
            "quality_rest": b"  "}
    for edge, line, _ in edges:
        assert edge % Q_TILE and edge % 4096 == 0
        assert body[edge - 1:edge - 1 + len(want[line])].tobytes() == want[line]
    return pad_lf(body, N_FASTQ)


def fastq_big_block(tiles: int, flip_case: bool, seed: int = 26) -> np.ndarray:
    """A FASTQ block (past the leading '@') of at least ``tiles`` 32 KiB
    tiles of reads of 1 to 400 bases, comments on one header in two; with
    ``flip_case``, each read in lower case with probability 1/2, so that
    case changes sit at many tile starts."""
    rng = np.random.default_rng(seed)
    n_rec = tiles * Q_TILE // 400 + 1
    lens = rng.integers(1, 401, n_rec)
    pool = rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=int(lens.sum()))
    if flip_case:
        pool |= np.repeat((rng.random(n_rec) < 0.5).astype(np.uint8) * 32, lens)
    qual = rng.integers(35, 74, size=pool.size, dtype=np.uint8).tobytes()
    seq = pool.tobytes()
    rows, o = [], 0
    for i, ln in enumerate(lens.tolist()):
        com = b" x:%d" % i if i % 2 else b""
        rows.append(b"@r%d%s\n%s\n+\n%s\n" % (i, com, seq[o:o + ln], qual[o:o + ln]))
        o += ln
    body = np.frombuffer(b"".join(rows), np.uint8)[1:]
    assert body.size >= tiles * Q_TILE
    return body


#: the FASTQ cases, and those the FASTQ emit's look-back and bit masks need
#: besides (run under host emulation and on the card)
FASTQ_EMIT_CASES = FASTQ_CASES + ["many_tiles", "line_edges", "unexpected_lanes", "ragged_16",
                                   "long_header", "warp_edges"]


def fastq_case_change_behind_tile_start(where: str) -> np.ndarray:
    """Reads of 100 bases, upper case up to the read at which the second
    32 KiB tile starts (the edge falls inside its header, or inside the
    quality line of the read before it) and lower case from there on: the
    tile's first kept byte is a case change but not its first byte.

    Layout of the body (past the leading '@'): a first record with an
    h-byte header, then 212-byte records "@r%05d\\n" + seq + "\\n+\\n" +
    qual + "\\n" whose j-th '@' sits at h + 7 + 212 j.
    """
    j, h, edge = {"header": (154, 110, 3), "quality": (153, 175, 150)}[where]
    assert h + 7 + 212 * j + edge == Q_TILE
    first_lower = j if where == "header" else j + 1
    rng = np.random.default_rng(70)
    rows = [b"@" + b"p" * h + b"\nA\n+\n!\n"]
    for i in range(300):
        seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=100)
        if i >= first_lower:
            seq |= 32
        qual = rng.integers(35, 74, size=100, dtype=np.uint8)
        rows.append(b"@r%05d\n%s\n+\n%s\n" % (i, seq.tobytes(), qual.tobytes()))
    body = np.frombuffer(b"".join(rows), np.uint8)[1:]
    return pad_lf(body, N_FASTQ)


# ---------------------------------------------------------------------------
# mask parity
# ---------------------------------------------------------------------------

#: named cases of mask_parity_case, each one to three 32 KiB tiles of the
#: kernel (a lane holds 128 bytes, a warp 4,096); all but all_bytes keep
#: their chars below 224, so only all_bytes shows a carry between bytes
MASK_PARITY_CASES = ["lane_warp_edges", "tile_span", "dense", "all_twos", "all_bytes"]


def dense_toggles(rng, n: int) -> np.ndarray:
    """u8[n] toggles: a bound every 1-3 bytes, 1-3 bounds at each."""
    tog = np.zeros(n, np.uint8)
    at = np.cumsum(rng.integers(1, 4, n))
    at = at[at < n]
    tog[at] = rng.integers(1, 4, at.size)
    return tog


def mask_parity_case(name: str) -> tuple:
    """(chars, tog) u8 of one named mask-parity case."""
    t = CLASSIFY_TILE
    rng = np.random.default_rng(len(name) + 70)
    bases = np.frombuffer(b"ACGTNacgtn", np.uint8)
    if name == "lane_warp_edges":   # a bound at each lane's last byte and each warp's first:
        n = 2 * t + 4099            # odd lanes and warps, even tiles
        tog = np.zeros(n, np.uint8)
        tog[127::128] = 1
        tog[::4096] = 1
        return rng.choice(bases, n), tog
    if name == "tile_span":         # one masked byte, the last of tile 0; tile 1 in one warp
        n = t + 4000
        tog = np.zeros(n, np.uint8)
        tog[t - 1] = tog[t] = 1
        return rng.choice(bases, n), tog
    if name == "dense":             # within one warp
        return rng.choice(bases, 3000), dense_toggles(rng, 3000)
    if name == "all_twos":          # two bounds at every byte: nothing changes case
        n = t + 333
        return rng.choice(bases, n), np.full(n, 2, np.uint8)
    if name == "all_bytes":         # every byte value, bytes 100-2999 masked: 224-255 wrap
        n = 4 * 1024 + 5
        tog = np.zeros(n, np.uint8)
        tog[[100, 3000]] = 1
        return np.tile(np.arange(256, dtype=np.uint8), n // 256 + 1)[:n], tog
    raise ValueError(name)


def mask_parity_input(case) -> tuple:
    """(chars, tog) of a named case of MASK_PARITY_CASES, or sparse toggles
    over n bytes."""
    if isinstance(case, str):
        return mask_parity_case(case)
    n = case
    rng = np.random.default_rng(63)
    chars = rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=n)
    tog = (rng.random(n) < 0.01).astype(np.uint8)
    tog[rng.integers(0, n, size=3)] += 2            # collisions keep the parity
    if n > TILE:
        tog[TILE - 1] = tog[TILE] = 1               # a single-char run across the edge
    return chars, tog


# ---------------------------------------------------------------------------
# scans, compaction, the two-pass encode and the ragged render
# ---------------------------------------------------------------------------

#: stream lengths of the scan and compaction cases: one element, ragged
#: tails of the 8192-element kernel tile and of the TPU kernels' tiles
SCAN_LENGTHS = [1, 100, 8193, 70001]
#: keep densities of the compaction cases (tests/test_compact_kernel.py),
#: one per 10,000-element segment of one stream
COMPACT_DENSITIES = [0.99, 0.986, 0.5, 0.01, 1.0, 0.0, 0.7]
#: the short (length, density) cases of tests/test_compact_kernel.py
COMPACT_SHORT = [(1, 1.0), (130, 0.7)]


def scan_input(n: int, kind: str, seed: int = 0) -> np.ndarray:
    """A scan input of n elements: 'bool', 'u8', or 'i32' (values around
    and below the max scan's floor of -2^30 included)."""
    rng = np.random.default_rng(seed + n)
    if kind == "bool":
        return rng.random(n) < 0.3
    if kind == "u8":
        return rng.integers(0, 256, n, dtype=np.uint8)
    x = rng.integers(-(1 << 31), (1 << 31) - 1, n, dtype=np.int64)
    x[::7] = rng.integers(-(1 << 30) - 3, -(1 << 30) + 3, x[::7].size)
    return x.astype(np.int32)


#: named scan cases of scan_case, each a few tiles of the scan kernel long
SCAN_CASES = ["tile_edges", "max_floor", "first_only", "wraps", "ragged_16"]
#: longer ones for the card: tens of thousands of tiles, so the look-back
#: meets tiles that have not published yet, and a u8 sum past 2^31
SCAN_CARD_CASES = ["many_tiles", "u8_wraps"]


def scan_case(name: str) -> list:
    """The inputs of a named scan case, one array per element type it covers."""
    t = SCAN_TILE
    rng = np.random.default_rng(len(name))
    if name == "tile_edges":        # the running max rises at each tile's first and last element
        n = 4 * t + 5
        edges = np.array(sorted({k * t for k in range(1, 5)} | {k * t - 1 for k in range(1, 5)}))
        x = rng.integers(-1000, 1000, n).astype(np.int32)
        x[edges] = 1000 + 7 * np.arange(edges.size)
        b = rng.integers(0, 8, n, dtype=np.uint8)
        b[edges] = 10 + 20 * np.arange(edges.size)
        return [x, b]
    if name == "max_floor":         # every value below -2^30: every max is -2^30
        return [rng.integers(-(1 << 31), -(1 << 30), 3 * t + 7).astype(np.int32)]
    if name == "first_only":        # the maximum at element 0: its carry crosses every tile
        n = 5 * t + 3
        x = rng.integers(-(1 << 31), (1 << 31) - 1, n).astype(np.int32)
        x[0] = (1 << 31) - 1
        b = rng.integers(0, 255, n, dtype=np.uint8)
        b[0] = 255
        return [x, b, np.arange(n) == 0]
    if name == "wraps":             # the i32 sum passes 2^31 near the end of each tile
        x = np.full(3 * t + 11, (1 << 31) // t + 1, np.int64)
        x[1::2] += rng.integers(-3, 4, x[1::2].size)
        return [x.astype(np.int32)]
    if name == "ragged_16":         # a length that is not a multiple of 16
        return [scan_input(2 * t + 13, kind) for kind in ("bool", "u8", "i32")]
    if name == "many_tiles":
        return [scan_input(20_000 * t + 9, kind) for kind in ("u8", "i32")]
    if name == "u8_wraps":          # 255s past 2^31 of sum
        return [np.full((1 << 31) // 255 + 3 * t + 5, 255, np.uint8)]
    raise KeyError(name)


def compact_input(n: int, p_keep, kind: str):
    """(values, keep) of a compaction case: u8 bytes or i32 positions.
    ``p_keep`` is one density, or a list of densities for equal segments."""
    dens = np.repeat(np.atleast_1d(p_keep), -(-n // np.atleast_1d(p_keep).size))[:n]
    rng = np.random.default_rng(n)
    keep = rng.random(n) < dens
    if kind == "u8":
        return rng.integers(0, 256, n, dtype=np.uint8), keep
    return (np.arange(n, dtype=np.int32) * 3 - 7), keep


#: named compaction cases of compact_case, each several 32,768-element
#: tiles of the compaction kernel long
COMPACT_CASES = ["tile_edges", "all_kept", "none_kept", "last_only", "first_half", "byte_flags"]
#: longer ones for the card: a zero tail over thousands of tiles, tens of
#: thousands of tiles, a length that is not a multiple of 16
COMPACT_CARD_CASES = ["first_half_long", "many_tiles", "ragged_16"]


def compact_case(case, kind: str):
    """(values, keep) of a compaction case: a length (COMPACT_DENSITIES in
    equal segments) or a name of COMPACT_CASES or COMPACT_CARD_CASES."""
    if isinstance(case, int):
        return compact_input(case, COMPACT_DENSITIES, kind)
    t = COMPACT_TILE
    n = {"tile_edges": 5 * t + 100, "all_kept": 3 * t + 9, "none_kept": 3 * t + 9,
         "last_only": 2 * t + 77, "first_half": 6 * t + 5, "byte_flags": 3 * t + 21,
         "first_half_long": 3000 * t + 5, "many_tiles": 20_000 * t + 9,
         "ragged_16": 1000 * t + 13}[case]
    v, keep = compact_input(n, COMPACT_DENSITIES if case == "many_tiles" else 0.5, kind)
    if case == "tile_edges":        # all | none | half | all | none, changing at tile edges
        keep[:t], keep[t:2 * t], keep[3 * t:4 * t], keep[4 * t:] = True, False, True, False
    elif case == "all_kept":
        keep[:] = True
    elif case in ("none_kept", "last_only"):
        keep[:] = False
        keep[-1] = case == "last_only"
    elif case.startswith("first_half"):
        keep[:n // 2], keep[n // 2:] = True, False
    elif case == "byte_flags":      # u8 flags: any nonzero byte keeps
        keep = np.random.default_rng(n).choice(
            np.array([0, 0, 0, 1, 2, 0x7F, 0x80, 0xFF], np.uint8), size=n)
    return v, keep


def typed_fasta(rng, seq_type: int, n_rec: int = 20, max_len: int = 600) -> bytes:
    """Records of one sequence type (tests/test_parallel.py _typed_fasta)."""
    alpha = {C.SEQ_TYPE_DNA: b"ACGTacgtNn", C.SEQ_TYPE_RNA: b"ACGUacguNn",
             C.SEQ_TYPE_PROTEIN: b"ACDEFGHIKLMNPQRSTVWYacdefghiklm*-",
             C.SEQ_TYPE_TEXT: b"abcXYZ019{}#>~%$"}[seq_type]
    rows = []
    for i in range(n_rec):
        com = b" com %d" % i if i % 2 else b""
        rows.append(b">s%d%s\n" % (i, com))
        seq = rng.choice(np.frombuffer(alpha, np.uint8), size=int(rng.integers(1, max_len)))
        rows.append(b"\n".join(seq[j:j + 60].tobytes() for j in range(0, seq.size, 60)) + b"\n")
    return b"".join(rows)


def reads_fasta(rng, n_reads: int, read_len: int = 150) -> bytes:
    """Short reads as FASTA with Illumina CASAVA 1.8 headers whose
    coordinates vary in width: a header byte every three or four input
    bytes, past the fused emit's sparse cap in every tile."""
    rows = []
    for i in range(n_reads):
        seq = rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=read_len).tobytes()
        rows.append(b">A00123:8:H5KJ3DSXX:1:%d:%d:%d 1:N:0:ACGTAC\n%s\n"
                    % (1101 + i % 50, rng.integers(1, 40000), rng.integers(1, 40000), seq))
    return b"".join(rows)


def sra_fastq(rng, n_reads: int, read_len: int = 150) -> bytes:
    """Reads as fastq-dump writes them: '@SRR<n>.<i> <name> length=<len>',
    the '+' line repeating the defline (past the FASTQ emit's sparse cap)."""
    rows = []
    for i in range(n_reads):
        seq = rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=read_len).tobytes()
        qual = rng.integers(35, 74, size=read_len, dtype=np.uint8).tobytes()
        d = b"SRR1234567.%d A00123:8:H5KJ3DSXX:1:1101:%d:%d length=%d" % (
            i + 1, rng.integers(1, 40000), rng.integers(1, 40000), read_len)
        rows.append(b"@%s\n%s\n+%s\n%s\n" % (d, seq, d, qual))
    return b"".join(rows)


def ragged_fasta(rng, n_rec: int = 30, max_len: int = 400,
                 alphabet: bytes = b"ACGTacgtNnRYKMbdhv-", line: int = 61) -> bytes:
    """Records of random length, some empty, some with comments
    (tests/test_device_decode.py _fasta)."""
    out = []
    for i in range(n_rec):
        if i % 5 == 1:
            out.append(b">empty%d\n" % i)
            continue
        out.append(b">rec%d%s\n" % (i, b" some comment" if i % 3 else b""))
        seq = rng.choice(np.frombuffer(alphabet, np.uint8),
                         size=int(rng.integers(1, max_len))).tobytes()
        out.extend(seq[j:j + line] + b"\n" for j in range(0, len(seq), line))
    return b"".join(out)


def ragged_fastq(rng, n_rec: int = 50, max_len: int = 150) -> bytes:
    """Reads of random length (tests/test_device_decode.py _fastq)."""
    out = []
    for i in range(n_rec):
        ln = int(rng.integers(1, max_len))
        seq = rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=ln).tobytes()
        qual = rng.integers(33, 74, size=ln, dtype=np.uint8).tobytes()
        out.append(b"@read%d/%d\n%s\n+\n%s\n" % (i, i, seq, qual))
    return b"".join(out)


# ---- whole inputs of the host modes, the stream encoder and the CLI ------------

def mixed_fasta(seed: int = 0, n_rec: int = 40, max_len: int = 3000, line: int = 60) -> bytes:
    """A nucleotide FASTA: soft-masked runs, IUPAC codes and gaps, an empty
    record, records with and without a comment, ``line``-wide lines."""
    rng = np.random.default_rng(seed)
    upper = np.frombuffer(b"ACGTACGTACGTNRYKMSWBDHV-", np.uint8)
    out = []
    for i in range(n_rec):
        ln = 0 if i == 3 else int(rng.integers(1, max_len))
        seq = rng.choice(upper, size=ln)
        for s in rng.integers(0, max(ln, 1), size=ln // 400):
            seq[s:s + int(rng.integers(1, 300))] |= 32
        head = b">seq%d" % i + (b" sample %d" % i if i % 3 else b"")
        body = seq.tobytes()
        out.append(head + b"\n" + b"".join(body[j:j + line] + b"\n"
                                           for j in range(0, ln, line)))
    return b"".join(out)


def mixed_fastq(seed: int = 1, n_rec: int = 300, max_len: int = 250) -> bytes:
    """A FASTQ of ragged reads with soft-masked runs and Ns, comments on
    some deflines."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_rec):
        ln = int(rng.integers(1, max_len))
        seq = rng.choice(np.frombuffer(b"ACGTACGTN", np.uint8), size=ln)
        if i % 4 == 0:
            seq[ln // 3:ln // 2] |= 32
        qual = rng.integers(35, 74, size=ln, dtype=np.uint8)
        head = b"@r%d" % i + (b" lane:%d" % (i % 7) if i % 2 else b"")
        out.append(b"%s\n%s\n+\n%s\n" % (head, seq.tobytes(), qual.tobytes()))
    return b"".join(out)


def protein_fasta(seed: int = 2, n_rec: int = 30) -> bytes:
    """A protein FASTA of 60-wide lines, some residues lowercase."""
    rng = np.random.default_rng(seed)
    aa = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWYXacdefg*", np.uint8)
    out = []
    for i in range(n_rec):
        seq = rng.choice(aa, size=int(rng.integers(1, 400))).tobytes()
        out.append(b">sp|P%05d|PROT_%d desc\n" % (i, i)
                   + b"".join(seq[j:j + 60] + b"\n" for j in range(0, len(seq), 60)))
    return b"".join(out)


def text_fasta(seed: int = 3, n_rec: int = 10) -> bytes:
    """A text-typed FASTA: printable bytes of any case in the records."""
    rng = np.random.default_rng(seed)
    pool = np.frombuffer(b"The quick brown fox jumps over 13 lazy dogs.,;:!?()", np.uint8)
    return b"".join(b">t%d words\n%s\n" % (i, rng.choice(pool, size=int(rng.integers(1, 200)))
                                           .tobytes()) for i in range(n_rec))


# ---- the streamed device encode (test_torch_stream.py, and on the card) --------

def stream_fasta(rng, n_rec: int, maxlen: int = 300) -> bytes:
    """Soft-masked records with comments in 61-wide lines."""
    out = []
    for i in range(n_rec):
        s = bytes(rng.choice(list(b"ACGTacgtNnRy-"), size=int(rng.integers(1, maxlen))).tolist())
        lines = [s[j:j + 61] for j in range(0, len(s), 61)]
        out.append(b">seq%d comment %d\n" % (i, i) + b"\n".join(lines) + b"\n")
    return b"".join(out)


def stream_fastq(rng, n_rec: int, qual_lo: int = 33, qual_hi: int = 74) -> bytes:
    """Ragged reads with comments, some bases lowercase."""
    out = []
    for i in range(n_rec):
        n = int(rng.integers(1, 120))
        s = bytes(rng.choice(list(b"ACGTacgtn"), size=n).tolist())
        q = bytes(rng.integers(qual_lo, qual_hi, size=n, dtype=np.uint8).tolist())
        out.append(b"@read%d some comment\n" % i + s + b"\n+\n" + q + b"\n")
    return b"".join(out)


def _case_runs(rng, codes: np.ndarray, max_run: int) -> np.ndarray:
    """``codes`` in alternating upper and lower case runs of 1..max_run."""
    lower = np.zeros(codes.size, bool)
    pos, on = 0, bool(rng.integers(2))
    while pos < codes.size:
        n = int(rng.integers(1, max_run))
        lower[pos:pos + n] = on
        on, pos = not on, pos + n
    return np.where(lower, codes | 0x20, codes).astype(np.uint8)


def stream_odd_masked_fasta(seed: int = 30, n_rec: int = 24) -> bytes:
    """Records of odd length, so the nibble parity flips from record to
    record and chunks start at odd parity, under case runs of up to 700
    chars, so mask runs cross chunk edges."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_rec):
        n = 2 * int(rng.integers(20, 600)) + 1
        s = _case_runs(rng, rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=n), 700).tobytes()
        out.append(b">r%d\n" % i + b"".join(s[j:j + 70] + b"\n" for j in range(0, n, 70)))
    return b"".join(out)


def stream_odd_masked_fastq(seed: int = 31, n_rec: int = 150) -> bytes:
    """Reads of odd length under case runs that run across reads."""
    rng = np.random.default_rng(seed)
    lens = 2 * rng.integers(10, 80, size=n_rec) + 1
    codes = _case_runs(rng, rng.choice(np.frombuffer(b"ACGT", np.uint8), size=int(lens.sum())),
                       400)
    out, pos = [], 0
    for i, n in enumerate(lens):
        q = rng.integers(33, 74, size=n, dtype=np.uint8).tobytes()
        out.append(b"@q%d\n%s\n+\n%s\n" % (i, codes[pos:pos + n].tobytes(), q))
        pos += n
    return b"".join(out)


def _giant_record(seed: int = 1) -> bytes:
    rng = np.random.default_rng(seed)
    seq = rng.choice(list(b"ACGTacgt"), size=20000)
    return b">chr1 giant\n" + b"\n".join(bytes(seq[j:j + 63].tolist())
                                         for j in range(0, seq.size, 63)) + b"\n"


def _giant_line(seed: int = 2) -> bytes:
    return b">x\n" + bytes(np.random.default_rng(seed).choice(list(b"ACGTN"), size=30000)
                           .tolist()) + b"\n"


def _rna() -> bytes:
    return stream_fasta(np.random.default_rng(3), 12).replace(b"T", b"U").replace(b"t", b"u")


STREAM_EDGES = [b">\n", b">", b">a\nACGT", b">a\n>b\n\n>c\nAC\n",
                b">i b\nACGTRYKMSWBDHVNacgtrykmswbdhvn\nZZ!!QQ\nACGT\n"]

#: name -> (input, EncodeOptions keywords, chunk sizes, whether a piece must
#: take the device, the host reasons a piece may take); the cases of
#: naf_tpu's tests/test_device_stream.py and two of odd parity under masks
STREAM_CASES = {
    "multi_record": (lambda: stream_fasta(np.random.default_rng(0), 40), {}, (64, 257, 5000),
                     True, ()),
    "giant_single_record": (_giant_record, {}, (64, 257, 300, 1111, 5000), True, ()),
    "single_giant_line": (_giant_line, {}, (257, 1024, 5000), False, ("open_line", "mid_line")),
    **{f"edge_{i}": (lambda d=d: d, {}, (8, 64, 257, 5000), False,
                     ("open_line", "mid_line")) for i, d in enumerate(STREAM_EDGES)},
    "rna": (_rna, {"seq_type": C.SEQ_TYPE_RNA}, (64, 257, 999, 5000), True, ()),
    "no_mask": (lambda: stream_fasta(np.random.default_rng(3), 12), {"no_mask": True}, (257,),
                True, ()),
    "level_19": (lambda: stream_fasta(np.random.default_rng(3), 12), {"level": 19}, (257,),
                 True, ()),
    "title": (lambda: stream_fasta(np.random.default_rng(3), 12), {"title": "t"}, (257,),
              True, ()),
    "protein": (lambda: b">p1\nMKVLA*xx\n>p2\nACDEFGHIKLMNPQRSTVWY\n",
                {"seq_type": C.SEQ_TYPE_PROTEIN}, (16, 64, 257), False, ("host_mode",)),
    "odd_masked_fasta": (stream_odd_masked_fasta, {}, (64, 257, 5000), True, ()),
    "fastq_regular": (lambda: stream_fastq(np.random.default_rng(4), 200), {},
                      (64, 257, 300, 4096, 5000), True, ("no_full_record",)),
    "fastq_qual_at_sign": (lambda: b"".join(b"@r%d c\nACGT\n+\n@@F@\n" % i for i in range(50)),
                           {}, (*range(17, 27), 257, 4096, 5000), True, ("no_full_record",)),
    "fastq_plus_line_text": (lambda: b"".join(b"@r%d x\nACGTacgt\n+r%d x\nIIIIIIII\n" % (i, i)
                                              for i in range(30)), {}, (64, 257, 999, 5000),
                             True, ("no_full_record",)),
    "odd_masked_fastq": (stream_odd_masked_fastq, {}, (64, 257, 5000), True,
                         ("no_full_record",)),
}


# ---- inputs of the block mesh (tests/test_torch_mesh.py) ------------------------

def mesh_giant_fasta(seed: int = 50, n_lines: int = 601, line: int = 61) -> bytes:
    """One record over every block of a mesh: ``n_lines`` lines of an odd
    width, so blocks cut at line starts begin at odd nibble parity, under
    lowercase runs of 40-700 chars that cross lines, and so block edges;
    then two short records."""
    rng = np.random.default_rng(seed)
    seq = rng.choice(np.frombuffer(b"ACGTNRY", np.uint8), size=n_lines * line)
    pos = 0
    while pos < seq.size:
        ln = int(rng.integers(40, 700))
        seq[pos:pos + ln] |= 32
        pos += ln + int(rng.integers(40, 700))
    body = seq.tobytes()
    return (b">giant spans every block\n"
            + b"".join(body[j:j + line] + b"\n" for j in range(0, len(body), line))
            + b">tail1 c\nACGTacgt\n>tail2\nNNNN\n")


#: the block counts of the mesh tests
MESH_SIZES = [2, 3, 8]

#: name -> (input, options as keywords, the route at every block count):
#: the FASTA inputs of tests/test_torch_mesh.py
MESH_FASTA_CASES = {
    "fused_fasta": (lambda: mixed_fasta(seed=80, n_rec=24, max_len=2500), {}, "encode_device"),
    "unexpected_chars": (lambda: b">r1 ok\nACGT@home\nACGT\n>r2\nNNNN!!\nacgt\n" * 9, {},
                         "encode_device:two_pass:unexpected_chars"),
    "strict": (lambda: typed_fasta(np.random.default_rng(84), C.SEQ_TYPE_DNA).upper(),
               {"strict": True}, "encode_device"),
    "giant_record": (mesh_giant_fasta, {}, "encode_device"),
}
#: those of tests/test_torch_mesh_two_pass.py: FASTQ and the two-pass inputs
MESH_TWO_PASS_CASES = {
    "fused_fastq": (lambda: mixed_fastq(seed=81, n_rec=120), {}, "encode_device"),
    "protein": (lambda: typed_fasta(np.random.default_rng(82), C.SEQ_TYPE_PROTEIN),
                {"seq_type": C.SEQ_TYPE_PROTEIN}, "encode_device:two_pass:text_like"),
    "sparse_overflow": (lambda: reads_fasta(np.random.default_rng(83), 500, read_len=40), {},
                        "encode_device:two_pass:sparse_overflow"),
    "sparse_overflow_fastq": (lambda: sra_fastq(np.random.default_rng(85), 420, read_len=40),
                              {}, "encode_device:two_pass:sparse_overflow"),
}


# ---- the match-candidate kernels (csrc/matchfind.cu) ------------------------

#: (window bytes, padded size) of the keys kernel: wraps at an exact size,
#: zero padding past a ragged one, sizes under one block of the launch and
#: across several
MATCH_KEY_CASES = [(16, 16), (17, 24), (1000, 1024), (4096, 4096), (4096 + 5, 8192),
                   (65_536, 65_536), (70_001, 131_072), (0, 64)]
#: (kind, window bytes, padded size) of the chain kernel: short runs
#: (random), equal-key runs far longer than 16 (all-equal bytes; ACGT's 256
#: keys over 64 Ki positions)
MATCH_CHAIN_WINDOWS = [("random", 5000, 8192), ("acgt", 65_536, 65_536),
                       ("equal", 9000, 16_384)]


def match_window(n: int, seed: int, kind: str = "acgt") -> np.ndarray:
    """n window bytes: ACGT, random bytes, or one byte repeated."""
    rng = np.random.default_rng(seed)
    if kind == "equal":
        return np.full(n, 0xC3, np.uint8)
    if kind == "random":
        return rng.integers(0, 256, n, dtype=np.uint8)
    return rng.choice(np.frombuffer(b"ACGT", np.uint8), n)


def match_spans(cap: int) -> list:
    """Spans [r0, r1) of a padded window of ``cap`` positions: the whole
    window, its start, one across the middle, the last rows, one row."""
    return [(0, cap), (0, 100), (cap // 2 - 77, cap // 2 + 1500), (cap - 9, cap),
            (cap // 3, cap // 3 + 1)]


#: the match kernels' tiles (csrc/matchfind.cu): window bytes a keys block
#: (KEYS_TILE) and sorted entries a chain tile (CHAIN_TILE)
MATCH_KEYS_TILE, MATCH_CHAIN_TILE = 8192, 2048


def match_sorted_runs(m: int, seed: int, shuffled: bool) -> tuple[np.ndarray, np.ndarray]:
    """(sk int32, order int64) of the stable sort of m keys made of equal-key
    runs about 12 long, with a run of 81 across every chain tile edge (and
    the entry before it, where order is 8 bytes past a 16-byte boundary).
    Unshuffled, the keys are already sorted, so sorted index i is position
    i; shuffled, the same runs lie at random positions."""
    rng = np.random.default_rng(seed)
    start = rng.random(m) < 1 / 12
    start[0] = True
    for e in range(MATCH_CHAIN_TILE, m, MATCH_CHAIN_TILE):
        start[e - 40:e + 41] = False
    keys = (np.cumsum(start) - 1).astype(np.int32) * 7919
    if shuffled:
        keys = rng.permutation(keys)
    order = np.argsort(keys, kind="stable")
    return keys[order], order.astype(np.int64)


def match_tile_spans(m: int, stride: int = 1) -> list:
    """Spans [r0, r1) of m sorted entries of `stride` positions each, in
    positions: the whole window; one from 8 entries before the first tile
    edge to 24 after it (a depth of 16 reaches back into the first tile);
    one that starts and ends inside the second tile (the other tiles have no
    entry in it, unshuffled); one across the second edge, starting and ending
    inside an entry; the last 5 positions."""
    t, s = MATCH_CHAIN_TILE, stride
    return [(0, m * s), ((t - 8) * s, (t + 24) * s), ((t + 100) * s, (t + 300) * s),
            ((2 * t - 1) * s + s // 2, (2 * t + 1) * s + s // 2), (m * s - 5, m * s)]
