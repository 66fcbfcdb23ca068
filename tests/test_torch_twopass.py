"""naf_tpu_torch's two-pass device encode against the JAX package.

  * the plain versions of the scan and compaction kernels equal the TPU
    kernels (cumsum_i32_pallas, maxscan_i32_pallas, compact_u8_pallas,
    compact_u8_dense) in interpret mode, on u8/bool and i32 streams,
    ragged lengths, the max scan's floor of -2^30 and the keep densities of
    test_compact_kernel.py;
  * stats_blocks_sharded and emit_blocks_sharded on one CPU block equal
    naf_tpu's on a one-device CPU mesh (XLA formulations), for
    FASTA DNA, RNA, protein and text, and FASTQ;
  * encode_device(device="cpu") archives and EncodeStats equal naf_tpu's
    encode_sharded (which takes the two-pass on a CPU mesh) and the port's
    host encode(), with the route each input takes.
Everything is integer or bytes: tolerance 0.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from naf_tpu.ops.compact import compact_u8_dense as ref_compact_dense
from naf_tpu.ops.compact import compact_u8_pallas as ref_compact
from naf_tpu.ops.scan_fused import cumsum_i32_pallas, maxscan_i32_pallas
from naf_tpu.parallel import block as RB
from naf_tpu.parallel import pipeline as RP
from naf_tpu.parallel.mesh import block_mesh, block_sharding
from naf_tpu.pipeline import encoder as RENC
from naf_tpu.pipeline.parser import InputError as RefInputError
from naf_tpu_torch import device as D
from naf_tpu_torch.format import constants as C
from naf_tpu_torch.ops import compact as CP
from naf_tpu_torch.ops import scan_fused as SF
from naf_tpu_torch.parallel import block as PB
from naf_tpu_torch.parallel.pipeline import encode_device
from naf_tpu_torch.pipeline.encoder import EncodeOptions, encode
from naf_tpu_torch.pipeline.parser import InputError

from torch_cases import (COMPACT_DENSITIES, COMPACT_SHORT, SCAN_LENGTHS, compact_input, em_np_fields, fastq_reads, reads_fasta,
                         scan_input, sra_fastq, typed_fasta)


def _ref_opts(opts: EncodeOptions) -> RENC.EncodeOptions:
    return RENC.EncodeOptions(**vars(opts))


# ---------------------------------------------------------------------------
# the kernels' plain versions against the TPU kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["bool", "u8", "i32"])
@pytest.mark.parametrize("n", SCAN_LENGTHS)
def test_scans_match_pallas(n, kind):
    x = scan_input(n, kind)
    t = torch.from_numpy(x)
    for plain, ref in ((SF.cumsum_i32_plain, cumsum_i32_pallas),
                       (SF.maxscan_i32_plain, maxscan_i32_pallas)):
        want = np.asarray(ref(jnp.asarray(x), interpret=True))
        got = plain(t)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want), plain.__name__


def test_maxscan_floor():
    """The max scan starts its carry at -2^30, so no output is below it."""
    x = np.asarray([-(1 << 31), -(1 << 30) - 1, -(1 << 30), -5, -(1 << 31), 7], np.int32)
    got = SF.maxscan_i32_plain(torch.from_numpy(x)).numpy()
    assert got.tolist() == [-(1 << 30)] * 3 + [-5, -5, 7]
    assert np.array_equal(got, np.asarray(maxscan_i32_pallas(jnp.asarray(x), interpret=True)))


@pytest.mark.parametrize("kind", ["u8", "i32"])
@pytest.mark.parametrize("n,p_keep", [(10_000 * len(COMPACT_DENSITIES), COMPACT_DENSITIES)]
                         + COMPACT_SHORT)
def test_compaction_matches_pallas(n, p_keep, kind):
    v, k = compact_input(n, p_keep, kind)
    got, cnt = CP.compact_plain(torch.from_numpy(v), torch.from_numpy(k))
    assert got.dtype == (torch.uint8 if kind == "u8" else torch.int32)
    for ref in (ref_compact, ref_compact_dense):
        out, want_cnt = ref(jnp.asarray(v), jnp.asarray(k), interpret=True)
        assert int(cnt) == int(want_cnt) == int(k.sum())
        assert np.array_equal(got.numpy(), np.asarray(out)), ref.__name__


# ---------------------------------------------------------------------------
# the two passes on one block against naf_tpu's on one device
# ---------------------------------------------------------------------------

def _block_case(name: str):
    """(data, seq_type, fastq) of one two-pass block case."""
    rng = np.random.default_rng(90)
    if name == "fastq":
        body = fastq_reads(rng, 150, alphabet=b"ACGTNacgtZz ")
        return b"@" + body.tobytes(), C.SEQ_TYPE_DNA, True
    seq_type = {"dna": C.SEQ_TYPE_DNA, "rna": C.SEQ_TYPE_RNA, "protein": C.SEQ_TYPE_PROTEIN,
                "text": C.SEQ_TYPE_TEXT}[name]
    data = typed_fasta(rng, seq_type, n_rec=40) + b">odd \x01bytes\x7f\nAC*GT!\n"
    return data, seq_type, False


def _sharded_passes(body: np.ndarray, seq_type: int, fastq: bool):
    mesh = block_mesh(1)
    blocks = RB.make_blocks_fastq(body, 1)[0] if fastq else RB.make_blocks(body, 1)
    sh = block_sharding(mesh)
    args = [jax.device_put(jnp.asarray(a), sh)
            for a in (blocks.data, blocks.prev, blocks.starts_in_seq)]
    st = [np.asarray(o) for o in RB.stats_blocks_sharded(*args, seq_type=seq_type, fastq=fastq,
                                                          mesh=mesh)]
    counts, odd, id_bytes, com_bytes, qual_bytes, n_rec, n_runs = st[:7]
    text_like = seq_type >= C.SEQ_TYPE_PROTEIN
    caps = dict(
        p_cap=RP._bucket(int(counts.max()) + 1) if text_like
        else RP._bucket(int((counts + 1).max() // 2) + 1),
        id_cap=RP._bucket(max(int(id_bytes.max()), 1)),
        com_cap=RP._bucket(max(int(com_bytes.max()), 1)),
        r_cap=RP._bucket(int(n_rec.max()) + 1),
        m_cap=2 if text_like else RP._bucket(max(int(n_runs.max()), 2)),
        q_cap=RP._bucket(max(int(qual_bytes.max()), 1)) if fastq else 16)
    em = RB.emit_blocks_sharded(*args, jax.device_put(jnp.asarray(odd), sh), seq_type=seq_type,
                                fastq=fastq, mesh=mesh, pack_nibbles=not text_like, **caps)
    return blocks, st, [np.asarray(o) for o in em]


@pytest.mark.parametrize("name", ["dna", "rna", "protein", "text", "fastq"])
def test_stats_and_emit_block_match_sharded(name):
    data, seq_type, fastq = _block_case(name)
    body = np.frombuffer(data, np.uint8)[1:]
    blocks, st, em_r = _sharded_passes(body, seq_type, fastq)
    x = torch.from_numpy(blocks.data[0].copy())
    prev, sis = int(blocks.prev[0]), bool(blocks.starts_in_seq[0])
    stats, masks = PB.stats_blocks_sharded([x], [prev], [sis], seq_type=seq_type, fastq=fastq)
    stats = stats[0]
    assert not st[1].any()                    # odd: no chars before the one block
    for k, key in zip((0, 2, 3, 4, 5, 6, 7, 8), PB.STATS_KEYS):
        assert stats[key] == st[k][0], key
    for got, lo, hi in zip(stats["hists"], st[9::2], st[10::2]):
        assert np.array_equal(got, RP._merge_hist(lo[0], hi[0]))
    counts, id_bytes, com_bytes, qual_bytes, n_rec, n_runs = (
        stats[k] for k in PB.STATS_KEYS[:6])
    text_like = seq_type >= C.SEQ_TYPE_PROTEIN
    em = PB.emit_blocks_sharded([x], masks, [stats], seq_type=seq_type, fastq=fastq,
                                pack_nibbles=not text_like)
    used = dict(packed=counts if text_like else (counts + 1) // 2 + 1, first_codes=None,
                id_vals=id_bytes, com_vals=com_bytes, qual_vals=qual_bytes if fastq else 0,
                seq_lens=n_rec + 1, id_lens=n_rec + 1, com_lens=n_rec + 1,
                qual_lens=n_rec + 1 if fastq else 0, run_lens=0 if text_like else n_runs)
    assert np.array_equal(em.counts, em_r[2])
    for k, want in em_np_fields(em_r).items():
        if k == "first_codes" and text_like:
            continue                          # no nibble code without a pack
        got, w = getattr(em, k), used[k]
        if w is None:
            assert np.array_equal(got.astype(np.int64), want.astype(np.int64)), k
        else:
            assert np.array_equal(got[:, :w].astype(np.int64), want[:, :w].astype(np.int64)), k


# ---------------------------------------------------------------------------
# encode_device against encode_sharded and host encode()
# ---------------------------------------------------------------------------

def _all_bytes() -> bytes:
    every = bytes(range(256))
    return (b">a " + every.replace(b"\n", b"") + b"\nACGT" + every + b"\n>b x\nACGT\n"
            + b">c\x01\x7f id\nNNNN\n")


TWO_PASS_CASES = {
    "protein": (lambda: typed_fasta(np.random.default_rng(72), C.SEQ_TYPE_PROTEIN),
                EncodeOptions(seq_type=C.SEQ_TYPE_PROTEIN), "encode_device:two_pass:text_like"),
    "protein_no_mask": (lambda: typed_fasta(np.random.default_rng(72), C.SEQ_TYPE_PROTEIN),
                        EncodeOptions(seq_type=C.SEQ_TYPE_PROTEIN, no_mask=True),
                        "encode_device:two_pass:text_like"),
    "text": (lambda: typed_fasta(np.random.default_rng(73), C.SEQ_TYPE_TEXT),
             EncodeOptions(seq_type=C.SEQ_TYPE_TEXT), "encode_device:two_pass:text_like"),
    "strict_clean": (lambda: typed_fasta(np.random.default_rng(3), C.SEQ_TYPE_DNA).upper(),
                     EncodeOptions(strict=True), "encode_device"),
    "strict_clean_protein": (lambda: typed_fasta(np.random.default_rng(4), C.SEQ_TYPE_PROTEIN),
                             EncodeOptions(strict=True, seq_type=C.SEQ_TYPE_PROTEIN),
                             "encode_device:two_pass:text_like"),
    "unexpected_chars": (lambda: b">r1 ok\nACGT@home\nACGT\n>r2\nNNNN!!\nacgt\n" * 5,
                         EncodeOptions(), "encode_device:two_pass:unexpected_chars"),
    "all_bytes": (_all_bytes, EncodeOptions(), "encode_device:two_pass:unexpected_chars"),
    "all_bytes_rna": (_all_bytes, EncodeOptions(seq_type=C.SEQ_TYPE_RNA),
                      "encode_device:two_pass:unexpected_chars"),
    "header_dense_fasta": (lambda: reads_fasta(np.random.default_rng(74), 700),
                           EncodeOptions(), "encode_device:two_pass:sparse_overflow"),
    "header_dense_no_mask": (lambda: reads_fasta(np.random.default_rng(75), 600).lower(),
                             EncodeOptions(no_mask=True),
                             "encode_device:two_pass:sparse_overflow"),
    "fastq_long_comments": (lambda: sra_fastq(np.random.default_rng(76), 500),
                            EncodeOptions(), "encode_device:two_pass:sparse_overflow"),
    "fastq_unexpected": (lambda: sra_fastq(np.random.default_rng(77), 30)
                         + b"@z \x01c\nACZT\n+\n!!\x7f!\n@y\nAC\n+\n!!\n",
                         EncodeOptions(), "encode_device:two_pass:unexpected_chars"),
}


@pytest.mark.parametrize("name", list(TWO_PASS_CASES))
def test_two_pass_encode_equals_sharded_and_host(name):
    make, opts, route = TWO_PASS_CASES[name]
    data = make()
    D.reset_counts()
    blob, stats = encode_device(data, opts, device="cpu")
    assert D.ROUTES == {route: 1}
    host_blob, host_stats = encode(data, opts)
    ref_blob, ref_stats = RP.encode_sharded(data, _ref_opts(opts), mesh=block_mesh(1))
    assert blob == host_blob == ref_blob
    for field in ("n_sequences", "longest_line", "seq_size_original", "in_format"):
        assert getattr(stats, field) == getattr(host_stats, field) == getattr(ref_stats, field)
    for field in ("unexpected_id", "unexpected_comment", "unexpected_seq", "unexpected_qual"):
        got = getattr(stats, field)
        assert np.array_equal(got, getattr(host_stats, field)), field
        assert np.array_equal(got, getattr(ref_stats, field)), field


def test_header_dense_inputs_overflow_the_fused_emit():
    """The header-dense FASTA and the SRA FASTQ overflow the fused emits'
    sparse channel, which is why they take the two-pass."""
    for data in (reads_fasta(np.random.default_rng(74), 700),
                 sra_fastq(np.random.default_rng(76), 500)):
        fastq = data[:1] == b"@"
        body = np.frombuffer(data, np.uint8)[1:]
        blocks = PB.make_blocks_fastq(body, 1)[0] if fastq else PB.make_blocks(body, 1)
        x = torch.from_numpy(blocks.data[0].copy())
        if fastq:
            scal = PB.fused_blocks_fastq_sharded([x], blocks.prev, 0, seq_type=0)[3]
        else:
            scal = PB.fused_blocks_sharded([x], blocks.prev, [False], 0, seq_type=0)[1]
        assert not bool(scal[0][3])           # sp_ok


def test_strict_dirty_raises_as_host():
    data = b">a\nACGTZGGG\nACGT\n>b\nTTTT\n"
    opts = EncodeOptions(strict=True)
    with pytest.raises(RefInputError) as ref:
        RP.encode_sharded(data, _ref_opts(opts), mesh=block_mesh(1))
    D.reset_counts()
    with pytest.raises(InputError) as got:
        encode_device(data, opts, device="cpu")
    assert str(got.value) == str(ref.value)
    assert D.ROUTES == {"encode_host:strict_unexpected": 1}


def test_two_pass_fastq_quality_length_mismatch_raises_as_host():
    data = sra_fastq(np.random.default_rng(78), 40) + b"@bad x\nACGT\n+\n!!!\n"
    with pytest.raises(RefInputError) as ref:
        RENC.encode(data, RENC.EncodeOptions())
    D.reset_counts()
    with pytest.raises(InputError) as got:
        encode_device(data, device="cpu")
    assert str(got.value) == str(ref.value)
    assert D.ROUTES == {"encode_host:qual_length_mismatch": 1}
