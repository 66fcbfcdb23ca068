"""naf_tpu_torch's ragged device render against the JAX package.

  * _render_step equals the reference's _make_kernel_ref (the per-byte
    oracle) and _make_kernel on random record layouts, FASTA and FASTQ,
    wrapped and not, masked and not, on whole ranges and on windows that
    start inside a record;
  * render_batched over one CPU device equals naf_tpu's render_sharded
    with the uniform path off (NAF_TPU_NO_REGULAR=1) on a one-device CPU
    mesh, and the port's host Decoder, on the plans of real archives: masked IUPAC, RNA,
    text with and without upper case, line lengths 0, 7 and 60, FASTQ with
    empty reads, several batches;
  * fasta_device / fastq_device(device="cpu") take the ragged route by name
    and equal the host Decoder; RenderOverflow goes to the host; the
    uniform path takes text archives.
Everything is integer or bytes: tolerance 0.
"""

from __future__ import annotations

import io

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from naf_tpu.parallel import decode as RD
from naf_tpu.parallel.mesh import block_mesh
from naf_tpu_torch import device as D
from naf_tpu_torch.format import constants as C
from naf_tpu_torch.parallel import decode as PD
from naf_tpu_torch.parallel.mesh import block_mesh as torch_mesh
from naf_tpu_torch.pipeline.decoder import DecodeOptions, Decoder, fasta_device, fastq_device
from naf_tpu_torch.pipeline.encoder import EncodeOptions, EncodeStats, build_archive, encode
from naf_tpu_torch.pipeline.parser import ParseResult

from torch_cases import ragged_fasta, ragged_fastq, typed_fasta


def _dec(blob: bytes, **kw) -> Decoder:
    return Decoder(io.BytesIO(blob), DecodeOptions(**kw))


def _layout(rng, mode: int, L: int):
    """A random batch layout (test_device_decode.py's kernel test)."""
    n_rec = int(rng.integers(1, 12))
    slens = rng.integers(0 if mode == PD.MODE_FASTA else 1, 200, n_rec).astype(np.int64)
    hls = rng.integers(2, 30, n_rec).astype(np.int64)
    if mode == PD.MODE_FASTQ:
        outs = hls + 2 * slens + 4
    elif L > 0:
        outs = hls + slens + np.maximum((slens + L - 1) // L, 1)
    else:
        outs = hls + slens + 1
    E = np.cumsum(slens).astype(np.int32)
    O = np.cumsum(outs).astype(np.int32)
    H = np.cumsum(hls).astype(np.int32)
    hdr = rng.integers(65, 90, int(H[-1]), dtype=np.uint8)
    seq = rng.integers(0, 256, max(int(E[-1]) // 2 + 1, 1), dtype=np.uint8)
    qual = rng.integers(33, 74, max(int(E[-1]), 1), dtype=np.uint8)
    return E, O, H, hdr, seq, qual


@pytest.mark.parametrize("trial", range(8))
def test_render_step_matches_reference_kernels(trial):
    rng = np.random.default_rng(50 + trial)
    mode = PD.MODE_FASTQ if trial % 4 == 3 else PD.MODE_FASTA
    L = [0, 60, 7, 0][trial % 4]
    packed = trial != 5
    E, O, H, hdr, seq, qual = _layout(rng, mode, L)
    masking = mode == PD.MODE_FASTA and trial % 2 == 0
    if masking:
        bounds = np.sort(rng.integers(0, max(int(E[-1]), 1), int(rng.integers(1, 6)) * 2)
                         ).astype(np.int32)
    else:
        bounds = np.full(2, 1 << 30, np.int32)
    osz = int(O[-1])
    args = tuple(jnp.asarray(a) for a in (seq, qual, np.zeros(4, np.int32), E, O, H, hdr,
                                          bounds))
    opts = (mode, L, False, packed, trial == 5, masking)
    want = np.asarray(jax.jit(RD._make_kernel_ref(osz, *opts))(*args))
    assert np.array_equal(np.asarray(jax.jit(RD._make_kernel(osz, *opts))(*args)), want)
    t = [torch.from_numpy(a.copy()) for a in (seq, qual, E, O, H, hdr, bounds)]
    kw = dict(mode=mode, line_len=L, rna=False, packed=packed, upper=trial == 5, masking=masking)
    # whole range, then windows that start inside records
    for o0, o1 in [(0, osz), (osz // 3, osz), (osz // 5, osz // 2 + 1)]:
        if o1 <= o0:
            continue
        got = PD._render_step(t[0], t[1], o0, 0, 0, *t[2:], osz=o1 - o0, **kw)
        assert np.array_equal(got.numpy(), want[o0:o1]), (o0, o1)


# ---------------------------------------------------------------------------
# render_batched against render_sharded and the host Decoder
# ---------------------------------------------------------------------------

def _foreign_fastq_with_empty_reads() -> bytes:
    """A FASTQ archive with zero-length records (test_device_decode.py)."""
    res = ParseResult(n_sequences=3, ids_blob=b"a\0b\0c\0", comments_blob=b"x\0\0\0",
                      seq=np.frombuffer(b"ACGTGG", np.uint8),
                      qual=np.frombuffer(b"!!!!##", np.uint8),
                      lengths=np.asarray([4, 0, 2], np.uint64), longest_line=4)
    zero = np.zeros(257, np.uint64)
    stats = EncodeStats(n_sequences=3, longest_line=4, seq_size_original=6, unexpected_id=zero,
                        unexpected_comment=zero, unexpected_seq=zero, unexpected_qual=zero,
                        in_format=C.IN_FORMAT_FASTQ)
    return build_archive(res, EncodeOptions(level=1, no_mask=True), stats)[0]


RENDER_CASES = {
    "masked_iupac": (lambda: ragged_fasta(np.random.default_rng(0)), EncodeOptions(), {}),
    "unmasked_output": (lambda: ragged_fasta(np.random.default_rng(1)), EncodeOptions(),
                        {"use_mask": False}),
    "line_length_0": (lambda: ragged_fasta(np.random.default_rng(2)), EncodeOptions(),
                      {"line_length": 0}),
    "line_length_7": (lambda: ragged_fasta(np.random.default_rng(2)), EncodeOptions(),
                      {"line_length": 7}),
    "line_length_60": (lambda: ragged_fasta(np.random.default_rng(3), line=60), EncodeOptions(),
                       {}),
    "rna": (lambda: ragged_fasta(np.random.default_rng(5), alphabet=b"ACGUacguNn"),
            EncodeOptions(seq_type=C.SEQ_TYPE_RNA), {}),
    "protein": (lambda: ragged_fasta(np.random.default_rng(6),
                                     alphabet=b"ARNDCEQGHILKMFPSTWYVarndceqg"),
                EncodeOptions(seq_type=C.SEQ_TYPE_PROTEIN), {}),
    "text_upper": (lambda: typed_fasta(np.random.default_rng(7), C.SEQ_TYPE_TEXT),
                   EncodeOptions(seq_type=C.SEQ_TYPE_TEXT), {"use_mask": False}),
    "fastq": (lambda: ragged_fastq(np.random.default_rng(8)), EncodeOptions(), {}),
    "fastq_empty_reads": (None, None, {}),
}


@pytest.mark.parametrize("out_batch", [0, 1000])
@pytest.mark.parametrize("name", list(RENDER_CASES))
def test_render_batched_matches_render_sharded(name, out_batch, monkeypatch):
    make, opts, kw = RENDER_CASES[name]
    blob = _foreign_fastq_with_empty_reads() if make is None else encode(make(), opts)[0]
    d = _dec(blob, **kw)
    fastq = name.startswith("fastq")
    if fastq:
        plan, raw = d._plan(PD.MODE_FASTQ, False)
        qual = d._load_qual()
        want = _dec(blob, **kw).fastq()
    else:
        plan, raw = d._fasta_plan(d.masking)
        qual = None
        want = _dec(blob, **kw).fasta()
    got = PD.render_batched(plan, raw, qual, mesh=torch_mesh(devices=["cpu"]),
                            out_batch=out_batch)
    assert got == want
    monkeypatch.setenv("NAF_TPU_NO_REGULAR", "1")
    assert got == RD.render_sharded(plan, raw, qual, mesh=block_mesh(1), out_batch=out_batch)
    if 0 < out_batch < plan.total_out:
        assert len(PD.plan_batches(plan, out_batch)) > 1


# ---------------------------------------------------------------------------
# the entry points' routes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["masked_iupac", "rna", "protein", "text_upper"])
def test_fasta_device_takes_the_ragged_route(name):
    make, opts, kw = RENDER_CASES[name]
    blob = encode(make(), opts)[0]
    D.reset_counts()
    out = fasta_device(_dec(blob, **kw), device="cpu")
    assert D.ROUTES == {"decode_device:ragged:too_many_groups": 1}
    assert out == _dec(blob, **kw).fasta()


def test_fastq_device_takes_the_ragged_route(monkeypatch):
    blob = encode(ragged_fastq(np.random.default_rng(9), 40), EncodeOptions())[0]
    D.reset_counts()
    assert fastq_device(_dec(blob), device="cpu") == _dec(blob).fastq()
    assert D.ROUTES == {"decode_device:ragged:too_many_groups": 1}
    blob = _foreign_fastq_with_empty_reads()
    monkeypatch.setattr(PD, "OUT_BATCH", 8)           # several batches, and too_large
    D.reset_counts()
    assert fastq_device(_dec(blob), device="cpu") == _dec(blob).fastq()
    assert D.ROUTES == {"decode_device:ragged:too_large": 1}


def test_render_overflow_guard_giant_record():
    """A record whose span exceeds the i32 batch window raises before any
    buffer is made (test_device_decode.py's guard test)."""
    plan = PD.build_plan(mode=PD.MODE_FASTA, line_len=80, rna=False, packed=True, upper=False,
                         slens=np.asarray([100, 3 << 30, 50], np.int64),
                         ids_blob=b"a\0b\0c\0", comments_blob=None, name_sep=b" ",
                         mask_spans=None)
    with pytest.raises(PD.RenderOverflow):
        PD.render_batched(plan, np.zeros(8, np.uint8), mesh=torch_mesh(devices=["cpu"]))
    with pytest.raises(RD.RenderOverflow):
        RD.render_sharded(plan, np.zeros(8, np.uint8), None, mesh=block_mesh(1))


def test_render_overflow_goes_to_the_host(monkeypatch):
    blob = encode(ragged_fasta(np.random.default_rng(10), 40), EncodeOptions())[0]

    def overflow(*args, **kwargs):
        raise PD.RenderOverflow("forced")

    monkeypatch.setattr(PD, "render_batched", overflow)
    D.reset_counts()
    assert fasta_device(_dec(blob), device="cpu") == _dec(blob).fasta()
    assert D.ROUTES == {"decode_host:render_overflow": 1}


@pytest.mark.parametrize("seq_type,use_mask", [(C.SEQ_TYPE_PROTEIN, True),
                                               (C.SEQ_TYPE_TEXT, False)])
def test_uniform_path_takes_text(seq_type, use_mask):
    rng = np.random.default_rng(11)
    seq = rng.choice(np.frombuffer(b"ARNDCEQGHILKMFPSTWYVarnd", np.uint8), size=(6, 130))
    data = b"".join(b">p%d\n%s\n%s\n%s\n" % (i, s[:60].tobytes(), s[60:120].tobytes(),
                                               s[120:].tobytes()) for i, s in enumerate(seq))
    blob = encode(data, EncodeOptions(seq_type=seq_type))[0]
    D.reset_counts()
    out = fasta_device(_dec(blob, use_mask=use_mask), device="cpu")
    assert D.ROUTES == {"decode_device": 1}
    assert out == _dec(blob, use_mask=use_mask).fasta()
    assert out == (data if use_mask else b"\n".join(
        r if r.startswith(b">") else r.upper() for r in data.split(b"\n")))
