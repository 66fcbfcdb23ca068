"""The harness on the CPU at small sizes: the result line's shape, a cell,
traffic mix and metric found as new files, and the roofline's byte count."""

import io
import json

import numpy as np
import pytest

from benchmark import harness, roofline
from benchmark.devtrace import reduce
from benchmark.reference import encoder as RE
from benchmark.reference.container import NafReader

CPU = ["cpu"]


def run(root, cell, capsys, *, trace=0, devices=CPU, seed=2**31 + 5, **kw):
    rc = harness.main(["--workload", cell, "--seed", str(seed), "--seconds", "0.2",
                       "--trace", str(trace)], root=root, devices=devices, **kw)
    out, err = capsys.readouterr()
    return rc, json.loads(out.strip().splitlines()[-1]) if rc == 0 else None, err


def test_last_line_shape(small_root, capsys, spec):
    rc, res, err = run(small_root, "chr1.compress", capsys)
    assert rc == 0
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert res["correct"] is True and res["attempted"] >= 1 and res["failed"] == 0
    e2e = {m["name"]: m["unit"] for m in spec["end_to_end"]
           if "chr1.compress" in m.get("workloads", ["chr1.compress"])}
    assert {k: v["unit"] for k, v in res["metrics"].items()} == e2e
    assert 0.2 < res["metrics"]["archive_ratio"]["value"] < 0.3
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert res["checks"]["bytes_off"] == {"value": 0, "limit": 0}
    assert err.rstrip().splitlines()[-1] == "check bytes_off 0 limit <= 0"


def test_traced_line_shape(small_root, capsys, monkeypatch):
    from naf_tpu_torch.utils import trace

    # a run is a fresh process, which reads NAF_TPU_TRACE at the import
    monkeypatch.setattr(trace, "ENABLED", True)
    rc, res, _ = run(small_root, "reads.decompress", capsys, trace=1)
    assert rc == 0 and res["correct"] is True
    assert list(res)[-2:] == ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(res["device"])
    m = res["metrics"]
    assert m["device_route_pct.decompress"]["value"] == 100.0
    assert m["plan_ms.decompress"]["value"] > 0 and m["seq_unzstd_ms.decompress"]["value"] > 0
    # no card: the device metrics have nothing to read and are left out
    assert not any(k.startswith(("kernels_roofline", "copy_ms", "device_idle")) for k in m)


def test_no_card_no_result(small_root, capsys):
    """Without a card (and no stand-in devices) the run ends with a
    message, a non-zero code and no result line."""
    rc, res, err = run(small_root, "chr1.compress", capsys, devices=None)
    assert rc != 0 and "no CUDA card" in err


def test_new_files_are_found(small_root, capsys):
    """A configuration, a traffic mix and a metric added as files, and
    entries added to BENCHMARK.json, make a cell that runs: no file edited."""
    b = small_root / "benchmark"
    cfg = json.loads((b / "configs" / "hg38-chr1.l1.json").read_text())
    cfg.update(name="tiny-asm.l3", level=3)
    cfg["records"] = [{"id": "c1", "comment": "x y", "length": 90_001},
                      {"id": "c2", "comment": "", "length": 70_003}]
    cfg["gaps"] = {"ends": 100, "large": {"size": 2000, "at": 0.3}, "sizes": [50, 60]}
    (b / "configs" / "tiny-asm.l3.json").write_text(json.dumps(cfg))
    (b / "traffic" / "decompress.cold.json").write_text(json.dumps(
        {"op": "decompress", "mesh_devices": 1, "why": "a test"}))
    (b / "metrics" / "calls_per_s.decompress.py").write_text(
        "def read(r):\n    return r.calls / r.window_s\n")
    spec = json.loads((small_root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny-asm.l3", "source": "https://example.org/asm",
                            "file": "benchmark/configs/tiny-asm.l3.json", "reduced": [],
                            "why": "two records"})
    spec["workloads"].append({"name": "asm.decompress", "config": "tiny-asm.l3",
                              "traffic": "decompress.cold", "chips": 1, "why": "a test"})
    spec["end_to_end"][1]["workloads"].append("asm.decompress")
    spec["per_layer"].append({"name": "calls_per_s.decompress", "unit": "1/s",
                              "better": "higher", "source": "host_clock", "layer": "entry points",
                              "moves": "decompress_MBps", "workloads": ["asm.decompress"]})
    (small_root / "BENCHMARK.json").write_text(json.dumps(spec))
    rc, res, _ = run(small_root, "asm.decompress", capsys)
    assert rc == 0 and res["correct"] is True
    assert set(res["metrics"]) == {"decompress_MBps", "setup_s"}
    rc, res, _ = run(small_root, "asm.decompress", capsys, trace=1)
    assert rc == 0 and res["metrics"]["calls_per_s.decompress"]["value"] > 0


def test_roofline_bytes_of_a_tiny_archive():
    """The text once and every uncompressed section once, the sequence as
    its packed nibbles."""
    text = b">r1 c\nACGTacgtNNA\n>r2\nGG\n"
    archive = RE.encode(text, RE.EncodeOptions(level=1))[0]
    sections = roofline.section_bytes(archive)
    # ids "r1\0r2\0", comments "c\0\0", lengths 2 x u32, mask units [4,4,5]
    assert sections == {"ids": 6, "comments": 3, "lengths": 8, "mask": 3, "sequence": 7}
    assert roofline.work_bytes(len(text), archive) == len(text) + 27
    assert roofline.bound_s(3_350_000, "NVIDIA H100 80GB HBM3") == pytest.approx(1e-6)
    assert roofline.bound_s(1, "cpu") is None
    r = NafReader(io.BytesIO(archive))
    assert r.header.has_mask and not r.header.has_quality


def test_trace_reduce_counts_overlap_once():
    """Busy time is the union of a card's intervals; kernel and copy time
    are sums; idle time goes to the innermost host range open over it."""
    ev = [{"ph": "X", "name": "bench.call", "cat": "user_annotation", "ts": 0, "dur": 100},
          {"ph": "X", "name": "stitch", "cat": "user_annotation", "ts": 60, "dur": 40},
          {"ph": "X", "name": "k1", "cat": "kernel", "ts": 10, "dur": 20, "args": {"device": 0}},
          {"ph": "X", "name": "k2", "cat": "kernel", "ts": 20, "dur": 20, "args": {"device": 0}},
          {"ph": "X", "name": "Memcpy HtoD", "cat": "gpu_memcpy", "ts": 50, "dur": 5,
           "args": {"device": 0}},
          {"ph": "X", "name": "k3", "cat": "kernel", "ts": 10, "dur": 10, "args": {"device": 1}}]
    t = reduce(ev, 1, [0, 1])
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s[0] == pytest.approx(35e-6) and t.busy_s[1] == pytest.approx(10e-6)
    assert t.kernel_s[0] == pytest.approx(40e-6) and t.copy_s[0] == pytest.approx(5e-6)
    gaps = dict(t.idle_gaps)
    assert gaps["stitch"] == pytest.approx(40e-6)
    assert gaps["call, no span"] == pytest.approx(25e-6)


def test_reservoir_is_seeded():
    from benchmark.textgen import rng_of

    def pick(seed):
        r = harness.Reservoir(3, rng_of(seed, 99))
        for i in range(50):
            r.offer(i)
        return r.items

    assert pick(1) == pick(1) and len(pick(1)) == 3
    assert harness.bytes_off(b"abcd", b"abxde") == 2
    assert np.isscalar(harness.bytes_off(b"", b""))
