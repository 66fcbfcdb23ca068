"""One run of one benchmark cell: set-up, the measured window, the check
against the reference, and the result line.

Everything that belongs to one configuration, traffic mix or metric is a
file that the harness finds by the name ``BENCHMARK.json`` gives it:

- ``configs/<name>.json`` (the entry's ``file``): the data set's sizes and
  its ``generator``, the level, the control;
- ``generators/<generator>.py``: ``generate(config, seed) -> Dataset``;
- ``traffic/<traffic>.json``: the operation (``op``) and the cards of the
  mesh (``mesh_devices``); one client, closed loop;
- ``ops/<op>.py``: ``Op``, which drives the program and names the
  reference's output it must equal;
- ``metrics/<metric>.py``: ``read(Readings)``, one per metric.

So a later change adds a configuration, a mix or a metric by adding files
and entries, and edits none.

The run: the inputs from ``--seed``, the warm-up calls, then calls back to
back for ``--seconds`` (one client, closed loop).  With ``--trace 1`` the
benchmark times the program's layers from its own spans and the program's
``[naf-trace]`` lines over the window, and profiles a few calls before it.
After the window a seeded sample of the window's outputs, and the warm-up
outputs, are compared with the reference's, byte for byte.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from .controls import CONTROLS
from .devtrace import profile_calls
from .readings import Readings
from .roofline import bound_s, work_bytes
from .spans import Spans
from .textgen import rng_of

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "naf_tpu")
SAMPLES = 3          # window outputs compared, besides the warm-up calls
WARMUP_CALLS = 2
TRACED_CALLS = 3     # calls under the profiler in a traced run


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def plugin(root: Path, kind: str, name: str):
    """The module ``<root>/benchmark/<kind>/<name>.py``."""
    path = root / "benchmark" / kind / f"{name}.py"
    mod_name = f"_bench_{kind}_" + "".join(c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def by_name(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json has no {what} {name!r}")


class Cell:
    """A cell's entries and files, found by name."""

    def __init__(self, root: Path, workload: str):
        self.root = root
        self.spec = load_json(root / "BENCHMARK.json")
        self.workload = by_name(self.spec["workloads"], workload, "workload")
        entry = by_name(self.spec["configs"], self.workload["config"], "config")
        self.config = load_json(root / entry["file"])
        self.traffic = load_json(root / "benchmark" / "traffic" / f"{self.workload['traffic']}.json")
        if self.traffic["mesh_devices"] > self.workload["chips"]:
            raise ValueError(f"{workload}: a mesh of {self.traffic['mesh_devices']} cards "
                             f"on {self.workload['chips']} chips")

    def metrics(self, trace: bool) -> list[dict]:
        """The metrics this cell reports: its end-to-end ones, or with
        ``trace`` its per-layer ones; a metric without ``workloads`` in
        every cell that reports what it moves."""
        e2e = [m for m in self.spec["end_to_end"] if self._has(m)]
        if not trace:
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.spec["per_layer"] if self._has(m)
                if "workloads" in m or m["moves"] in names]

    def _has(self, m: dict) -> bool:
        return "workloads" not in m or self.workload["name"] in m["workloads"]

    def op_class(self):
        return plugin(self.root, "ops", self.traffic["op"]).Op

    def generate(self, seed: int):
        return plugin(self.root, "generators", self.config["generator"]).generate(self.config,
                                                                                 seed)

    def reader(self, metric: str):
        return plugin(self.root, "metrics", metric).read


def card_line() -> str:
    """Each card's name and power limit, as nvidia-smi reads them."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=index,name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=60)
        return "; ".join(r.stdout.strip().splitlines()) or f"nvidia-smi: {r.stderr.strip()}"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"


def bytes_off(a: bytes, b: bytes) -> int:
    """Positions at which two outputs differ, counting a length difference."""
    m = min(len(a), len(b))
    x = np.frombuffer(a, np.uint8, m)
    y = np.frombuffer(b, np.uint8, m)
    return int(np.count_nonzero(x != y)) + abs(len(a) - len(b))


class Reservoir:
    """A uniform sample of ``k`` of the outputs offered, drawn from the seed."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.items, self.seen = k, rng, [], 0

    def offer(self, x) -> None:
        if len(self.items) < self.k:
            self.items.append(x)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = x
        self.seen += 1


def calls_line(per_call: list) -> str:
    """The spread of the window's calls, for a reader of the run's stderr."""
    q = np.percentile(per_call, [0, 50, 100])
    return f"calls: {len(per_call)}, s a call min {q[0]:.4f} median {q[1]:.4f} max {q[2]:.4f}"


def resolve_threads(cfg: dict) -> dict:
    cfg = dict(cfg)
    if cfg.get("threads") == "all":
        cfg["threads"] = os.cpu_count() or 1
    return cfg


def checks_of(outputs: list, expected: bytes) -> dict:
    """The numbers compared, each with its limit."""
    offs = [bytes_off(o, expected) for o in outputs]
    return {"outputs_checked": {"value": len(outputs), "limit": 1, "at_least": True},
            "outputs_off": {"value": sum(1 for x in offs if x), "limit": 0},
            "bytes_off": {"value": sum(offs), "limit": 0}}


def is_correct(checks: dict) -> bool:
    return all(c["value"] >= c["limit"] if c.get("at_least") else c["value"] <= c["limit"]
               for c in checks.values())


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, *, t0=None, root: Path = ROOT, devices=None, wrap_op=None) -> int:
    """Run one cell once and print its result line; the exit code.

    ``devices`` (torch device names, one a block) stands in for the cards
    and skips the look for them: the tests drive a whole run on the CPU
    that way.  ``wrap_op(op, ds, cell)`` may put another object in the
    program's place (the control, a planted fault)."""
    t0 = time.perf_counter() if t0 is None else t0
    args = parse_args(argv)
    cell = Cell(root, args.workload)
    cfg = resolve_threads(cell.config)
    if args.trace:
        os.environ["NAF_TPU_TRACE"] = "1"       # the program reads it once, at import
    else:
        os.environ.pop("NAF_TPU_TRACE", None)
    os.environ.pop("NAF_TPU_PROFILE", None)

    import torch

    chips = cell.workload["chips"]
    if devices is None:
        if not torch.cuda.is_available():
            print("benchmark: no CUDA card; this benchmark runs on the card only",
                  file=sys.stderr)
            return 2
        if torch.cuda.device_count() < chips:
            print(f"benchmark: {args.workload} needs {chips} cards, "
                  f"{torch.cuda.device_count()} visible", file=sys.stderr)
            return 2
        print(f"cards: {card_line()}", file=sys.stderr)

    from naf_tpu_torch import device as D
    from naf_tpu_torch.parallel.mesh import block_mesh

    mesh = (block_mesh(n_devices=cell.traffic["mesh_devices"]) if devices is None
            else block_mesh(devices=devices))
    cuda = [d for d in dict.fromkeys(mesh.devices) if d.type == "cuda"]
    kind = torch.cuda.get_device_name(cuda[0]) if cuda else "cpu"

    def sync():
        for d in cuda:
            torch.cuda.synchronize(d)

    spans = Spans()
    ds = cell.generate(args.seed)
    op = cell.op_class()(ds, cfg, mesh, spans)
    if wrap_op is not None:
        op = wrap_op(op, ds, cell)
    warm = [op.call() for _ in range(WARMUP_CALLS)]
    sync()
    setup_s = time.perf_counter() - t0

    trace = None
    if args.trace:
        for module, attr, name in op.SPANS:
            spans.wrap(module, attr, name)
        spans.on = True
        trace = profile_calls(op.call, TRACED_CALLS, [d.index for d in cuda], spans, sync)
        spans.clear()

    D.reset_counts()
    keep = Reservoir(SAMPLES, rng_of(args.seed, 99))
    calls = bytes_in = bytes_out = 0
    per_call = []
    with spans.tap_stderr() if args.trace else contextlib.nullcontext():
        start = end = time.perf_counter()
        deadline = start + args.seconds
        while True:
            out = op.call()
            per_call.append(time.perf_counter() - end)
            end = time.perf_counter()
            calls += 1
            bytes_in += len(op.input)
            bytes_out += len(out)
            keep.offer(out)
            if end >= deadline:
                break
    del out
    routes = dict(D.ROUTES)
    spans.on = False
    spans.unwrap()
    peak = max((torch.cuda.max_memory_allocated(d) for d in cuda), default=0)
    torch.cuda.empty_cache()

    expected = op.expected()
    checks = checks_of(keep.items + warm, expected)
    del keep, warm
    text_bytes, archive = op.work(expected)
    r = Readings(direction=op.direction, setup_s=setup_s, window_s=end - start, calls=calls,
                 bytes_in=bytes_in, bytes_out=bytes_out,
                 device_routes=sum(v for k, v in routes.items() if op.device_route(k)),
                 spans=dict(spans.seconds), program_spans=dict(spans.program), trace=trace,
                 bound_s=bound_s(work_bytes(text_bytes, archive), kind))
    metrics = {}
    for m in cell.metrics(bool(args.trace)):
        v = cell.reader(m["name"])(r)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    device = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": len(cuda),
              "memory_peak_bytes": int(peak)}
    result = {"correct": is_correct(checks), "attempted": calls, "failed": 0,
              "metrics": metrics, "device": device}
    if trace is not None:
        cards = list(trace.busy_s.values())
        device["busy_s"] = sum(cards) / len(cards) if cards else 0.0
        device["window_s"] = trace.window_s
        result["breakdown"] = {"device_ops": trace.device_ops, "idle_gaps": trace.idle_gaps}
    result["checks"] = checks
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    print(calls_line(per_call), file=sys.stderr)
    print(f"routes: {json.dumps(routes)}", file=sys.stderr)
    for name, c in checks.items():
        rel = ">=" if c.get("at_least") else "<="
        print(f"check {name} {c['value']} limit {rel} {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def control_op(op, ds, cell):
    """The control in the program's place: the reference's output for the
    records with the configuration's control applied (a guarantee
    broken), returned by every call."""
    out = op.expected(CONTROLS[cell.config["control"]](ds))

    class Control:
        direction, SPANS, input = op.direction, [], op.input
        device_route = staticmethod(op.device_route)
        expected, work = op.expected, op.work

        def call(self):
            return out

    return Control()
