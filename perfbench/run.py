"""Run one cell of ``BENCHMARK.json`` on the card and print one JSON line.

    python3 perfbench/run.py --workload granite8b.chat --seed 7 --seconds 45 --trace 0

Everything a cell needs is found by name: the configuration file
(``configs[*].file``), the traffic file (``perfbench/traffic/<traffic>.json``),
the limits of its comparison (``perfbench/limits/<workload>.json``), the
model family's module (``perfbench/models/<model>.py``, the configuration's
``model`` key: its weights, plain reference, counts and map onto the port)
and one reader a metric (``perfbench/metrics/<metric>.py``, else, for a
metric named ``<stem>.<cell>``, ``perfbench/metrics/<stem>.py``; ``read(run)
-> float | None``).  A new cell, mix, family or metric is new files and
entries, never an edit here.

A run: weights from ``--seed`` on the card, the engine and its pool, the K5
geometry of every shape the traffic brings, the decode tick captured as a
CUDA graph, a ramp (open loop) or primed clients (closed loop); then the
measured window of ``--seconds``, with ``--trace 1`` a profiled sub-window
inside it; then the comparison with the plain reference, on the program's
state freed.  ``--trace 0`` prints the cell's end-to-end metrics, ``--trace
1`` its per-layer metrics, each line ending in ``checks``: each number
compared with its limit.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def set_cache_dirs(root: Path) -> None:
    """Every cache the program or its libraries keep, at fixed paths inside
    the checkout, so that only a checkout's first run builds anything."""
    cache = root / "build" / "perfbench"
    cache.mkdir(parents=True, exist_ok=True)
    os.environ["REPRO_AUTOTUNE_CACHE"] = str(cache / "autotune.json")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """A workload of ``BENCHMARK.json`` with its files."""

    def __init__(self, root: Path, name: str):
        self.root = root
        self.bench = load_json(root / "BENCHMARK.json")
        found = [w for w in self.bench["workloads"] if w["name"] == name]
        if not found:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.workload = found[0]
        self.name = name
        cfg_entry = next(c for c in self.bench["configs"] if c["name"] == self.workload["config"])
        self.cfg = load_json(root / cfg_entry["file"])
        self.traffic = load_json(root / "perfbench" / "traffic" / f"{self.workload['traffic']}.json")
        self.limits = load_json(root / "perfbench" / "limits" / f"{name}.json")

    def metrics(self, kind: str) -> list[dict]:
        """The cell's end-to-end or per-layer metrics."""
        return [m for m in self.bench[kind]
                if "workloads" not in m or self.name in m["workloads"]]


def reader_path(root: Path, name: str) -> Path:
    """The reader of metric ``name``: ``metrics/<name>.py``, else that of
    its stem, the name without its last ``.<part>`` (``prefill_ms.chat``
    is read by ``metrics/prefill_ms.py``)."""
    folder = root / "perfbench" / "metrics"
    path = folder / f"{name}.py"
    if not path.is_file() and "." in name:
        path = folder / f"{name.rsplit('.', 1)[0]}.py"
    return path


def load_reader(root: Path, name: str):
    path = reader_path(root, name)
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Run:
    """What a run measured, for the metric readers: the window [t0, t1] on
    the host clock, the served requests (``loop.Record``), the device work
    (``loop.Work``), the loop's spans, the set-up seconds, the power meter,
    the profiled sub-window's summary (``profiling.summarize_trace`` plus
    ``k5_bound_s`` and ``k5_launches``), the model family's module and the
    configuration's sizes.

    ``excluded``: in a traced run, the host-clock interval from just before
    the profiler starts to just after it stops (None otherwise).  Its start
    takes seconds and its recording slows the loop, so the work, spans and
    power samples read on the host clock leave it out, and ``clear_s`` is
    the window's seconds without it."""

    def __init__(self, **kw):
        self.excluded = None
        self.__dict__.update(kw)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    @property
    def clear_s(self) -> float:
        if self.excluded is None:
            return self.window_s
        a, b = self.excluded
        return self.window_s - max(0.0, min(b, self.t1) - max(a, self.t0))

    def inside(self, t: float) -> bool:
        return self.t0 <= t <= self.t1

    def clear(self, a: float, b: float) -> bool:
        """[a, b] lies inside the window and outside ``excluded``."""
        if not (self.t0 <= a and b <= self.t1):
            return False
        return self.excluded is None or b <= self.excluded[0] or a >= self.excluded[1]

    def tokens_in_window(self) -> int:
        return sum(1 for r in self.records for t in r.times if self.inside(t))

    def work_in_window(self) -> list:
        return [w for w in self.work if self.clear(w.t0, w.t1)]

    def span_seconds(self, name: str) -> list[float]:
        return [b - a for n, a, b in self.spans if n == name and self.clear(a, b)]

    def power_samples(self) -> list[float]:
        """Watts of the power samples taken in the window, outside ``excluded``."""
        if self.power is None:
            return []
        return [w for t, w in self.power.samples if self.clear(t, t)]


def _warm_shapes(traffic: dict, model, sizes, requests) -> list:
    """(m, k, n, batch) of every K5 launch the traffic brings: the tick's
    pool rows, and each prompt length (blocking) or chunk (chunked)."""
    pool, adm = traffic["pool"], traffic["admission"]
    ms = {pool["max_batch"]}
    for r in requests:
        s0 = len(r.prompt)
        if adm["mode"] == "blocking":
            ms.add(s0)
        else:
            ms.add(min(s0, adm["chunk_tokens"]))
            if s0 % adm["chunk_tokens"]:
                ms.add(s0 % adm["chunk_tokens"])
    return sorted({(m, k, n, b) for m in ms for m, k, n, b, _ in model.k5_calls(sizes, m)})


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", rehearsal: bool = False, t_process: float = T_PROCESS,
             log=print, control: bool = False, traffic_over: dict | None = None) -> dict:
    """One run of cell ``name``; returns the result line as a dict.
    ``rehearsal``: the port's reduced config and the traffic file's
    ``rehearsal`` overrides, on any device (the CPU tests).  ``control``:
    the control on the same sample too, judged by the same ``check.verdict``
    (``control`` in the result; the benchmark's own runs never compute
    it).  ``traffic_over``: traffic parameters put over the file's (the
    knee sweep's rates)."""
    import torch

    from perfbench import check, counts, program
    from perfbench.loop import ServeLoop
    from perfbench.profiling import PowerMeter, summarize_trace
    from perfbench.traffic import make_requests

    cell = Cell(root, name)
    cfg, traffic = cell.cfg, dict(cell.traffic)
    model = importlib.import_module(f"perfbench.models.{cfg['model']}")
    arch = program.arch_config(cfg, model, rehearsal=rehearsal)
    limit = cell.limits["max_logit_gap"]
    if rehearsal:
        cfg = model.rehearsal_config(cfg, arch)
        traffic.update(traffic.get("rehearsal", {}))
        limit = cell.limits["rehearsal"]["max_logit_gap"]
    traffic.update(traffic_over or {})
    sizes = model.sizes(cfg)
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    # ---- set-up -------------------------------------------------------------
    phases = {"imports": time.perf_counter() - t_process}
    mark = time.perf_counter()

    def phase(name):
        nonlocal mark
        now = time.perf_counter()
        phases[name] = now - mark
        mark = now

    weights = model.make_weights(cfg, seed, device)
    params = program.program_params(weights, cfg, arch, model)
    del weights
    eng, pool = program.make_engine(arch, params, traffic["pool"], device)
    del params
    sync()
    phase("weights_engine")
    requests = make_requests(traffic, seed=seed, seconds=seconds, vocab_size=sizes.vocab)
    if cuda:
        program.warm_k5_plans(_warm_shapes(traffic, model, sizes, requests))
    phase("k5_plans")
    eng.masked_decode_step(pool)  # captures the tick (no slot decodes yet)
    phase("capture")
    loop = ServeLoop(eng, pool, traffic, requests, sync=sync)
    if traffic["admission"]["mode"] == "blocking":
        longest = max(requests, key=lambda r: len(r.prompt)).prompt
        eng.prefill_into_slot(pool, pool.next_free(), longest, rid=-1, budget=1)
        pool.retire(pool.active_slots()[0])
    sync()
    phase("warm_prefill")
    if traffic["loop"] == "open":
        t0 = time.perf_counter() + traffic.get("ramp_s", 0.0)
        loop.start(t0)
        loop.run_until(t0)
    else:
        loop.start(time.perf_counter())
        loop.prime(min(int(traffic["clients"]), traffic["pool"]["max_batch"]))
        sync()
        t0 = time.perf_counter()
    setup_s = t0 - t_process
    phase("ramp_or_prime")

    # ---- the window ------------------------------------------------------------
    power = PowerMeter() if cuda else None
    # t0, t1: the profiled sub-window; x0, x1: it with the profiler's start
    # and stop, which the host-clock readers leave out (``Run.excluded``)
    tr = {"prof": None, "t0": None, "t1": None, "x0": None, "x1": None, "k5": 0}
    span = traffic.get("trace", {})
    p_start = t0 + span.get("start_frac", 0.4) * seconds

    def hook(now: float) -> None:
        if not trace:
            return
        if tr["prof"] is None and tr["t0"] is None and now >= p_start:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
            tr["x0"] = time.perf_counter()
            sync()
            tr["prof"] = profile(activities=acts)
            tr["prof"].__enter__()
            loop.spans.annotate = True
            tr["k5"] = program.k5_launches()
            tr["t0"] = time.perf_counter()
        elif (tr["prof"] is not None and tr["t1"] is None
              and now >= min(tr["t0"] + span.get("seconds", 3.0), t0 + seconds)):
            sync()
            tr["t1"] = time.perf_counter()
            tr["prof"].__exit__(None, None, None)
            loop.spans.annotate = False
            tr["k5"] = program.k5_launches() - tr["k5"]
            tr["x1"] = time.perf_counter()

    if power is not None:
        power.start()
    loop.run_until(t0 + seconds, hook)
    sync()
    t1 = time.perf_counter()
    if power is not None:
        power.stop()
    hook(float("inf"))
    waiting = len(loop.ready)
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    summary = None
    if tr["t1"] is not None:
        summary = summarize_trace(tr["prof"], tr["t1"] - tr["t0"])
        calls = [c for w in loop.work if w.t0 >= tr["t0"] and w.t1 <= tr["t1"]
                 for c in model.work_k5_calls(sizes, w.kind, traffic["pool"]["max_batch"], **w.args)]
        summary["k5_bound_s"] = sum(counts.k5_call_bound_s(*c) for c in calls)
        summary["k5_counted"] = len(calls)
        summary["k5_launches"] = tr["k5"]
        del tr["prof"]
        if not len(calls) == tr["k5"] == summary["k5_events"]:
            log(f"int8_matmul launches: {len(calls)} counted from the configuration, "
                f"{tr['k5']} by the port's counter, {summary['k5_events']} in the trace")

    # ---- requests that finish after the close, for the sample ------------------
    recs = list(loop.records.values())
    samp = traffic["sample"]
    deadline = time.perf_counter() + 60
    while (sum(len(r.tokens) for r in check.sample(recs, seed, **samp)) < samp["min_tokens"]
           and time.perf_counter() < deadline):
        loop.run_until(time.perf_counter() + 1.0)
        recs = list(loop.records.values())
    chosen = check.sample(recs, seed, **samp)

    run = Run(t0=t0, t1=t1, records=recs, work=list(loop.work), spans=list(loop.spans.items),
              setup_s=setup_s, power=power, trace=summary, model=model, sizes=sizes, cell=cell,
              traffic=traffic, excluded=None if tr["x0"] is None else (tr["x0"], tr["x1"]))
    due = [r for r in recs if run.inside(r.due if r.req.arrival_s is not None
                                          else (r.started or -1))]
    attempted = len(due)
    failed = sum(1 for r in due if r.failed)
    failed_all = sum(1 for r in recs if r.failed)

    for e in loop.errors:
        log(e)

    # ---- the comparison, on the program's state freed ---------------------------
    loop.eng = loop.pool = None
    del eng, pool, loop
    gc.collect()
    program.free_cuda()
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    weights = model.make_weights(cfg, seed, device)
    weights4 = (model.make_weights(cfg, seed, device, levels=check.INT4_LEVELS)
                if control else None)
    gaps, ctl = check.gaps(model, weights, cfg, chosen, device, weights4)
    del weights, weights4
    program.free_cuda()
    widest = max(gaps) if gaps else None
    served = sum(len(r.tokens) for r in chosen)
    correct = check.verdict(gaps, failed_all, limit)

    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell.metrics(kind):
        value = load_reader(root, m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    if summary is not None:
        dev["busy_s"], dev["window_s"] = summary["busy_s"], summary["window_s"]
    out = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": dev}
    if summary is not None:
        out["breakdown"] = {"device_ops": summary["device_ops"],
                            "idle_gaps": summary["idle_gaps"]}
    out["notes"] = {"waiting_at_end": waiting, "setup_s": setup_s, "served_tokens_compared": served,
                    "power_mean_w": power.mean_w if power else None,
                    "energy_j": power.energy_j if power else None,
                    "energy_counter": bool(power and power.counted),
                    "window_s": t1 - t0, "setup_phases": phases}
    if ctl is not None:
        # the control's verdict: its gaps through the program's comparison
        out["control"] = {"correct": check.verdict(ctl, failed_all, limit),
                          "max_logit_gap": max(ctl) if ctl else None, "per_request": ctl,
                          "program_per_request": gaps}
    # each number compared with its limit: the widest gap at most its limit,
    # no failed request (the window's or any other), at least one finished
    # request compared
    out["checks"] = {"max_logit_gap": {"value": widest, "limit": limit},
                     "failed_requests": {"value": failed_all, "limit": 0},
                     "requests_compared": {"value": len(chosen), "limit": 1}}
    return out


def rehearse(name: str, seed: int = 1, seconds: float = 2.0, trace: bool = False,
             root: Path = ROOT) -> dict:
    """The run of cell ``name`` at the port's reduced sizes on the CPU, with
    the kernels' plain versions: for the tests.  Its numbers are not
    metrics."""
    sys.path.insert(0, str(root / "src"))
    set_cache_dirs(root)
    return run_cell(root, name, seed, seconds, trace, device="cpu", rehearsal=True,
                    t_process=time.perf_counter())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = Cell(ROOT, args.workload)
    import torch

    need = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"no result: the cell needs {need} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 3
    set_cache_dirs(ROOT)
    sys.path.insert(0, str(ROOT / "src"))
    out = run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                   log=lambda m: print(m, file=sys.stderr))
    found = forbidden_modules()
    if found:
        print(f"no result: modules of JAX or the JAX package are loaded: {found}", file=sys.stderr)
        return 4
    for key, c in out["checks"].items():
        print(f"check {key}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
