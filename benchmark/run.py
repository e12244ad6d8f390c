"""One run of one cell of the benchmark of hotrack_tpu_torch.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell's configuration and traffic mix by name (BENCHMARK.json),
sets the port up (inputs from the seed, the SDF distillation, a warm-up of
every shape), then measures: with --trace 0, whole tracker calls started
until --seconds have passed, and prints the cell's end-to-end metrics; with
--trace 1, one whole call under torch.profiler, and prints its per-layer
metrics with a breakdown. Then it frees the port's state and checks sampled
outputs of the window against the plain reference. The last line of standard
output is one JSON object; the numbers compared, each beside its limit, are
the last lines of standard error and the last key of that object.

Needs a CUDA card: without one (or with fewer than the cell asks for) it
exits 2 and prints no result. The port's kernels build into the checkout's
build/kernels/ on the first run there.
"""

import time

PROCESS_START = time.monotonic()

import os  # noqa: E402

# one process with few threads: the port's host work is one thread's
os.environ.setdefault("OMP_NUM_THREADS", "1")

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from benchmark import core, trace  # noqa: E402
from benchmark.reference import plain_float32  # noqa: E402


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def measure(system, seconds: float, device) -> tuple:
    """Whole calls started until `seconds` have passed: (records, window s)."""
    records = []
    core.sync(device)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        records.append(system.call(len(records)))
        core.sync(device)
    return records, time.perf_counter() - t0


def measure_traced(system, device, label_frames: int = 10) -> tuple:
    """One whole call under torch.profiler, tracing the device alone (the
    host's own events would slow the host and read as idle device time):
    (records, window s, device operations). Then the first `label_frames`
    frames of the next call traced with the host's operations too, whose
    idle gaps are labelled by what the host was doing: (gaps, ...)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = [ProfilerActivity.CUDA] if device.type == "cuda" else []
    core.sync(device)
    with profile(activities=cuda or [ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        records = [system.call(0)]
        core.sync(device)
        window_s = time.perf_counter() - t0
    device_ops, _ = trace.collect(prof)
    del prof
    with profile(activities=[ProfilerActivity.CPU] + cuda) as prof:
        with record_function("benchmark.frames"):
            system.call(1, frames=label_frames)
            core.sync(device)
    label_ops, host_ops = trace.collect(prof)
    del prof
    spans = [(h[1], h[2]) for h in host_ops if h[0] == "benchmark.frames"]
    gaps = trace.idle_gaps(label_ops, host_ops, spans[0]) if spans else []
    return records, window_s, device_ops, gaps


def reduce_checks(gaps: dict, checks: dict) -> tuple:
    """{number: (value, limit)}, each number a quantile of one kind of gap
    over the sampled answers (configuration's `checks`: gap, quantile,
    limit), and the count of sampled answers whose gap is over the limit of
    a number read from it (a NaN is over)."""
    numbers, failed = {}, 0
    for name, spec in checks.items():
        values = gaps[spec["gap"]]
        limit = float(spec["limit"])
        failed += int((~(values <= limit)).sum())
        finite = bool(torch.isfinite(values).all())
        numbers[name] = (float(torch.quantile(values, spec["quantile"])) if finite
                         else math.nan, limit)
    return numbers, failed


def run_cell(workload: str, seed: int, seconds: float, traced: bool, device,
             here: Path = core.HERE, config_override: dict | None = None,
             traffic: str | None = None) -> dict:
    """A run of one cell on `device`; returns the result object (without
    printing). config_override merges keys over the configuration and
    traffic (a test's small sizes); `traffic` names another mix for the
    cell's configuration (a mix that no cell lists yet, explored)."""
    plain_float32()
    cell = core.resolve_cell(core.load_spec(here.parent), workload, here, traffic)
    config, traffic = dict(cell["config"]), dict(cell["traffic"])
    if config_override:
        config.update(config_override.get("config", {}))
        traffic.update(config_override.get("traffic", {}))
    system = core.system_module(config, here).System(config, traffic, seed, device)
    spans = {}
    system.setup(spans)
    core.sync(device)
    setup_s = time.monotonic() - PROCESS_START

    if traced:
        records, window_s, device_ops, idle = measure_traced(system, device)
    else:
        records, window_s = measure(system, seconds, device)
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    frames = system.frames_per_call * len(records)

    metrics, dev_extra, breakdown = {}, {}, None
    if traced:
        busy = trace.busy_us(device_ops) * 1e-6
        dev_extra = {"busy_s": busy, "window_s": window_s}
        ctx = {"device_ops": device_ops, "window_s": window_s, "busy_s": busy,
               "spans": spans, "config": config, "traffic": traffic,
               "chunk_frames": system.chunk_frames_per_call * len(records),
               "work": system.work_per_chunk_frame()}
        for m in cell["per_layer"]:
            value = core.metric_reader(m["name"], here).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        by_label = {}
        for label, s in idle:
            by_label[label] = by_label.get(label, 0.0) + s
        breakdown = {"device_ops": [[k, v * 1e-6] for k, v in
                                    trace.top(trace.by_name(device_ops))],
                     "idle_gaps": trace.top(by_label)}
    else:
        values = {"frames_per_s": frames / window_s, "setup_s": setup_s}
        for m in cell["end_to_end"]:
            metrics[m["name"]] = {"value": values[core.base_name(m["name"])],
                                  "unit": m["unit"]}

    system.free_program()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    gaps = system.check(records)
    check_s = time.perf_counter() - t_check
    numbers, failed = reduce_checks(gaps, config["checks"])
    correct = all(v <= lim for v, lim in numbers.values())
    result = {
        "correct": correct, "attempted": frames, "failed": failed, "metrics": metrics,
        "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": int(memory_peak), **dev_extra},
        "spans": spans, "window_calls": len(records), "window_s": window_s,
        "check_s": check_s,
    }
    if hasattr(system, "extra"):
        result.update(system.extra(records))
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in numbers.items()}
    return result


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--traffic", default=None,
                    help="another traffic mix for the cell's configuration (exploration)")
    args = ap.parse_args()

    spec = core.load_spec()
    chips = core.find(spec["workloads"], args.workload, "workload")["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: needs {chips} CUDA card(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"card: {power_limit()}", file=sys.stderr)
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), traffic=args.traffic)
    loaded = core.forbidden_loaded()
    if loaded:
        print(f"benchmark: forbidden modules loaded: {', '.join(loaded)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
