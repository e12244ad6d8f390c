#!/usr/bin/env python3
"""Where the card idles in a benchmark cell's traced call, by the trackers' spans
(hotrack_tpu_torch/utils/trace.py), and which of the program's lines make the host wait
for the card.

    python3 scripts/profile_torch_spans.py CELL      # e.g. handopt.s4

After the cell's set-up (benchmark/systems), it makes the cell's traced call as
`benchmark/run.py --trace 1` does (benchmark/run.measure_traced) and prints the device's
idle time between the call's first and last operation by the innermost span open at each
gap's middle (benchmark/metrics/program_spans.py; the span's path of names, outermost
first). Then SYNC_FRAMES frames under `torch.cuda.set_sync_debug_mode("warn")`: each
line of the program under which the host waited for the card, with its count. Last, the
cost of a span with no profiler on. Needs a CUDA card.
"""

from __future__ import annotations

import collections
import sys
import timeit
import traceback
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark import core, run  # noqa: E402
from benchmark.metrics import program_spans  # noqa: E402
from benchmark.reference import plain_float32  # noqa: E402

PACKAGE = str(ROOT / "hotrack_tpu_torch")
SEED = 2**33 + 2020
SYNC_FRAMES = 3


def path_of(span, by_id) -> str:
    names = []
    while span is not None:
        names.append(span.name)
        span = by_id.get(span.parent)
    return " > ".join(reversed(names)) or "(no span)"


def idle_table(system, device) -> None:
    records, window_s, device_ops, _ = run.measure_traced(system, device, label_frames=1)
    ctx = {"device_ops": device_ops, "window_s": window_s,
           "chunk_frames": system.chunk_frames_per_call * len(records)}
    by_id = {s.id: s for s in program_spans.call_spans(ctx)}
    idle = collections.Counter()
    for s, sec in program_spans.idle_by_span(ctx) or []:
        idle[path_of(s, by_id)] += sec
    total = sum(idle.values())
    under = total - idle.get("(no span)", 0.0)
    print(f"  traced call: window {window_s:.4f} s, {len(device_ops)} device operations; "
          f"idle {total:.6f} s, {1e3 * total / ctx['chunk_frames']:.4f} ms a loop frame, "
          f"under a span {100.0 * under / total if total else 0.0:.2f}%")
    for path, sec in idle.most_common(14):
        print(f"    {sec:10.6f} s  {100.0 * sec / total:6.2f}%  {path}")


def sync_sites(system, device) -> None:
    """Each line of the program under which the host waited for the card."""
    sites = collections.Counter()

    def show(message, category, filename, lineno, file=None, line=None):
        stack = [f for f in traceback.extract_stack()[:-1] if f.filename.startswith(PACKAGE)]
        where = " > ".join(f"{Path(f.filename).relative_to(PACKAGE)}:{f.lineno} {f.name}"
                           for f in stack[-3:]) or f"{filename}:{lineno}"
        sites[(where, stack[-1].line if stack else "")] += 1

    core.sync(device)
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            system.call(2, frames=SYNC_FRAMES)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    core.sync(device)
    print(f"  synchronising calls in {SYNC_FRAMES} frames: {sum(sites.values())}")
    for (where, line), n in sites.most_common(40):
        print(f"    {n:6d}  {where}\n            {line}")


def off_cost() -> None:
    n = 1_000_000
    setup = ("from hotrack_tpu_torch.utils.trace import span, spanned\n"
             "def bare():\n    return None\n"
             "wrapped = spanned('x')(bare)")
    with_span = timeit.timeit("with span('x'):\n    pass", setup=setup, number=n)
    empty = timeit.timeit("pass", number=n)
    deco = (timeit.timeit("wrapped()", setup=setup, number=n)
            - timeit.timeit("bare()", setup=setup, number=n))
    print(f"span off: {1e9 * (with_span - empty) / n:.1f} ns a `with span(...)`, "
          f"{1e9 * deco / n:.1f} ns a `spanned` call over the bare call")


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    name = sys.argv[1]
    device = torch.device("cuda", 0)
    print(f"{name} on {run.power_limit()}")
    plain_float32()
    cell = core.resolve_cell(core.load_spec(), name)
    config, traffic = dict(cell["config"]), dict(cell["traffic"])
    system = core.system_module(config).System(config, traffic, SEED, device)
    system.setup({})
    core.sync(device)
    idle_table(system, device)
    sync_sites(system, device)
    system.free_program()
    off_cost()
    return 0


if __name__ == "__main__":
    sys.exit(main())
