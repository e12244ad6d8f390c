"""The readers of the program's spans (metrics/program_spans.py and the four quantities
that use it) on a synthetic traced run: a buffer holding spans of an earlier profile, of
the traced call and of the labelled pass after it, and the call's device operations.
On a card (`gpu`): the spans add no device operation to a traced call of either loop,
and every device operation of the call starts after the first span."""

import sys
from types import SimpleNamespace

import pytest
import torch

import hotrack_tpu_torch.utils
from benchmark import core, trace
from benchmark.metrics import program_spans
from hotrack_tpu_torch.utils import trace as program_trace
from hotrack_tpu_torch.utils.trace import Span

BASE_US = 1_790_000_000_000_000   # the profiler's clock: microseconds since the epoch
CHUNK_FRAMES = 2
# the profiler converts the card's timestamps to the host's clock: a call's first kernel
# has read up to 130 us before the span that launched it
CLOCK_US = 1000.0
READERS = ("handnet_ms.hand", "opt_iter_host_ms.obj", "opt_iter_host_ms.hand",
           "opt_idle_ms.obj", "opt_idle_ms.hand", "net_idle_ms.hand")


def _span(i, name, parent, lo, hi):
    return Span(name, i, parent, 1, (BASE_US + lo) * 1000, (BASE_US + hi) * 1000)


BEFORE = [_span(2, "opt.obj_pose", 1, 110, 190), _span(1, "track.obj.frame", None, 100, 200)]
CALL = [
    _span(11, "net.handtracknet", 10, 1001, 1055),
    _span(12, "net.iknet", 10, 1056, 1090),
    _span(15, "opt.particle.energy", 14, 1093, 1120),
    _span(14, "opt.particle.iter", 13, 1092, 1250),
    _span(17, "opt.particle.energy", 16, 1251, 1300),
    _span(16, "opt.particle.iter", 13, 1250, 1490),
    _span(13, "opt.hand_pose", 10, 1091, 1500),
    _span(10, "track.hand.frame", None, 1000, 1580),
    _span(20, "opt.particle.iter", 19, 1586, 1597),
    _span(19, "opt.hand_shape", None, 1585, 1598),
]
AFTER = [_span(31, "net.handtracknet", 30, 1801, 1850),
         _span(30, "track.hand.frame", None, 1800, 1900)]
# gaps: 1040-1060 (net.handtracknet), 1100-1130 (opt.particle.energy), 1200-1210 and
# 1300-1400 (opt.particle.iter), 1520-1600 (track.hand.frame), 1640-1660 (none)
OPS_US = [(1005, 1040), (1060, 1100), (1130, 1200), (1210, 1300), (1400, 1500), (1450, 1520),
          (1600, 1640), (1660, 1700)]
WINDOW_S = 710e-6   # from the call's start at 990 to the synchronise's end at 1700


def _ctx():
    return {"device_ops": [("k", BASE_US + a, BASE_US + b) for a, b in OPS_US],
            "window_s": WINDOW_S, "chunk_frames": CHUNK_FRAMES}


@pytest.fixture
def buffer(monkeypatch):
    """recorded() returns the spans of an earlier profile, the call and the labelled
    pass, in the order they ended."""
    monkeypatch.setattr(program_trace, "recorded", lambda: BEFORE + CALL + AFTER)


def test_only_the_traced_calls_spans_are_read(buffer):
    assert sorted(s.id for s in program_spans.call_spans(_ctx())) == sorted(s.id for s in CALL)


def test_idle_falls_to_the_innermost_open_span(buffer):
    owners = sorted(((None if s is None else s.name, round(sec * 1e6, 6))
                     for s, sec in program_spans.idle_by_span(_ctx())), key=str)
    assert owners == sorted([("net.handtracknet", 20), ("opt.particle.energy", 30),
                             ("opt.particle.iter", 10), ("opt.particle.iter", 100),
                             ("track.hand.frame", 80), (None, 20)], key=str)


def test_idle_under_spans_and_under_none_sums_to_the_unions_gaps(buffer):
    ctx = _ctx()
    idle_s = sum(sec for _, sec in program_spans.idle_by_span(ctx))
    ops = ctx["device_ops"]
    union_gaps_us = ops[-1][2] - ops[0][1] - trace.busy_us(ops)
    assert idle_s == pytest.approx(union_gaps_us * 1e-6, rel=1e-9)
    assert union_gaps_us == pytest.approx(260, abs=1e-6)


@pytest.mark.parametrize("name,want", [
    ("handnet_ms.hand", 35e-3 / CHUNK_FRAMES),     # the operation 1005-1040
    ("opt_iter_host_ms.obj", (0.158 + 0.240) / 2),    # the pose optimiser's two
    ("opt_iter_host_ms.hand", (0.158 + 0.240) / 2),
    ("opt_idle_ms.obj", (30 + 10 + 100) * 1e-3 / CHUNK_FRAMES),
    ("opt_idle_ms.hand", (30 + 10 + 100) * 1e-3 / CHUNK_FRAMES),
    ("net_idle_ms.hand", 20 * 1e-3 / CHUNK_FRAMES),
])
def test_reader_values(buffer, name, want):
    assert core.metric_reader(name).read(_ctx()) == pytest.approx(want, rel=1e-6)


def test_busy_is_clipped_to_the_spans(monkeypatch):
    """A span that starts and ends inside operations counts only its part of them."""
    monkeypatch.setattr(program_trace, "recorded",
                        lambda: [_span(1, "net.handtracknet", None, 1020, 1080)])
    assert program_spans.busy_ms_within(_ctx(), "net.handtracknet") == pytest.approx(
        (20 + 20) * 1e-3 / CHUNK_FRAMES, rel=1e-9)
    assert program_spans.busy_ms_within(_ctx(), "net.iknet") is None


@pytest.mark.parametrize("name", READERS)
def test_reader_is_none_without_spans(monkeypatch, name):
    reader = core.metric_reader(name)
    monkeypatch.setattr(program_trace, "recorded", lambda: [])
    assert reader.read(_ctx()) is None
    monkeypatch.setattr(program_trace, "recorded", lambda: BEFORE + CALL + AFTER)
    assert reader.read({**_ctx(), "device_ops": []}) is None
    # a program without the module (the parent of the change that added it)
    monkeypatch.delattr(hotrack_tpu_torch.utils, "trace")
    monkeypatch.setitem(sys.modules, "hotrack_tpu_torch.utils.trace", None)
    with pytest.raises(ImportError):
        from hotrack_tpu_torch.utils import trace as _  # noqa: F401
    assert reader.read(_ctx()) is None


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in core.load_spec(core.ROOT)["workloads"]])
def test_spans_add_no_device_operation(monkeypatch, cell):
    """Three frames of the cell's loop at its own sizes (a short distillation), traced on
    the device alone after a first traced call, eight times each with the spans on and off
    in turns: as many operations (the most each side read), none before the first span
    (within the clocks' agreement)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the loops' kernels")
    from torch.profiler import ProfilerActivity, profile

    found = core.resolve_cell(core.load_spec(core.ROOT), cell)
    config = {**found["config"], "distill": {**found["config"]["distill"], "steps": 30}}
    traffic = {**found["traffic"], "frames": 3}
    device = torch.device("cuda", 0)
    system = core.system_module(config).System(config, traffic, 2**33 + 7, device)
    system.setup({})
    on_flag, off_flag = program_trace._profiler, SimpleNamespace(_is_profiler_enabled=False)
    counts = {True: [], False: []}
    for on in (None,) + (True, False) * 8:   # None: the first traced call, dropped
        monkeypatch.setattr(program_trace, "_profiler", off_flag if on is False else on_flag)
        program_trace.clear()
        core.sync(device)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            system.call(0)
            core.sync(device)
        ops, _ = trace.collect(prof)
        spans = program_trace.recorded()
        if on is None:
            continue
        counts[on].append(len(ops))
        if on:
            first_us = min(s.start_ns for s in spans) * 1e-3
            early = [op for op in ops if op[1] < first_us - CLOCK_US]
            assert ops and not early, (first_us, early[:5])
        else:
            assert spans == []
    program_trace.clear()
    # the profiler loses a traced call's records now and then, spans on or off (one process
    # on the card read 17,627, 17,312 and 17,312 of the hand's 17,630), and adds none after
    # the first call: each side's count is the most it read
    assert max(counts[True]) == max(counts[False]), counts
