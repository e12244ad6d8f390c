"""The trackers' spans (hotrack_tpu_torch/utils/trace.py) on the CPU, at tiny sizes.

Without a profiler a span is the shared no-op and a two-frame run of the batched hand
pipeline (HandTrackNet, IKNet, the frame-0 shape optimiser, the pose optimiser) and of
the batched object loop (after its distillation) records nothing. Under a CPU
`torch.profiler.profile` the same runs record the span tree the module's docstring
names, give outputs bitwise those of the untraced run, and stamp each span within 1 ms
of the profiler's own range of the same name. Parents are kept per thread, and the
buffer's cap counts what it drops.
"""

import threading

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from hotrack_tpu_torch.mano.model import synthetic_mano_model
from hotrack_tpu_torch.models import HandTrackNet, IKNet
from hotrack_tpu_torch.opt.hand_pose import POSE_SPEC, load_contact_zones
from hotrack_tpu_torch.opt.hand_shape import SHAPE_SPEC
from hotrack_tpu_torch.opt.obj_pose import OBJ_SPEC
from hotrack_tpu_torch.sdf.assets import synthetic_box_sdf_setup
from hotrack_tpu_torch.sdf.distill import distill_sdf_volume
from hotrack_tpu_torch.track import track_hand_sequences_batched, track_obj_sequences_batched
from hotrack_tpu_torch.utils import trace

S, T, N, P = 2, 2, 64, 16
SIZE, SCALE = 21, 0.01
NET_CFG = {
    "sa1": {"npoint": 32, "radius_list": [0.1], "nsample_list": [8],
            "mlp_list": [[16, 16, 32]]},
    "sa2": {"npoint": 16, "radius_list": [0.2], "nsample_list": [8],
            "mlp_list": [[32, 32, 64]]},
    "sa3": {"mlp": [64, 64, 128]},
    "fp3": {"mlp": [64, 64]},
    "fp2": {"mlp": [64, 64]},
    "fp1": {"mlp": [64, 64]},
}
WEIGHTS = {"penetrate_sum_loss": 1.0, "sil_loss": 0.1, "attraction_loss": 0.05,
           "vis_regu_loss": 10.0, "invis_regu_loss": 0.0, "temporal_smooth": 1.0}
NS_PER_MS = 1_000_000


@pytest.fixture(autouse=True)
def _empty_buffer():
    trace.clear()
    yield
    trace.clear()


def _distill():
    return distill_sdf_volume(synthetic_box_sdf_setup(SIZE, SCALE), SCALE,
                              torch.Generator().manual_seed(3), steps=3, batch=64, hidden=16,
                              depth=1, pool_batches=2)


def _hand_run(inputs):
    torch.manual_seed(0)
    handnet = HandTrackNet(NET_CFG, backbone_out_dim=48).eval()
    iknet = IKNet(width=32).eval()
    out = track_hand_sequences_batched(
        handnet, synthetic_mano_model(), inputs["frames"], iknet=iknet, use_opt=True,
        shape_mode=1, shape_particles=inputs["shape_bank"], pose_particles=inputs["pose_bank"],
        zones=load_contact_zones(None), energy_weight=WEIGHTS, sdf_voxel_scale=SCALE,
        distilled=[inputs["model"]] * S)
    return list(out)


def _obj_run(inputs):
    model = _distill()
    out = track_obj_sequences_batched(None, inputs["obj_bank"], inputs["clouds"],
                                      inputs["init_r"], inputs["init_t"], voxel_scale=SCALE,
                                      bbox_res=SIZE, distilled=[model] * S)
    return list(out) + list(model.weights)


RUNS = {"hand": _hand_run, "obj": _obj_run}


@pytest.fixture(scope="module")
def runs():
    """Each run untraced, then under a CPU profiler: {side: (outputs untraced, spans
    recorded untraced, outputs traced, spans, the profiler's ranges by name)}."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    g = torch.Generator().manual_seed(1)
    centre = torch.tensor([0.0, 0.0, 0.5])
    bank = torch.randn((P, 16), generator=g)
    bank[0] = 0.0
    shape_bank = torch.randn((P, 10), generator=g)
    shape_bank[0] = 0.0
    obj_bank = torch.randn((P, 6), generator=g)
    obj_bank[0] = 0.0
    inputs = {
        "model": _distill(), "pose_bank": bank, "shape_bank": shape_bank, "obj_bank": obj_bank,
        "frames": {
            "hand_points": torch.randn((S, T, N, 3), generator=g) * 0.03 + centre,
            "jittered_hand_kp": torch.randn((S, T, 21, 3), generator=g) * 0.03 + centre,
            "projection": torch.tensor([60.0, 60.0, 32.0, 24.0]).expand(S, T, 4),
            "gt_obj_pose": {"rotation": torch.eye(3).expand(S, T, 3, 3),
                            "translation": centre.reshape(3, 1).expand(S, T, 3, 1)}},
        "clouds": torch.randn((S, T, N, 3), generator=g) * 0.03,
        "init_r": torch.eye(3).expand(S, 3, 3), "init_t": torch.full((S, 3, 1), 0.002)}
    out = {}
    try:
        for side, run in RUNS.items():
            trace.clear()
            plain = run(inputs)
            plain_spans = trace.recorded()
            trace.clear()
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                traced = run(inputs)
            ranges = {}
            for e in prof.profiler.kineto_results.events():
                if e.device_type() == DeviceType.CPU and e.is_user_annotation():
                    ranges.setdefault(e.name(), []).append(
                        (e.start_ns(), e.start_ns() + e.duration_ns()))
            out[side] = (plain, plain_spans, traced, trace.recorded(), ranges)
    finally:
        torch.set_num_threads(threads)
        trace.clear()
    return out


def _tree(spans):
    """{(name, parent's name): count}."""
    by_id = {s.id: s.name for s in spans}
    tree = {}
    for s in spans:
        key = (s.name, by_id.get(s.parent))
        tree[key] = tree.get(key, 0) + 1
    return tree


WANT = {
    "hand": {("track.hand.init", None): 1,
             ("net.handtracknet", "track.hand.init"): 1,
             ("opt.hand_shape", "track.hand.init"): 1,
             ("opt.particle.iter", "opt.hand_shape"): SHAPE_SPEC.iterations,
             ("track.hand.frame", None): T,
             ("net.handtracknet", "track.hand.frame"): T,
             ("net.iknet", "track.hand.frame"): T,
             ("opt.hand_pose", "track.hand.frame"): T,
             ("opt.particle.iter", "opt.hand_pose"): T * POSE_SPEC.iterations,
             ("opt.particle.energy", "opt.particle.iter"):
                 SHAPE_SPEC.iterations + T * POSE_SPEC.iterations},
    "obj": {("sdf.distill", None): 1,
            ("track.obj.frame", None): T,
            ("opt.obj_pose", "track.obj.frame"): T,
            ("opt.particle.iter", "opt.obj_pose"): T * OBJ_SPEC.iterations,
            ("opt.particle.energy", "opt.particle.iter"): T * OBJ_SPEC.iterations},
}


def test_span_is_the_shared_noop_without_a_profiler():
    assert trace.span("track.hand.frame") is trace.OFF
    assert trace.span("net.iknet") is trace.OFF
    with trace.span("x") as s:
        assert s is None
    assert trace.recorded() == [] and trace.dropped() == 0


@pytest.mark.parametrize("side", sorted(RUNS))
def test_untraced_run_records_nothing(runs, side):
    assert runs[side][1] == []


@pytest.mark.parametrize("side", sorted(RUNS))
def test_traced_run_records_the_span_tree(runs, side):
    spans = runs[side][3]
    assert _tree(spans) == WANT[side]
    assert len({s.id for s in spans}) == len(spans)
    by_id = {s.id: s for s in spans}
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:   # a child lies within its parent
            parent = by_id[s.parent]
            assert parent.start_ns <= s.start_ns and s.end_ns <= parent.end_ns


@pytest.mark.parametrize("side", sorted(RUNS))
def test_traced_outputs_are_bitwise_the_untraced(runs, side):
    plain, _, traced, _, _ = runs[side]
    assert len(plain) == len(traced)
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)


@pytest.mark.parametrize("side", sorted(RUNS))
def test_spans_lie_on_the_profilers_clock(runs, side):
    """Each span against the profiler's range of the same name, in start order."""
    spans, ranges = runs[side][3], runs[side][4]
    for name in {s.name for s in spans}:
        mine = sorted((s.start_ns, s.end_ns) for s in spans if s.name == name)
        theirs = sorted(ranges.get(name, []))
        assert len(mine) == len(theirs), name
        for (s0, e0), (s1, e1) in zip(mine, theirs):
            assert abs(s0 - s1) < NS_PER_MS and abs(e0 - e1) < NS_PER_MS, (name, s0 - s1,
                                                                           e0 - e1)


def test_parents_are_kept_per_thread():
    """Two threads, each an outer span open while the other opens its inner one."""
    barrier = threading.Barrier(2, timeout=10)

    def work(i):
        with trace.span(f"outer{i}"):
            barrier.wait()
            with trace.span(f"inner{i}"):
                barrier.wait()

    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("main"):
            workers = [threading.Thread(target=work, args=(i,)) for i in range(2)]
            for w in workers:
                w.start()
            for w in workers:
                w.join(timeout=10)
    assert not any(w.is_alive() for w in workers)
    spans = {s.name: s for s in trace.recorded()}
    assert set(spans) == {"main", "outer0", "inner0", "outer1", "inner1"}
    assert spans["main"].parent is None
    for i in range(2):
        assert spans[f"outer{i}"].parent is None
        assert spans[f"inner{i}"].parent == spans[f"outer{i}"].id
        assert spans[f"inner{i}"].thread == spans[f"outer{i}"].thread
    assert len({spans[n].thread for n in ("main", "outer0", "outer1")}) == 3


def test_cap_counts_dropped_records(monkeypatch):
    monkeypatch.setattr(trace, "CAP", 3)
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(5):
            with trace.span(f"s{i}"):
                pass
    assert [s.name for s in trace.recorded()] == ["s0", "s1", "s2"]
    assert trace.dropped() == 2
    trace.clear()
    assert trace.recorded() == [] and trace.dropped() == 0
