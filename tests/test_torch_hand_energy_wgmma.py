"""The fused hand energy kernel (#6, csrc/hand_energy.cu) on the wgmma core of
csrc/sdf_mlp_wgmma.cuh, held on the CPU.

The kernel runs the persistent walk that it shares with the SDF MLP kernel
(#3, csrc/sdf_mlp.cu): items are 128-point rounds, a block walks items b,
b + grid, ...; each consumer lane reads its two rows a round ahead, lanes
0-15 of a warp store the warp's 16 sdf values, and the producer
warpgroup's three other warps store the round's hits. None of that runs
here, so the walk is modelled in numpy with the constants read from the
header and checked against the sources' own loop headers:

- every vertex's sdf and hit are stored exactly once, by a lane that holds
  that vertex's value, and nothing past the last vertex, for counts below a
  round, about a round and at the hand path's 5120 x 778 vertices, on a grid
  of one block, a few and an H100's 132 (and, for the sdf, with several
  sequences, as #3b walks them);
- the wrapper hands the kernel `PackedSDF.wg`, the buffer of the wgmma core
  (a spy on the launch), and with compute_dtype bf16 `PackedSDF.wg16` to the
  bf16 instantiation, which walks the same items.

The layout of `PackedSDF.wg` and the 3xTF32 arithmetic on it are held in
test_torch_sdf_wgmma_layout.py; the kernel itself on the card
(`chip_smoke.py`, the `gpu` tests of test_torch_hand_kernels.py).
"""

import re

import numpy as np
import pytest
import torch

from hotrack_tpu_torch.ops import hand_energy, kernels, mask_lookup, sdf_mlp
from hotrack_tpu_torch.utils.convert import distilled_from_numpy
from torch_sdf_models import model_arrays


def _constants() -> dict:
    """Every `constexpr int` of the header, evaluated in order (C's integer
    division)."""
    src = (kernels.CSRC_DIR / "sdf_mlp_wgmma.cuh").read_text()
    out = {}
    for name, expr in re.findall(r"constexpr (?:int|uint32_t) (\w+) = ([^;]+);", src):
        out[name] = int(eval(expr.replace("/", "//"), {}, dict(out)))  # noqa: S307
    return out


K = _constants()
ROUND = K["kRoundPoints"]
ASIDE = K["kAsideThreads"]
CONSUMER_WARPS = K["kConsumerWarps"]


def test_the_model_follows_the_sources():
    """The loop headers and index expressions the walk below models."""
    header = (kernels.CSRC_DIR / "sdf_mlp_wgmma.cuh").read_text()
    for line in ("const long long row = (item - s * rounds) * kRoundPoints + warp * 16 + g;",
                 "job.load(s, row + 8, nb);",
                 "const long long base = (item - s * rounds) * kRoundPoints + warp * 16;",
                 "const float lo = __shfl_sync(0xffffffffu, sdf.x, 4 * (lane & 7));",
                 "const float hi = __shfl_sync(0xffffffffu, sdf.y, 4 * (lane & 7));",
                 "if (lane < 16 && base + lane < job.m) job.store(s, base + lane, "
                 "lane < 8 ? lo : hi);",
                 # groups of span() rounds a block are a job's choice (kGroups); #3
                 # and #6 keep the default, so a block walks items b, b + grid, ...
                 "static constexpr bool kGroups = false;",
                 "return J::kGroups ? static_cast<long long>(blockIdx.x) * span : blockIdx.x;",
                 "if constexpr (!J::kGroups) return item + gridDim.x;",
                 "for (long long item = first(); item < items; item = after(item)) {",
                 "const int t = static_cast<int>(threadIdx.x) - 32 * (kProducerWarp + 1);",
                 "job.aside(s, item - s * rounds, t);"):
        assert line in header, line
    src = (kernels.CSRC_DIR / "hand_energy.cu").read_text()
    assert "struct Vertices : wg::Job {" in src   # the defaults: no stage, no sums, span 1
    assert "for (int v = t; v < wg::kRoundPoints; v += wg::kAsideThreads) {" in src
    assert "const long long row = round * wg::kRoundPoints + v;" in src
    assert "wg::walk<kBf16>(job, smem, packed, 0, rounds, rounds, shape, pinned, ring);" in src
    assert "const long long rounds = (m + wg::kRoundPoints - 1) / wg::kRoundPoints;" in src
    # the producer's warpgroup: one copying warp after the consumers, the rest do the aside
    assert K["kProducerWarp"] == CONSUMER_WARPS
    assert ASIDE == K["kThreads"] - 32 * (CONSUMER_WARPS + 1) > 0


def _blocks(items: int, grid: int) -> list:
    """The items each block of the persistent grid walks, in its order."""
    return [np.arange(b, items, grid) for b in range(min(items, grid))]


def _sdf_stores(m: int, n_seq: int, grid: int) -> np.ndarray:
    """How often each of the n_seq x m outputs is stored by the consumer
    lanes, checking that the storing lane stores the value of the row its
    source lane read."""
    rounds = -(-m // ROUND)
    count = np.zeros(n_seq * m, np.int64)
    lane = np.arange(32)
    for items in _blocks(rounds * n_seq, grid):
        s, r = items // rounds, items % rounds
        for warp in range(CONSUMER_WARPS):
            base = r * ROUND + warp * 16                                    # (items,)
            g = lane >> 2
            row_a = base[:, None] + g[None, :]                              # lane's fetched rows
            row_b = row_a + 8
            store = lane[:16]
            src = 4 * (store & 7)                                           # the shuffle's source
            value_row = np.where(store < 8, row_a[:, src], row_b[:, src])  # the row it holds
            at = base[:, None] + store[None, :]
            assert np.array_equal(value_row, at)
            ok = at < m
            np.add.at(count, (s[:, None] * m + at)[ok], 1)
    return count


def _hit_stores(m: int, grid: int) -> np.ndarray:
    """How often each hit is stored by the aside threads."""
    rounds = -(-m // ROUND)
    count = np.zeros(m, np.int64)
    for items in _blocks(rounds, grid):
        for t in range(ASIDE):
            rows = items[:, None] * ROUND + np.arange(t, ROUND, ASIDE)[None, :]
            np.add.at(count, rows[rows < m], 1)
    return count


@pytest.mark.parametrize("m,grid", [(1, 1), (63, 7), (127, 132), (128, 1), (129, 7),
                                    (1000, 132), (1000, 1), (5120 * 778, 132)])
def test_walk_stores_every_vertex_once(m, grid):
    assert np.array_equal(_sdf_stores(m, 1, grid), np.ones(m, np.int64))
    assert np.array_equal(_hit_stores(m, grid), np.ones(m, np.int64))


@pytest.mark.parametrize("m,n_seq,grid", [(37, 3, 2), (300, 4, 132), (129, 2, 1)])
def test_walk_of_several_sequences_stores_each_once(m, n_seq, grid):
    """#3b's walk: a round never spans two sequences."""
    assert np.array_equal(_sdf_stores(m, n_seq, grid), np.ones(n_seq * m, np.int64))


class _Lib:
    """A stand-in for the built library: records the launch's arguments."""

    def __init__(self):
        self.calls = []

    def hotrack_hand_energy(self, *args):
        self.calls.append(args)
        return 0

    def hotrack_hand_energy_bf16(self, *args):
        self.calls.append(("bf16", *args))
        return 0


@pytest.mark.parametrize("shape", [(3, 5), (130,)])
def test_hand_energy_wrapper_launches_on_the_wgmma_layout(monkeypatch, shape):
    """A spy on the launch: the packed model's buffer is `PackedSDF.wg`, with
    its widths and the vertex count; the device checks are stood in for,
    since there is no card here."""
    lib = _Lib()
    monkeypatch.setattr(kernels, "_check_f32", lambda *a: None)
    monkeypatch.setattr(kernels, "_check_frame", lambda *a: 0)
    monkeypatch.setattr(kernels, "_check_mask", lambda name, mask, hw, like: (*hw, 0))
    monkeypatch.setattr(kernels, "_load", lambda name, bind: lib)

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
    model = distilled_from_numpy(model_arrays(4, widths=(21, 32, 48)))
    packed = sdf_mlp.pack_distilled(model)
    mask = mask_lookup.pack_mask(torch.zeros((6, 9), dtype=torch.bool))
    frame = torch.zeros(16)
    pts = torch.ones((*shape, 3))
    before = kernels.launch_counts["hand_energy"]
    sdf, hit = kernels.hand_energy_cuda(pts, frame, mask, (6, 9), packed)
    assert kernels.launch_counts["hand_energy"] == before + 1
    assert tuple(sdf.shape) == tuple(hit.shape) == shape
    (call,) = lib.calls
    assert call[:6] == (pts.data_ptr(), frame.data_ptr(), mask.data_ptr(), packed.wg.data_ptr(),
                        sdf.data_ptr(), hit.data_ptr())
    assert call[6:11] == (pts.numel() // 3, 6, 9, packed.n_freqs, len(packed.widths) - 1)
    assert list(call[11]) == list(packed.widths)
    assert not hasattr(packed, "packed")   # the float32 FMA core's layout is gone


def test_hand_energy_wrapper_launches_bf16_on_the_bf16_layout(monkeypatch):
    """compute_dtype bf16: the bf16 entry point on `PackedSDF.wg16`, counted
    apart; never the 3xTF32 one."""
    lib = _Lib()
    monkeypatch.setattr(kernels, "_check_f32", lambda *a: None)
    monkeypatch.setattr(kernels, "_check_frame", lambda *a: 0)
    monkeypatch.setattr(kernels, "_check_mask", lambda name, mask, hw, like: (*hw, 0))
    monkeypatch.setattr(kernels, "_load", lambda name, bind: lib)

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
    packed = sdf_mlp.pack_distilled(distilled_from_numpy(model_arrays(4, widths=(21, 32, 48))))
    mask = mask_lookup.pack_mask(torch.zeros((6, 9), dtype=torch.bool))
    before = dict(kernels.launch_counts)
    kernels.hand_energy_cuda(torch.ones((130, 3)), torch.zeros(16), mask, (6, 9), packed,
                             compute_dtype=torch.bfloat16)
    (call,) = lib.calls
    assert call[0] == "bf16" and call[4] == packed.wg16.data_ptr()
    assert kernels.launch_counts["hand_energy_bf16"] == before["hand_energy_bf16"] + 1
    assert kernels.launch_counts["hand_energy"] == before["hand_energy"]


def test_hand_energy_dispatch_keeps_the_plain_version_on_the_cpu():
    """A CPU tensor takes the plain version, never the wrapper."""
    model = distilled_from_numpy(model_arrays(5))
    mask = mask_lookup.pack_mask(torch.zeros((4, 4), dtype=torch.bool))
    frame = hand_energy.hand_frame(torch.eye(3), torch.zeros(3), 4.0, 4.0, 2.0, 2.0)
    pts = torch.tensor([[[0.01, 0.02, 0.4], [0.0, 0.0, 0.5]]])
    before = kernels.launch_counts["hand_energy"]
    sdf, hit = hand_energy.fused_hand_energy(model, mask, frame, pts, (4, 4))
    assert kernels.launch_counts["hand_energy"] == before
    want = hand_energy._hand_energy_torch(model, mask, frame, pts, (4, 4))
    assert torch.equal(sdf, want[0]) and torch.equal(hit, want[1])
    with pytest.raises(ValueError, match="CUDA"):
        kernels.hand_energy_cuda(pts, frame, mask, (4, 4), sdf_mlp.pack_distilled(model))
