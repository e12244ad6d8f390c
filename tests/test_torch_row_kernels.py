"""The designs of the FPS kernel (#1, csrc/fps.cu) and of the deterministic
scatter-add (#2b, csrc/gather_rows.cu), and the launch path they share with
the row gather (#2), held on the CPU.

The CUDA kernels run only on a card, so their reductions are emulated here in
numpy, step for step, at the launch layout csrc/fps.cu chooses and with each
kernel's constants read from its source:

- FPS: each thread's best (value, index) in select chains over its points,
  a warp's winner as the largest order-preserving key, then the lowest index
  among the lanes that hold it, and, above 1024 points, the block's winner
  from the warps' slots the same way. On tie-heavy and masked clouds it gives
  the plain version's indices and the JAX package's (index-exact: the same
  float32 arithmetic, ties to the lowest index).
- The scatter-add: the per-block bucketing (counts, a scan, a placement
  ranked within each warp) lists every row's hits in ascending s, so the
  float32 sum it drives is bitwise the plain version's on the CPU, and
  within the adjoint bound of tests/test_torch_gather.py (rtol 1e-6, atol
  1e-5) of JAX's `_gather_bwd_impl` in Pallas interpret mode. In bf16 the
  sum waits between chunks of positions in float32 and is rounded once.
- The launch path: `index_points` launches the gather directly where no
  gradient is recorded, and through the autograd Function (whose backward
  is the scatter-add) only where one is; the kernels' wrappers refuse a CPU
  tensor.

The `gpu`-marked tests at the end hold the kernels themselves on the card
and skip without one.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hotrack_tpu.ops import pointops as jops
from hotrack_tpu.ops.pallas.fps import farthest_point_sample_pallas
from hotrack_tpu.ops.pallas.gather_mm import _gather_bwd_impl
from hotrack_tpu_torch.ops import kernels
from hotrack_tpu_torch.ops import pointops as tops

ADJOINT_RTOL, ADJOINT_ATOL = 1e-6, 1e-5  # as tests/test_torch_gather.py holds the adjoint
INT_MAX = np.iinfo(np.int32).max


def _grid_cloud(rng, b, n, levels=6):
    """Tie-heavy cloud: integer grid points, each repeated up to four times
    (as chip_smoke.py's); with few levels, fewer distinct points than FPS
    steps, so that the later steps tie at distance 0 everywhere."""
    base = rng.randint(0, levels, size=(b, -(-n // 4), 3)).astype(np.float32)
    return np.ascontiguousarray(np.repeat(base, 4, axis=1)[:, :n][:, rng.permutation(n)])


# ---- FPS: the kernels' reduction, emulated ----

def _order_key(v: np.ndarray) -> np.ndarray:
    """csrc/fps.cu order_key: float32 -> uint32, order-preserving (no NaN)."""
    u = v.astype(np.float32).view(np.uint32)
    return np.where(u & np.uint32(0x80000000), ~u, u | np.uint32(0x80000000))


def _thread_best(d: np.ndarray):
    """Each thread's (value, k) over its points d (threads, P): up to four
    select chains, chain c over k = c mod C in ascending k with a strict '>',
    merged into chain 0 by value, then k."""
    t, p = d.shape
    c_n = min(p, 4)
    bv, bk = d[:, :c_n].copy(), np.tile(np.arange(c_n), (t, 1))
    for k in range(c_n, p):
        c = k % c_n
        better = d[:, k] > bv[:, c]
        bv[:, c] = np.where(better, d[:, k], bv[:, c])
        bk[:, c] = np.where(better, k, bk[:, c])
    for c in range(1, c_n):
        better = (bv[:, c] > bv[:, 0]) | ((bv[:, c] == bv[:, 0]) & (bk[:, c] < bk[:, 0]))
        bv[:, 0] = np.where(better, bv[:, c], bv[:, 0])
        bk[:, 0] = np.where(better, bk[:, c], bk[:, 0])
    return bv[:, 0], bk[:, 0]


def _warp_winner(keys: np.ndarray, idx: np.ndarray):
    """redux.sync max of the keys, then min of the indices of the lanes that
    hold it: (..., 32) -> (top, winner) (...,)."""
    top = keys.max(-1)
    return top, np.where(keys == top[..., None], idx, INT_MAX).min(-1)


def _fps_constants() -> dict:
    src = (kernels.CSRC_DIR / "fps.cu").read_text()
    return {name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
            for name in ("kWarpPoints", "kBlockThreads", "kRegisterPoints", "kMaxPoints",
                         "kGlobalThreads")}


def _fps_layout(n: int) -> tuple:
    """(points a thread, threads a cloud) that csrc/fps.cu's hotrack_fps
    launches for a cloud of n points."""
    k = _fps_constants()
    if n <= k["kWarpPoints"]:
        per = 1
        while 32 * per < n:
            per *= 2
        return per, 32
    if n > k["kMaxPoints"]:  # the global-memory kernel: a fixed block
        return -(-n // k["kGlobalThreads"]), k["kGlobalThreads"]
    for per in (4, 8, 16):
        threads = 32 * -(-n // (32 * per))
        if threads <= k["kBlockThreads"]:
            return per, threads
    return 32, 32 * -(-n // (32 * 32))


def fps_emulated(xyz: np.ndarray, npoint: int, mask=None) -> np.ndarray:
    """csrc/fps.cu step for step at its launch layout."""
    b, n, _ = xyz.shape
    per, threads = _fps_layout(n)
    out = np.zeros((b, npoint), np.int32)
    ids = np.arange(threads)[:, None] + threads * np.arange(per)[None, :]  # (T, P)
    real = ids < n
    for row in range(b):
        pts = xyz[row][np.minimum(ids, n - 1)]  # (T, P, 3)
        valid = np.ones(n, bool) if mask is None else mask[row]
        d = np.where(real, np.where(valid[np.minimum(ids, n - 1)], np.float32(1e10),
                                    np.float32(-1.0)), np.float32(-np.inf)).astype(np.float32)
        centre = xyz[row, 0]
        for it in range(1, npoint):
            dx, dy, dz = (pts[..., j] - centre[j] for j in range(3))
            dist = (dx * dx + dy * dy) + dz * dz  # numpy float32: each operation rounded
            d = np.minimum(d, dist)
            bv, bk = _thread_best(d)
            index = np.arange(threads) + threads * bk
            keys = _order_key(bv).reshape(-1, 32)
            top, win = _warp_winner(keys, index.reshape(-1, 32))
            if threads > 32:  # the block's slots, reduced by every warp alike
                pad = 32 - top.size
                top, win = _warp_winner(np.concatenate([top, np.zeros(pad, np.uint32)]),
                                        np.concatenate([win, np.full(pad, INT_MAX)]))
            far = int(np.asarray(win).reshape(-1)[0])
            out[row, it] = far
            centre = xyz[row, far]
    return out


FPS_EMULATED = [  # (name, B, N, npoint, cloud, masked): both kernels, every layout kind
    ("warp, 1 a lane", 2, 20, 12, "random", False),
    ("warp, 8 a lane, grid", 2, 256, 48, "grid", False),
    ("warp, 16 a lane, grid masked", 1, 512, 40, "grid", True),
    ("warp, 16 a lane, 27 distinct points", 1, 512, 64, "few", False),
    ("warp, 32 a lane (1024)", 1, 1024, 24, "random", True),
    ("block, 4 a thread (1025)", 1, 1025, 24, "grid", True),
    ("block, 4 a thread (1025), 27 distinct points", 1, 1025, 48, "few", False),
    ("block, 8 a thread (2560), point 0 invalid", 1, 2560, 20, "random", "seed_invalid"),
    ("global (14337), masked", 1, 14337, 12, "random", True),
    ("global (14400), 27 distinct points", 1, 14400, 40, "few", False),
]


@pytest.mark.parametrize("case", FPS_EMULATED, ids=[c[0] for c in FPS_EMULATED])
def test_fps_reduction_emulated_is_the_plain_version(case):
    _, b, n, npoint, cloud, masked = case
    rng = np.random.RandomState(n)
    xyz = {"grid": lambda: _grid_cloud(rng, b, n), "few": lambda: _grid_cloud(rng, b, n, 3),
           "random": lambda: (rng.randn(b, n, 3) * 0.05).astype(np.float32)}[cloud]()
    mask = None
    if masked:
        mask = rng.rand(b, n) > 0.4
        mask[:, 0] = masked != "seed_invalid"
    got = fps_emulated(xyz, npoint, mask)
    tmask = None if mask is None else torch.from_numpy(mask)
    want = tops._farthest_point_sample_torch(torch.from_numpy(xyz), npoint, tmask).numpy()
    np.testing.assert_array_equal(got, want)
    jmask = None if mask is None else jnp.asarray(mask)
    np.testing.assert_array_equal(
        got, np.asarray(jops._farthest_point_sample_xla(jnp.asarray(xyz), npoint, jmask)))
    if n <= 1025:  # the Pallas kernel in interpret mode, as test_torch_pointops.py runs it
        np.testing.assert_array_equal(got, np.asarray(farthest_point_sample_pallas(
            jnp.asarray(xyz), npoint, jmask, interpret=True)))
    if mask is not None:  # no invalid point is picked while a valid one is left
        for row in range(b):
            left = min(int(mask[row].sum()), npoint - 1)
            assert mask[row][got[row, 1:1 + left]].all()


def test_warp_winner_takes_the_first_maximal_index():
    """The two reductions pick the largest value, then the lowest index, with
    the ties spread over lanes and over a lane's points."""
    v = np.array([3.0, 7.0, 7.0, -1.0] * 8, np.float32)
    idx = np.arange(32)[::-1].copy()  # lanes hold descending indices
    top, win = _warp_winner(_order_key(v), idx)
    assert top == _order_key(np.float32(7.0)) and win == 1  # lanes 1, 2, 5, ..., 30 hold 30, 29, 26, ..., 1
    d = np.array([[5.0, 9.0, 9.0, 1.0, 9.0, 0.0, 9.0, 2.0, 9.0, 3.0]], np.float32)
    assert _thread_best(d)[1][0] == 1
    d = np.zeros((2, 16), np.float32)  # ties within one chain (k = 3 and 7) and across
    d[0, [3, 7]] = 9.0
    d[1, [6, 5, 13]] = 9.0
    assert _thread_best(d)[1].tolist() == [3, 5]
    keys = _order_key(np.array([-np.inf, -1.0, -0.5, 0.0, 1e-30, 1.0, 1e10], np.float32))
    assert (np.diff(keys.astype(np.int64)) > 0).all()


@pytest.mark.parametrize("n", [1, 31, 32, 33, 256, 512, 1000, 1024, 1025, 2048, 2049, 2560,
                               5120, 8192, 8193, 14336, 14337, 40000])
def test_fps_layout_covers_the_cloud(n):
    k = _fps_constants()
    per, threads = _fps_layout(n)
    assert per * threads >= n and threads % 32 == 0
    if n > k["kMaxPoints"]:  # every thread owns a point: none reduces an empty set
        assert threads == k["kGlobalThreads"] < n
    elif n <= k["kWarpPoints"]:
        assert threads == 32 and per in (1, 2, 4, 8, 16, 32) and (per == 1 or 16 * per < n)
    else:  # the block kernel: registers up to kRegisterPoints, the shared copy above
        assert threads <= k["kBlockThreads"]
        assert per in ((4, 8, 16) if n <= k["kRegisterPoints"] else (32,))
        assert k["kRegisterPoints"] == 16 * k["kBlockThreads"]


# ---- the scatter-add: the bucketing, emulated ----

def _scatter_constants() -> dict:
    src = (kernels.CSRC_DIR / "gather_rows.cu").read_text()
    return {name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
            for name in ("kScatterRows", "kScatterWarps", "kScatterChunk")}


def _bf16(x: np.ndarray) -> np.ndarray:
    """float32 -> bf16 (round to nearest even) -> float32."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).bfloat16().float().numpy()


def scatter_emulated(dout: np.ndarray, idx: np.ndarray, n: int, bf16: bool = False,
                     round_between_chunks: bool = False):
    """csrc/gather_rows.cu scatter_rows_add_kernel: returns (dsrc, the hits
    of every (batch, row) in the order the kernel adds them). dout holds
    float32 values; with `bf16` they are bf16 values, the sum is float32 and
    the last chunk rounds it to bf16 (an earlier chunk keeps it in the
    float32 scratch, or rounds it too with `round_between_chunks`, as a
    kernel that kept the sum in the output between chunks would)."""
    k = _scatter_constants()
    rows_per, warps, chunk = k["kScatterRows"], k["kScatterWarps"], k["kScatterChunk"]
    b, s, c = dout.shape
    out = np.zeros((b, n, c), np.float32)
    order = {}
    for bi in range(b):
        for r0 in range(0, n, rows_per):
            rows = min(rows_per, n - r0)
            for c0 in range(0, s, chunk):
                ln = min(chunk, s - c0)
                v = idx[bi, c0:c0 + ln]
                row_of = np.where((v >= r0) & (v < r0 + rows), v - r0, -1)
                seg = ((ln + warps - 1) // warps + 31) // 32 * 32
                counts = np.zeros((warps, rows_per), np.int64)
                for w in range(warps):
                    lo, hi = min(ln, w * seg), min(ln, w * seg + seg)
                    seg_rows = row_of[lo:hi]
                    np.add.at(counts[w], seg_rows[seg_rows >= 0], 1)
                total = counts.sum(0)
                start = np.concatenate([[0], np.cumsum(total)[:-1]])
                slot = start + np.concatenate([np.zeros((1, rows_per), np.int64),
                                               np.cumsum(counts, 0)[:-1]])
                hits = np.full(max(ln, 1), -1)
                for w in range(warps):
                    lo, hi = min(ln, w * seg), min(ln, w * seg + seg)
                    for base in range(lo, hi, 32):
                        lanes = row_of[base:min(base + 32, hi)]
                        for lane, r in enumerate(lanes):
                            if r < 0:
                                continue
                            rank = int((lanes[:lane] == r).sum())  # __match_any_sync rank
                            hits[slot[w, r] + rank] = c0 + base + lane
                        for r in np.unique(lanes[lanes >= 0]):
                            slot[w, r] += int((lanes == r).sum())
                for r in range(rows):
                    mine = hits[start[r]:start[r] + total[r]]
                    order.setdefault((bi, r0 + r), []).extend(mine.tolist())
                    acc = out[bi, r0 + r] if c0 > 0 else np.zeros(c, np.float32)
                    for at in mine:  # ascending s, one float32 addition after another
                        acc = acc + dout[bi, at]
                    last = c0 + ln == s
                    out[bi, r0 + r] = _bf16(acc) if bf16 and (last or round_between_chunks) \
                        else acc
    return out, order


SCATTER_CASES = [  # (name, B, N, C, S, distinct rows or None, out of range)
    ("path-like, two chunks", 2, 70, 12, 2500, None, False),
    ("7 distinct rows", 2, 40, 8, 700, 7, False),
    ("out-of-range indices", 2, 50, 6, 400, None, True),
]


@pytest.mark.parametrize("case", SCATTER_CASES, ids=[c[0] for c in SCATTER_CASES])
def test_scatter_bucketing_emulated_sums_in_ascending_s(case):
    _, b, n, c, s, hi, oor = case
    rng = np.random.RandomState(s)
    idx = rng.randint(-3 if oor else 0, (n + 3) if oor else (hi or n), (b, s))
    dout = rng.randn(b, s, c).astype(np.float32)
    got, order = scatter_emulated(dout, idx, n)
    for (bi, r), hits in order.items():  # every row's hits, in ascending s
        assert hits == np.flatnonzero(idx[bi] == r).tolist()
    keep = (idx >= 0) & (idx < n)
    want = tops._scatter_rows_add_torch(  # out-of-range terms as +0 into row 0: no change
        torch.from_numpy(dout * keep[..., None]), torch.from_numpy(np.where(keep, idx, 0)), n)
    np.testing.assert_array_equal(got, want.numpy())
    unselected = np.ones((b, n), bool)
    for bi in range(b):
        unselected[bi, idx[bi][keep[bi]]] = False
    assert (got[unselected] == 0).all()
    jax_dsrc = np.asarray(_gather_bwd_impl(jnp.asarray(idx.astype(np.int32)),
                                           jnp.asarray(dout), n, interpret=True))
    np.testing.assert_allclose(got, jax_dsrc, rtol=ADJOINT_RTOL, atol=ADJOINT_ATOL)


def test_scatter_bf16_sum_is_rounded_once_across_chunks():
    """bf16 above one chunk of positions (sa2's backward has S = 4096): the
    sum waits between chunks in float32, so the output is the float32 sum
    rounded once, bitwise the plain version in bf16 on the CPU. Rounding it
    at the chunk boundary as well would differ on these inputs."""
    chunk = _scatter_constants()["kScatterChunk"]
    b, n, c, s = 2, 48, 8, chunk + 900
    rng = np.random.RandomState(21)
    idx = rng.randint(0, n, (b, s))
    dout = _bf16(rng.randn(b, s, c))
    got, _ = scatter_emulated(dout, idx, n, bf16=True)
    want = tops._scatter_rows_add_torch(torch.from_numpy(dout).bfloat16(),
                                        torch.from_numpy(idx), n)
    assert want.dtype == torch.bfloat16
    np.testing.assert_array_equal(got, want.float().numpy())
    twice, _ = scatter_emulated(dout, idx, n, bf16=True, round_between_chunks=True)
    assert (twice != got).any()


# ---- the launch path ----

@pytest.fixture
def gather_apply_calls(monkeypatch):
    calls = []
    real = tops._GatherRows.apply

    def spy(*args):
        calls.append(args)
        return real(*args)

    monkeypatch.setattr(tops._GatherRows, "apply", spy)
    return calls


def _points_and_idx(seed=12, b=3, n=40, c=6, shape=(5, 4)):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, n, c).astype(np.float32),
            rng.randint(0, n, (b, *shape)).astype(np.int64))


def test_index_points_under_inference_mode_matches_jax(gather_apply_calls):
    pts, idx = _points_and_idx()
    with torch.inference_mode():
        got = tops.index_points(torch.from_numpy(pts), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.take_along_axis(
        jnp.asarray(pts), jnp.asarray(idx).reshape(3, -1)[..., None], axis=1)).reshape(
            3, 5, 4, 6))
    assert gather_apply_calls == []  # launched directly


@pytest.mark.parametrize("mode", ["no_grad", "points need none"])
def test_index_points_launches_directly_without_a_gradient(gather_apply_calls, mode):
    pts, idx = _points_and_idx(13)
    tp = torch.from_numpy(pts).requires_grad_(mode == "no_grad")
    with torch.no_grad() if mode == "no_grad" else torch.enable_grad():
        got = tops.index_points(tp, torch.from_numpy(idx).int())
    assert gather_apply_calls == [] and not got.requires_grad
    np.testing.assert_array_equal(got.numpy(), np.asarray(jops.index_points(
        jnp.asarray(pts), jnp.asarray(idx))))


def test_index_points_records_the_gradient_through_the_function(gather_apply_calls):
    pts, idx = _points_and_idx(14)
    tp = torch.from_numpy(pts).requires_grad_(True)
    cot = torch.from_numpy(np.random.RandomState(15).randn(3, 5, 4, 6).astype(np.float32))
    (tops.index_points(tp, torch.from_numpy(idx)) * cot).sum().backward()
    assert len(gather_apply_calls) == 1
    want = tops._scatter_rows_add_torch(cot.reshape(3, 20, 6), torch.from_numpy(idx).reshape(3, 20),
                                        40)
    assert torch.equal(tp.grad, want)


WRAPPERS = {
    "fps_cuda": lambda: kernels.fps_cuda(torch.zeros((1, 8, 3)), 4),
    "gather_rows_cuda": lambda: kernels.gather_rows_cuda(
        torch.zeros((1, 8, 3)), torch.zeros((1, 4), dtype=torch.int64)),
    "scatter_rows_add_cuda": lambda: kernels.scatter_rows_add_cuda(
        torch.zeros((1, 4, 3)), torch.zeros((1, 4), dtype=torch.int64), 8),
}


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_kernel_wrappers_refuse_cpu_tensors(name):
    """A wrapper raises on a CPU tensor before it reads a device or a stream
    (a CPU-only torch has neither reader) or builds anything."""
    with pytest.raises(ValueError, match="CUDA tensor"):
        WRAPPERS[name]()


# ---- the kernels on the card ----

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: csrc/fps.cu and csrc/gather_rows.cu run only on the card")
    return torch.device("cuda")


FPS_CARD = [(1, 512, 256, False), (4, 512, 256, True), (32, 256, 128, False),
            (4, 1024, 200, False), (4, 1024, 200, True), (4, 1025, 200, False),
            (4, 1025, 200, True), (32, 2560, 512, True), (2, 8192, 64, True),
            (2, 8193, 64, True), (1, 14336, 40, True), (1, 14337, 40, True),
            (2, 16384, 64, False), (140, 200, 50, False)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", FPS_CARD, ids=lambda s: "x".join(map(str, s)))
def test_fps_kernel_boundaries_and_batches(cuda_device, shape):
    b, n, npoint, masked = shape
    rng = np.random.RandomState(n + b)
    xyz = torch.from_numpy(_grid_cloud(rng, b, n) if n % 2 == 0 else
                           (rng.randn(b, n, 3) * 0.05).astype(np.float32)).to(cuda_device)
    mask = torch.from_numpy(rng.rand(b, n) > 0.3).to(cuda_device) if masked else None
    got = kernels.fps_cuda(xyz, npoint, mask)
    again = kernels.fps_cuda(xyz, npoint, mask)
    want = tops._farthest_point_sample_torch(xyz, npoint, mask)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(got, again)


@pytest.mark.gpu
def test_fps_kernel_refuses_clouds_above_capacity(cuda_device):
    """Above the shared copy's capacity the launch needs the running minima's
    scratch, which fps_cuda allocates: without it the entry point refuses the
    cloud (cudaErrorInvalidValue), with it the cloud is sampled."""
    n = _fps_constants()["kMaxPoints"] + 1
    xyz = torch.from_numpy((np.random.RandomState(3).randn(1, n, 3) * 0.05)
                           .astype(np.float32)).to(cuda_device)
    lib = kernels._load("fps", kernels._bind_fps)
    assert lib.hotrack_fps_scratch(1, n) == n and lib.hotrack_fps_scratch(1, n - 1) == 0
    out = torch.empty((1, 8), dtype=torch.int32, device=cuda_device)
    assert lib.hotrack_fps(xyz.data_ptr(), None, None, out.data_ptr(), 1, n, 8,
                           torch.cuda.current_stream().cuda_stream) == 1
    got = kernels.fps_cuda(xyz, 8)
    assert torch.equal(got, tops._farthest_point_sample_torch(xyz, 8))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(32, 512, 384, 1344, None, "f32"),
                                   (32, 256, 64, 4096, None, "f32"),
                                   (4, 512, 384, 1344, 7, "f32"), (3, 100, 5, 2500, None, "f32"),
                                   (32, 256, 64, 4096, None, "bf16"),
                                   (3, 100, 6, 2500, None, "bf16")],
                         ids=lambda s: "x".join(map(str, s)))
def test_scatter_kernel_is_bitwise_the_cpu_plain_version(cuda_device, shape):
    b, n, c, s, hi, dtype = shape
    rng = np.random.RandomState(s)
    dout = torch.from_numpy(rng.randn(b, s, c).astype(np.float32)).to(
        {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]).to(cuda_device)
    for itype in (torch.int64, torch.int32):
        idx = torch.from_numpy(rng.randint(0, hi or n, (b, s))).to(itype).to(cuda_device)
        got = kernels.scatter_rows_add_cuda(dout, idx, n)
        again = kernels.scatter_rows_add_cuda(dout, idx, n)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        assert torch.equal(got.cpu(), tops._scatter_rows_add_torch(dout.cpu(), idx.cpu(), n))
        if hi is not None:
            assert bool((got[:, hi:] == 0).all())


@pytest.mark.gpu
def test_kernels_launch_on_the_callers_stream(cuda_device):
    side = torch.cuda.Stream()
    pts = torch.randn(2, 64, 32, device=cuda_device)
    idx = torch.randint(0, 64, (2, 100), device=cuda_device)
    torch.cuda.synchronize()
    with torch.cuda.stream(side):
        assert torch._C._cuda_getCurrentRawStream(torch.cuda.current_device()) == \
            side.cuda_stream
        with torch.inference_mode():
            got = tops.index_points(pts, idx)
        sums = kernels.scatter_rows_add_cuda(got, idx, 64)
    side.synchronize()
    assert torch.equal(got, tops._gather_rows_torch(pts, idx))
    assert torch.equal(sums.cpu(), tops._scatter_rows_add_torch(got.cpu(), idx.cpu(), 64))
    assert torch._C._cuda_getCurrentRawStream(torch.cuda.current_device()) == \
        torch.cuda.current_stream().cuda_stream
