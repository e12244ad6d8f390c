"""The wgmma layout of the distilled-SDF MLP kernel (#3 and #3b,
csrc/sdf_mlp.cu on csrc/sdf_mlp_wgmma.cuh), held on the CPU.

The kernel reads its weights as tiles of shared memory through wgmma matrix
descriptors, streams the tiles it cannot keep through a ring of slots, and
takes its A fragments from registers. None of that runs here, so it is
modelled in numpy with the constants read from the header:

- the packed buffer (`PackedSDF.wg`), copied tile by tile into shared memory
  as the producer warp copies it (pinned tiles once, the rest through the
  ring in the order the consumers take them), and read back through the
  descriptor's addressing (no swizzle, core matrices kLbo apart along K and
  kSbo apart along N), gives the model's weights split by `tf32_split`,
  bitwise;
- a walk of one round (128 points, two warpgroups of four warps) through that
  shared memory, with each lane's A fragments and accumulators where the
  instruction puts them, computes the hidden layers of the 3xTF32 emulation
  (`ops/tf32.raw_sdf_mlp_3xtf32`) bitwise and its sdf to the output layer's
  float32 rounding.

The kernel itself is held on the card (`chip_smoke.py`, the `gpu` tests of
test_torch_sdf_kernels.py and test_torch_batched_kernels_gpu.py).
"""

import re

import numpy as np
import pytest
import torch

from hotrack_tpu_torch.ops import kernels, sdf_mlp, tf32
from torch_sdf_models import model_arrays
from hotrack_tpu_torch.utils.convert import distilled_from_numpy

WIDTHS = [((21, 128, 128, 128), None), ((15, 32, 48), [1.0, 2.5]), ((9, 128), None),
          ((39, 128, 128, 128, 128), None)]
SMEM_LIMIT = 232_448   # dynamic shared memory a block may opt into on an H100


def _constants() -> dict:
    src = (kernels.CSRC_DIR / "sdf_mlp_wgmma.cuh").read_text()
    return {name: int(re.search(rf"constexpr (?:int|uint32_t) {name} = (\d+);", src).group(1))
            for name in ("kRing", "kLbo", "kSbo", "kUnits", "kConsumerWarps")}


K = _constants()
TILE_BYTES = 8 * K["kUnits"] * 4


def _model(widths, freqs, seed):
    return distilled_from_numpy(model_arrays(seed, widths=widths, freqs=freqs))


def _plan(tiles: int, ks0: int, limit: int = SMEM_LIMIT) -> tuple:
    """wg::plan: (pinned, ring) for a net of `tiles` tiles."""
    bars = lambda ring: (8 * (2 * ring + 1) + 15) & ~15  # noqa: E731
    if tiles * TILE_BYTES + bars(0) <= limit:
        return tiles, 0
    pinned = (limit - K["kRing"] * TILE_BYTES - bars(K["kRing"])) // TILE_BYTES
    assert pinned >= 2 * ks0
    return pinned, K["kRing"]


def _geometry(packed: sdf_mlp.PackedSDF) -> dict:
    n_hidden = len(packed.widths) - 1
    ks0 = (3 * packed.n_freqs + 6) // 4   # 3F angles and 3 coordinates, 4 a k-step
    header = 4 + packed.n_freqs + -packed.n_freqs % 4
    return {"n_hidden": n_hidden, "ks0": ks0, "header": header,
            "tiles_at": header + 128 * n_hidden + 132,
            "tiles": 2 * (ks0 + 16 * (n_hidden - 1))}


class SharedMemory:
    """A block's shared memory as the producer fills it for `rounds` rounds:
    the pinned tiles once, the rest through the ring; `take(t)` returns the
    bytes of the round's tile t where the consumer's `acquire` finds them."""

    def __init__(self, buf: np.ndarray, geo: dict):
        self.tiles = [buf[geo["tiles_at"] + 1024 * t:geo["tiles_at"] + 1024 * (t + 1)]
                      for t in range(geo["tiles"])]
        self.pinned, self.ring = _plan(geo["tiles"], geo["ks0"])
        self.mem = np.zeros((self.pinned + self.ring) * 1024, np.float32)
        for t in range(self.pinned):
            self.mem[1024 * t:1024 * (t + 1)] = self.tiles[t]
        self.issued = self.taken = 0
        self.held = {}   # ring slot -> the tile the producer put there

    def _produce(self):
        # the producer runs at most `ring` tiles ahead of the consumers
        streamed = len(self.tiles) - self.pinned
        while self.issued < self.taken + self.ring:
            slot = self.issued % self.ring
            t = self.pinned + self.issued % streamed
            at = (self.pinned + slot) * 1024
            self.mem[at:at + 1024] = self.tiles[t]
            self.held[slot] = t
            self.issued += 1

    def take(self, t: int) -> np.ndarray:
        if t < self.pinned:
            return self.mem[1024 * t:1024 * (t + 1)]
        self._produce()
        slot = self.taken % self.ring
        assert self.held[slot] == t, "the ring hands the consumers another tile"
        self.taken += 1
        at = (self.pinned + slot) * 1024
        return self.mem[at:at + 1024].copy()


def _read_b(tile: np.ndarray) -> np.ndarray:
    """The (8 k-slots, 128 units) B operand a descriptor of this tile
    describes: unit n, k-slot c at byte (n // 8) kSbo + (c // 4) kLbo
    + (n % 8) 16 + (c % 4) 4."""
    n = np.arange(128)[None, :]
    c = np.arange(8)[:, None]
    byte = (n // 8) * K["kSbo"] + (c // 4) * K["kLbo"] + (n % 8) * 16 + (c % 4) * 4
    return tile[byte // 4]


def _layer_tiles(geo: dict, l: int) -> tuple:
    """(first tile, k-steps) of hidden layer l."""
    if l == 0:
        return 0, geo["ks0"]
    return 2 * (geo["ks0"] + 16 * (l - 1)), 16


@pytest.mark.parametrize("widths,freqs", WIDTHS)
def test_wgmma_layout_unpacks_to_the_model_bitwise(widths, freqs):
    model = _model(widths, freqs, 21)
    packed = sdf_mlp.pack_distilled(model)
    geo = _geometry(packed)
    buf = packed.wg.numpy()
    assert packed.wg.dtype == torch.float32 and buf.size == geo["tiles_at"] + 1024 * geo["tiles"]
    assert geo["tiles_at"] % 4 == 0   # 16-byte aligned for the bulk copies
    assert buf[0] == model.scale and buf[1] == model.clamp
    assert np.array_equal(buf[4:4 + packed.n_freqs], model.freqs.numpy())
    dims = [*widths, 1]
    for l in range(geo["n_hidden"]):
        bias = buf[geo["header"] + 128 * l:geo["header"] + 128 * (l + 1)]
        assert np.array_equal(bias[:dims[l + 1]], model.biases[l].numpy()) \
            and not bias[dims[l + 1]:].any()
    wout = buf[geo["header"] + 128 * geo["n_hidden"]:geo["tiles_at"]]
    assert np.array_equal(wout[:dims[-2]], model.weights[-1][:, 0].numpy())
    assert wout[128] == model.biases[-1] and not wout[dims[-2]:128].any()
    smem = SharedMemory(buf, geo)
    for rnd in range(2):   # the second round's streamed tiles come round the ring again
        for l in range(geo["n_hidden"]):
            first, n_ks = _layer_tiles(geo, l)
            rows = sdf_mlp._wg_rows(l, widths).numpy()
            assert rows.size == 8 * n_ks
            big = np.zeros((129, 128), np.float32)   # row 128: where the zero rows land
            small = np.zeros((129, 128), np.float32)
            for ks in range(n_ks):
                big[rows[8 * ks:8 * ks + 8]] = _read_b(smem.take(first + 2 * ks))
                small[rows[8 * ks:8 * ks + 8]] = _read_b(smem.take(first + 2 * ks + 1))
            assert not big[-1].any() and not small[-1].any()
            w = model.weights[l]
            want_big, want_small = tf32.tf32_split(w)
            assert np.array_equal(big[:w.shape[0], :w.shape[1]], want_big.numpy())
            assert np.array_equal(small[:w.shape[0], :w.shape[1]], want_small.numpy())
            assert not big[w.shape[0]:].any() and not big[:, w.shape[1]:].any()
            if l == 0:   # every feature once; a sine and its cosine share a lane
                assert sorted(rows[rows >= 0].tolist()) == list(range(widths[0]))
                pairs = rows.reshape(-1, 2, 4)
                sines = pairs[:, 0][pairs[:, 1] >= 0]
                assert np.array_equal(pairs[:, 1][pairs[:, 1] >= 0],
                                      sines + 3 * packed.n_freqs)
    if widths == (21, 128, 128, 128):   # the shipped net: 48 of its 70 tiles pinned
        assert (smem.pinned, smem.ring, geo["tiles"]) == (48, 8, 70)
    two = sdf_mlp.pack_distilled_batched([model, model])
    assert two.wg.shape == (2, buf.size) and torch.equal(two.wg[1], packed.wg)


# -- a walk of one round of the kernel ---------------------------------------

LANES = np.arange(32)
G, T = LANES // 4, LANES % 4


def _split(x: np.ndarray) -> tuple:
    big, small = tf32.tf32_split(torch.from_numpy(np.ascontiguousarray(x, np.float32)))
    return big.numpy(), small.numpy()


def _a_matrix(frags: np.ndarray) -> np.ndarray:
    """The 64 x 8 A operand of one k-step from the warpgroup's fragments
    (4 warps, 32 lanes, 4 words): a0 row g col t, a1 row g + 8 col t, a2 row g
    col t + 4, a3 row g + 8 col t + 4, warp w's rows 16 w on."""
    a = np.zeros((64, 8), frags.dtype)
    for w in range(4):
        r = 16 * w + G
        a[r, T], a[r + 8, T], a[r, T + 4], a[r + 8, T + 4] = (frags[w, :, i] for i in range(4))
    return a


def _accumulators(d: np.ndarray) -> np.ndarray:
    """The warpgroup's 64 x 128 sums as each lane holds them: (4 warps, 32
    lanes, 64), d[4 j + i] = row g + 8 (i // 2), unit 8 j + 2 t + i % 2."""
    acc = np.zeros((4, 32, 64), d.dtype)
    for w in range(4):
        for j in range(16):
            for i in range(4):
                acc[w, :, 4 * j + i] = d[16 * w + G + 8 * (i // 2), 8 * j + 2 * T + i % 2]
    return acc


def _walk(packed: sdf_mlp.PackedSDF, pts: np.ndarray) -> tuple:
    """One round of 128 points (two warpgroups) through `packed.wg` as the
    kernel reads it. Returns (each hidden layer's ReLU outputs (128, 128) in
    unit order, the clamped sdf (128,))."""
    buf = packed.wg.numpy()
    geo = _geometry(packed)
    smem = SharedMemory(buf, geo)
    clamp = buf[1]
    # features as the plain version computes them (the card's sinf / cosf are
    # its own), placed by column: x | sin axis-major frequency-minor | cos | 0
    feats = np.zeros((128, 129), np.float32)   # column 128: the zero rows' feature
    feats[:, :packed.widths[0]] = sdf_mlp.fourier_features(
        torch.from_numpy(pts), torch.from_numpy(buf[4:4 + packed.n_freqs]),
        torch.tensor(buf[0])).numpy()
    feats = feats[:, sdf_mlp._wg_rows(0, packed.widths).numpy()]     # in k-slot order
    # layer 0's fragments: lane (g, t) computes features 8 ks + t and + 4 of its rows
    frags = [np.stack([np.stack([feats[64 * h + 16 * w + G, 8 * ks + T],
                                 feats[64 * h + 16 * w + G + 8, 8 * ks + T],
                                 feats[64 * h + 16 * w + G, 8 * ks + T + 4],
                                 feats[64 * h + 16 * w + G + 8, 8 * ks + T + 4]], -1)
                       for w in range(4)]) for h in range(2) for ks in range(geo["ks0"])]
    frags = np.stack(frags).reshape(2, geo["ks0"], 4, 32, 4)             # (wg, ks, warp, lane, i)
    hidden, acc = [], None
    k = np.arange(64)
    units = 8 * (k // 4)[None, :] + 2 * T[:, None] + k % 2                 # (lane, 64): d's unit
    dims = [*packed.widths, 1]
    for l in range(geo["n_hidden"]):
        first, n_ks = _layer_tiles(geo, l)
        # both warpgroups read the same tiles; the round's A operand is theirs stacked
        b = np.concatenate([np.stack([_read_b(smem.take(first + 2 * ks)),
                                      _read_b(smem.take(first + 2 * ks + 1))])
                            for ks in range(n_ks)], 1)                     # (big / small, K, 128)
        a = np.concatenate([np.concatenate([_a_matrix(frags[h, ks]) for ks in range(n_ks)], 1)
                            for h in range(2)])                            # (128, K)
        # k-slot j of the layer holds input row rows[j]: back to the model's order
        rows = sdf_mlp._wg_rows(l, packed.widths).numpy()
        a_model, b_model = np.zeros((128, 129), a.dtype), np.zeros((2, 129, 128), b.dtype)
        a_model[:, rows], b_model[:, rows] = a, b
        d = np.zeros((128, 128), np.float32)
        d[:, :dims[l + 1]] = _product(a_model[:, :dims[l]],
                                      b_model[:, :dims[l], :dims[l + 1]])
        d = d.reshape(2, 64, 128)
        acc = np.stack([_accumulators(d[h]) for h in range(2)])          # (wg, warp, lane, 64)
        bias = buf[geo["header"] + 128 * l:geo["header"] + 128 * (l + 1)]
        act = np.maximum(acc + bias[units], np.float32(0.0))
        out = np.zeros((128, 128), np.float32)
        for h in range(2):
            for w in range(4):
                for j in range(16):
                    for i in range(4):
                        out[64 * h + 16 * w + G + 8 * (i // 2), 8 * j + 2 * T + i % 2] = \
                            act[h, w, :, 4 * j + i]
        hidden.append(out)
        if l + 1 < geo["n_hidden"]:   # k-slots t and t + 4 of k-step ks: units 8 ks + 2 t, + 1
            frags = act.reshape(2, 4, 32, 16, 4)[..., [0, 2, 1, 3]].transpose(0, 3, 1, 2, 4)
    wout = buf[geo["header"] + 128 * geo["n_hidden"]:geo["tiles_at"]]
    act = hidden[-1]
    sdf = np.zeros(128, np.float32)
    for r in range(128):   # each lane's chain over its n-tiles, then lanes t = 0 1 2 3
        lanes = np.zeros(4, np.float32)
        for t in range(4):
            p = np.float32(0.0)
            for u in 8 * np.arange(16) + 2 * t:
                for e in range(2):   # fmaf: the product exact in float64, one rounding
                    p = np.float32(np.float64(act[r, u + e]) * np.float64(wout[u + e]) + p)
            lanes[t] = p
        s = np.float32(np.float32(lanes[0] + lanes[1]) + np.float32(lanes[2] + lanes[3]))
        sdf[r] = np.clip(np.float32(s + wout[128]), -clamp, clamp)
    return hidden, sdf


def _product(a: np.ndarray, w: np.ndarray) -> np.ndarray:
    """a (M, K) @ (big + small) w (2, K, N) in 3xTF32 as ops/tf32.py sums it:
    the exact products in float64, rounded to float32 once."""
    ab, as_ = (torch.from_numpy(v).double() for v in _split(a))
    wb, ws = (torch.from_numpy(np.ascontiguousarray(v)).double() for v in w)
    return (torch.matmul(ab, wb + ws) + torch.matmul(as_, wb)).to(torch.float32).numpy()


def _emulated_hidden(model, pts: np.ndarray) -> list:
    """The hidden layers of `raw_sdf_mlp_3xtf32` with each weight's small half
    exact in TF32 (the wgmma kernel keeps it as a float32 word)."""
    h = sdf_mlp.fourier_features(torch.from_numpy(pts), model.freqs, model.scale).numpy()
    out = []
    for w, b in zip(model.weights[:-1], model.biases[:-1]):
        split = np.stack([v.numpy() for v in tf32.tf32_split(w)])
        h = np.maximum(_product(h, split) + b.numpy(), np.float32(0.0))
        out.append(h)
    return out


@pytest.mark.parametrize("widths,freqs", WIDTHS)
def test_walk_of_the_wgmma_layout_computes_the_3xtf32_mlp(widths, freqs):
    model = _model(widths, freqs, 22)
    packed = sdf_mlp.pack_distilled(model)
    pts = (np.random.RandomState(23).randn(128, 3) * 0.08).astype(np.float32)
    hidden, sdf = _walk(packed, pts)
    for got, want in zip(hidden, _emulated_hidden(model, pts)):
        assert np.array_equal(got[:, :want.shape[1]], want) and not got[:, want.shape[1]:].any()
    emu = sdf_mlp._sdf_mlp_torch(model, torch.from_numpy(pts).T,
                                 mlp=tf32.raw_sdf_mlp_3xtf32).numpy()
    # the output layer's float32 sum in the kernel's order against the library's
    np.testing.assert_allclose(sdf, emu, atol=1e-7, rtol=0)
    assert 0.02 < np.mean(np.abs(emu) >= model.clamp.item()) < 0.9   # the clamp is exercised
