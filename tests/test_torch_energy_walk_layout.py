"""The object energy (#4, #4b, csrc/obj_energy.cu) and skinned hand energy
(#7, #7b, csrc/hand_energy_skin.cu) on the persistent wgmma walk of
csrc/sdf_mlp_wgmma.cuh, in both precisions (3xTF32 and bf16), held on the
CPU.

Neither kernel runs here, so their walks are modelled in numpy with the
constants read from the sources, and the sources are checked for the lines
the model follows:

- The walk's tile counts (from `make_shape`, checked against the packed
  models' lengths) and the pinned / streamed split that `plan()` gives with
  each job's shared memory (`job_bytes`): 48 of the shipped net's 70 3xTF32
  tiles pinned for #3, #4, #6 and #7's 3xTF32 rows, every bf16 tile pinned;
  the fused 3xTF32 skinning job, which was not taken, would pin 33.
- #4, one job in both precisions: a row is (sequence, candidate, point), each
  candidate's cloud padded to whole rounds of 128; a group is a candidate's
  rounds, walked by one block in ascending order. Every (candidate, point) is
  summed exactly once and every energy written once, at any P and N and on
  any grid; summing the plain version's per-point |sdf| (of the precision) in
  the kernel's fixed order (a lane's rows g then g + 8, rounds ascending; the
  warp's butterfly; the 8 warps ascending) gives its energies to float32
  summation rounding; sequence s of a batched walk sums bitwise what an
  unbatched walk on s's inputs sums.
- #7 in 3xTF32: a skinning pre-pass (a block 32 vertices by 32 candidates of
  one sequence, a thread a vertex and four candidates) builds every (sequence,
  candidate, vertex) exactly once at any P, N and S from its staged inputs
  (the candidates' transposed, the vertices' columns), with the float32 FMA
  order of the bf16 job's aside warps, so the two precisions build bitwise the
  same vertices (and within float32 rounding of the plain version); the walk
  then takes row r of a sequence as vertex r, stored once.
- #7 in bf16: a round is (vertex tile of 32, quad of 4 candidates),
  tile-major, and row 4 j + c of it is candidate 4 quad + c's vertex
  32 tile + j; every (candidate, vertex) is one row, the rest (past N or P)
  padding. The aside warps build every row of a round exactly once from the
  quad's staged per-candidate inputs (pose_map, rt, offset, entry e of
  candidate c at 4 e + c) and the tile's staged columns of posedirs, v_shaped
  and weights (staged again only when a block's round moves to another tile or
  sequence), so the vertices are bitwise those of the same arithmetic on the
  unstaged inputs; every hit and sdf is stored exactly once; the stage's slots
  are taken in the order they are filled.
- The wrappers hand the 3xTF32 entries `PackedSDF.wg` (and #7's a vertex
  scratch) and the bf16 entries `PackedSDF.wg16` (a spy on the launch);
  `PackedSDF` has no mma.sync layout.

The kernels themselves are held on the card (`chip_smoke.py`, the `gpu`
tests of test_torch_sdf_kernels.py, test_torch_hand_kernels.py and
test_torch_batched_kernels_gpu.py).
"""

import re

import numpy as np
import pytest
import torch

from hand_energy_cases import candidates
from hotrack_tpu_torch.mano import layer
from hotrack_tpu_torch.mano.model import synthetic_mano_model
from hotrack_tpu_torch.ops import hand_energy_skin, kernels, mask_lookup, obj_energy, sdf_mlp
from hotrack_tpu_torch.pose.rotations import normalize_quat, unit_quaternion_to_matrix
from hotrack_tpu_torch.utils.convert import distilled_from_numpy
from torch_sdf_models import model_arrays

BF16 = torch.bfloat16
PRECISIONS = ("3xtf32", "bf16")


def _by_precision(cases: list) -> list:
    """`cases` in both precisions for `parametrize`, the precision last; a
    bf16 case keeps the id it had before the 3xTF32 kernels joined the walk
    (its values alone), a 3xTF32 one is prefixed."""
    return [pytest.param(*c, prec, id="-".join(map(str, c if prec == "bf16" else (prec, *c))))
            for prec in PRECISIONS for c in cases]


def _constants(name: str) -> dict:
    """Every namespace-scope `constexpr int` of a source, evaluated in order
    (C's integer division)."""
    out = {}
    for key, expr in re.findall(r"^constexpr (?:int|uint32_t) (\w+) = ([^;]+);",
                                (kernels.CSRC_DIR / name).read_text(), re.M):
        out[key] = int(eval(expr.replace("/", "//"), {}, dict(out)))  # noqa: S307
    return out


WG = _constants("sdf_mlp_wgmma.cuh")
ROUND, WARPS, ASIDE = WG["kRoundPoints"], WG["kConsumerWarps"], WG["kAsideThreads"]
SKIN = _constants("hand_energy_skin.cu")
QUAD, TILE, JOINTS, ROLES = SKIN["kQuad"], SKIN["kTile"], SKIN["kJoints"], SKIN["kRoles"]
PASS_VERTS, PASS_CANDS, PASS_THREADS = (SKIN["kPassVerts"], SKIN["kPassCands"],
                                        SKIN["kPassThreads"])
STAGE = int(re.search(r"static constexpr int kStage = (\d+);",
                      (kernels.CSRC_DIR / "hand_energy_skin.cu").read_text()).group(1))
LANES = np.arange(32)


def test_the_model_follows_the_sources():
    for precision in PRECISIONS:
        _follows_the_sources(precision)


def _follows_the_sources(precision):
    header = (kernels.CSRC_DIR / "sdf_mlp_wgmma.cuh").read_text()
    for line in ("for (long long item = first(); item < items; item = after(item)) {",
                 "const long long row = (item - s * rounds) * kRoundPoints + warp * 16 + g;",
                 "job.add(sum, row, sdf);",
                 "if ((item + 1) % span == 0) job.total(sum, item / span, scratch, groups++ & 1);",
                 "const uint32_t n = built++, slot = n % J::kStage;",
                 "const uint32_t n = taken++, slot = n % J::kStage;",
                 "mbar_init(stage_full + 8 * i, kAsideThreads);",
                 "mbar_init(stage_empty + 8 * i, kConsumerWarps);",
                 "if constexpr (kBf16) sdf = mlp_rows16(xa, xb, net, shape, w);",
                 "else sdf = mlp_rows(xa, xb, net, shape, w);"):
        assert line in header, line
    assert "sdf_mlp_tc" not in header and "mma.sync.aligned" not in header
    obj = (kernels.CSRC_DIR / "obj_energy.cu").read_text()
    for line in ("static constexpr bool kGroups = true;",
                 "__host__ __device__ long long span() const { return rounds; }",
                 "__host__ long long scratch_bytes() const { return 2 * 4 * wg::kConsumerWarps; }",
                 "static_cast<unsigned>(rounds * wg::kRoundPoints));",
                 "if (i < n) e += fabsf(sdf.x);",
                 "if (i + 8 < n) e += fabsf(sdf.y);",
                 "e += __shfl_xor_sync(0xffffffffu, e, 4);",
                 "e += __shfl_xor_sync(0xffffffffu, e, 8);",
                 "e += __shfl_xor_sync(0xffffffffu, e, 16);",
                 "for (int w = 1; w < wg::kConsumerWarps; ++w) sum += red[w];",
                 "out[group] = sum;",
                 "wg::walk<kBf16>(job, smem, packed, packed_seq, rounds, items, shape, pinned, "
                 "ring);",
                 "const wg::Shape shape = wg::make_shape(n_freqs, n_hidden, widths, kBf16);",
                 f"return launch<{'false' if precision == '3xtf32' else 'true'}>(pcld_cf, rts, "
                 "packed, out, p, n, n_seq, pcld_seq, packed_seq, n_freqs,"):
        assert line in obj, line
    skin = (kernels.CSRC_DIR / "hand_energy_skin.cu").read_text()
    if precision == "3xtf32":
        lines = ("const int v0 = blockIdx.x * kPassVerts, p0 = blockIdx.y * kPassCands;",
                 "const int tid = threadIdx.x, lane = tid & 31, cq = 4 * (tid >> 5);",
                 "const long long cands = s * p + p0;   // the block's first candidate",
                 "pm[i] = p0 + (i & 31) < p ? __ldg(pose_map_g + (cands + (i & 31)) * k + "
                 "(i >> 5)) : 0.0f;",
                 "? __ldg(rt_g + (cands + (i & 31)) * (kRoles * kJoints) + (i >> 5)) : 0.0f;",
                 "? __ldg(offset_g + (cands + (tid & 31)) * 3 + (tid >> 5)) : 0.0f;",
                 "pd[i] = v0 + (i & 31) < n ? __ldg(posedirs + static_cast<long long>(i >> 5) * n "
                 "+ (i & 31))",
                 "vs[tid] = real_v ? __ldg(v_shaped + static_cast<long long>(tid >> 5) * n + lane) "
                 ": 0.0f;",
                 "wt[i] = v0 + (i & 31) < n ? __ldg(weights + static_cast<long long>(i >> 5) * n "
                 "+ (i & 31))",
                 "const float* col = pd + c * k * kPassVerts + lane;",
                 "const float4 q = *reinterpret_cast<const float4*>(pm + kk * kPassCands + cq);",
                 "const float* r = rt + (e < 3 ? 3 * c + e : 9 + c) * kJoints * kPassCands + cq;",
                 "x[c][i] = __fadd_rn(__fadd_rn(a[i], b[i]), og[c * kPassCands + cq + i]);",
                 "const long long at = (cands + cq + i) * n + v0 + lane;",
                 "skin_vertices_kernel<<<dim3(tiles, chunks, n_seq), kPassThreads,",
                 "const float* q = verts + 3 * (s * m + row);",
                 "sdf[s * m + row] = value;",
                 "wg::walk<false>(job, smem, packed, packed_seq, rounds, items, shape, pinned, "
                 "ring);",
                 "const wg::Shape shape = wg::make_shape(n_freqs, n_hidden, widths);")
    else:
        lines = ("const unsigned round = r / wg::kRoundPoints, i = r % wg::kRoundPoints;",
                 "const unsigned tile = round / static_cast<unsigned>(quads);",
                 "v = static_cast<int>(kTile * tile + i / kQuad);",
                 "cand = static_cast<int>(kQuad * (round - tile * quads) + i % kQuad);",
                 "const int c = t >> 5, j = t & 31;",
                 "const int tile = static_cast<int>(round / quads), "
                 "q = static_cast<int>(round % quads);",
                 "const int key = static_cast<int>(s) * tiles + tile;",
                 "const bool restage = *staged != key;",
                 "for (int jj = c; jj < kJoints; jj += 3)",
                 "for (int i = t; i < kQuad * k; i += wg::kAsideThreads) {",
                 "for (int i = t; i < kQuad * kRoles * kJoints; i += wg::kAsideThreads) {",
                 "if (t < kQuad * 3) {",
                 "for (int i = c; i < kQuad; i += 3) {",
                 "const int tiles = (n + kTile - 1) / kTile, quads = (p + kQuad - 1) / kQuad;",
                 "wg::walk<true>(job, smem, packed, job.seq.packed, rounds, items, shape, pinned, "
                 "ring);")
    for line in lines:
        assert line in skin, line
    assert "if constexpr (J::kStage > 0) *reinterpret_cast<int*>(scratch) = -1;" in header
    assert ASIDE == 3 * TILE and QUAD * TILE == ROUND == 128 and WARPS == 8
    assert not (kernels.CSRC_DIR / "sdf_mlp_tc.cuh").exists()


# -- the walk's shared memory --------------------------------------------------

SMEM_LIMIT = 232_448   # an H100 block's opt-in shared memory (227 KB)
TILE_BYTES, RING = WG["kTileBytes"], WG["kRing"]


def _tiles(widths, bf16: bool) -> tuple:
    """wg::make_shape's (first_tiles, tiles) of a model."""
    f, hidden = widths[0] // 6, len(widths) - 1
    if bf16:
        ks0 = (3 * f + 10) // 8
        return ks0, ks0 + 8 * (hidden - 1)
    ks0 = (3 * f + 6) // 4
    return 2 * ks0, 2 * (ks0 + 16 * (hidden - 1))


def _plan(tiles: int, first_tiles: int, extra: int) -> tuple:
    """wg::plan within SMEM_LIMIT - extra bytes: (pinned, ring)."""
    barrier = lambda ring: (8 * (2 * ring + 1) + 15) & ~15   # noqa: E731
    limit = SMEM_LIMIT - extra
    if tiles * TILE_BYTES + barrier(0) <= limit:
        return tiles, 0
    fit = (limit - RING * TILE_BYTES - barrier(RING)) // TILE_BYTES
    return (fit if fit >= first_tiles else -1), RING


def _skinned_job_bytes(k: int) -> int:
    """Skinned::scratch_bytes() + its 2-slot stage's barriers (the bf16 job;
    the fused 3xTF32 design would have taken the same)."""
    entries = -(-k // 4) * 4 + ROLES * JOINTS + 4
    return 4 * (4 + (STAGE + 1) * 3 * ROUND + QUAD * entries + (k + 1) * ASIDE
                + JOINTS * TILE) + ((16 * STAGE + 15) & ~15)


# (job, precision, job_bytes at the hand path's K = 135, pinned, streamed) at
# 21-128-128-128-1: #3, #6 and 3xTF32 #7's rows add nothing, #4 its 64 bytes
WALK_JOBS = [("#3, #6, #7 rows", "3xtf32", 0, 48, 22), ("#4", "3xtf32", 64, 48, 22),
             ("fused #7, not taken", "3xtf32", _skinned_job_bytes(135), 33, 37),
             ("#3, #6", "bf16", 0, 18, 0), ("#4", "bf16", 64, 18, 0),
             ("#7", "bf16", _skinned_job_bytes(135), 18, 0)]


@pytest.mark.parametrize("job,precision,extra,pinned,streamed", WALK_JOBS,
                         ids=[f"{p}-{j}" for j, p, *_ in WALK_JOBS])
def test_walk_pins_what_fits_beside_each_job(job, precision, extra, pinned, streamed):
    """The tile counts of make_shape against the packed model's length, and
    plan()'s split beside each job's shared memory."""
    skin = (kernels.CSRC_DIR / "hand_energy_skin.cu").read_text()
    assert ("return 4LL * (4 + (kStage + 1) * 3 * wg::kRoundPoints + kQuad * quad_entries(k) +\n"
            "                  (k + 1) * wg::kAsideThreads + kJoints * kTile);") in skin
    assert "struct Rows : wg::Job {" in skin and "__host__ long long scratch_bytes" not in \
        skin[skin.index("struct Rows"):skin.index("hand_energy_rows_kernel(")]
    model = distilled_from_numpy(model_arrays(2, widths=(21, 128, 128, 128)))
    packed = sdf_mlp.pack_distilled(model)
    first, tiles = _tiles((21, 128, 128, 128), precision == "bf16")
    buf = packed.wg16 if precision == "bf16" else packed.wg
    head = 4 + 4 + 128 * 3 + 132   # header (3 frequencies padded to 4), biases, output layer
    assert (buf.numel() - head) * 4 == tiles * TILE_BYTES
    got = _plan(tiles, first, extra)
    assert got == (pinned, RING if streamed else 0) and tiles - pinned == streamed, got
    if job.startswith("fused"):
        print(f"[walk] the fused 3xTF32 #7 job would pin {got[0]} of {tiles} tiles "
              f"({(tiles - got[0]) * TILE_BYTES} bytes streamed a round)")


def _group_walk(groups: int, span: int, grid: int) -> list:
    """The items each block walks: the rounds of groups b, b + grid, ...,
    ascending (wg::walk's `after`)."""
    out = []
    for b in range(min(groups, grid)):
        item, items = b * span, []
        while item < groups * span:
            items.append(item)
            item = item + 1 if (item + 1) % span else item + 1 + (grid - 1) * span
        out.append(items)
    return out


# -- #4 ------------------------------------------------------------------------

def _obj_energies(absdf: np.ndarray, n: int, grid: int) -> np.ndarray:
    """The kernel's sums of |sdf| (S, P, N) float32, walked as the kernel walks
    them on `grid` blocks, each energy written once."""
    s_, p, _ = absdf.shape
    rounds = -(-n // ROUND)
    rows = np.zeros((s_ * p, rounds * ROUND), np.float32)   # a candidate's padded cloud
    rows[:, :n] = absdf.reshape(s_ * p, n)
    out = np.full(s_ * p, np.nan, np.float32)
    writes = np.zeros(s_ * p, np.int64)
    g = LANES // 4
    for items in _group_walk(s_ * p, rounds, grid):
        for group in sorted({i // rounds for i in items}):
            mine = [i for i in items if i // rounds == group]
            assert mine == list(range(group * rounds, (group + 1) * rounds))   # ascending
            lane = np.zeros((WARPS, 32), np.float32)   # lanes t = 0 add; the rest hold 0
            for item in mine:
                base = (item - group * rounds) * ROUND
                for w in range(WARPS):
                    i0 = base + 16 * w + g
                    t0 = LANES % 4 == 0
                    add = np.where(t0 & (i0 < n), rows[group, np.minimum(i0, rows.shape[1] - 1)],
                                   np.float32(0))
                    lane[w] = np.where(t0 & (i0 < n), lane[w] + add, lane[w])
                    add = np.where(t0 & (i0 + 8 < n),
                                   rows[group, np.minimum(i0 + 8, rows.shape[1] - 1)],
                                   np.float32(0))
                    lane[w] = np.where(t0 & (i0 + 8 < n), lane[w] + add, lane[w])
            for x in (4, 8, 16):   # the butterfly, every lane at once
                lane = lane + lane[:, LANES ^ x]
            total = lane[0, 0]
            for w in range(1, WARPS):
                total = np.float32(total + lane[w, 0])
            out[group] = total
            writes[group] += 1
    assert np.array_equal(writes, np.ones(s_ * p, np.int64))
    return out.reshape(s_, p)


@pytest.mark.parametrize("p,n,grid,precision", _by_precision(
    [(1, 1, 132), (3, 128, 1), (7, 129, 5), (5, 300, 132), (64, 1000, 7), (33, 1024, 132)]))
def test_obj_rows_sum_every_point_once_in_a_fixed_order(p, n, grid, precision):
    """Ones sum to N exactly, whatever the grid; every candidate written once.
    One job (Candidates) serves both precisions' walks, so the rows and the
    order are the same in both (test_the_model_follows_the_sources)."""
    ones = np.ones((1, p, n), np.float32)
    assert np.array_equal(_obj_energies(ones, n, grid), np.full((1, p), n, np.float32))
    rng = np.random.RandomState(p + n)
    vals = rng.rand(2, p, n).astype(np.float32)
    # the order depends on nothing but the candidate's values: any grid, and a
    # batched walk's sequence is the unbatched walk on its values, bitwise
    got = _obj_energies(vals, n, grid)
    assert np.array_equal(got, _obj_energies(vals, n, 1))
    for s in range(2):
        assert np.array_equal(got[s], _obj_energies(vals[s:s + 1], n, 3)[0])


@pytest.mark.parametrize("p,n,precision", _by_precision([(9, 300), (4, 1024), (5, 77)]))
def test_obj_rows_sum_the_plain_bf16_values_to_the_plain_energies(p, n, precision):
    """The plain version's per-point |sdf| (float32, or bf16), summed in the
    kernel's order, against its energies: float32 summation rounding of the
    two orders, 2 (N - 1) 2^-24 sum |sdf|."""
    dtype = BF16 if precision == "bf16" else None
    model = distilled_from_numpy(model_arrays(15, widths=(21, 32, 32)))
    rng = np.random.RandomState(16)
    pcld = torch.from_numpy((rng.randn(3, n) * 0.06).astype(np.float32))
    rot = unit_quaternion_to_matrix(normalize_quat(torch.from_numpy(
        rng.randn(p, 4).astype(np.float32))))
    rts = obj_energy.obj_rts(rot, torch.from_numpy((rng.randn(p, 3) * 0.03).astype(np.float32)))
    obj = -rts[:, 9:, None] + sum(rts[:, :9].reshape(p, 3, 3, 1)[:, :, y] * pcld[y]
                                  for y in range(3))
    absdf = sdf_mlp._sdf_mlp_torch(model, obj, compute_dtype=dtype).abs().numpy()
    got = _obj_energies(absdf[None], n, 11)[0]
    want = obj_energy._obj_sdf_energy_torch(model, pcld, rts, compute_dtype=dtype).numpy()
    bound = 2 * (n - 1) * 2.0 ** -24 * absdf.astype(np.float64).sum(1)
    assert np.all(np.abs(got.astype(np.float64) - want) <= bound), (got - want, bound)
    print(f"[walk] #4 {precision} order: largest {np.abs(got - want).max():.3e} against the plain "
          f"version's sums (bound {bound.min():.3e} to {bound.max():.3e})")


# -- #7 ------------------------------------------------------------------------

def _skin_rounds(p: int, n: int) -> tuple:
    """(tiles, quads, rounds a sequence)."""
    tiles, quads = -(-n // TILE), -(-p // QUAD)
    return tiles, quads, tiles * quads


def _row_at(r: np.ndarray, p: int, n: int) -> tuple:
    """Skinned::row_at: (candidate, vertex, a real pair) of rows r of a sequence."""
    _, quads, _ = _skin_rounds(p, n)
    round_, i = r // ROUND, r % ROUND
    tile, q = round_ // quads, round_ % quads
    v, cand = TILE * tile + i // QUAD, QUAD * q + i % QUAD
    return cand, v, (v < n) & (cand < p)


@pytest.mark.parametrize("p,n", [(1, 1), (2, 5), (3, 778), (4, 778), (7, 778), (8, 778),
                                 (9, 31), (5120, 778), (13, 200)])
def test_skin_rows_map_each_pair_once_and_quads_share_a_vertex(p, n):
    tiles, quads, rounds = _skin_rounds(p, n)
    m = rounds * ROUND
    cand, v, real = _row_at(np.arange(m), p, n)
    assert np.array_equal(np.bincount((cand * n + v)[real], minlength=p * n),
                          np.ones(p * n, np.int64))
    blocks = np.arange(m).reshape(-1, QUAD)   # rows 4 j .. 4 j + 3: one vertex, four candidates
    assert np.array_equal(v[blocks], np.repeat(v[blocks[:, :1]], QUAD, 1))
    assert np.array_equal(cand[blocks] % QUAD, np.tile(np.arange(QUAD), (len(blocks), 1)))
    # padding: the last tile past N and the last quad past P
    assert m - p * n == ROUND * rounds - p * n
    assert (m - p * n) / m <= 1 - (n / (TILE * tiles)) * (p / (QUAD * quads)) + 1e-12
    if (p, n) == (5120, 778):
        print(f"[walk] #7 rows: {m} for {p * n} pairs ({1 - p * n / m:.4f} padding)")


# -- #7 in 3xTF32: the skinning pre-pass and the walk's rows ---------------------

def _prepass_pairs(p: int, n: int, s: int) -> tuple:
    """Every (vertex-scratch index, block, thread, i) the pre-pass writes, as
    skin_vertices_kernel's grid (tiles, chunks, S) and threads (warp w, lane)
    take them: candidate p0 + 4 w + i, vertex v0 + lane, where both are real."""
    tiles, chunks = -(-n // PASS_VERTS), -(-p // PASS_CANDS)
    bx, by, bz, t, i = np.meshgrid(np.arange(tiles), np.arange(chunks), np.arange(s),
                                   np.arange(PASS_THREADS), np.arange(4), indexing="ij")
    v = bx * PASS_VERTS + (t & 31)
    cand = by * PASS_CANDS + 4 * (t >> 5) + i
    real = (v < n) & (cand < p)
    at = ((bz * p + cand) * n + v)[real]   # (cands + cq + i) * n + v0 + lane
    return at, cand[real], v[real], bz[real]


@pytest.mark.parametrize("p,n,s", [(1, 1, 1), (7, 129, 2), (33, 778, 1), (40, 50, 3),
                                   (5120, 778, 1)])
def test_skin_prepass_builds_every_pair_once_and_the_walk_reads_each_once(p, n, s):
    """3xTF32 #7: the pre-pass writes each (sequence, candidate, vertex) of the
    (S, P, N, 3) scratch and of hit exactly once, whatever P, N and S; the
    walk's rows (Rows: row r of sequence s is scratch entry s P N + r) take
    each once, 128 a round, and store each sdf once."""
    at, _, _, _ = _prepass_pairs(p, n, s)
    assert np.array_equal(np.bincount(at, minlength=s * p * n), np.ones(s * p * n, np.int64))
    m = p * n
    rounds = -(-m // ROUND)
    rows = (np.arange(rounds)[:, None, None, None] * ROUND + 16 * np.arange(WARPS)[:, None, None]
            + (LANES // 4)[:, None] + np.array([0, 8])).reshape(rounds, -1)
    stored = rows[rows < m]   # each row of a warp's 16 by one of lanes 0-15
    for seq in range(s):
        got = np.bincount(seq * m + np.unique(stored), minlength=s * m)[seq * m:(seq + 1) * m]
        assert np.array_equal(got, np.ones(m, np.int64))
    assert np.array_equal(np.unique(rows), np.arange(rounds * ROUND))


def _prepass_block(pose_map, rt, offset, consts, p0: int, v0: int):
    """A pre-pass block's vertices (3, 32 candidates, 32 vertices) from its
    shared memory, staged as skin_vertices_kernel stages it (zeros past P and
    N; candidate inputs transposed, entry e of candidate c at 32 e + c;
    columns entry e of vertex j at 32 e + j) and read as its threads read it
    (pm and rt as float4 of four candidates, a lane's column)."""
    p, k = pose_map.shape
    n = consts.posedirs_cf.shape[-1]
    rt_, i = rt.reshape(p, ROLES * JOINTS), np.arange(PASS_CANDS * k)
    cand = np.minimum(p0 + (i & 31), p - 1)
    pm = np.where(p0 + (i & 31) < p, pose_map[cand, i >> 5], np.float32(0))
    i = np.arange(PASS_CANDS * ROLES * JOINTS)
    rts = np.where(p0 + (i & 31) < p, rt_[np.minimum(p0 + (i & 31), p - 1), i >> 5], np.float32(0))
    i = np.arange(PASS_CANDS * 4)
    og = np.where((p0 + (i & 31) < p) & (i < PASS_CANDS * 3),
                  offset[np.minimum(p0 + (i & 31), p - 1), np.minimum(i >> 5, 2)], np.float32(0))
    col = lambda a, rows: np.where(v0 + (np.arange(rows * 32) & 31) < n,   # noqa: E731
                                   a.reshape(rows, n)[np.arange(rows * 32) >> 5,
                                                      np.minimum(v0 + (np.arange(rows * 32) & 31),
                                                                 n - 1)], np.float32(0))
    pd = col(consts.posedirs_cf.numpy(), 3 * k)
    vs, wt = col(consts.vshaped_cf.numpy(), 3), col(consts.weights_t.numpy(), JOINTS)
    # thread (w, lane) reads pm[kk 32 + 4 w + i], pd[(c k + kk) 32 + lane], ...: as rows
    # (candidate 4 w + i, lane), flattened
    def by_lane(a):
        return np.broadcast_to(a[..., None, :], (*a.shape[:-1], 32, 32)).reshape(
            *a.shape[:-1], -1)

    def by_cand(a):
        return np.repeat(a, 32, axis=-1)

    x = _blend(by_lane(pd.reshape(3, k, 32)), by_lane(vs.reshape(3, 32)),
               by_lane(wt.reshape(JOINTS, 32)), by_cand(pm.reshape(k, 32)),
               by_cand(rts.reshape(ROLES, JOINTS, 32)), by_cand(og.reshape(4, 32)[:3]))
    return x.reshape(3, 32, 32)


@pytest.mark.parametrize("p", [7, 40])
def test_skin_prepass_builds_the_vertices_of_both_precisions_from_its_stage(p):
    """3xTF32 #7's pre-pass, block by block from its staged shared memory, builds
    bitwise the vertices of the same arithmetic on the unstaged inputs, which
    are bitwise the bf16 job's (both precisions build the same vertices and
    hits), and within float32 rounding of the plain version."""
    pose_map, rt_flat, offset, consts = _skin_inputs(p, seed=5)
    n = consts.posedirs_cf.shape[-1]
    rt = rt_flat.reshape(p, ROLES, JOINTS).numpy()
    pm, off = pose_map.numpy(), offset.numpy()
    verts = np.full((3, p, n), np.nan, np.float32)
    for p0 in range(0, p, PASS_CANDS):
        for v0 in range(0, n, PASS_VERTS):
            x = _prepass_block(pm, rt, off, consts, p0, v0)
            c, v = np.arange(p0, min(p0 + PASS_CANDS, p)), np.arange(v0, min(v0 + PASS_VERTS, n))
            verts[:, c[:, None], v] = x[:, :len(c), :len(v)]
    cand, v = np.divmod(np.arange(p * n), n)
    direct = _blend(consts.posedirs_cf.numpy()[:, :, v], consts.vshaped_cf.numpy()[:, v],
                    consts.weights_t.numpy()[:, v], pm[cand].T, rt[cand].transpose(1, 2, 0),
                    off[cand].T)
    assert np.array_equal(verts.reshape(3, -1), direct)
    # the bf16 job's rounds build the same vertices, bitwise
    _, _, rounds = _skin_rounds(p, n)
    for r in range(0, rounds, 7):
        xs, real, _ = _staged_round(pm, rt, off, consts, r, p, n)
        rc, rv, _ = _row_at(r * ROUND + np.arange(ROUND), p, n)
        assert np.array_equal(xs[:, real], verts[:, rc[real], rv[real]])
    plain = hand_energy_skin.skin_reference(pose_map, rt_flat, offset, consts).numpy()
    np.testing.assert_allclose(verts.transpose(1, 2, 0), plain, atol=2e-6, rtol=0)


def _skin_inputs(p: int, seed: int):
    pose, trans, beta = candidates(p, seed=seed)
    mano = synthetic_mano_model()
    shaped = layer.shape_hand(mano, torch.from_numpy(beta))
    _, pose_map, rt_flat, offset = layer.mano_skin_inputs(
        mano, torch.from_numpy(pose), torch.from_numpy(trans), shaped)
    consts = hand_energy_skin.skin_consts(mano, shaped)
    return pose_map, rt_flat, offset, consts


def _fma(a, b, c):
    """fmaf, the product exact in float64 and one rounding."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64) + c).astype(np.float32)


def _blend(pd, vs, wts, pm, rt, off):
    """Phase 1's arithmetic for rows of (pd (3, K, R) posedirs, vs (3, R),
    wts (16, R), pm (K, R), rt (12, 16, R), off (3, R)): vp_c a fmaf chain in
    ascending k from 0, then + v_shaped; s_r a fmaf chain in ascending j; x_c =
    ((s_3c vp_0 + s_3c+1 vp_1 + s_3c+2 vp_2) + s_9+c) + offset_c."""
    vp = np.zeros(vs.shape, np.float32)
    for kk in range(pm.shape[0]):
        vp = _fma(pd[:, kk], pm[kk], vp)
    vp = (vp + vs).astype(np.float32)
    sr = np.zeros(rt.shape[::2], np.float32)   # (12, R)
    for j in range(JOINTS):
        sr = _fma(rt[:, j], wts[j], sr)
    x = np.zeros(vs.shape, np.float32)
    for c in range(3):
        a = (sr[3 * c] * vp[0]).astype(np.float32)
        a = _fma(sr[3 * c + 1], vp[1], a)
        a = _fma(sr[3 * c + 2], vp[2], a)
        x[c] = ((a + sr[9 + c]).astype(np.float32) + off[c]).astype(np.float32)
    return x


def _staged_round(pose_map, rt, offset, consts, round_, p, n):
    """One round as the aside warps build it from the staged quad inputs
    (entry e of candidate c at 4 e + c, each slot copied once) and the tile's
    staged columns; returns (the round's vertices (3, 128), the real rows, the
    hit rows each warp takes)."""
    k = pose_map.shape[1]
    k4 = -(-k // 4) * 4
    entries = k4 + ROLES * JOINTS + 4
    _, quads, _ = _skin_rounds(p, n)
    tile, q = round_ // quads, round_ % quads
    first, count = QUAD * q, min(QUAD, p - QUAD * q)
    stage = np.zeros(QUAD * entries, np.float32)
    covered = np.zeros(QUAD * entries, np.int64)
    rt_ = rt.reshape(p, ROLES * JOINTS)
    # the three copy loops of the aside threads: entry e of candidate cq at 4 e + cq
    for at, src, width in ((0, pose_map, k), (QUAD * k4, rt_, ROLES * JOINTS),
                           (QUAD * (k4 + ROLES * JOINTS), offset, 3)):
        for t in range(ASIDE):
            for i in range(t, QUAD * width, ASIDE):
                covered[at + i] += 1
                e, cq = i >> 2, i & 3
                if cq < count:
                    stage[at + i] = src[first + cq, e]
    # the pads after pose_map and offset are never read
    pads = [QUAD * e + cq for e in (*range(k, k4), k4 + ROLES * JOINTS + 3) for cq in range(QUAD)]
    covered[pads] = 1
    assert np.array_equal(covered, np.ones_like(covered))
    slots = stage.reshape(entries, QUAD)             # [entry][candidate]
    v = TILE * tile + np.arange(TILE)                # lane j's vertex
    ok_v = v < n
    vv = np.minimum(v, n - 1)
    # the tile's columns as the aside threads stage them: posedirs and v_shaped of
    # (c, v) by thread (c, j), weights of v by threads (jj % 3, j)
    cols = consts.posedirs_cf.numpy()[:, :, vv]      # (3, K, 32)
    vs = consts.vshaped_cf.numpy()[:, vv]            # (3, 32)
    wts = consts.weights_t.numpy()[:, vv]            # (16, 32)
    assert sorted(jj for c in range(3) for jj in range(c, JOINTS, 3)) == list(range(JOINTS))
    rep = lambda a: np.repeat(a, QUAD, axis=-1)      # noqa: E731  (a lane's four rows)
    x = _blend(rep(cols), rep(vs), rep(wts), np.tile(slots[:k], TILE),
               np.tile(slots[k4:k4 + ROLES * JOINTS], TILE).reshape(ROLES, JOINTS, -1),
               np.tile(slots[k4 + ROLES * JOINTS:k4 + ROLES * JOINTS + 3], TILE))
    real = rep(ok_v) & np.tile(np.arange(QUAD) < count, TILE)
    xs = np.where(real, x, np.float32(0))
    hit_rows = [[QUAD * j + i for j in range(TILE) for i in range(c, QUAD, 3)] for c in range(3)]
    return xs, real, hit_rows


@pytest.mark.parametrize("p", [7, 8])
def test_skin_stage_builds_each_round_from_the_staged_inputs(p):
    """The vertices of the walk's rounds from the staged inputs are bitwise
    the same arithmetic on the unstaged inputs, and within float32 rounding
    of the plain version (`skin_reference`); every real row built and its hit
    stored once, padding rows zero."""
    pose_map, rt_flat, offset, consts = _skin_inputs(p, seed=3)
    n = consts.posedirs_cf.shape[-1]
    _, _, rounds = _skin_rounds(p, n)
    rt = rt_flat.reshape(p, ROLES, JOINTS).numpy()
    pm, off = pose_map.numpy(), offset.numpy()
    verts = np.zeros((3, rounds * ROUND), np.float32)
    built = np.zeros(rounds * ROUND, np.int64)
    for r in range(rounds):
        xs, real, hit_rows = _staged_round(pm, rt, off, consts, r, p, n)
        verts[:, r * ROUND:(r + 1) * ROUND] = xs
        taken = np.bincount(np.concatenate(hit_rows), minlength=ROUND)
        assert np.array_equal(taken, np.ones(ROUND, np.int64))
        built[r * ROUND:(r + 1) * ROUND] += real
    cand, v, real = _row_at(np.arange(rounds * ROUND), p, n)
    assert np.array_equal(built, real.astype(np.int64)) and not verts[:, ~real].any()
    cand, v = cand[real], v[real]
    direct = _blend(consts.posedirs_cf.numpy()[:, :, v], consts.vshaped_cf.numpy()[:, v],
                    consts.weights_t.numpy()[:, v], pm[cand].T, rt[cand].transpose(1, 2, 0),
                    off[cand].T)
    assert np.array_equal(verts[:, real], direct)
    plain = hand_energy_skin.skin_reference(pose_map, rt_flat, offset, consts).numpy()
    np.testing.assert_allclose(verts[:, real].T, plain[cand, v], atol=2e-6, rtol=0)


@pytest.mark.parametrize("p,n_seq,grid", [(5120, 1, 132), (5120, 4, 132), (7, 2, 5), (33, 1, 2)])
def test_skin_tile_columns_are_staged_when_the_tile_changes(p, n_seq, grid):
    """A block stages a tile's columns again only when its next round lies in
    another tile or sequence; at the hand path's 5120 candidates a block's
    rounds b, b + 132, ... stay on a tile for about quads / 132 of them."""
    tiles, quads, rounds = _skin_rounds(p, 778)
    restages = 0
    for b in range(min(grid, rounds * n_seq)):
        key = -1
        for item in range(b, rounds * n_seq, grid):
            s, r = divmod(item, rounds)
            want = s * tiles + r // quads
            restages += want != key
            key = want
    per_restage = rounds * n_seq / restages
    if p == 5120:
        assert per_restage > 8, per_restage
        print(f"[walk] #7 at S={n_seq}: a tile staged once every {per_restage:.2f} rounds")


@pytest.mark.parametrize("rounds,grid", [(1, 132), (5, 2), (32_000, 132), (37, 7)])
def test_skin_stage_slots_are_taken_as_they_are_filled(rounds, grid):
    """Both sides of a block count the walk's items alike, so the consumers
    take slot n % kStage at phase n // kStage as the aside warps filled it."""
    for items in _group_walk(rounds, 1, grid):
        n = np.arange(len(items))
        slot, phase = n % STAGE, n // STAGE
        assert np.array_equal(np.diff(items), np.full(len(items) - 1, grid))
        for k in range(STAGE, len(items)):
            assert slot[k] == slot[k - STAGE] and phase[k] == phase[k - STAGE] + 1


# -- the wrappers --------------------------------------------------------------

class _Lib:
    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("hotrack_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, *args)) or 0


@pytest.fixture
def spy(monkeypatch):
    lib = _Lib()
    monkeypatch.setattr(kernels, "_check_f32", lambda *a: None)
    monkeypatch.setattr(kernels, "_check_frame", lambda *a: 0)
    monkeypatch.setattr(kernels, "_check_mask", lambda name, mask, hw, like, n_seq=None: (*hw, 0))
    monkeypatch.setattr(kernels, "_load", lambda name, bind: lib)

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
    return lib


@pytest.mark.parametrize("batched", [False, True])
def test_obj_wrappers_launch_bf16_on_the_walk_layout(spy, batched):
    packed = sdf_mlp.pack_distilled(distilled_from_numpy(model_arrays(4, widths=(21, 32, 48))))
    lead = (2,) if batched else ()
    name = "obj_sdf_energy_batched" if batched else "obj_sdf_energy"
    fn = kernels.obj_sdf_energy_batched_cuda if batched else kernels.obj_sdf_energy_cuda
    before = dict(kernels.launch_counts)
    fn(torch.zeros(3, 130), torch.zeros(*lead, 5, 12), packed, compute_dtype=BF16)
    fn(torch.zeros(3, 130), torch.zeros(*lead, 5, 12), packed)
    (bf16, f32) = spy.calls
    assert bf16[0] == "hotrack_obj_energy_bf16" and bf16[3] == packed.wg16.data_ptr()
    assert f32[0] == "hotrack_obj_energy" and f32[3] == packed.wg.data_ptr()
    assert kernels.launch_counts[f"{name}_bf16"] == before[f"{name}_bf16"] + 1
    assert kernels.launch_counts[name] == before[name] + 1
    # the mma.sync core's layouts are gone: both precisions run the walk
    assert sdf_mlp.PackedSDF._fields == ("n_freqs", "widths", "wg", "wg16")


@pytest.mark.parametrize("batched", [False, True])
def test_skin_wrappers_launch_bf16_on_the_walk_layout(spy, batched):
    packed = sdf_mlp.pack_distilled(distilled_from_numpy(model_arrays(4, widths=(21, 32, 48))))
    lead = (2,) if batched else ()
    name = "hand_energy_skin_batched" if batched else "hand_energy_skin"
    fn = kernels.hand_energy_skin_batched_cuda if batched else kernels.hand_energy_skin_cuda
    mask = mask_lookup.pack_mask(torch.zeros((6, 9), dtype=torch.bool))
    args = (torch.zeros(*lead, 3, 4), torch.zeros(*lead, 36, 16), torch.zeros(*lead, 3, 3),
            torch.zeros(3, 4, 5), torch.zeros(3, 5), torch.zeros(16, 5), torch.zeros(16), mask,
            (6, 9), packed)
    before = dict(kernels.launch_counts)
    fn(*args, compute_dtype=BF16)
    (call,) = spy.calls
    assert call[0] == "hotrack_hand_energy_skin_bf16" and call[9] == packed.wg16.data_ptr()
    assert kernels.launch_counts[f"{name}_bf16"] == before[f"{name}_bf16"] + 1
    assert kernels.launch_counts[name] == before[name]
    # 3xTF32: PackedSDF.wg, and the pre-pass's vertex scratch after hit, apart
    # from every input and output; then (p, k, n, h, w, S) as in bf16
    fn(*args)
    f32 = spy.calls[1]
    assert f32[0] == "hotrack_hand_energy_skin" and f32[9] == packed.wg.data_ptr()
    assert len(f32) == len(call) + 1 and f32[13:19] == call[12:18] == (3, 4, 5, 6, 9, len(lead) + 1)
    assert f32[12] not in f32[1:12] and f32[12] != 0
    assert kernels.launch_counts[name] == before[name] + 1
