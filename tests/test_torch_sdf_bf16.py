"""HOTRACK_SDF_BF16 in the port: the distilled-SDF queries of the optimiser
energies in bf16 (hotrack_tpu_torch/sdf/distill.sdf_compute_dtype, the
`compute_dtype` of ops/sdf_mlp.py, ops/obj_energy.py, ops/hand_energy.py and
ops/hand_energy_skin.py), against the JAX package on the CPU.

The JAX oracle is the XLA path, `_raw_sdf` through `eval_distilled_sdf(_cf)(
..., compute_dtype=jnp.bfloat16)`, composed with the JAX package's own
object-frame transforms, under `jax.jit`. The Pallas kernels cannot run in
bf16 in interpret mode on XLA:CPU (its dot thunk has no bf16 x bf16 = f32:
"Unsupported element type for DotThunk::Execute"), so the JAX optimisers are
held on their CPU routes, which take that XLA path. JAX reads the variable
when it traces: every JAX function here is traced after the variable is set
(fresh closures, cleared jit caches).

Bounds. Both sides round the same float32 features and weights to bf16 and
sum exact products in float32, in different orders. A float32 sum that lands
on the other side of a bf16 rounding boundary moves one activation by a bf16
ulp, and the later layers carry that ("flips"), so no uniform tight bound
holds; a value is held by two parts:
- share: at least BF16_SDF_SHARE of the values within BF16_SDF_ATOL_TIGHT
  (the float32 sums' rounding; measured 0.1% of 20,000 values above 1e-6), at
  the shipped depth of 3 hidden layers and with at least 4 values allowed
  beyond it (torch_sdf_models.bf16_share_floor: each hidden layer's output is
  rounded once);
- flip: every value within `flip`, derived from the model and the points
  (torch_sdf_models.bf16_flip_atol): a flip moves an activation a by one bf16
  ulp, 2^(e - 7) for a in [2^e, 2^(e + 1)), and the output layer carries it
  with that unit's weight; the bound is the largest such step over the last
  hidden layer's units, each at its largest activation over the points
  (2.7e-4 to 1.2e-3 for the nets here; an earlier layer's flip is spread
  over the later weights and arrives smaller). Measured here: at most 1.9e-4.
A sum of N values (kernel #4's energies) is held at
bf16_sum_atol(N, flip) = N x BF16_SDF_ATOL_TIGHT + max(1, (1 - share) x N) x
flip: the share bound per value, with the flipped values' whole bound.
Silhouette hits do not depend on the SDF and stay exact.

The optimisers (open loop, iteration 0): energies at those bounds scaled as
the energy scales them (object: 500 / N times a sum; hand: one penetration
value, the attraction's five fingers at weight 0.05, and a flipped pixel
where the float64 pixel lies within 1e-4 of an integer), and the candidates
that beat particle 0 equal but for those within that bound of particle 0's
energy, which are counted and printed.
"""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hand_energy_cases import camera_points, candidates, intrinsics, mask_of, object_pose
from hotrack_tpu.mano.model import synthetic_mano_model as jax_mano
from hotrack_tpu.opt import hand_pose as jax_hand_pose
from hotrack_tpu.opt import obj_pose as jax_obj_pose
from hotrack_tpu.pose.rotations import rotvec_to_matrix as jax_rotvec_to_matrix
from hotrack_tpu.sdf import distill as jdistill
from hotrack_tpu_torch.mano import layer
from hotrack_tpu_torch.mano.model import synthetic_mano_model
from hotrack_tpu_torch.ops import (hand_energy, hand_energy_skin, kernels, mask_lookup,
                                   obj_energy, sdf_mlp)
from hotrack_tpu_torch.opt import hand_pose, obj_pose
from hotrack_tpu_torch.opt.particle import quat_extend
from hotrack_tpu_torch.pose.rotations import unit_quaternion_to_matrix
from hotrack_tpu_torch.sdf import distill
from hotrack_tpu_torch.track import ObjTracker, track_obj_sequence
from torch_sdf_models import (BF16_SDF_ATOL_TIGHT, bf16_flip_atol, bf16_share_floor,
                              bf16_sum_atol, model_arrays, random_model)

BF16 = torch.bfloat16
SMALL, WIDE = (21, 32, 32), (21, 128, 128)


def hold_sdf(tag, got, want, flip):
    """The share and flip bounds on sdf values; returns (share, largest)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all(), tag
    d = np.abs(got - want).ravel()
    share, worst = float(np.mean(d <= BF16_SDF_ATOL_TIGHT)), float(d.max())
    print(f"[bf16] {tag}: {100 * share:.3f}% within {BF16_SDF_ATOL_TIGHT:g}, largest {worst:.3e}"
          f" of {d.size} (flip bound {flip:.2e})")
    assert share >= bf16_share_floor(d.size), (tag, share)
    assert worst <= flip, (tag, worst, flip)
    return share, worst


def _jax_eval_cf(jmodel, pts_cf):
    return np.asarray(jax.jit(lambda m, p: jdistill.eval_distilled_sdf_cf(
        m, p, compute_dtype=jnp.bfloat16))(jmodel, jnp.asarray(pts_cf)))


def _jax_obj_frame_cf(points, rot, trans):
    """The JAX optimisers' object-frame transform: (..., N, 3) camera-frame
    points -> (..., 3, N), R^T (x - t) by einsum, as hand_pose's separate route."""
    return np.asarray(jax.jit(lambda h, r, t: jnp.einsum("...nj,ji->...in", h - t, r))(
        jnp.asarray(points), jnp.asarray(rot), jnp.asarray(trans)))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------------- reading


@pytest.mark.parametrize("value", [None, "", "0", "1"])
def test_sdf_compute_dtype_reads_the_variable_as_jax_does(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("HOTRACK_SDF_BF16", raising=False)
    else:
        monkeypatch.setenv("HOTRACK_SDF_BF16", value)
    want = jdistill.sdf_compute_dtype()
    got = distill.sdf_compute_dtype()
    assert (got is None) == (want is None)
    assert got is None or (got == torch.bfloat16 and want == jnp.bfloat16)
    assert (got is not None) == bool(value)   # "0" turns it on, as in JAX


def test_other_compute_dtypes_are_refused():
    _, tmodel = random_model(1, widths=SMALL)
    pts = torch.zeros(3, 5)
    for bad in (torch.float16, torch.float32, "bf16"):
        with pytest.raises(ValueError, match="bfloat16"):
            sdf_mlp.fused_sdf_mlp_cf(tmodel, pts, compute_dtype=bad)
        with pytest.raises(ValueError, match="bfloat16"):
            kernels._precision("sdf_mlp_cuda", bad)
    before = dict(kernels.launch_counts)
    with pytest.raises(ValueError, match="CUDA"):   # a CPU tensor at a kernel: no plain version
        kernels.sdf_mlp_cuda(pts, sdf_mlp.pack_distilled(tmodel), True, compute_dtype=BF16)
    assert kernels.launch_counts == before
    assert {f"{n}_bf16" for n in kernels.SDF_KERNELS} <= set(kernels.launch_counts)


# ------------------------------------------------------------------- weights


def _jax_bf16_bits(a) -> np.ndarray:
    return np.asarray(jnp.asarray(np.asarray(a)).astype(jnp.bfloat16)).view(np.uint16)


def _bits(words: torch.Tensor) -> np.ndarray:
    """float32 words -> their bf16 halves, low first."""
    return words.contiguous().numpy().view(np.uint16)


def _decode_wg16(buf, widths):
    """The bf16 wgmma image read through the tiles' descriptors (core matrix
    (nb, kb) at nb * kSbo + kb * kLbo bytes, 16 bytes a unit's row of 8
    k-slots): per hidden layer the weights of its k-slots (K slots, 128)."""
    f, n_hidden = widths[0] // 6, len(widths) - 1
    at = 4 + f + -f % 4 + 128 * n_hidden + 132
    kk, n = np.meshgrid(np.arange(16), np.arange(128), indexing="ij")
    index = ((n // 8) * 256 + (kk // 8) * 128 + (n % 8) * 16 + (kk % 8) * 2) // 2
    layers = []
    for l in range(n_hidden):
        steps = (3 * f + 10) // 8 if l == 0 else 8
        tiles = [_bits(buf[at + 1024 * s:at + 1024 * (s + 1)])[index] for s in range(steps)]
        layers.append(np.concatenate(tiles))
        at += 1024 * steps
    return layers


def _kernel_features16(x, freqs):
    """Layer 0's k-slots as the bf16 wgmma walk fills them (first_fragments16):
    x (M, 3) scaled coordinates -> (M, 16 ks0); lane t of k-step ks puts angle
    8 ks + 4 h + t's sine and cosine in k-slots 16 ks + 8 h + 2 t and + 1, or
    past the angles a coordinate in the first of the two."""
    f = len(freqs)
    angles, steps = 3 * f, (3 * f + 10) // 8
    out = np.zeros((x.shape[0], 16 * steps), np.float32)
    for ks in range(steps):
        for h in range(2):
            for t in range(4):
                j, c = 8 * ks + 4 * h + t, 16 * ks + 8 * h + 2 * t
                if j < angles:
                    ang = (x[:, j // f] * freqs[j % f]).astype(np.float32)
                    out[:, c], out[:, c + 1] = np.sin(ang), np.cos(ang)
                elif j < angles + 3:
                    out[:, c] = x[:, j - angles]
    return out


@pytest.mark.parametrize("widths", [SMALL, WIDE, (15, 32, 48, 64), (39, 128, 128)])
def test_packed_bf16_weights_are_bitwise_jax_and_laid_out_for_the_kernels(widths):
    arrays = model_arrays(7, widths=widths)
    tmodel = random_model(7, widths=widths)[1]
    packed = sdf_mlp.pack_distilled(tmodel)
    want = [_jax_bf16_bits(w) for w in arrays["weights"]]
    wg_layers = _decode_wg16(packed.wg16, packed.widths)
    for l, w in enumerate(want[1:-1], 1):   # the later layers' rows in order
        full = np.zeros((128, 128), np.uint16)
        full[:w.shape[0], :w.shape[1]] = w
        np.testing.assert_array_equal(wg_layers[l], full)
    f, n_hidden = len(arrays["freqs"]), len(widths) - 1
    header = 4 + 4 * math.ceil(f / 4)
    buf = packed.wg16.numpy()
    assert buf[0] == tmodel.scale and buf[1] == tmodel.clamp
    np.testing.assert_array_equal(buf[4:4 + f], arrays["freqs"])
    out_bits = buf[header + 128 * n_hidden:header + 128 * (n_hidden + 1)].view(np.uint32)
    np.testing.assert_array_equal(out_bits[:want[-1].shape[0]] >> 16, want[-1][:, 0])
    assert not (out_bits & 0xFFFF).any()          # bf16 values as float32 words
    # layer 0 of the wgmma walk: its k-slots' features times its slot rows are
    # the features times layer 0's bf16 weights, exactly (float64 sums of
    # exact products)
    x = np.random.RandomState(1).randn(64, 3).astype(np.float32)
    w0 = wg_layers[0].astype(np.uint32) << 16
    slots = _kernel_features16(x, arrays["freqs"])
    feats = sdf_mlp.fourier_features(_t(x), _t(arrays["freqs"]), 1.0).numpy()
    as64 = lambda a: sdf_mlp.bf16_round(_t(a)).double().numpy()   # noqa: E731
    got = as64(slots) @ w0.view(np.float32).astype(np.float64)
    units = widths[1]
    assert not got[:, units:].any()
    w0_jax = (want[0].astype(np.uint32) << 16).view(np.float32).astype(np.float64)
    np.testing.assert_allclose(got[:, :units], as64(feats) @ w0_jax, rtol=1e-12, atol=1e-12)
    batched = sdf_mlp.pack_distilled_batched([tmodel, random_model(8, widths=widths)[1]])
    assert torch.equal(batched.wg16[0], packed.wg16)


# ------------------------------------------------------------- plain versions


@pytest.mark.parametrize("widths", [SMALL, WIDE])
def test_plain_bf16_sdf_mlp_matches_jax(widths):
    jmodel, tmodel = random_model(11, widths=widths)
    pts_cf = (np.random.RandomState(2).randn(4, 3, 1250) * 0.15).astype(np.float32)
    want = _jax_eval_cf(jmodel, pts_cf)
    pts = np.swapaxes(pts_cf, -1, -2)
    flip = bf16_flip_atol(tmodel, _t(pts))
    hold_sdf(f"#3 cf {widths}", sdf_mlp.fused_sdf_mlp_cf(tmodel, _t(pts_cf),
                                                         compute_dtype=BF16).numpy(), want, flip)
    got = sdf_mlp.fused_sdf_mlp(tmodel, _t(pts), compute_dtype=BF16).numpy()
    hold_sdf(f"#3 channels-last {widths}", got, np.asarray(jax.jit(
        lambda m, p: jdistill.eval_distilled_sdf(m, p, compute_dtype=jnp.bfloat16))(
            jmodel, jnp.asarray(pts))), flip)
    assert np.array_equal(got, distill.eval_distilled_sdf(tmodel, _t(pts), None, BF16).numpy())
    f32 = sdf_mlp.fused_sdf_mlp(tmodel, _t(pts)).numpy()
    assert np.abs(got - f32).max() > 1e-5                       # bf16 really ran
    # the unset default is the float32 formula, bitwise
    h = sdf_mlp.fourier_features(_t(pts), tmodel.freqs, tmodel.scale)
    for i, (w, b) in enumerate(zip(tmodel.weights, tmodel.biases)):
        h = torch.matmul(h, w) + b
        h = torch.relu(h) if i < len(tmodel.weights) - 1 else h
    assert np.array_equal(f32, torch.clamp(h[..., 0], -tmodel.clamp, tmodel.clamp).numpy())


def test_plain_bf16_batched_sdf_mlp_matches_jax():
    pairs = [random_model(s, widths=SMALL) for s in (12, 13)]
    pts_cf = (np.random.RandomState(3).randn(2, 5, 3, 300) * 0.15).astype(np.float32)
    models = [p[1] for p in pairs]
    got = sdf_mlp.fused_sdf_mlp_cf_batched(models, _t(pts_cf), compute_dtype=BF16)
    for s, (jmodel, tmodel) in enumerate(pairs):
        hold_sdf(f"#3b sequence {s}", got[s].numpy(), _jax_eval_cf(jmodel, pts_cf[s]),
                 bf16_flip_atol(tmodel, _t(np.swapaxes(pts_cf[s], -1, -2))))
        assert torch.equal(got[s], sdf_mlp.fused_sdf_mlp_cf(tmodel, _t(pts_cf[s]),
                                                            compute_dtype=BF16))
    last = sdf_mlp.fused_sdf_mlp_batched(models, _t(np.swapaxes(pts_cf, -1, -2)),
                                         compute_dtype=BF16)
    assert torch.equal(last, got)


def _poses(p, seed):
    rng = np.random.RandomState(seed)
    rot = np.stack([np.asarray(jax_rotvec_to_matrix(jnp.asarray(v, jnp.float32)))
                    for v in rng.randn(p, 3)])
    return rot, (rng.randn(p, 3) * 0.05).astype(np.float32)


def _jax_obj_sums(jmodel, pcld_cf, rot, t):
    """(sums of |sdf| a candidate, the object-frame points (P, 3, N))."""
    rot_t = jnp.swapaxes(jnp.asarray(rot), -1, -2)
    obj = (jnp.einsum("pij,jn->pin", rot_t, jnp.asarray(pcld_cf))
           - jnp.matmul(rot_t, jnp.asarray(t)[..., None]))
    return np.asarray(jnp.sum(jnp.abs(jax.jit(lambda m, o: jdistill.eval_distilled_sdf_cf(
        m, o, compute_dtype=jnp.bfloat16))(jmodel, obj)), axis=-1)), np.asarray(obj)


def _flip_cf(tmodel, pts_cf) -> float:
    return bf16_flip_atol(tmodel, _t(np.swapaxes(np.asarray(pts_cf), -1, -2)))


@pytest.mark.parametrize("widths", [SMALL, WIDE])
def test_plain_bf16_obj_energy_matches_jax(widths):
    jmodel, tmodel = random_model(14, widths=widths)
    n = 200
    pcld_cf = (np.random.RandomState(4).randn(3, n) * 0.1).astype(np.float32)
    rot, t = _poses(40, 5)
    got = obj_energy.fused_obj_sdf_energy(tmodel, _t(pcld_cf), _t(rot), _t(t),
                                          compute_dtype=BF16).numpy()
    want, obj = _jax_obj_sums(jmodel, pcld_cf, rot, t)
    assert np.all(want > 0)
    worst, atol = np.abs(got - want).max(), bf16_sum_atol(n, _flip_cf(tmodel, obj))
    print(f"[bf16] #4 {widths}: largest {worst:.3e} of sums near {want.mean():.3f}, bound "
          f"{atol:.3e}")
    assert worst <= atol
    f32 = obj_energy.fused_obj_sdf_energy(tmodel, _t(pcld_cf), _t(rot), _t(t)).numpy()
    assert np.abs(got - f32).max() > 1e-5


def test_plain_bf16_batched_obj_energy_matches_unbatched_and_jax():
    pairs = [random_model(s, widths=SMALL) for s in (15, 16)]
    n = 150
    pcld_cf = (np.random.RandomState(6).randn(2, 3, n) * 0.1).astype(np.float32)
    poses = [_poses(20, s) for s in (7, 8)]
    rot, t = np.stack([p[0] for p in poses]), np.stack([p[1] for p in poses])
    got = obj_energy.fused_obj_sdf_energy_batched([p[1] for p in pairs], _t(pcld_cf), _t(rot),
                                                  _t(t), compute_dtype=BF16)
    for s, (jmodel, tmodel) in enumerate(pairs):
        one = obj_energy.fused_obj_sdf_energy(tmodel, _t(pcld_cf[s]), _t(rot[s]), _t(t[s]),
                                              compute_dtype=BF16)
        assert torch.equal(got[s], one)
        want, obj = _jax_obj_sums(jmodel, pcld_cf[s], rot[s], t[s])
        assert np.abs(got[s].numpy() - want).max() <= bf16_sum_atol(n, _flip_cf(tmodel, obj))


def _hand_inputs(hw=(48, 64), p=6, seed=0):
    rot, trans = object_pose(seed)
    fx, fy, cx, cy = intrinsics(hw)
    mask = mask_of(hw, seed)
    frame = hand_energy.hand_frame(_t(rot), _t(trans), fx, fy, cx, cy)
    return rot, trans, frame, mask_lookup.pack_mask(_t(mask)), hw


def test_plain_bf16_hand_energy_matches_jax():
    rot, trans, frame, bits, hw = _hand_inputs()
    for widths in (SMALL, WIDE):
        jmodel, tmodel = random_model(17, widths=widths)
        pts = camera_points((6, 300), seed=3)
        sdf, hit = hand_energy.fused_hand_energy(tmodel, bits, frame, _t(pts), hw,
                                                 compute_dtype=BF16)
        sdf32, hit32 = hand_energy.fused_hand_energy(tmodel, bits, frame, _t(pts), hw)
        assert torch.equal(hit, hit32)                           # hits do not change
        obj = _jax_obj_frame_cf(pts, rot, trans)
        hold_sdf(f"#6 {widths}", sdf.numpy(), _jax_eval_cf(jmodel, obj), _flip_cf(tmodel, obj))
        assert (sdf - sdf32).abs().max() > 1e-5
    # the batched route (#3b + #5b): sequence s bitwise the unbatched route
    models = [random_model(s, widths=SMALL)[1] for s in (18, 19)]
    pts = camera_points((2, 4, 200), seed=4)
    frames = torch.stack([frame, frame])
    got = hand_energy.fused_hand_energy_batched(models, torch.stack([bits, bits]), frames,
                                                _t(pts), hw, compute_dtype=BF16)
    for s in range(2):
        one = hand_energy.fused_hand_energy(models[s], bits, frame, _t(pts[s]), hw,
                                            compute_dtype=BF16)
        assert torch.equal(got[0][s], one[0]) and torch.equal(got[1][s], one[1])


def _skin_case(tm, p, seed):
    pose, trans, beta = candidates(p, seed)
    shaped = layer.shape_hand(tm, _t(beta))
    kp, pose_map, rt_flat, offset = layer.mano_skin_inputs(tm, _t(pose), _t(trans), shaped)
    return pose_map, rt_flat, offset, hand_energy_skin.skin_consts(tm, shaped)


def test_plain_bf16_hand_energy_skin_matches_jax():
    tm = synthetic_mano_model()
    rot, trans, frame, bits, hw = _hand_inputs()
    jmodel, tmodel = random_model(20, widths=SMALL)
    pose_map, rt_flat, offset, consts = _skin_case(tm, 4, 5)
    sdf, hit = hand_energy_skin.fused_hand_energy_skin(tmodel, bits, frame, pose_map, rt_flat,
                                                       offset, consts, hw, compute_dtype=BF16)
    sdf32, hit32 = hand_energy_skin.fused_hand_energy_skin(tmodel, bits, frame, pose_map,
                                                           rt_flat, offset, consts, hw)
    assert torch.equal(hit, hit32)
    verts = hand_energy_skin.skin_reference(pose_map, rt_flat, offset, consts).numpy()
    obj = _jax_obj_frame_cf(verts, rot, trans)
    hold_sdf("#7", sdf.numpy(), _jax_eval_cf(jmodel, obj), _flip_cf(tmodel, obj))
    # #7b: sequence s bitwise the unbatched kernel's plain version on s's inputs
    other = _skin_case(tm, 4, 6)
    models = [tmodel, random_model(21, widths=SMALL)[1]]
    consts2 = consts._replace(vshaped_cf=torch.stack([consts.vshaped_cf, other[3].vshaped_cf]))
    got = hand_energy_skin.fused_hand_energy_skin_batched(
        models, torch.stack([bits, bits]), torch.stack([frame, frame]),
        torch.stack([pose_map, other[0]]), torch.stack([rt_flat, other[1]]),
        torch.stack([offset, other[2]]), consts2, hw, compute_dtype=BF16)
    assert torch.equal(got[0][0], sdf) and torch.equal(got[1][0], hit)
    one = hand_energy_skin.fused_hand_energy_skin(models[1], bits, frame, *other[:3], other[3],
                                                  hw, compute_dtype=BF16)
    assert torch.equal(got[0][1], one[0]) and torch.equal(got[1][1], one[1])


# ----------------------------------------------------------------- optimisers

OBJ_P, OBJ_N = 96, 64


@pytest.fixture(scope="module")
def obj_scene():
    jmodel, tmodel = random_model(30, widths=SMALL)
    rng = np.random.RandomState(31)
    cam = (rng.randn(OBJ_N, 3) * 0.04).astype(np.float32) + np.float32([0.0, 0.0, 0.3])
    init_r = np.asarray(jax_rotvec_to_matrix(jnp.asarray([0.2, -0.1, 0.3], jnp.float32)))
    bank = rng.randn(OBJ_P, 6).astype(np.float32)
    bank[0] = 0.0
    return dict(jmodel=jmodel, tmodel=tmodel, cam=cam, init_r=init_r,
                init_t=np.array([[0.01], [0.0], [0.29]], np.float32), bank=bank)


def _obj_run(sc, route, trace=None, iterations=1):
    return obj_pose.optimize_obj_pose(
        None, _t(sc["bank"]), _t(sc["cam"]), _t(sc["init_r"]), _t(sc["init_t"]),
        iterations=iterations, distilled=sc["tmodel"], obj_energy=route, trace=trace)


def _first_energies(module, run):
    """The JAX optimiser's energies of iteration 0: its particle loop swapped
    for one evaluation of its own energy closure, traced afresh."""
    real = module.run_particle_opt

    def first(spec, presampled, initial_scale, params, energy_fn, apply_mean, extend_sample,
              **_):
        return params, energy_fn(params, extend_sample(presampled * initial_scale))[0]

    module.run_particle_opt = first
    jax.clear_caches()
    try:
        return run()
    finally:
        module.run_particle_opt = real
        jax.clear_caches()


def _hold_accepted(tag, got, want, atol):
    """Energies within atol; the candidates better than particle 0 equal but
    for those within atol of particle 0's energy (printed)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    worst = np.abs(got - want).max()
    assert worst <= atol, (tag, worst, atol)
    near = np.abs(want - want[0]) <= atol
    differ = (got < got[0]) != (want < want[0])
    print(f"[bf16] {tag}: energies within {worst:.3e} (bound {atol:.3e}); "
          f"{int((want < want[0]).sum())} candidates better than particle 0, "
          f"{int(near[1:].sum())} near-ties, {int(differ.sum())} of them taken on one side only")
    assert not (differ & ~near).any(), tag
    return int(near[1:].sum())


@pytest.mark.parametrize("route", ["fused", "composed"])
def test_obj_optimiser_under_the_variable_matches_jax(monkeypatch, obj_scene, route):
    sc = obj_scene
    monkeypatch.setenv("HOTRACK_SDF_BF16", "1")
    trace = []
    _obj_run(sc, route, trace)
    want = _first_energies(jax_obj_pose, lambda: np.asarray(jax_obj_pose.optimize_obj_pose(
        None, jnp.asarray(sc["bank"]), jnp.asarray(sc["cam"]), jnp.asarray(sc["init_r"]),
        jnp.asarray(sc["init_t"]), iterations=1, distilled=sc["jmodel"])[2]))
    sample = quat_extend(_t(sc["bank"]) * obj_pose.SCALING_COEFFICIENT1)
    rot = _t(sc["init_r"]) @ unit_quaternion_to_matrix(sample[:, :4])
    obj = torch.matmul(rot.transpose(-1, -2),
                       _t(sc["cam"]).T[None] - _t(sc["init_t"])[None] - sample[:, 4:, None])
    flip = _flip_cf(sc["tmodel"], obj.numpy())
    _hold_accepted(f"object {route}", trace[0][0].numpy(), want,
                   500.0 * bf16_sum_atol(OBJ_N, flip) / OBJ_N)
    monkeypatch.delenv("HOTRACK_SDF_BF16")
    plain = []
    _obj_run(sc, route, plain)
    assert (trace[0][0] - plain[0][0]).abs().max() > 1e-3     # bf16 really ran


def test_obj_routes_unset_and_empty_are_the_float32_route_bitwise(monkeypatch, obj_scene):
    for route in ("fused", "composed"):
        monkeypatch.delenv("HOTRACK_SDF_BF16", raising=False)
        unset = _obj_run(obj_scene, route, iterations=2)
        monkeypatch.setenv("HOTRACK_SDF_BF16", "")
        empty = _obj_run(obj_scene, route, iterations=2)
        assert all(torch.equal(a, b) for a, b in zip(unset, empty))


def test_batched_chunk_and_served_frames_under_the_variable(monkeypatch, obj_scene):
    """Under the variable: a chunk of two sequences through the batched
    optimiser gives each sequence's iteration-0 energies bitwise the
    unbatched optimiser's, and ObjTracker's served frames are bitwise the
    offline tracker's."""
    sc = obj_scene
    monkeypatch.setenv("HOTRACK_SDF_BF16", "0")
    other = random_model(32, widths=SMALL)[1]
    clouds = np.stack([sc["cam"], sc["cam"][::-1] + np.float32(0.002)])
    trace, ones = [], []
    obj_pose.optimize_obj_pose(
        None, _t(sc["bank"]), _t(clouds), _t(np.stack([sc["init_r"]] * 2)),
        _t(np.stack([sc["init_t"]] * 2)), iterations=1, distilled=[sc["tmodel"], other],
        trace=trace)
    for s, model in enumerate((sc["tmodel"], other)):
        one = []
        obj_pose.optimize_obj_pose(None, _t(sc["bank"]), _t(clouds[s]), _t(sc["init_r"]),
                                   _t(sc["init_t"]), iterations=1, distilled=model, trace=one)
        assert torch.equal(trace[0][0][s], one[0][0])
        ones.append(one[0][0])
    frames = _t(np.stack([sc["cam"], sc["cam"] + np.float32(0.001), sc["cam"][::-1]]))
    offline = track_obj_sequence(None, _t(sc["bank"]), frames, _t(sc["init_r"]),
                                 _t(sc["init_t"]), distilled=sc["tmodel"])
    tracker = ObjTracker(None, _t(sc["bank"]), distilled=sc["tmodel"])
    got = list(tracker.serve(tracker.init_state(_t(sc["init_r"]), _t(sc["init_t"])),
                             list(frames)))
    for f, g in enumerate(got):
        np.testing.assert_array_equal(g["rotation"], offline.rotation[f].numpy())
        np.testing.assert_array_equal(g["translation"], offline.translation[f].numpy())
    monkeypatch.delenv("HOTRACK_SDF_BF16")
    f32 = track_obj_sequence(None, _t(sc["bank"]), frames, _t(sc["init_r"]), _t(sc["init_t"]),
                             distilled=sc["tmodel"])
    assert not torch.equal(f32.sdf_energy, offline.sdf_energy)


HAND_HW = (64, 80)
HAND_INTR = {"fx": 75.0, "fy": 75.0, "cx": 40.0, "cy": 32.0}
HAND_WEIGHTS = {"penetrate_sum_loss": 1.0, "sil_loss": 0.1, "attraction_loss": 0.05,
                "vis_regu_loss": 10.0, "invis_regu_loss": 0.5, "temporal_smooth": 1.0}
HAND_P = 48
HAND_FLIP = 0.1 / 778   # one flipped silhouette pixel


def hand_e_atol(flip: float) -> float:
    """One penetration value, the attraction's five fingers at weight 0.05,
    and the float32 routes' own 2e-6 (tests/test_torch_hand_opt.py)."""
    return 2e-6 + (1.0 + 5 * 0.05) * flip


@pytest.fixture(scope="module")
def hand_scene():
    jmodel, tmodel = random_model(40, widths=SMALL)
    tm = synthetic_mano_model()
    rng = np.random.RandomState(41)
    theta = (rng.randn(1, 45) * 0.2).astype(np.float32)
    init_r = np.asarray(jax_rotvec_to_matrix(jnp.asarray(rng.randn(1, 3) * 0.3, jnp.float32)))
    init_t = np.array([[[0.02], [-0.01], [0.45]]], np.float32)
    beta = (rng.randn(1, 10) * 0.3).astype(np.float32)
    from hotrack_tpu_torch.pose.rotations import matrix_to_rotvec
    verts, kp = layer.mano_forward(tm, torch.cat([matrix_to_rotvec(_t(init_r)), _t(theta)], -1),
                                   betas=_t(beta), trans=_t(init_t[..., 0]))
    vis = np.ones((1, 21), bool)
    vis[0, [8, 12, 20]] = False
    bank = rng.randn(HAND_P, 16).astype(np.float32)
    bank[0] = 0.0
    # the start is off the prediction, so that candidates beat particle 0
    return dict(jmodel=jmodel, tmodel=tmodel, beta=beta, init_r=init_r,
                init_t=init_t + np.float32(0.01), theta=theta + np.float32(0.1),
                kp=kp.numpy(), verts=verts.numpy(), vis=vis, bank=bank,
                mask=mask_of(HAND_HW, 7),
                obj_r=np.asarray(jax_rotvec_to_matrix(jnp.asarray([0.2, -0.1, 0.3],
                                                                  jnp.float32))),
                obj_t=np.array([0.0, 0.0, 0.46], np.float32))


def _hand_args(sc, jnp_or_t):
    return [jnp_or_t(sc[k]) for k in ("beta", "init_r", "init_t", "theta", "kp", "vis", "kp")]


def _hand_run(sc, route, trace):
    return hand_pose.optimize_hand_pose(
        synthetic_mano_model(), _t(sc["bank"]), hand_pose.load_contact_zones(None), None,
        *_hand_args(sc, _t), 1.0, _t(sc["obj_r"]), _t(sc["obj_t"]), _t(sc["mask"]), HAND_INTR,
        HAND_WEIGHTS, iterations=1, distilled=sc["tmodel"], hand_energy=route, trace=trace)


def test_hand_optimiser_under_the_variable_matches_jax(monkeypatch, hand_scene):
    sc = hand_scene
    monkeypatch.setenv("HOTRACK_SDF_BF16", "1")
    want = _first_energies(jax_hand_pose, lambda: np.asarray(jax_hand_pose.optimize_hand_pose(
        jax_mano(), jnp.asarray(sc["bank"]), jax_hand_pose.load_contact_zones(None), None,
        *_hand_args(sc, jnp.asarray), jnp.asarray(1.0), jnp.asarray(sc["obj_r"]),
        jnp.asarray(sc["obj_t"]), jnp.asarray(sc["mask"]), HAND_INTR, HAND_WEIGHTS,
        iterations=1, distilled=sc["jmodel"])[4]))
    assert want.max() - want.min() > 1e-3
    # the flip bound at the start's vertices, twice over for the candidates' spread
    flip = 2 * _flip_cf(sc["tmodel"], _jax_obj_frame_cf(sc["verts"], sc["obj_r"], sc["obj_t"]))
    energies = {}
    for route in ("skin", "fused", "separate"):
        trace = []
        _hand_run(sc, route, trace)
        energies[route] = trace[0][0].numpy()
        # a vertex's pixel may flip between the routes' float32 vertices
        _hold_accepted(f"hand {route}", energies[route], want, hand_e_atol(flip) + 2 * HAND_FLIP)
    monkeypatch.delenv("HOTRACK_SDF_BF16")
    plain = []
    _hand_run(sc, "skin", plain)
    assert np.abs(plain[0][0].numpy() - energies["skin"]).max() > 1e-6    # bf16 really ran
