"""Port parity for the batched kernels' plain versions (a model, mask, shape
and object pose a sequence) against the JAX package's batched Pallas kernels
in interpret mode, reached as the JAX package reaches them: `jax.vmap` of the
unbatched entry over per-sequence assets, whose `custom_vmap` rules launch
`_cf_impl_batched` (#3b), `_obj_impl_batched` (#4b), `_lookup_impl_batched`
(#5b) and `_skin_impl_batched` (#7b); the hand energy's rule falls back to
#3b + #5b, which `fused_hand_energy_batched` follows. On the CPU the port's
batched entries are those plain versions, so holding them holds the batched
kernels' oracles (tests/test_torch_batched_kernels_gpu.py holds the kernels
against them on a card).

Every sequence gets its own seeded model, mask, object pose and shape, made
with numpy. Tolerances, as the unbatched tests state them: the SDF MLP 2e-5
a value (the TPU kernel's double-angle recurrence), the object energy rtol
2e-5 + atol 2e-5 of a sum, the mask lookup exact; the fused skinning sdf to
3e-5 and hit equal wherever the float64 pixel is 2e-3 pixels clear of an
integer; the fused hand energy sdf to 3e-5, hit where 1e-3 clear.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hand_energy_cases import (camera_points, candidates, intrinsics, mask_of, object_pose,
                               pixel_margin)
from hotrack_tpu.mano import layer as jax_layer
from hotrack_tpu.mano.model import synthetic_mano_model as jax_mano
from hotrack_tpu.ops.pallas import hand_energy as jax_hand_energy
from hotrack_tpu.ops.pallas import hand_energy_skin as jax_skin
from hotrack_tpu.ops.pallas import mask_lookup as jax_mask_lookup
from hotrack_tpu.ops.pallas import obj_energy as jax_obj_energy
from hotrack_tpu.ops.pallas import sdf_mlp as jax_sdf_mlp
from hotrack_tpu.pose.rotations import unit_quaternion_to_matrix as jax_quat_to_matrix
from hotrack_tpu_torch.mano import layer
from hotrack_tpu_torch.mano.model import synthetic_mano_model
from hotrack_tpu_torch.ops import (hand_energy, hand_energy_skin, kernels, mask_lookup,
                                   obj_energy, sdf_mlp)
from torch_sdf_models import random_model

N_VERTS = 778


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Thousands of operations on small tensors: one intra-op thread runs them
    faster than a pool, and does not contend with the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _models(s, seed=0, widths=(21, 32, 32)):
    """S distinct seeded models: (the JAX stack, the port's list)."""
    pairs = [random_model(seed + 5 * i, widths=widths) for i in range(s)]
    return jax.tree.map(lambda *xs: jnp.stack(xs), *[p[0] for p in pairs]), [p[1] for p in pairs]


def _poses(rng, s, p):
    q = rng.randn(s, p, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    rot = np.array(jax_quat_to_matrix(jnp.asarray(q)), np.float32)
    return rot, (rng.randn(s, p, 3) * 0.05).astype(np.float32)


@pytest.mark.parametrize("shape,cf", [((3, 2, 3, 129), True), ((2, 5, 3, 40), True),
                                      ((3, 37, 3), False), ((2, 1, 1, 3), False)])
def test_sdf_mlp_batched_plain_version_matches_the_batched_pallas_kernel(shape, cf):
    s = shape[0]
    jmodels, tmodels = _models(s, seed=1)
    pts = (np.random.RandomState(s + len(shape)).randn(*shape) * 0.1).astype(np.float32)
    fn = sdf_mlp.fused_sdf_mlp_cf_batched if cf else sdf_mlp.fused_sdf_mlp_batched
    got = fn(tmodels, _t(pts))
    assert tuple(got.shape) == (shape[:-2] + shape[-1:] if cf else shape[:-1])
    jfn = jax_sdf_mlp.fused_sdf_mlp_cf if cf else jax_sdf_mlp.fused_sdf_mlp
    want = jax.vmap(lambda m, p: jfn(m.weights, m.biases, m.freqs, m.scale, m.clamp, p,
                                     interpret=True))(jmodels, jnp.asarray(pts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)
    # each sequence is its own model's unbatched plain version, bitwise
    for i, m in enumerate(tmodels):
        one = (sdf_mlp.fused_sdf_mlp_cf if cf else sdf_mlp.fused_sdf_mlp)(m, _t(pts[i]))
        assert torch.equal(got[i], one)
    assert not torch.equal(got[1], (sdf_mlp.fused_sdf_mlp_cf if cf else sdf_mlp.fused_sdf_mlp)(
        tmodels[0], _t(pts[1])))


@pytest.mark.parametrize("s,p,n", [(3, 16, 256), (2, 7, 129), (2, 1, 1)])
def test_obj_energy_batched_plain_version_matches_the_batched_pallas_kernel(s, p, n):
    rng = np.random.RandomState(p + n)
    jmodels, tmodels = _models(s, seed=20, widths=(21, 128, 128))
    pcld = (rng.randn(s, 3, n) * 0.1).astype(np.float32)
    rot, trans = _poses(rng, s, p)
    got = obj_energy.fused_obj_sdf_energy_batched(tmodels, _t(pcld), _t(rot), _t(trans))
    assert tuple(got.shape) == (s, p)
    want = jax.vmap(lambda m, c, r, t: jax_obj_energy.fused_obj_sdf_energy(
        m, c, r, t, interpret=True))(jmodels, jnp.asarray(pcld), jnp.asarray(rot),
                                     jnp.asarray(trans))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    for i, m in enumerate(tmodels):
        assert torch.equal(got[i], obj_energy.fused_obj_sdf_energy(
            m, _t(pcld[i]), _t(rot[i]), _t(trans[i])))
    # translations (S, P, 3, 1) give the same
    assert torch.equal(got, obj_energy.fused_obj_sdf_energy_batched(
        tmodels, _t(pcld), _t(rot), _t(trans)[..., None]))


@pytest.mark.parametrize("hw", [(64, 80), (37, 53), (1, 1)])
@pytest.mark.parametrize("shape", [(3, 200), (2, 7, 13), (4, 1)])
def test_mask_lookup_batched_plain_version_is_exact(hw, shape):
    rng = np.random.RandomState(hw[0] + len(shape))
    s = shape[0]
    masks = np.stack([mask_of(hw, 30 + i) for i in range(s)])
    iy = rng.randint(0, hw[0], shape).astype(np.int32)
    ix = rng.randint(0, hw[1], shape).astype(np.int32)
    packed = torch.stack([mask_lookup.pack_mask(_t(m)) for m in masks])
    got = mask_lookup.packed_mask_lookup_batched(packed, _t(iy), _t(ix), hw)
    want = jax.vmap(lambda pk, a, b: jax_mask_lookup.packed_mask_lookup(
        pk, a, b, interpret=True))(jnp.stack([jax_mask_lookup.pack_mask(jnp.asarray(m))
                                              for m in masks]), jnp.asarray(iy), jnp.asarray(ix))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for i in range(s):
        np.testing.assert_array_equal(got[i].numpy(), masks[i][iy[i], ix[i]].astype(np.float32))


def _skin_both(s, p, hw):
    """S sequences of P candidates, each with its own shape, object pose,
    mask, intrinsics and model, in both packages."""
    jm, tm = jax_mano(), synthetic_mano_model()
    betas = np.concatenate([candidates(1, 40 + i)[2] for i in range(s)])
    jshaped = jax_layer.shape_hand(jm, jnp.asarray(betas))
    tshaped = layer.shape_hand(tm, _t(betas))
    jin, tin = [], []
    for i in range(s):
        pose, trans, _ = candidates(p, 50 + i)
        jin.append(jax_layer.mano_skin_inputs(jm, jnp.asarray(pose), jnp.asarray(trans),
                                              (jshaped[0][i:i + 1], jshaped[1][i:i + 1])))
        tin.append(layer.mano_skin_inputs(tm, _t(pose), _t(trans),
                                          (tshaped[0][i:i + 1], tshaped[1][i:i + 1])))
    poses = [object_pose(60 + i) for i in range(s)]
    intr = np.array([intrinsics(hw) for _ in range(s)], np.float32) \
        * (1.0 + 0.05 * np.arange(s, dtype=np.float32))[:, None]
    masks = np.stack([mask_of(hw, 70 + i) for i in range(s)])
    return dict(jm=jm, tm=tm, jshaped=jshaped, tshaped=tshaped, jin=jin, tin=tin,
                rot=np.stack([q[0] for q in poses]), otrans=np.stack([q[1] for q in poses]),
                intr=intr, masks=masks)


@pytest.mark.parametrize("hw", [(64, 80), (37, 53)])
def test_hand_energy_skin_batched_plain_version_matches_the_batched_pallas_kernel(hw):
    s, p = 2, 5
    c = _skin_both(s, p, hw)
    jmodels, tmodels = _models(s, seed=9)
    # the port: per-candidate inputs (S, ...), a shape, frame, mask and model a sequence
    pose_map, rt_flat, offset = (torch.stack(x) for x in zip(*[t[1:] for t in c["tin"]]))
    consts = hand_energy_skin.skin_consts(c["tm"], c["tshaped"], batched=True)
    frames = hand_energy.hand_frame(_t(c["rot"]), _t(c["otrans"]),
                                    *(_t(c["intr"][:, j]) for j in range(4)))
    packed = torch.stack([mask_lookup.pack_mask(_t(m)) for m in c["masks"]])
    sdf, hit = hand_energy_skin.fused_hand_energy_skin_batched(
        tmodels, packed, frames, pose_map, rt_flat, offset, consts, hw)
    assert tuple(sdf.shape) == tuple(hit.shape) == (s, p, N_VERTS)

    # JAX: vmap over the per-sequence assets, posedirs and weights shared
    vp_pad = (N_VERTS + 127) // 128 * 128
    pad = ((0, 0), (0, vp_pad - N_VERTS))
    posed_cf = jnp.pad(jnp.transpose(c["jm"].posedirs, (1, 2, 0)), ((0, 0),) + pad)
    w_t = jnp.pad(jnp.swapaxes(c["jm"].weights, 0, 1), pad)
    vshap = jnp.stack([jnp.pad(jnp.swapaxes(c["jshaped"][0][i], 0, 1), pad) for i in range(s)])
    jpm, jrf, joff = (jnp.stack(x) for x in zip(*[j[1:] for j in c["jin"]]))
    jpacked = jnp.stack([jax_mask_lookup.pack_mask(jnp.asarray(m)) for m in c["masks"]])
    want_sdf, want_hit = jax.vmap(
        lambda m, pk, r, t, fx, fy, cx, cy, pm, rf, of, vs: jax_skin.fused_hand_energy_skin(
            m, pk, r, t, fx, fy, cx, cy, pm, rf, of, posed_cf, vs, w_t, hw, interpret=True))(
        jmodels, jpacked, jnp.asarray(c["rot"]), jnp.asarray(c["otrans"]),
        *(jnp.asarray(c["intr"][:, j]) for j in range(4)), jpm, jrf, joff, vshap)
    want_sdf = np.asarray(want_sdf)[..., :N_VERTS]
    want_hit = np.asarray(want_hit)[..., :N_VERTS]
    np.testing.assert_allclose(sdf.numpy(), want_sdf, atol=3e-5, rtol=0)
    for i in range(s):
        verts = hand_energy_skin.skin_reference(
            pose_map[i], rt_flat[i], offset[i],
            consts._replace(vshaped_cf=consts.vshaped_cf[i])).numpy()
        clear = pixel_margin(verts, *c["intr"][i]) > 2e-3
        np.testing.assert_array_equal(hit[i].numpy()[clear], want_hit[i][clear])
        assert np.mean(hit[i].numpy() == want_hit[i]) > 0.99
        # and the unbatched plain version on sequence i's inputs, bitwise
        one = hand_energy_skin.fused_hand_energy_skin(
            tmodels[i], packed[i], frames[i], pose_map[i], rt_flat[i], offset[i],
            hand_energy_skin.skin_consts(c["tm"], (c["tshaped"][0][i:i + 1],
                                                   c["tshaped"][1][i:i + 1])), hw)
        assert torch.equal(sdf[i], one[0]) and torch.equal(hit[i], one[1])
    # the shapes differ, so sequence 0's shape in place of sequence 1's moves the sdf
    other = hand_energy_skin.fused_hand_energy_skin(
        tmodels[1], packed[1], frames[1], pose_map[1], rt_flat[1], offset[1],
        consts._replace(vshaped_cf=consts.vshaped_cf[0]), hw)
    assert not torch.equal(other[0], sdf[1])


@pytest.mark.parametrize("hw", [(64, 80), (1, 1)])
def test_fused_hand_energy_batched_follows_the_jax_batched_rule(hw):
    """Per-sequence assets: the object-frame transform, #3b and #5b, as the
    JAX rule composes them."""
    s = 3
    jmodels, tmodels = _models(s, seed=12)
    pts = np.stack([camera_points((4, 60), seed=80 + i) for i in range(s)])
    poses = [object_pose(90 + i) for i in range(s)]
    rot, otrans = np.stack([q[0] for q in poses]), np.stack([q[1] for q in poses])
    intr = np.array([intrinsics(hw) for _ in range(s)], np.float32)
    masks = np.stack([mask_of(hw, 95 + i) for i in range(s)])
    frames = hand_energy.hand_frame(_t(rot), _t(otrans), *(_t(intr[:, j]) for j in range(4)))
    packed = torch.stack([mask_lookup.pack_mask(_t(m)) for m in masks])
    sdf, hit = hand_energy.fused_hand_energy_batched(tmodels, packed, frames, _t(pts), hw)
    assert tuple(sdf.shape) == tuple(hit.shape) == (s, 4, 60)
    want_sdf, want_hit = jax.vmap(
        lambda m, pk, r, t, fx, fy, cx, cy, p: jax_hand_energy.fused_hand_energy(
            m, pk, r, t, fx, fy, cx, cy, p, hw, interpret=True))(
        jmodels, jnp.stack([jax_mask_lookup.pack_mask(jnp.asarray(m)) for m in masks]),
        jnp.asarray(rot), jnp.asarray(otrans), *(jnp.asarray(intr[:, j]) for j in range(4)),
        jnp.asarray(np.swapaxes(pts, -1, -2)))
    np.testing.assert_allclose(sdf.numpy(), np.asarray(want_sdf), atol=3e-5, rtol=0)
    for i in range(s):
        clear = pixel_margin(pts[i], *intr[i]) > 1e-3
        np.testing.assert_array_equal(hit[i].numpy()[clear], np.asarray(want_hit)[i][clear])
        # sequence i is the unbatched fused route's plain version on its inputs
        one_sdf, one_hit = hand_energy.fused_hand_energy(tmodels[i], packed[i], frames[i],
                                                         _t(pts[i]), hw)
        np.testing.assert_allclose(sdf[i].numpy(), one_sdf.numpy(), atol=1e-6, rtol=0)
        assert torch.equal(hit[i], one_hit)


def test_hand_frame_of_several_sequences_is_each_sequences_frame():
    rot = np.stack([object_pose(i)[0] for i in range(3)])
    otrans = np.stack([object_pose(i)[1] + 0.01 * i for i in range(3)])
    intr = np.array([intrinsics((48, 64))] * 3, np.float32) * np.float32(1.1)
    frames = hand_energy.hand_frame(_t(rot), _t(otrans), *(_t(intr[:, j]) for j in range(4)))
    assert tuple(frames.shape) == (3, 16)
    for i in range(3):
        one = hand_energy.hand_frame(_t(rot[i]), _t(otrans[i]), *(float(v) for v in intr[i]))
        # R^T and the intrinsics bitwise; R^T t by a batched matrix product,
        # whose sums may round in another order
        assert torch.equal(frames[i, :9], one[:9]) and torch.equal(frames[i, 12:], one[12:])
        np.testing.assert_allclose(frames[i, 9:12].numpy(), one[9:12].numpy(), atol=1e-7,
                                   rtol=0)


def test_batched_entries_refuse_mismatched_sequences():
    _, tmodels = _models(3, seed=2)
    with pytest.raises(ValueError, match="sequence"):
        sdf_mlp.fused_sdf_mlp_cf_batched(tmodels[:2], torch.zeros(3, 2, 3, 5))
    with pytest.raises(ValueError, match="equal widths"):
        sdf_mlp.pack_distilled_batched([tmodels[0], random_model(3, widths=(21, 32, 48))[1]])
    with pytest.raises(ValueError, match="S, 3, N"):
        obj_energy.fused_obj_sdf_energy_batched(tmodels, torch.zeros(3, 5, 3),
                                                torch.eye(3).expand(3, 2, 3, 3),
                                                torch.zeros(3, 2, 3))
    with pytest.raises(ValueError, match="S, H, WP"):
        mask_lookup.packed_mask_lookup_batched(torch.zeros(2, 4, 2, dtype=torch.uint8),
                                               torch.zeros(3, 5, dtype=torch.int32),
                                               torch.zeros(3, 5, dtype=torch.int32), (4, 9))
    before = kernels.launch_counts["sdf_mlp_batched"]
    with pytest.raises(ValueError, match="CUDA"):
        kernels.sdf_mlp_batched_cuda(torch.zeros(3, 2, 3), sdf_mlp.pack_distilled_batched(
            tmodels), False)
    assert kernels.launch_counts["sdf_mlp_batched"] == before
