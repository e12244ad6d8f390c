"""Port parity for MANO skinning fused with the hand energy
(hotrack_tpu_torch.ops.hand_energy_skin, mano.layer.mano_skin_inputs) against
hotrack_tpu on the CPU, on the bit-identical synthetic rig and the same
seeded candidates, model, mask and object pose.

Tolerances. `mano_skin_inputs`: keypoints, pose_map, rt_flat and offset to
2e-6 (the same elementwise chain in both packages; the fingertip mini-skin
sums in the library's order). `skin_reference`: vertices to 2e-6 m against
the JAX function, 5e-6 m against `mano_forward` (the JAX test's bound). The
plain fused version against the Pallas kernel in interpret mode: `sdf` to
3e-5 (the JAX package's bound between its routes), `hit` equal wherever the
float64 pixel coordinate is 2e-3 pixels clear of an integer (the vertices
differ by 1e-6 m, 1.4e-3 pixels at 600 / 0.45), and at least 99.9%
agreement overall, as the JAX test asks of its own routes.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hand_energy_cases import candidates, intrinsics, mask_of, object_pose, pixel_margin
from hotrack_tpu.mano import layer as jax_layer
from hotrack_tpu.mano.model import synthetic_mano_model as jax_mano
from hotrack_tpu.ops.pallas import hand_energy_skin as jax_skin
from hotrack_tpu.ops.pallas import mask_lookup as jax_mask_lookup
from hotrack_tpu_torch.mano import layer
from hotrack_tpu_torch.mano.model import synthetic_mano_model
from hotrack_tpu_torch.ops import hand_energy, hand_energy_skin, mask_lookup
from torch_sdf_models import random_model

N_VERTS = 778
MARGIN = 2e-3


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _jax_consts(mano, shaped):
    """The JAX kernel's per-call constants, as optimize_hand_pose builds them."""
    vp_pad = (N_VERTS + 127) // 128 * 128
    pad = ((0, 0), (0, 0), (0, vp_pad - N_VERTS))
    return (jnp.pad(jnp.transpose(mano.posedirs, (1, 2, 0)), pad),
            jnp.pad(jnp.swapaxes(shaped[0][0], 0, 1), pad[1:]),
            jnp.pad(jnp.swapaxes(mano.weights, 0, 1), pad[1:]))


@pytest.fixture(scope="module")
def both():
    """Candidates and their skinning inputs from both packages."""
    pose, trans, beta = candidates(6, seed=1)
    jm, tm = jax_mano(), synthetic_mano_model()
    jshaped = jax_layer.shape_hand(jm, jnp.asarray(beta))
    tshaped = layer.shape_hand(tm, _t(beta))
    jin = jax_layer.mano_skin_inputs(jm, jnp.asarray(pose), jnp.asarray(trans), jshaped)
    tin = layer.mano_skin_inputs(tm, _t(pose), _t(trans), tshaped)
    return dict(pose=pose, trans=trans, beta=beta, jm=jm, tm=tm, jshaped=jshaped,
                tshaped=tshaped, jin=jin, tin=tin, jconsts=_jax_consts(jm, jshaped),
                tconsts=hand_energy_skin.skin_consts(tm, tshaped))


def test_mano_skin_inputs_match_jax(both):
    for name, got, want in zip(("kp", "pose_map", "rt_flat", "offset"), both["tin"], both["jin"]):
        assert tuple(got.shape) == want.shape, name
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6, rtol=0,
                                   err_msg=name)
    _, kp_ref = layer.mano_forward(both["tm"], _t(both["pose"]), trans=_t(both["trans"]),
                                   shaped=both["tshaped"])
    np.testing.assert_allclose(both["tin"][0].numpy(), kp_ref.numpy(), atol=2e-6, rtol=0)


def test_skin_consts_are_the_jax_constants_without_padding(both):
    for got, want in zip(both["tconsts"], both["jconsts"]):
        assert got.is_contiguous() and got.shape[-1] == N_VERTS
        # the rig's arrays bitwise; the shaped vertices to the shape blend's rounding
        np.testing.assert_allclose(got.numpy(), np.asarray(want)[..., :N_VERTS],
                                   atol=1e-7 if got.dim() == 2 and got.shape[0] == 3 else 0,
                                   rtol=0)
    with pytest.raises(ValueError, match="one shape"):
        hand_energy_skin.skin_consts(both["tm"], layer.shape_hand(both["tm"], torch.zeros(2, 10)))


def test_skin_reference_matches_jax_and_mano_forward(both):
    _, pose_map, rt_flat, offset = both["tin"]
    verts = hand_energy_skin.skin_reference(pose_map, rt_flat, offset, both["tconsts"])
    assert tuple(verts.shape) == (6, N_VERTS, 3)
    want = jax_skin.skin_reference(*both["jin"][1:], *both["jconsts"])[:, :, :N_VERTS]
    np.testing.assert_allclose(verts.numpy(), np.moveaxis(np.asarray(want), 0, -1),
                               atol=2e-6, rtol=0)
    full, _ = layer.mano_forward(both["tm"], _t(both["pose"]), trans=_t(both["trans"]),
                                 shaped=both["tshaped"])
    np.testing.assert_allclose(verts.numpy(), full.numpy(), atol=5e-6, rtol=0)


@pytest.mark.parametrize("hw", [(64, 80), (37, 53), (1, 1)])
def test_plain_fused_version_matches_the_pallas_kernel_and_the_composition(both, hw):
    rot, otrans = object_pose(2)
    intr = intrinsics(hw)
    mask = mask_of(hw, 3)
    jmodel, tmodel = random_model(9, widths=(21, 32, 32))
    frame = hand_energy.hand_frame(_t(rot), _t(otrans), *(float(v) for v in intr))
    packed = mask_lookup.pack_mask(_t(mask))
    _, pose_map, rt_flat, offset = both["tin"]
    sdf, hit = hand_energy_skin.fused_hand_energy_skin(
        tmodel, packed, frame, pose_map, rt_flat, offset, both["tconsts"], hw)
    assert tuple(sdf.shape) == tuple(hit.shape) == (6, N_VERTS)

    want_sdf, want_hit = jax_skin.fused_hand_energy_skin(
        jmodel, jax_mask_lookup.pack_mask(jnp.asarray(mask)), jnp.asarray(rot),
        jnp.asarray(otrans), *(jnp.float32(v) for v in intr), *both["jin"][1:],
        *both["jconsts"], hw, interpret=True)
    want_sdf, want_hit = np.asarray(want_sdf)[:, :N_VERTS], np.asarray(want_hit)[:, :N_VERTS]
    np.testing.assert_allclose(sdf.numpy(), want_sdf, atol=3e-5, rtol=0)
    verts, _ = layer.mano_forward(both["tm"], _t(both["pose"]), trans=_t(both["trans"]),
                                  shaped=both["tshaped"])
    clear = pixel_margin(verts.numpy(), *intr) > MARGIN
    np.testing.assert_array_equal(hit.numpy()[clear], want_hit[clear])
    assert np.mean(hit.numpy() == want_hit) > 0.999

    # and the port's own composition: mano_forward + the plain per-vertex energy
    comp_sdf, comp_hit = hand_energy.fused_hand_energy(tmodel, packed, frame, verts, hw)
    np.testing.assert_allclose(sdf.numpy(), comp_sdf.numpy(), atol=3e-5, rtol=0)
    np.testing.assert_array_equal(hit.numpy()[clear], comp_hit.numpy()[clear])
    assert float((hit != comp_hit).float().mean()) < 1e-3


def test_mano_helpers_match_jax(both):
    """pca_comps2pose, mano_keypoints and template_keypoints, to 1e-6."""
    rng = np.random.RandomState(4)
    pca = rng.randn(5, 10).astype(np.float32)
    np.testing.assert_allclose(
        layer.pca_comps2pose(both["tm"], _t(pca)).numpy(),
        np.asarray(jax_layer.pca_comps2pose(both["jm"], jnp.asarray(pca))), atol=1e-6, rtol=0)
    assert tuple(layer.pca_comps2pose(both["tm"], _t(pca[:, :6]), 6).shape) == (5, 45)
    np.testing.assert_allclose(
        layer.mano_keypoints(both["tm"], _t(both["pose"]), _t(both["beta"]),
                             _t(both["trans"])).numpy(),
        np.asarray(jax_layer.mano_keypoints(both["jm"], jnp.asarray(both["pose"]),
                                            jnp.asarray(both["beta"]),
                                            jnp.asarray(both["trans"]))), atol=1e-6, rtol=0)
    for beta in (None, both["beta"]):
        got = layer.template_keypoints(both["tm"], None if beta is None else _t(beta))
        want = jax_layer.template_keypoints(both["jm"],
                                            None if beta is None else jnp.asarray(beta))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
        assert float(got[0, 0].abs().max()) == 0.0  # wrist-centred
