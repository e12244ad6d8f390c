"""Port parity for the fused per-vertex hand energy
(hotrack_tpu_torch.ops.hand_energy) against
hotrack_tpu.ops.pallas.hand_energy on the CPU: the same seeded model, mask,
object pose, intrinsics and camera-frame points through the plain PyTorch
version and the Pallas kernel in interpret mode.

Tolerances. `sdf`: 3e-5, the JAX package's own bound between its routes (its
kernel builds the higher Fourier octaves by the double-angle recurrence,
about 1e-6 off sinf / cosf, through a random net's steep first layer); the
same against the plain version run with the 3xTF32 emulation of the card's
kernel (ops/tf32.raw_sdf_mlp_3xtf32), whose own difference from the float32
plain version is held on the card at 2.5e-7 a value.
`hit`: exact wherever the pixel coordinate, computed in float64, is at least
1e-3 pixels from an integer (float32 rounding of (a / z) f + c at 640 pixels
is 6e-5, and XLA may contract the multiply-add); the share of other points
is small and they are not compared. Against the plain separate pieces of the
port itself (`fused_sdf_mlp`, the mask gather): exact.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hand_energy_cases import camera_points, intrinsics, mask_of, object_pose, pixel_margin
from hotrack_tpu.ops.pallas import hand_energy as jax_hand_energy
from hotrack_tpu.ops.pallas import mask_lookup as jax_mask_lookup
from hotrack_tpu_torch.ops import hand_energy, mask_lookup, sdf_mlp, tf32
from torch_sdf_models import random_model

SDF_ATOL = 3e-5
MARGIN = 1e-3


def _case(hw, shape, seed):
    rot, trans = object_pose(seed)
    return dict(hw=hw, mask=mask_of(hw, seed), rot=rot, trans=trans, intr=intrinsics(hw),
                pts=camera_points(shape, seed))


def _torch_run(case, model):
    frame = hand_energy.hand_frame(torch.from_numpy(case["rot"]), torch.from_numpy(case["trans"]),
                                   *(float(v) for v in case["intr"]))
    packed = mask_lookup.pack_mask(torch.from_numpy(case["mask"]))
    return frame, packed, hand_energy.fused_hand_energy(
        model, packed, frame, torch.from_numpy(case["pts"]), case["hw"])


@pytest.mark.parametrize("hw", [(64, 80), (37, 53), (1, 1)])
@pytest.mark.parametrize("shape", [(4, 150), (1, 300), (3, 2, 40)])
def test_plain_version_matches_the_pallas_kernel(hw, shape):
    case = _case(hw, shape, seed=len(shape) + hw[0])
    jmodel, tmodel = random_model(7, widths=(21, 32, 32))
    _, _, (sdf, hit) = _torch_run(case, tmodel)
    assert tuple(sdf.shape) == tuple(hit.shape) == shape
    want_sdf, want_hit = jax_hand_energy.fused_hand_energy(
        jmodel, jax_mask_lookup.pack_mask(jnp.asarray(case["mask"])), jnp.asarray(case["rot"]),
        jnp.asarray(case["trans"]), *(jnp.float32(v) for v in case["intr"]),
        jnp.asarray(np.swapaxes(case["pts"], -1, -2)), hw, interpret=True)
    np.testing.assert_allclose(sdf.numpy(), np.asarray(want_sdf), atol=SDF_ATOL, rtol=0)
    clear = pixel_margin(case["pts"], *case["intr"]) > MARGIN
    assert clear.mean() > 0.99 or hw == (1, 1)
    np.testing.assert_array_equal(hit.numpy()[clear], np.asarray(want_hit)[clear])
    if hw != (1, 1):
        assert 0.2 < float(hit.mean()) < 0.8


@pytest.mark.parametrize("widths,hw,shape", [((21, 128, 128, 128), (64, 80), (2, 70)),
                                             ((39, 32, 48, 32), (37, 53), (3, 45)),
                                             ((9, 128), (1, 1), (130,))])
def test_emulated_3xtf32_version_matches_the_pallas_kernel(widths, hw, shape):
    """The card's arithmetic (`_hand_energy_torch` with the 3xTF32 MLP)
    against the JAX package's `_fused_impl` in interpret mode: the shipped
    width, 6 frequencies at depth 3 over narrow layers, depth 1 over a ragged
    128-vertex round."""
    case = _case(hw, shape, seed=len(widths) + hw[0])
    jmodel, tmodel = random_model(9, widths=widths)
    frame = hand_energy.hand_frame(torch.from_numpy(case["rot"]), torch.from_numpy(case["trans"]),
                                   *(float(v) for v in case["intr"]))
    packed = mask_lookup.pack_mask(torch.from_numpy(case["mask"]))
    pts = torch.from_numpy(case["pts"]) if len(shape) > 1 else torch.from_numpy(case["pts"])[None]
    sdf, hit = hand_energy._hand_energy_torch(tmodel, packed, frame, pts, hw,
                                              mlp=tf32.raw_sdf_mlp_3xtf32)
    want_sdf, want_hit = jax_hand_energy.fused_hand_energy(
        jmodel, jax_mask_lookup.pack_mask(jnp.asarray(case["mask"])), jnp.asarray(case["rot"]),
        jnp.asarray(case["trans"]), *(jnp.float32(v) for v in case["intr"]),
        jnp.asarray(np.swapaxes(pts.numpy(), -1, -2)), hw, interpret=True)
    assert 0.02 < np.mean(np.abs(np.asarray(want_sdf)) >= 0.05) < 0.98   # the clamp is exercised
    np.testing.assert_allclose(sdf.numpy(), np.asarray(want_sdf), atol=SDF_ATOL, rtol=0)
    clear = pixel_margin(pts.numpy(), *case["intr"]) > MARGIN
    np.testing.assert_array_equal(hit.numpy()[clear], np.asarray(want_hit)[clear])


def test_plain_version_equals_its_separate_pieces_exactly():
    """sdf = the SDF MLP at (x - t) R summed as the kernel sums it, hit = the
    mask at the truncated, clipped pixel: both bitwise, clipped pixels on all
    four edges among them."""
    hw = (48, 64)
    case = _case(hw, (5, 200), seed=3)
    _, tmodel = random_model(8, widths=(21, 32, 32))
    frame, packed, (sdf, hit) = _torch_run(case, tmodel)
    pts = torch.from_numpy(case["pts"])
    obj_cf = hand_energy.object_frame(pts, frame)
    assert torch.equal(sdf, sdf_mlp.fused_sdf_mlp_cf(tmodel, obj_cf))
    # the object frame is R^T (x - t) to rounding
    want_obj = torch.matmul(pts - torch.from_numpy(case["trans"]), torch.from_numpy(case["rot"]))
    np.testing.assert_allclose(obj_cf.transpose(-1, -2).numpy(), want_obj.numpy(), atol=2e-7)
    fx, fy, cx, cy = case["intr"]
    iy = np.clip((case["pts"][..., 1] / case["pts"][..., 2] * fy + cy).astype(np.int32), 0, 47)
    ix = np.clip((case["pts"][..., 0] / case["pts"][..., 2] * fx + cx).astype(np.int32), 0, 63)
    for idx, hi in ((iy, 47), (ix, 63)):
        assert (idx == 0).any() and (idx == hi).any()
    np.testing.assert_array_equal(hit.numpy(), case["mask"][iy, ix].astype(np.float32))
    got_iy, got_ix = hand_energy.pixel_coords(pts, frame, hw)
    np.testing.assert_array_equal(got_iy.numpy(), iy)
    np.testing.assert_array_equal(got_ix.numpy(), ix)


def test_hand_frame_layout_and_tensor_intrinsics():
    rot, trans = object_pose(5)
    a = hand_energy.hand_frame(torch.from_numpy(rot), torch.from_numpy(trans), 600.0, 590.0,
                               320.0, 240.0)
    b = hand_energy.hand_frame(torch.from_numpy(rot), torch.from_numpy(trans)[:, None],
                               *(torch.tensor(v) for v in (600.0, 590.0, 320.0, 240.0)))
    assert tuple(a.shape) == (16,) and a.dtype == torch.float32 and torch.equal(a, b)
    np.testing.assert_array_equal(a[:9].numpy(), rot.T.reshape(-1))
    np.testing.assert_allclose(a[9:12].numpy(), rot.T @ trans, atol=1e-7)
    np.testing.assert_array_equal(a[12:].numpy(), [600.0, 590.0, 320.0, 240.0])


def test_fused_hand_energy_refuses_other_layouts():
    _, tmodel = random_model(8, widths=(21, 32, 32))
    frame = torch.zeros(16)
    packed = mask_lookup.pack_mask(torch.zeros((2, 2), dtype=torch.bool))
    with pytest.raises(ValueError, match=r"\(\.\.\., N, 3\)"):
        hand_energy.fused_hand_energy(tmodel, packed, frame, torch.zeros(3, 5), (2, 2))
