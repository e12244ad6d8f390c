"""The three hand-energy kernels of hotrack_tpu_torch on a card: the packed
mask lookup (csrc/mask_lookup.cu), the fused per-vertex energy
(csrc/hand_energy.cu) and skinning fused with it (csrc/hand_energy_skin.cu),
each against its plain PyTorch version on the same device. All tests here
are marked `gpu` and skip without a CUDA device: a CUDA kernel has no
interpret mode. The plain versions themselves are held against the JAX
package in test_torch_mask_lookup.py, test_torch_hand_energy.py and
test_torch_hand_energy_skin.py, on the CPU.

This file imports torch and the port only, so it runs on a machine with a
card and no JAX:

    python -m pytest tests/test_torch_hand_kernels.py -m gpu -q

Tolerances, both sides float32. The lookup: exact. The fused energy: `hit`
exact (the kernel rounds every step of the projection as eager PyTorch
does), `sdf` within 5e-7 (the MLP's sums in another order). The fused
skinning: the kernel sums a vertex in ascending order with FMA, the plain
version by library products, so the vertices differ by float32 rounding
(1e-7 m) and with them `sdf` by up to SKIN_SDF_ATOL through the random net's
steep features, and `hit` may flip where the plain version's pixel
coordinate lies within PIXEL_MARGIN of an integer: it is held equal
everywhere else. Two launches of every kernel agree bitwise.
"""

import numpy as np
import pytest
import torch

from hotrack_tpu_torch.mano.layer import mano_forward, mano_skin_inputs, shape_hand
from hotrack_tpu_torch.mano.model import synthetic_mano_model
from hotrack_tpu_torch.ops import hand_energy, hand_energy_skin, kernels, mask_lookup
from hotrack_tpu_torch.utils.convert import distilled_from_numpy
from hand_energy_cases import camera_points, candidates, intrinsics, mask_of, object_pose
from torch_sdf_models import model_arrays

SDF_ATOL = 5e-7
SKIN_SDF_ATOL = 2e-5
PIXEL_MARGIN = 2e-3   # pixels
MODELS = {
    "shipped width": dict(widths=(21, 128, 128, 128)),
    "narrow, non-geometric frequencies": dict(widths=(15, 32, 48), freqs=[1.0, 2.5]),
}
MASKS = [(480, 640), (1, 1), (37, 53)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA kernel has no interpret mode")
    return torch.device("cuda")


def _mask(seed, hw, device):
    return torch.from_numpy(mask_of(hw, seed)).to(device)


def _frame(seed, hw, device):
    rot, trans = object_pose(seed)
    return hand_energy.hand_frame(torch.from_numpy(rot).to(device),
                                  torch.from_numpy(trans).to(device),
                                  *(float(v) for v in intrinsics(hw)))


@pytest.mark.gpu
@pytest.mark.parametrize("hw", MASKS)
@pytest.mark.parametrize("shape,offset", [((5120, 778), 0), ((7, 13), 0), ((1,), 0),
                                          ((1001,), 1), ((64, 778), 3)])
def test_mask_lookup_kernel_is_exact(cuda_device, hw, shape, offset):
    """Against the plain version and against mask[iy, ix]; `offset` starts the
    index arrays off a 16-byte boundary (the kernel's scalar path)."""
    rng = np.random.RandomState(hw[0] + len(shape))
    mask = _mask(1, hw, cuda_device)
    packed = mask_lookup.pack_mask(mask)
    n = int(np.prod(shape))

    def index(hi):
        store = torch.from_numpy(rng.randint(0, hi, n + offset).astype(np.int32)).to(cuda_device)
        return store[offset:].reshape(shape)

    iy, ix = index(hw[0]), index(hw[1])
    before = kernels.launch_counts["packed_mask_lookup"]
    got = mask_lookup.packed_mask_lookup(packed, iy, ix, hw)
    again = mask_lookup.packed_mask_lookup(packed, iy, ix, hw)
    torch.cuda.synchronize()
    assert kernels.launch_counts["packed_mask_lookup"] == before + 2
    assert got.shape == iy.shape and got.dtype == torch.float32
    assert torch.equal(got, again)
    assert torch.equal(got, mask_lookup._packed_mask_lookup_torch(packed, iy, ix))
    assert torch.equal(got, mask[iy.long(), ix.long()].float())


@pytest.mark.gpu
def test_mask_lookup_kernel_refuses_what_it_does_not_take(cuda_device):
    mask = mask_lookup.pack_mask(torch.zeros((4, 9), dtype=torch.bool, device=cuda_device))
    idx = torch.zeros(8, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="int32"):
        kernels.packed_mask_lookup_cuda(mask, idx.long(), idx.long(), (4, 9))
    with pytest.raises(ValueError, match="packed mask"):
        kernels.packed_mask_lookup_cuda(mask, idx, idx, (4, 17))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.packed_mask_lookup_cuda(mask, idx.cpu(), idx.cpu(), (4, 9))


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("hw", MASKS)
@pytest.mark.parametrize("shape", [(64, 778), (7, 10), (1, 1), (300,)])
def test_hand_energy_kernel_matches_plain_version(cuda_device, name, hw, shape):
    model = distilled_from_numpy(model_arrays(2, **MODELS[name]), device=cuda_device)
    packed_mask = mask_lookup.pack_mask(_mask(2, hw, cuda_device))
    frame = _frame(3, hw, cuda_device)
    pts = torch.from_numpy(camera_points(shape, seed=shape[0])).to(cuda_device)
    if len(shape) == 1:
        pts = pts[None]
    before = kernels.launch_counts["hand_energy"]
    sdf, hit = hand_energy.fused_hand_energy(model, packed_mask, frame, pts, hw)
    sdf2, hit2 = hand_energy.fused_hand_energy(model, packed_mask, frame, pts, hw)
    torch.cuda.synchronize()
    assert kernels.launch_counts["hand_energy"] == before + 2
    assert torch.equal(sdf, sdf2) and torch.equal(hit, hit2)
    want_sdf, want_hit = hand_energy._hand_energy_torch(model, packed_mask, frame, pts, hw)
    assert sdf.shape == want_sdf.shape == pts.shape[:-1] and hit.shape == sdf.shape
    assert bool(torch.isfinite(sdf).all())
    assert torch.equal(hit, want_hit)
    assert float((sdf - want_sdf).abs().max()) <= SDF_ATOL
    if hw == (480, 640) and shape == (64, 778):
        iy, ix = hand_energy.pixel_coords(pts, frame, hw)
        for idx, hi in ((iy, hw[0] - 1), (ix, hw[1] - 1)):  # the clip is exercised
            assert int((idx == 0).sum()) > 0 and int((idx == hi).sum()) > 0
        assert 0.2 < float(hit.mean()) < 0.8


@pytest.mark.gpu
def test_hand_energy_kernel_refuses_what_it_does_not_take(cuda_device):
    model = distilled_from_numpy(model_arrays(2, **MODELS["shipped width"]), device=cuda_device)
    packed_mask = mask_lookup.pack_mask(_mask(0, (8, 8), cuda_device))
    frame = _frame(0, (8, 8), cuda_device)
    pts = torch.from_numpy(camera_points((4, 5))).to(cuda_device)
    from hotrack_tpu_torch.ops.sdf_mlp import pack_distilled
    packed = pack_distilled(model)
    with pytest.raises(ValueError, match="float32"):
        kernels.hand_energy_cuda(pts.double(), frame, packed_mask, (8, 8), packed)
    with pytest.raises(ValueError, match="frame"):
        kernels.hand_energy_cuda(pts, frame[:12].contiguous(), packed_mask, (8, 8), packed)
    with pytest.raises(ValueError, match="packed mask"):
        kernels.hand_energy_cuda(pts, frame, packed_mask, (8, 9), packed)


def _skin_case(seed, p, n_verts, device):
    """Candidates around a hand 0.45 m in front of the camera; with n_verts
    below 778 the rig is cut to its first vertices (fingertips included,
    taken from the cut range)."""
    mano = synthetic_mano_model().to(device)
    if n_verts != 778:
        mano = mano._replace(v_template=mano.v_template[:n_verts],
                             shapedirs=mano.shapedirs[:n_verts],
                             posedirs=mano.posedirs[:n_verts],
                             j_regressor=mano.j_regressor[:, :n_verts],
                             weights=mano.weights[:n_verts],
                             tips=torch.arange(5, device=device) * (n_verts // 5))
    pose, trans, beta = (torch.from_numpy(a).to(device) for a in candidates(p, seed))
    return mano, pose, trans, shape_hand(mano, beta)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("hw", MASKS)
@pytest.mark.parametrize("p,n_verts", [(33, 778), (2, 778), (1, 778), (6, 50), (5, 129)])
def test_hand_energy_skin_kernel_matches_plain_version(cuda_device, name, hw, p, n_verts):
    model = distilled_from_numpy(model_arrays(3, **MODELS[name]), device=cuda_device)
    packed_mask = mask_lookup.pack_mask(_mask(4, hw, cuda_device))
    frame = _frame(5, hw, cuda_device)
    mano, pose, trans, shaped = _skin_case(p + n_verts, p, n_verts, cuda_device)
    kp, pose_map, rt_flat, offset = mano_skin_inputs(mano, pose, trans, shaped)
    consts = hand_energy_skin.skin_consts(mano, shaped)

    before = kernels.launch_counts["hand_energy_skin"]
    args = (model, packed_mask, frame, pose_map, rt_flat, offset, consts, hw)
    sdf, hit = hand_energy_skin.fused_hand_energy_skin(*args)
    sdf2, hit2 = hand_energy_skin.fused_hand_energy_skin(*args)
    torch.cuda.synchronize()
    assert kernels.launch_counts["hand_energy_skin"] == before + 2
    assert torch.equal(sdf, sdf2) and torch.equal(hit, hit2)
    assert tuple(sdf.shape) == tuple(hit.shape) == (p, n_verts)

    # the plain version, and mano_forward + the plain per-vertex energy
    want_sdf, want_hit = hand_energy_skin._hand_energy_skin_torch(*args)
    verts, kp_ref = mano_forward(mano, pose, trans=trans, shaped=shaped)
    ref_sdf, _ = hand_energy._hand_energy_torch(model, packed_mask, frame, verts, hw)
    assert float((kp - kp_ref).abs().max()) <= 2e-6
    assert float((hand_energy_skin.skin_reference(pose_map, rt_flat, offset, consts)
                  - verts).abs().max()) <= 5e-6
    assert float((sdf - want_sdf).abs().max()) <= SKIN_SDF_ATOL
    assert float((sdf - ref_sdf).abs().max()) <= 2 * SKIN_SDF_ATOL

    # hit: equal wherever the plain version's pixel is clear of an integer
    ref_verts = hand_energy_skin.skin_reference(pose_map, rt_flat, offset, consts)
    z = ref_verts[..., 2]
    fy_pix = ref_verts[..., 1] / z * frame[13] + frame[15]
    fx_pix = ref_verts[..., 0] / z * frame[12] + frame[14]
    clear = ((fy_pix - torch.round(fy_pix)).abs() > PIXEL_MARGIN) \
        & ((fx_pix - torch.round(fx_pix)).abs() > PIXEL_MARGIN)
    assert torch.equal(hit[clear], want_hit[clear])
    assert float((hit != want_hit).float().mean()) <= 0.01
