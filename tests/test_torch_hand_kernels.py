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

Tolerances, both sides float32. The lookup: exact. The fused energy runs the
SDF MLP kernel's wgmma core (3xTF32, csrc/sdf_mlp_wgmma.cuh): `hit` exact
(the kernel rounds every step of the projection as eager PyTorch does) and
bitwise the lookup kernel at `pixel_coords`; `sdf` bitwise the SDF MLP
kernel on `object_frame` (the same rounding of every step of the transform)
and within TC_SDF_ATOL of the plain version's and of the 3xTF32 emulation's
(the tensor cores' float32 sums truncate); its compiler report shows no
spill and no serialised wgmma. The fused
skinning: the kernel sums a vertex in ascending order with FMA, the plain
version by library products, so the vertices differ by float32 rounding
(1e-7 m) and with them `sdf` by up to SKIN_SDF_ATOL through the random net's
steep features, and `hit` may flip where the plain version's pixel
coordinate lies within PIXEL_MARGIN of an integer: it is held equal
everywhere else. The fused skinning runs the MLP on the tensor cores in
3xTF32 on the fused energy's wgmma walk, after a skinning pre-pass: on
vertices that it and the plain version build bitwise alike, its sdf is held
within TC_SDF_ATOL of the plain version's and of the 3xTF32 emulation's
(ops/tf32.py; the tensor cores' float32 sums truncate), and its sdf and hit
bitwise the fused energy kernel's on those vertices; its compiler report shows
no spill. Two launches of every kernel agree bitwise.

bf16 (HOTRACK_SDF_BF16): #6's and #7's bf16 instantiations, `hit` exactly the
3xTF32 kernel's, `sdf` against the bf16 plain version under
tests/test_torch_sdf_bf16.py's two-part bound (torch_sdf_models), #6 bitwise
#3's bf16 instantiation on `object_frame`; #7 on vertices built by both alike
under that bound, and on the others within SKIN_SDF_ATOL beside it.
"""

import re

import numpy as np
import pytest
import torch

from hotrack_tpu_torch.mano.layer import mano_forward, mano_skin_inputs, shape_hand
from hotrack_tpu_torch.mano.model import synthetic_mano_model
from hotrack_tpu_torch.ops import (hand_energy, hand_energy_skin, kernels, mask_lookup, sdf_mlp,
                                   tf32)
from hotrack_tpu_torch.utils.convert import distilled_from_numpy
from hand_energy_cases import camera_points, candidates, intrinsics, mask_of, object_pose
from torch_sdf_models import (BF16_CARD_FLIPS, bf16_flip_atol, bf16_share_floor,
                              bf16_share_and_worst, model_arrays)

SKIN_SDF_ATOL = 2e-5
TC_SDF_ATOL = 2.5e-7
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
    emu_sdf, _ = hand_energy._hand_energy_torch(model, packed_mask, frame, pts, hw,
                                                mlp=tf32.raw_sdf_mlp_3xtf32)
    assert sdf.shape == want_sdf.shape == pts.shape[:-1] and hit.shape == sdf.shape
    assert bool(torch.isfinite(sdf).all())
    assert torch.equal(hit, want_hit)
    assert float((sdf - want_sdf).abs().max()) <= TC_SDF_ATOL
    assert float((sdf - emu_sdf).abs().max()) <= TC_SDF_ATOL
    # bitwise the SDF MLP kernel (#3) and the mask lookup kernel (#5) composed
    iy, ix = hand_energy.pixel_coords(pts, frame, hw)
    assert torch.equal(sdf, sdf_mlp.fused_sdf_mlp_cf(model, hand_energy.object_frame(pts, frame)))
    assert torch.equal(hit, mask_lookup.packed_mask_lookup(packed_mask, iy, ix, hw))
    if hw == (480, 640) and shape == (64, 778):
        for idx, hi in ((iy, hw[0] - 1), (ix, hw[1] - 1)):  # the clip is exercised
            assert int((idx == 0).sum()) > 0 and int((idx == hi).sum()) > 0
        assert 0.2 < float(hit.mean()) < 0.8


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("hw", MASKS)
@pytest.mark.parametrize("shape", [(64, 778), (7, 10), (300,)])
def test_hand_energy_kernel_bf16_matches_plain_version(cuda_device, name, hw, shape):
    model = distilled_from_numpy(model_arrays(2, **MODELS[name]), device=cuda_device)
    packed_mask = mask_lookup.pack_mask(_mask(2, hw, cuda_device))
    frame = _frame(3, hw, cuda_device)
    pts = torch.from_numpy(camera_points(shape, seed=shape[0])).to(cuda_device)
    if len(shape) == 1:
        pts = pts[None]
    bf16 = torch.bfloat16
    before = dict(kernels.launch_counts)
    sdf, hit = hand_energy.fused_hand_energy(model, packed_mask, frame, pts, hw,
                                             compute_dtype=bf16)
    sdf2, hit2 = hand_energy.fused_hand_energy(model, packed_mask, frame, pts, hw,
                                               compute_dtype=bf16)
    torch.cuda.synchronize()
    assert kernels.launch_counts["hand_energy_bf16"] == before["hand_energy_bf16"] + 2
    assert kernels.launch_counts["hand_energy"] == before["hand_energy"]
    assert torch.equal(sdf, sdf2) and torch.equal(hit, hit2)
    want_sdf, want_hit = hand_energy._hand_energy_torch(model, packed_mask, frame, pts, hw,
                                                        compute_dtype=bf16)
    assert torch.equal(hit, want_hit)
    assert torch.equal(hit, hand_energy.fused_hand_energy(model, packed_mask, frame, pts, hw)[1])
    obj = hand_energy.object_frame(pts, frame)
    share, worst = bf16_share_and_worst(sdf, want_sdf)
    flip = bf16_flip_atol(model, obj.transpose(-1, -2), BF16_CARD_FLIPS)
    floor = bf16_share_floor(sdf.numel(), len(model.weights) - 1)
    assert share >= floor and worst <= flip, (share, floor, worst, flip)
    assert torch.equal(sdf, sdf_mlp.fused_sdf_mlp_cf(model, obj, compute_dtype=bf16))


@pytest.mark.gpu
def test_hand_energy_kernel_compiles_without_spills_or_serialised_wgmma(cuda_device):
    """ptxas's report beside the library: no spill, no wgmma serialised
    (C7520 / C7513) and no setmaxnreg ignored (C7508)."""
    log = open(str(kernels.build("hand_energy")) + ".log").read()
    assert "registers" in log
    assert not any(code in log for code in ("C7520", "C7513", "C7508")), log
    assert not any(int(n) for n in re.findall(r"(\d+) bytes spill", log)), log


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


@pytest.mark.gpu
@pytest.mark.parametrize("widths", [(21, 128, 128, 128), (39, 128, 128, 128, 128), (9, 128),
                                    (21,) + (128,) * 8])
def test_hand_energy_skin_kernel_matches_its_3xtf32_emulation(cuda_device, widths):
    """No pose blend, one joint a vertex with the identity rotation: the
    kernel and skin_reference build every vertex as ((v_shaped + t) + offset),
    bitwise alike, so the sdf isolates the MLP's 3xTF32 arithmetic (the deep
    nets' tiles stream through the walk's ring), and is bitwise the fused
    energy kernel's on those vertices, hit and all."""
    rng = np.random.RandomState(len(widths))
    model = distilled_from_numpy(model_arrays(7, widths=widths), device=cuda_device)
    mano = synthetic_mano_model().to(cuda_device)
    shaped = shape_hand(mano, torch.zeros(1, 10, device=cuda_device))
    p, n = 9, mano.v_template.shape[0]
    joint = torch.from_numpy(rng.randint(0, 16, n)).to(cuda_device)
    consts = hand_energy_skin.SkinConsts(
        mano.posedirs.permute(1, 2, 0).contiguous(), shaped[0][0].T.contiguous(),
        torch.nn.functional.one_hot(joint, 16).T.float().contiguous())
    rt = torch.zeros(p, 12, 16, device=cuda_device)
    rt[:, [0, 4, 8]] = 1.0
    rt[:, 9:] = torch.from_numpy((rng.randn(p, 3, 1) * 0.02).astype(np.float32)).to(cuda_device)
    offset = torch.from_numpy((rng.randn(p, 3) * 0.02 + [0, 0, 0.45]).astype(np.float32)) \
        .to(cuda_device)
    pose_map = torch.zeros(p, consts.posedirs_cf.shape[1], device=cuda_device)
    hw = (480, 640)
    args = (model, mask_lookup.pack_mask(_mask(4, hw, cuda_device)), _frame(5, hw, cuda_device),
            pose_map, rt.reshape(p * 12, 16), offset, consts, hw)
    verts = hand_energy_skin.skin_reference(*args[3:7])
    assert torch.equal(verts, (consts.vshaped_cf.T + rt[:, None, 9:, 0]) + offset[:, None])
    sdf, hit = hand_energy_skin.fused_hand_energy_skin(*args)
    want_sdf, want_hit = hand_energy_skin._hand_energy_skin_torch(*args)
    emu_sdf, _ = hand_energy_skin._hand_energy_skin_torch(*args, mlp=tf32.raw_sdf_mlp_3xtf32)
    torch.cuda.synchronize()
    assert torch.equal(hit, want_hit)
    assert float((sdf - want_sdf).abs().max()) <= TC_SDF_ATOL
    assert float((sdf - emu_sdf).abs().max()) <= TC_SDF_ATOL
    sdf6, hit6 = hand_energy.fused_hand_energy(model, args[1], args[2], verts, hw)
    assert torch.equal(sdf, sdf6) and torch.equal(hit, hit6)


@pytest.mark.gpu
def test_hand_energy_skin_kernel_compiles_without_spills_or_serialised_wgmma(cuda_device):
    """ptxas's report beside the library (the pre-pass, the 3xTF32 walk and
    the bf16 walk): no spill, no wgmma serialised, no setmaxnreg ignored."""
    log = open(str(kernels.build("hand_energy_skin")) + ".log").read()
    assert log.count("Compiling entry function") == 3 and "registers" in log
    assert not any(code in log for code in ("C7520", "C7513", "C7508")), log
    assert not any(int(n) for n in re.findall(r"(\d+) bytes spill", log)), log


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("hw", [(480, 640), (1, 1)])
@pytest.mark.parametrize("p,n_verts", [(33, 778), (1, 778), (5, 129)])
def test_hand_energy_skin_kernel_bf16_matches_plain_version(cuda_device, name, hw, p, n_verts):
    model = distilled_from_numpy(model_arrays(3, **MODELS[name]), device=cuda_device)
    packed_mask = mask_lookup.pack_mask(_mask(4, hw, cuda_device))
    frame = _frame(5, hw, cuda_device)
    mano, pose, trans, shaped = _skin_case(p + n_verts, p, n_verts, cuda_device)
    _, pose_map, rt_flat, offset = mano_skin_inputs(mano, pose, trans, shaped)
    consts = hand_energy_skin.skin_consts(mano, shaped)
    args = (model, packed_mask, frame, pose_map, rt_flat, offset, consts, hw)
    before = dict(kernels.launch_counts)
    sdf, hit = hand_energy_skin.fused_hand_energy_skin(*args, compute_dtype=torch.bfloat16)
    sdf2, hit2 = hand_energy_skin.fused_hand_energy_skin(*args, compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert kernels.launch_counts["hand_energy_skin_bf16"] == \
        before["hand_energy_skin_bf16"] + 2
    assert kernels.launch_counts["hand_energy_skin"] == before["hand_energy_skin"]
    assert torch.equal(sdf, sdf2) and torch.equal(hit, hit2)
    # the skinning and the hit are the 3xTF32 kernel's code: its hit bitwise
    f32_sdf, f32_hit = hand_energy_skin.fused_hand_energy_skin(*args)
    assert torch.equal(hit, f32_hit)
    assert float((sdf - f32_sdf).abs().max()) > 1e-5
    # the vertices differ from the plain version's by rounding (SKIN_SDF_ATOL)
    want_sdf, _ = hand_energy_skin._hand_energy_skin_torch(*args, compute_dtype=torch.bfloat16)
    verts = hand_energy_skin.skin_reference(pose_map, rt_flat, offset, consts)
    flip = bf16_flip_atol(model, hand_energy.object_frame(verts, frame).transpose(-1, -2),
                          BF16_CARD_FLIPS)
    d = (sdf - want_sdf).abs()
    assert float((d <= SKIN_SDF_ATOL).float().mean()) >= bf16_share_floor(d.numel())
    assert float(d.max()) <= flip + SKIN_SDF_ATOL


@pytest.mark.gpu
@pytest.mark.parametrize("widths", [(21, 128, 128, 128), (39, 128, 128, 128, 128), (9, 128)])
def test_hand_energy_skin_kernel_bf16_on_exact_vertices(cuda_device, widths):
    """test_hand_energy_skin_kernel_matches_its_3xtf32_emulation's vertices,
    which the kernel and the plain version build bitwise alike: the sdf
    isolates the bf16 MLP (on the walk: 26 tiles pinned at depth 4)."""
    rng = np.random.RandomState(len(widths))
    model = distilled_from_numpy(model_arrays(7, widths=widths), device=cuda_device)
    mano = synthetic_mano_model().to(cuda_device)
    shaped = shape_hand(mano, torch.zeros(1, 10, device=cuda_device))
    p, n = 9, mano.v_template.shape[0]
    joint = torch.from_numpy(rng.randint(0, 16, n)).to(cuda_device)
    consts = hand_energy_skin.SkinConsts(
        mano.posedirs.permute(1, 2, 0).contiguous(), shaped[0][0].T.contiguous(),
        torch.nn.functional.one_hot(joint, 16).T.float().contiguous())
    rt = torch.zeros(p, 12, 16, device=cuda_device)
    rt[:, [0, 4, 8]] = 1.0
    rt[:, 9:] = torch.from_numpy((rng.randn(p, 3, 1) * 0.02).astype(np.float32)).to(cuda_device)
    offset = torch.from_numpy((rng.randn(p, 3) * 0.02 + [0, 0, 0.45]).astype(np.float32)) \
        .to(cuda_device)
    pose_map = torch.zeros(p, consts.posedirs_cf.shape[1], device=cuda_device)
    hw = (480, 640)
    frame = _frame(5, hw, cuda_device)
    args = (model, mask_lookup.pack_mask(_mask(4, hw, cuda_device)), frame,
            pose_map, rt.reshape(p * 12, 16), offset, consts, hw)
    sdf, hit = hand_energy_skin.fused_hand_energy_skin(*args, compute_dtype=torch.bfloat16)
    want_sdf, want_hit = hand_energy_skin._hand_energy_skin_torch(
        *args, compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.equal(hit, want_hit)
    verts = hand_energy_skin.skin_reference(*args[3:7])
    share, worst = bf16_share_and_worst(sdf, want_sdf)
    flip = bf16_flip_atol(model, hand_energy.object_frame(verts, frame).transpose(-1, -2),
                          BF16_CARD_FLIPS)
    floor = bf16_share_floor(sdf.numel(), len(model.weights) - 1)
    assert share >= floor and worst <= flip, (share, floor, worst, flip)
