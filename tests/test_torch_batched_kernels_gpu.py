"""The four batched kernels of hotrack_tpu_torch on a card: the SDF MLP
(csrc/sdf_mlp.cu), the fused object energy (csrc/obj_energy.cu), the packed
mask lookup (csrc/mask_lookup.cu) and the fused skinning + energy
(csrc/hand_energy_skin.cu), each with a leading sequence axis S and a model,
mask, shape and object pose a sequence. All tests here are marked `gpu` and
skip without a CUDA device: a CUDA kernel has no interpret mode. The batched
plain versions are held against the JAX package's batched Pallas kernels in
test_torch_batched_kernels.py, on the CPU.

This file imports torch and the port only, so it runs on a machine with a
card and no JAX:

    python -m pytest tests/test_torch_batched_kernels_gpu.py -m gpu -q

What is held, for every kernel: each sequence against the batched plain
version at the unbatched kernel's tolerances (SDF MLP 2.5e-7 a value against
it and against the 3xTF32 emulation, object energy 2e-6 of a sum, mask lookup exact, skinning sdf 2e-5 and hit wherever
the pixel is 2e-3 pixels clear of an integer); each sequence bitwise equal
to an unbatched launch on its own inputs (one kernel body serves both); a
second batched launch bitwise equal to the first. The per-sequence inputs
differ, so a kernel that read sequence 0's model, mask or shape for every
sequence would fail.
"""

import numpy as np
import pytest
import torch

from hotrack_tpu_torch.mano.layer import mano_skin_inputs, shape_hand
from hotrack_tpu_torch.mano.model import synthetic_mano_model
from hotrack_tpu_torch.ops import (hand_energy, hand_energy_skin, kernels, mask_lookup,
                                   obj_energy, sdf_mlp, tf32)
from hotrack_tpu_torch.pose.rotations import normalize_quat, unit_quaternion_to_matrix
from hotrack_tpu_torch.utils.convert import distilled_from_numpy
from hand_energy_cases import camera_points, candidates, intrinsics, mask_of, object_pose
from torch_sdf_models import (BF16_CARD_FLIPS, bf16_flip_atol, bf16_share_floor,
                              bf16_share_and_worst, bf16_sum_atol, model_arrays)

# #3b, #4b and #7b run the MLP on the tensor cores in 3xTF32, whose float32
# sums truncate: one sdf value lay up to 1.7e-7 from the plain version's on the
# card (the float32 FMA kernel: 4.1e-8 a value, 1e-8 a point of an energy)
TC_SDF_ATOL = 2.5e-7
ENERGY_RTOL, ENERGY_ATOL = 2e-6, TC_SDF_ATOL
SKIN_SDF_ATOL = 2e-5
PIXEL_MARGIN = 2e-3
WIDTHS = {"shipped width": dict(widths=(21, 128, 128, 128)),
          "narrow, non-geometric frequencies": dict(widths=(15, 32, 48), freqs=[1.0, 2.5])}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA kernel has no interpret mode")
    return torch.device("cuda")


def _models(name, s, device, seed=0):
    return [distilled_from_numpy(model_arrays(seed + 7 * i, **WIDTHS[name]), device=device)
            for i in range(s)]


def _differs(a, b):
    return not torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(WIDTHS))
@pytest.mark.parametrize("shape,cf", [((3, 2, 3, 129), True), ((2, 64, 3, 778), True),
                                      ((3, 5, 37, 3), False), ((1, 300, 3), False),
                                      ((4, 1, 3, 1), True)])
def test_sdf_mlp_batched_kernel(cuda_device, name, shape, cf):
    s = shape[0]
    models = _models(name, s, cuda_device)
    packed = sdf_mlp.pack_distilled_batched(models)
    pts = torch.from_numpy((np.random.RandomState(s).randn(*shape) * 0.08)
                           .astype(np.float32)).to(cuda_device)
    before = kernels.launch_counts["sdf_mlp_batched"]
    fn = sdf_mlp.fused_sdf_mlp_cf_batched if cf else sdf_mlp.fused_sdf_mlp_batched
    got = fn(models, pts, packed)
    again = fn(models, pts, packed)
    torch.cuda.synchronize()
    assert kernels.launch_counts["sdf_mlp_batched"] == before + 2
    assert torch.equal(got, again)
    pts_cf = pts if cf else pts.transpose(-1, -2)
    want = sdf_mlp._sdf_mlp_batched_torch(models, pts_cf)
    emu = torch.stack([sdf_mlp._sdf_mlp_torch(m, p, mlp=tf32.raw_sdf_mlp_3xtf32)
                       for m, p in zip(models, pts_cf)])
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= TC_SDF_ATOL
    assert float((got - emu).abs().max()) <= TC_SDF_ATOL
    for i, model in enumerate(models):
        one = kernels.sdf_mlp_cuda(pts[i].contiguous(), sdf_mlp.pack_distilled(model), cf)
        assert torch.equal(got[i], one)
        # sequence i's model is its own (one point may sit at the clamp under both)
        if i and shape[-1 if cf else -2] > 8:
            other = kernels.sdf_mlp_cuda(pts[i].contiguous(), sdf_mlp.pack_distilled(models[0]),
                                         cf)
            assert _differs(other, got[i])
    # one model for every sequence: a stride of 0
    shared = kernels.sdf_mlp_batched_cuda(pts, sdf_mlp.pack_distilled(models[0]), cf)
    for i in range(s):
        assert torch.equal(shared[i], kernels.sdf_mlp_cuda(
            pts[i].contiguous(), sdf_mlp.pack_distilled(models[0]), cf))


def _poses(rng, s, p, device):
    quat = normalize_quat(torch.from_numpy(rng.randn(s, p, 4).astype(np.float32)))
    trans = torch.from_numpy((rng.randn(s, p, 3) * 0.03).astype(np.float32))
    return unit_quaternion_to_matrix(quat).to(device), trans.to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(WIDTHS))
@pytest.mark.parametrize("s,p,n", [(3, 17, 129), (2, 64, 1000), (4, 1, 1), (1, 33, 200)])
def test_obj_energy_batched_kernel(cuda_device, name, s, p, n):
    rng = np.random.RandomState(p + n)
    models = _models(name, s, cuda_device, seed=3)
    packed = sdf_mlp.pack_distilled_batched(models)
    pcld = torch.from_numpy((rng.randn(s, 3, n) * 0.06).astype(np.float32)).to(cuda_device)
    rot, trans = _poses(rng, s, p, cuda_device)
    before = kernels.launch_counts["obj_sdf_energy_batched"]
    got = obj_energy.fused_obj_sdf_energy_batched(models, pcld, rot, trans, packed)
    again = obj_energy.fused_obj_sdf_energy_batched(models, pcld, rot, trans, packed)
    torch.cuda.synchronize()
    assert kernels.launch_counts["obj_sdf_energy_batched"] == before + 2
    assert torch.equal(got, again) and got.shape == (s, p)
    # a sequence at a time, as the wrapper builds them: a batched product on the
    # card rounds by its shape
    rts = torch.stack([obj_energy.obj_rts(r, t) for r, t in zip(rot, trans)]).contiguous()
    want = obj_energy._obj_sdf_energy_batched_torch(models, pcld, rts)
    assert bool(((got - want).abs() <= ENERGY_RTOL * want.abs() + ENERGY_ATOL * n).all())
    for i, model in enumerate(models):
        one = kernels.obj_sdf_energy_cuda(pcld[i].contiguous(), rts[i].contiguous(),
                                          sdf_mlp.pack_distilled(model))
        assert torch.equal(got[i], one)
        if i and n > 8:
            assert _differs(got[i], kernels.obj_sdf_energy_cuda(
                pcld[i].contiguous(), rts[i].contiguous(), sdf_mlp.pack_distilled(models[0])))


@pytest.mark.gpu
@pytest.mark.parametrize("hw", [(480, 640), (37, 53), (1, 1)])
@pytest.mark.parametrize("shape,offset", [((3, 64, 778), 0), ((2, 7, 13), 0), ((4, 1), 0),
                                          ((2, 1001), 1), ((3, 5, 4), 4)])
def test_mask_lookup_batched_kernel(cuda_device, hw, shape, offset):
    """Exact against the plain version and against each sequence's
    mask[iy, ix]; `offset` starts the index arrays off a 16-byte boundary,
    and 7 x 13 queries a sequence are no multiple of 4 (the scalar path)."""
    rng = np.random.RandomState(hw[0] + len(shape))
    s = shape[0]
    masks = torch.from_numpy(np.stack([mask_of(hw, 10 + i) for i in range(s)])).to(cuda_device)
    packed = torch.stack([mask_lookup.pack_mask(m) for m in masks])
    n = int(np.prod(shape))

    def index(hi):
        store = torch.from_numpy(rng.randint(0, hi, n + offset).astype(np.int32)).to(cuda_device)
        return store[offset:].reshape(shape)

    iy, ix = index(hw[0]), index(hw[1])
    before = kernels.launch_counts["packed_mask_lookup_batched"]
    got = mask_lookup.packed_mask_lookup_batched(packed, iy, ix, hw)
    again = mask_lookup.packed_mask_lookup_batched(packed, iy, ix, hw)
    torch.cuda.synchronize()
    assert kernels.launch_counts["packed_mask_lookup_batched"] == before + 2
    assert torch.equal(got, again) and got.shape == iy.shape
    assert torch.equal(got, mask_lookup._packed_mask_lookup_batched_torch(packed, iy, ix))
    for i in range(s):
        assert torch.equal(got[i], masks[i].float()[iy[i].long(), ix[i].long()])
        assert torch.equal(got[i], kernels.packed_mask_lookup_cuda(
            packed[i], iy[i].contiguous(), ix[i].contiguous(), hw))


def _skin_inputs(s, p, device, hw, seed=0):
    """S sequences of P candidates, each with its own shape, object pose,
    mask and model."""
    mano = synthetic_mano_model().to(device)
    betas = torch.cat([torch.from_numpy(candidates(1, seed + i)[2]) for i in range(s)]).to(device)
    shaped = shape_hand(mano, betas)
    per_seq = []
    for i in range(s):
        pose, trans, _ = (torch.from_numpy(a).to(device) for a in candidates(p, seed + 20 + i))
        per_seq.append(mano_skin_inputs(mano, pose, trans, (shaped[0][i:i + 1],
                                                            shaped[1][i:i + 1]))[1:])
    pose_map, rt_flat, offset = (torch.stack(t) for t in zip(*per_seq))
    consts = hand_energy_skin.skin_consts(mano, shaped, batched=True)
    frames = torch.stack([hand_energy.hand_frame(
        *(torch.from_numpy(a).to(device) for a in object_pose(seed + i)),
        *(float(v) for v in intrinsics(hw))) for i in range(s)])
    masks = torch.stack([mask_lookup.pack_mask(torch.from_numpy(mask_of(hw, seed + i)))
                         for i in range(s)]).to(device)
    return mano, pose_map, rt_flat, offset, consts, frames, masks


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(WIDTHS))
@pytest.mark.parametrize("s,p,hw", [(3, 33, (480, 640)), (2, 2, (37, 53)), (4, 1, (1, 1)),
                                    (2, 64, (480, 640))])
def test_hand_energy_skin_batched_kernel(cuda_device, name, s, p, hw):
    models = _models(name, s, cuda_device, seed=5)
    packed = sdf_mlp.pack_distilled_batched(models)
    _, pose_map, rt_flat, offset, consts, frames, masks = _skin_inputs(s, p, cuda_device, hw)
    args = (models, masks, frames, pose_map, rt_flat, offset, consts, hw)
    before = kernels.launch_counts["hand_energy_skin_batched"]
    sdf, hit = hand_energy_skin.fused_hand_energy_skin_batched(*args, packed)
    sdf2, hit2 = hand_energy_skin.fused_hand_energy_skin_batched(*args, packed)
    torch.cuda.synchronize()
    assert kernels.launch_counts["hand_energy_skin_batched"] == before + 2
    assert torch.equal(sdf, sdf2) and torch.equal(hit, hit2)
    assert tuple(sdf.shape) == tuple(hit.shape) == (s, p, 778)
    want_sdf, want_hit = hand_energy_skin._hand_energy_skin_batched_torch(*args)
    assert float((sdf - want_sdf).abs().max()) <= SKIN_SDF_ATOL
    for i in range(s):
        c = consts._replace(vshaped_cf=consts.vshaped_cf[i].contiguous())
        one = kernels.hand_energy_skin_cuda(pose_map[i], rt_flat[i], offset[i], *c, frames[i],
                                            masks[i], hw, sdf_mlp.pack_distilled(models[i]))
        assert torch.equal(sdf[i], one[0]) and torch.equal(hit[i], one[1])
        verts = hand_energy_skin.skin_reference(pose_map[i], rt_flat[i], offset[i], c)
        z = verts[..., 2]
        v_pix = verts[..., 1] / z * frames[i, 13] + frames[i, 15]
        u_pix = verts[..., 0] / z * frames[i, 12] + frames[i, 14]
        clear = ((v_pix - torch.round(v_pix)).abs() > PIXEL_MARGIN) \
            & ((u_pix - torch.round(u_pix)).abs() > PIXEL_MARGIN)
        assert torch.equal(hit[i][clear], want_hit[i][clear])
        if i:  # sequence 0's shape in place of sequence i's changes the result
            c0 = consts._replace(vshaped_cf=consts.vshaped_cf[0].contiguous())
            other = kernels.hand_energy_skin_cuda(
                pose_map[i], rt_flat[i], offset[i], *c0, frames[i], masks[i], hw,
                sdf_mlp.pack_distilled(models[i]))
            assert _differs(other[0], sdf[i])


# bf16 (HOTRACK_SDF_BF16): the batched kernels' bf16 instantiations, sequence
# s bitwise the unbatched bf16 launch on s's inputs, two launches bitwise,
# against the bf16 plain versions under tests/test_torch_sdf_bf16.py's
# two-part bound (torch_sdf_models), and no 3xTF32 launch.
BF16 = torch.bfloat16


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(WIDTHS))
@pytest.mark.parametrize("shape,cf", [((3, 2, 3, 129), True), ((2, 64, 3, 778), True),
                                      ((3, 5, 37, 3), False), ((4, 1, 3, 1), True)])
def test_sdf_mlp_batched_kernel_bf16(cuda_device, name, shape, cf):
    s = shape[0]
    models = _models(name, s, cuda_device)
    packed = sdf_mlp.pack_distilled_batched(models)
    pts = torch.from_numpy((np.random.RandomState(s).randn(*shape) * 0.08)
                           .astype(np.float32)).to(cuda_device)
    before = dict(kernels.launch_counts)
    fn = sdf_mlp.fused_sdf_mlp_cf_batched if cf else sdf_mlp.fused_sdf_mlp_batched
    got = fn(models, pts, packed, compute_dtype=BF16)
    again = fn(models, pts, packed, compute_dtype=BF16)
    torch.cuda.synchronize()
    assert kernels.launch_counts["sdf_mlp_batched_bf16"] == before["sdf_mlp_batched_bf16"] + 2
    assert kernels.launch_counts["sdf_mlp_batched"] == before["sdf_mlp_batched"]
    assert torch.equal(got, again)
    pts_cf = pts if cf else pts.transpose(-1, -2)
    want = sdf_mlp._sdf_mlp_batched_torch(models, pts_cf, compute_dtype=BF16)
    for i, model in enumerate(models):
        one = kernels.sdf_mlp_cuda(pts[i].contiguous(), sdf_mlp.pack_distilled(model), cf,
                                   compute_dtype=BF16)
        assert torch.equal(got[i], one)
        share, worst = bf16_share_and_worst(got[i], want[i])
        flip = bf16_flip_atol(model, pts_cf[i].transpose(-1, -2), BF16_CARD_FLIPS)
        floor = bf16_share_floor(got[i].numel(), len(model.weights) - 1)
        assert share >= floor and worst <= flip, (share, floor, worst, flip)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(WIDTHS))
@pytest.mark.parametrize("s,p,n", [(3, 17, 129), (2, 64, 1000), (4, 1, 1)])
def test_obj_energy_batched_kernel_bf16(cuda_device, name, s, p, n):
    rng = np.random.RandomState(p + n)
    models = _models(name, s, cuda_device, seed=3)
    packed = sdf_mlp.pack_distilled_batched(models)
    pcld = torch.from_numpy((rng.randn(s, 3, n) * 0.06).astype(np.float32)).to(cuda_device)
    rot, trans = _poses(rng, s, p, cuda_device)
    before = dict(kernels.launch_counts)
    got = obj_energy.fused_obj_sdf_energy_batched(models, pcld, rot, trans, packed,
                                                  compute_dtype=BF16)
    again = obj_energy.fused_obj_sdf_energy_batched(models, pcld, rot, trans, packed,
                                                    compute_dtype=BF16)
    torch.cuda.synchronize()
    assert kernels.launch_counts["obj_sdf_energy_batched_bf16"] == \
        before["obj_sdf_energy_batched_bf16"] + 2
    assert kernels.launch_counts["obj_sdf_energy_batched"] == before["obj_sdf_energy_batched"]
    assert torch.equal(got, again) and got.shape == (s, p)
    # a sequence at a time, as the wrapper builds them: a batched product on the
    # card rounds by its shape
    rts = torch.stack([obj_energy.obj_rts(r, t) for r, t in zip(rot, trans)]).contiguous()
    want = obj_energy._obj_sdf_energy_batched_torch(models, pcld, rts, compute_dtype=BF16)
    for i, model in enumerate(models):
        one = kernels.obj_sdf_energy_cuda(pcld[i].contiguous(), rts[i].contiguous(),
                                          sdf_mlp.pack_distilled(model), compute_dtype=BF16)
        assert torch.equal(got[i], one)
        obj = -rts[i, :, 9:, None] + sum(rts[i, :, :9].reshape(p, 3, 3, 1)[:, :, y] * pcld[i, y]
                                         for y in range(3))
        atol = bf16_sum_atol(n, bf16_flip_atol(model, obj.transpose(-1, -2), BF16_CARD_FLIPS))
        assert float((got[i] - want[i]).abs().max()) <= atol


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(WIDTHS))
@pytest.mark.parametrize("s,p,hw", [(3, 33, (480, 640)), (4, 1, (1, 1))])
def test_hand_energy_skin_batched_kernel_bf16(cuda_device, name, s, p, hw):
    models = _models(name, s, cuda_device, seed=5)
    packed = sdf_mlp.pack_distilled_batched(models)
    _, pose_map, rt_flat, offset, consts, frames, masks = _skin_inputs(s, p, cuda_device, hw)
    args = (models, masks, frames, pose_map, rt_flat, offset, consts, hw)
    before = dict(kernels.launch_counts)
    sdf, hit = hand_energy_skin.fused_hand_energy_skin_batched(*args, packed, BF16)
    sdf2, hit2 = hand_energy_skin.fused_hand_energy_skin_batched(*args, packed, BF16)
    torch.cuda.synchronize()
    assert kernels.launch_counts["hand_energy_skin_batched_bf16"] == \
        before["hand_energy_skin_batched_bf16"] + 2
    assert kernels.launch_counts["hand_energy_skin_batched"] == \
        before["hand_energy_skin_batched"]
    assert torch.equal(sdf, sdf2) and torch.equal(hit, hit2)
    f32_sdf, f32_hit = hand_energy_skin.fused_hand_energy_skin_batched(*args, packed)
    assert torch.equal(hit, f32_hit)
    want_sdf, _ = hand_energy_skin._hand_energy_skin_batched_torch(*args, compute_dtype=BF16)
    for i in range(s):
        c = consts._replace(vshaped_cf=consts.vshaped_cf[i].contiguous())
        one = kernels.hand_energy_skin_cuda(pose_map[i], rt_flat[i], offset[i], *c, frames[i],
                                            masks[i], hw, sdf_mlp.pack_distilled(models[i]),
                                            compute_dtype=BF16)
        assert torch.equal(sdf[i], one[0]) and torch.equal(hit[i], one[1])
        verts = hand_energy_skin.skin_reference(pose_map[i], rt_flat[i], offset[i], c)
        flip = bf16_flip_atol(models[i], hand_energy.object_frame(verts, frames[i])
                              .transpose(-1, -2), BF16_CARD_FLIPS)
        d = (sdf[i] - want_sdf[i]).abs()
        assert float((d <= SKIN_SDF_ATOL).float().mean()) >= bf16_share_floor(d.numel())
        assert float(d.max()) <= flip + SKIN_SDF_ATOL


@pytest.mark.gpu
def test_batched_wrappers_refuse_what_they_do_not_take(cuda_device):
    models = _models("shipped width", 2, cuda_device)
    packed = sdf_mlp.pack_distilled_batched(models)
    pts = torch.zeros((3, 4, 3), device=cuda_device)
    with pytest.raises(ValueError, match="packed model"):   # 2 models, 3 sequences
        kernels.sdf_mlp_batched_cuda(pts, packed, False)
    with pytest.raises(ValueError, match="packed model"):   # a stack to the unbatched kernel
        kernels.sdf_mlp_cuda(pts[0], packed, False)
    with pytest.raises(ValueError, match="pcld_cf"):
        kernels.obj_sdf_energy_batched_cuda(torch.zeros((3, 3, 5), device=cuda_device),
                                            torch.zeros((2, 4, 12), device=cuda_device), packed)
    idx = torch.zeros((2, 8), dtype=torch.int32, device=cuda_device)
    masks = torch.zeros((3, 4, 2), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError, match="packed mask"):
        kernels.packed_mask_lookup_batched_cuda(masks, idx, idx, (4, 9))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.packed_mask_lookup_batched_cuda(masks[:2], idx.cpu(), idx.cpu(), (4, 9))
    _, pose_map, rt_flat, offset, consts, frames, masks = _skin_inputs(2, 3, cuda_device,
                                                                       (8, 8))
    with pytest.raises(ValueError, match="frame"):
        kernels.hand_energy_skin_batched_cuda(pose_map, rt_flat, offset, *consts,
                                              frames[:, :12].contiguous(), masks, (8, 8), packed)
    with pytest.raises(ValueError, match="vshaped_cf"):
        kernels.hand_energy_skin_batched_cuda(pose_map, rt_flat, offset, consts.posedirs_cf,
                                              consts.vshaped_cf[:1].contiguous(),
                                              consts.weights_t, frames, masks, (8, 8), packed)
