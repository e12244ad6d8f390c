"""The hand optimisers' index tensors and the particle loop's first search
size, made on the device without a copy from the host.

`mano/model.index_tensor` makes the int64 tensor of a tuple of ids once per
(ids, device); the MANO chain (`_kinematic_chain`, `mano_forward`,
`mano_skin_inputs`), `opt/hand_shape.kp2length` and `opt/hand_pose` index
with it where they indexed with the Python list of the ids, which PyTorch
copied to the card, and waited for, at every use. `run_particle_opt` fills
its first search size on the device. Each is held here bitwise against the
list-index formulation, on the CPU and on a card where there is one, and a
second call must find every index tensor already made. On the card, the
batched hand and object pose optimisers must not wait for it at all after a
warm-up (`torch.cuda.set_sync_debug_mode("error")`).

This file imports torch, numpy and the port only, so it runs on a machine
with a card and no JAX:

    python -m pytest tests/test_torch_index_tensors.py -m gpu -q
"""

import numpy as np
import pytest
import torch

from hand_energy_cases import candidates, intrinsics, mask_of, object_pose
from hotrack_tpu_torch.mano import layer
from hotrack_tpu_torch.mano.model import (LEV1_IDXS, LEV2_IDXS, LEV3_IDXS, REORDER_IDXS,
                                          index_tensor, synthetic_mano_model)
from hotrack_tpu_torch.opt import hand_pose, hand_shape, obj_pose, particle
from hotrack_tpu_torch.ops.sdf_mlp import pack_distilled_batched
from hotrack_tpu_torch.utils.convert import distilled_from_numpy
from torch_sdf_models import model_arrays


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device(request.param)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the optimisers' kernels have no interpret mode")
    return torch.device("cuda")


def _lists(ids, device):
    """The list-index formulation: what the MANO layer indexed with before."""
    return list(ids)


def _kinematic_chain_lists(rot_mats, joints):
    """`_kinematic_chain` as it was written with Python lists of the ids."""
    def compose(rp, tp, rl, tl):
        r = torch.sum(rp[..., :, :, None] * rl[..., None, :, :], dim=-2)
        t = torch.sum(rp * tl[..., None, :], dim=-1) + tp
        return r, t

    root_rot = rot_mats[:, 0]
    root_j = joints[:, 0]
    lev1, lev2, lev3 = list(LEV1_IDXS), list(LEV2_IDXS), list(LEV3_IDXS)
    r1, t1 = compose(root_rot[:, None], root_j[:, None],
                     rot_mats[:, lev1], joints[:, lev1] - root_j[:, None])
    r2, t2 = compose(r1, t1, rot_mats[:, lev2], joints[:, lev2] - joints[:, lev1])
    r3, t3 = compose(r2, t2, rot_mats[:, lev3], joints[:, lev3] - joints[:, lev2])
    order = list(REORDER_IDXS)
    r_all = torch.cat([root_rot[:, None], r1, r2, r3], dim=1)[:, order]
    t_all = torch.cat([root_j[:, None], t1, t2, t3], dim=1)[:, order]
    t_rel = t_all - torch.sum(r_all * joints[..., None, :], dim=-1)
    return r_all, t_all, t_rel


def _kp2length_lists(kp):
    bones = kp[..., list(hand_shape.BONE_IDX), :] - kp[..., list(hand_shape.BONE_PARENT), :]
    return torch.linalg.norm(bones, dim=-1)


def _first_searches(device, initial_scale, like_parent: bool):
    """The first iteration's candidates of `run_particle_opt` on a bank of
    ones: its first search size, exactly, for batch () and (2,). With
    `like_parent`, the search size made as it was, by a copy from the host."""
    out = []
    for batch in ((), (2,)):
        bank = torch.ones((3, 4), device=device)
        if like_parent:
            search = torch.as_tensor(initial_scale, dtype=bank.dtype, device=device)
            out.append(bank * search.expand(*batch, 4).clone()[..., None, :])
            continue
        seen = []

        def energy_fn(params, sample_ext):
            seen.append(sample_ext)
            zero = torch.zeros(sample_ext.shape[:-1], device=device)
            return zero, zero

        particle.run_particle_opt(particle.ParticleSpec(1, 0.1), bank, initial_scale,
                                  (torch.zeros((*batch, 1), device=device),), energy_fn,
                                  lambda params, mean: params, batch=batch)
        out.append(seen[0])
    return out


def _case(name, device):
    """(the function under test on its inputs, the same function's inputs
    run through the list-index formulation), each returning a tuple."""
    rng = np.random.RandomState(7)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32)).to(device)

    if name == "initial_search":
        scales = (0.005, 5.0, 0.02)   # the hand pose, hand shape and object optimisers'
        return (lambda: tuple(x for s in scales for x in _first_searches(device, s, False)),
                lambda: tuple(x for s in scales for x in _first_searches(device, s, True)))
    if name == "kp2length":
        kp = t(2, 3, 21, 3, scale=0.05)
        return lambda: (hand_shape.kp2length(kp), hand_shape.kp2length(kp[0, 0])), \
            lambda: (_kp2length_lists(kp), _kp2length_lists(kp[0, 0]))
    if name == "kinematic_chain":
        rot_mats = layer.mano_rodrigues(t(5, 16, 3, scale=0.4))
        joints = t(5, 16, 3, scale=0.05)
        return (lambda: layer._kinematic_chain(rot_mats, joints),
                lambda: _kinematic_chain_lists(rot_mats, joints))
    mano = synthetic_mano_model().to(device)
    pose = torch.from_numpy(candidates(6, seed=3)[0]).to(device)
    trans = t(6, 3, scale=0.02)
    betas = t(2, 10, scale=0.3)
    shaped = layer.shape_hand(mano, betas)
    if name == "mano_forward":
        def run():
            return (*layer.mano_forward(mano, pose, trans=trans, shaped=shaped),
                    *layer.mano_forward(mano, pose[:2], betas=betas, root_palm=True,
                                        original_version=True))
    else:
        def run():
            return layer.mano_skin_inputs(mano, pose, trans, shaped)
    return run, run


def _bitwise(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and g.device == w.device
        assert torch.equal(g.contiguous().view(torch.int32), w.contiguous().view(torch.int32))


@pytest.mark.parametrize("name", ["kinematic_chain", "mano_forward", "mano_skin_inputs",
                                  "kp2length", "initial_search"])
def test_index_tensors_gather_what_the_lists_gathered(device, name, monkeypatch):
    run, parent = _case(name, device)
    got = run()
    made = index_tensor.cache_info().misses
    again = run()
    assert index_tensor.cache_info().misses == made, "a second call made an index tensor"
    _bitwise(again, got)
    with monkeypatch.context() as m:
        m.setattr(layer, "index_tensor", _lists)
        want = parent()
    _bitwise(got, want)
    for ids in (LEV1_IDXS, REORDER_IDXS, hand_pose.TIP_KP_IDS, hand_shape.BONE_IDX):
        idx = index_tensor(ids, device)
        assert idx is index_tensor(ids, device)
        assert idx.dtype == torch.int64 and idx.tolist() == list(ids)
    with torch.inference_mode():   # the trackers' mode: autograd may still save it later
        assert not index_tensor.__wrapped__((3, 1), device).is_inference()


def _models(s, device):
    return [distilled_from_numpy(model_arrays(11 + 7 * i, widths=(21, 128, 128, 128)),
                                 device=device) for i in range(s)]


@pytest.mark.gpu
def test_pose_optimisers_never_wait_for_the_card(cuda_device):
    """One batched hand pose and one batched object pose call after a
    warm-up, each as the trackers make it (inputs on the card, the packed
    models made once), with the host forbidden to wait for the card."""
    dev, s, p, hw = cuda_device, 2, 64, (48, 64)
    gen = torch.Generator().manual_seed(0)
    mano = synthetic_mano_model().to(dev)
    models = _models(s, dev)
    packed = pack_distilled_batched(models)
    rot, obj_t = zip(*(object_pose(seed=i) for i in range(s)))
    obj_rot = torch.from_numpy(np.stack(rot)).to(dev)
    pose, trans, beta = candidates(s, seed=4)
    kp = layer.mano_forward(mano, torch.from_numpy(pose).to(dev),
                            trans=torch.from_numpy(trans).to(dev))[1][:, None]
    hand_args = dict(
        mano_model=mano, presampled=particle.presample_particles(p, 16, gen, device=dev),
        zones=hand_pose.load_contact_zones(device=dev), sdf_volume=None,
        hand_shape=torch.from_numpy(np.repeat(beta[None], s, 0)).to(dev),
        init_rotation=torch.eye(3, device=dev).repeat(s, 1, 1, 1),
        init_translation=torch.from_numpy(trans).to(dev)[:, None, :, None],
        init_theta=torch.from_numpy(pose[:, 3:]).to(dev)[:, None], pred_kp=kp,
        vis_mask=torch.arange(21, device=dev).repeat(s, 1, 1) % 3 > 0, last_frame_kp=kp,
        has_last=1.0, obj_rotation=obj_rot,
        obj_translation=torch.from_numpy(np.stack(obj_t)).to(dev),
        background_mask=torch.from_numpy(np.stack([mask_of(hw, i) for i in range(s)])).to(dev),
        intrinsics={k: torch.full((s,), float(v), device=dev)
                    for k, v in zip(("fx", "fy", "cx", "cy"), intrinsics(hw))},
        energy_weight={"penetrate_sum_loss": 1.0, "sil_loss": 0.1, "attraction_loss": 0.05,
                       "vis_regu_loss": 10.0, "invis_regu_loss": 0.0, "temporal_smooth": 1.0},
        distilled=models, packed=packed)
    cloud = np.random.RandomState(5).randn(s, 200, 3).astype(np.float32) * np.float32(0.03)
    obj_args = dict(
        sdf_volume=None, presampled=particle.presample_particles(p, 6, gen, device=dev),
        pcld=torch.from_numpy(cloud).to(dev), rotation=obj_rot,
        translation=torch.zeros((s, 3, 1), device=dev), distilled=models, packed=packed)
    warm = (hand_pose.optimize_hand_pose(**hand_args), obj_pose.optimize_obj_pose(**obj_args))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        held = (hand_pose.optimize_hand_pose(**hand_args), obj_pose.optimize_obj_pose(**obj_args))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    for w, h in zip(warm, held):   # the same inputs give the same answers
        _bitwise(tuple(w), tuple(h))
