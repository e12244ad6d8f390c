"""The two SDF kernels of hotrack_tpu_torch on a card: the distilled-SDF MLP
(csrc/sdf_mlp.cu) and the fused object-pose energy (csrc/obj_energy.cu), each
against its plain PyTorch version on the same device. All tests here are
marked `gpu` and skip without a CUDA device: a CUDA kernel has no interpret
mode. The plain versions themselves are held against the JAX package in
test_torch_distill.py and test_torch_obj_energy.py, on the CPU.

This file imports torch and the port only, so it runs on a machine with a
card and no JAX:

    python -m pytest tests/test_torch_sdf_kernels.py -m gpu -q

Tolerances, both sides float32. Both kernels run the MLP's hidden layers on
the tensor cores in 3xTF32 (the SDF MLP through wgmma, csrc/sdf_mlp_wgmma.cuh;
the energy through mma.sync, csrc/sdf_mlp_tc.cuh), whose float32 sums
truncate: one value within TC_SDF_ATOL (|sdf| <= 0.05; one lay up to 1.34e-7
from the plain version's on the card at depth 8, where a float32 FMA kernel
had 4.1e-8), against the plain version and against the 3xTF32 emulation of
ops/tf32.py, whose exact sums would show a layout error at the size of a
weight; a sum of N |sdf| values within ENERGY_RTOL of its size plus
ENERGY_ATOL a point; two launches of either kernel bitwise equal (a fixed
summation order, no atomics).
"""

import numpy as np
import pytest
import torch

from hotrack_tpu_torch.ops import kernels, obj_energy, sdf_mlp, tf32
from hotrack_tpu_torch.pose.rotations import normalize_quat, unit_quaternion_to_matrix
from hotrack_tpu_torch.utils.convert import distilled_from_numpy
from torch_sdf_models import model_arrays

MODELS = {
    "shipped width": dict(widths=(21, 128, 128, 128)),
    "6 frequencies, depth 4": dict(widths=(39, 128, 128, 128, 128)),
    "narrow, non-geometric frequencies": dict(widths=(15, 32, 48), freqs=[1.0, 2.5]),
    "depth 1": dict(widths=(9, 128)),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA kernel has no interpret mode")
    return torch.device("cuda")


def _model(name, device):
    return distilled_from_numpy(model_arrays(1, **MODELS[name]), device=device)


TC_SDF_ATOL = 2.5e-7   # one sdf value of a 3xTF32 kernel (chip_smoke.py's bound)


def _sdf_holds(model, pts, cf, got):
    """got against the plain version and the 3xTF32 emulation, within
    TC_SDF_ATOL a value."""
    pts_cf = pts if cf else pts.transpose(-1, -2)
    want = sdf_mlp._sdf_mlp_torch(model, pts_cf)
    emu = sdf_mlp._sdf_mlp_torch(model, pts_cf, mlp=tf32.raw_sdf_mlp_3xtf32)
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= TC_SDF_ATOL
    assert float((got - emu).abs().max()) <= TC_SDF_ATOL


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("shape,cf", [((2048, 3, 256), True), ((37, 3), False),
                                      ((4, 300, 3), False), ((3, 3, 1000), True)])
def test_sdf_mlp_kernel_matches_plain_version(cuda_device, name, shape, cf):
    model = _model(name, cuda_device)
    pts = torch.from_numpy((np.random.RandomState(2).randn(*shape) * 0.08)
                           .astype(np.float32)).to(cuda_device)
    before = kernels.launch_counts["sdf_mlp"]
    fn = sdf_mlp.fused_sdf_mlp_cf if cf else sdf_mlp.fused_sdf_mlp
    got = fn(model, pts)
    again = fn(model, pts)
    torch.cuda.synchronize()
    assert kernels.launch_counts["sdf_mlp"] == before + 2
    assert torch.equal(got, again)
    _sdf_holds(model, pts, cf, got)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 63, 64, 65, 127, 128, 129, 1000])
@pytest.mark.parametrize("cf", [True, False])
def test_sdf_mlp_kernel_ragged_counts_around_a_round(cuda_device, m, cf):
    """A round is 128 points: counts about it and about half of it, in both
    layouts; the ragged round stores nothing past m."""
    model = _model("shipped width", cuda_device)
    shape = (2, 3, m) if cf else (2, m, 3)
    pts = torch.from_numpy((np.random.RandomState(m).randn(*shape) * 0.08)
                           .astype(np.float32)).to(cuda_device)
    fn = sdf_mlp.fused_sdf_mlp_cf if cf else sdf_mlp.fused_sdf_mlp
    got = fn(model, pts)
    torch.cuda.synchronize()
    _sdf_holds(model, pts, cf, got)
    # each batch row alone gives the same values: no point reads another's
    for b in range(2):
        assert torch.equal(fn(model, pts[b:b + 1].contiguous())[0], got[b])


@pytest.mark.gpu
def test_sdf_mlp_kernel_depth_8_at_width_128(cuda_device):
    """The deepest net the kernels take, whose later layers do not all fit
    in a block's shared memory at once."""
    model = distilled_from_numpy(model_arrays(5, widths=(21,) + (128,) * 8), device=cuda_device)
    pts = torch.from_numpy((np.random.RandomState(6).randn(5, 3, 300) * 0.08)
                           .astype(np.float32)).to(cuda_device)
    got = sdf_mlp.fused_sdf_mlp_cf(model, pts)
    again = sdf_mlp.fused_sdf_mlp_cf(model, pts)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _sdf_holds(model, pts, True, got)


@pytest.mark.gpu
def test_sdf_mlp_kernel_refuses_what_it_does_not_take(cuda_device):
    model = _model("shipped width", cuda_device)
    packed = sdf_mlp.pack_distilled(model)
    with pytest.raises(ValueError, match="float32"):
        kernels.sdf_mlp_cuda(torch.zeros(3, 8, device=cuda_device, dtype=torch.float64),
                             packed, True)
    with pytest.raises(ValueError, match="backward"):
        sdf_mlp.fused_sdf_mlp(model, torch.zeros(8, 3, device=cuda_device, requires_grad=True))
    with torch.no_grad():  # a query under no_grad is fine whatever the points require
        sdf_mlp.fused_sdf_mlp(model, torch.zeros(8, 3, device=cuda_device, requires_grad=True))


ENERGY_RTOL, ENERGY_ATOL = 2e-6, 2.5e-7


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("p,n", [(16, 256), (10, 200), (7, 129), (1, 1), (33, 1000),
                                 (2048, 256), (2047, 1000)])
def test_obj_energy_kernel_matches_plain_version_and_relaunches_bitwise(cuda_device, name,
                                                                       p, n):
    model = _model(name, cuda_device)
    rng = np.random.RandomState(n)
    pcld_cf = torch.from_numpy((rng.randn(3, n) * 0.1).astype(np.float32)).to(cuda_device)
    rot = unit_quaternion_to_matrix(normalize_quat(
        torch.from_numpy(rng.randn(p, 4).astype(np.float32)).to(cuda_device)))
    trans = torch.from_numpy((rng.randn(p, 3) * 0.05).astype(np.float32)).to(cuda_device)
    before = kernels.launch_counts["obj_sdf_energy"]
    got = obj_energy.fused_obj_sdf_energy(model, pcld_cf, rot, trans)
    again = obj_energy.fused_obj_sdf_energy(model, pcld_cf, rot, trans)
    torch.cuda.synchronize()
    assert kernels.launch_counts["obj_sdf_energy"] == before + 2
    assert tuple(got.shape) == (p,) and torch.equal(got, again)
    rts = obj_energy.obj_rts(rot, trans).contiguous()
    want = obj_energy._obj_sdf_energy_torch(model, pcld_cf, rts)
    assert bool(((got - want).abs() <= ENERGY_RTOL * want.abs() + ENERGY_ATOL * n).all())
    # the 3xTF32 arithmetic with exact sums: a fragment-layout error would be
    # off by the size of a weight
    emu = obj_energy._obj_sdf_energy_torch(model, pcld_cf, rts, mlp=tf32.raw_sdf_mlp_3xtf32)
    assert bool(((got - emu).abs() <= ENERGY_RTOL * emu.abs() + ENERGY_ATOL * n).all())


@pytest.mark.gpu
def test_distillation_repeats_bitwise_on_the_card(cuda_device):
    """Two fits of one volume from one seed on the card are bitwise alike: the
    near-surface draw's cumulative sum is taken on the host, where a float32
    scan on the card adds in an order that changes from run to run."""
    from hotrack_tpu_torch.sdf.assets import synthetic_box_sdf_setup
    from hotrack_tpu_torch.sdf.distill import distill_sdf_volume
    vol = synthetic_box_sdf_setup(101, 0.004, device=cuda_device)
    fits = [distill_sdf_volume(vol, 0.004, torch.Generator().manual_seed(7), steps=30,
                               batch=1024, pool_batches=4) for _ in range(2)]
    for a, b in zip(fits[0].weights + fits[0].biases, fits[1].weights + fits[1].biases):
        assert torch.equal(a, b)
