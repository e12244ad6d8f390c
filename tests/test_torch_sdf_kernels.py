"""The two SDF kernels of hotrack_tpu_torch on a card: the distilled-SDF MLP
(csrc/sdf_mlp.cu) and the fused object-pose energy (csrc/obj_energy.cu), each
against its plain PyTorch version on the same device. All tests here are
marked `gpu` and skip without a CUDA device: a CUDA kernel has no interpret
mode. The plain versions themselves are held against the JAX package in
test_torch_distill.py and test_torch_obj_energy.py, on the CPU.

This file imports torch and the port only, so it runs on a machine with a
card and no JAX:

    python -m pytest tests/test_torch_sdf_kernels.py -m gpu -q

Tolerances, both sides float32: 5e-7 on a value (|sdf| <= 0.05; the kernel
adds a unit's products in ascending order with FMA, the library in its own
order). The energy kernel runs the MLP on the tensor cores in 3xTF32
(csrc/sdf_mlp_tc.cuh), whose float32 sums truncate: ENERGY_RTOL of a sum of
N |sdf| values plus ENERGY_ATOL a point (one value lay up to 1.7e-7 from the
plain version's on the card, where the float32 FMA kernel had 1e-8 a point),
against the plain version and against the 3xTF32 emulation of ops/tf32.py;
two launches of the energy kernel bitwise equal (a fixed summation order, no
atomics).
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


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("shape,cf", [((2048, 3, 256), True), ((37, 3), False),
                                      ((4, 300, 3), False), ((3, 3, 1000), True)])
def test_sdf_mlp_kernel_matches_plain_version(cuda_device, name, shape, cf):
    model = _model(name, cuda_device)
    pts = torch.from_numpy((np.random.RandomState(2).randn(*shape) * 0.08)
                           .astype(np.float32)).to(cuda_device)
    before = kernels.launch_counts["sdf_mlp"]
    got = (sdf_mlp.fused_sdf_mlp_cf if cf else sdf_mlp.fused_sdf_mlp)(model, pts)
    torch.cuda.synchronize()
    assert kernels.launch_counts["sdf_mlp"] == before + 1
    want = sdf_mlp._sdf_mlp_torch(model, pts if cf else pts.transpose(-1, -2))
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= 5e-7


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
