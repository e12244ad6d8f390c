"""Port parity for the fused object-pose SDF energy
(hotrack_tpu_torch/ops/obj_energy.py) against the Pallas kernel of
hotrack_tpu/ops/pallas/obj_energy.py in interpret mode and against the
composed oracle of tests/test_obj_energy.py (transform by einsum, the
distilled SDF's XLA path, sum of |sdf|), on the CPU. On the CPU
`fused_obj_sdf_energy` is the plain version of the CUDA kernel
(`_obj_sdf_energy_torch`), so holding it holds the kernel's oracle.

Tolerances: a sum of N |sdf| values (each <= 0.05) against the composed
oracle rtol 2e-6 + atol 1e-6 (float32 products summed in another order,
then N terms); against the Pallas kernel rtol 2e-5 + atol 2e-5, the JAX
package's own bound for it (its double-angle recurrence for the higher
frequencies deviates by about 1e-6 a point). Also here: the build cache's
hash over included headers.
"""

import shutil

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hotrack_tpu.ops.pallas import obj_energy as jax_kernel
from hotrack_tpu.pose.rotations import unit_quaternion_to_matrix as jax_quat_to_matrix
from hotrack_tpu.sdf.distill import eval_distilled_sdf_cf as jax_eval_cf
from hotrack_tpu_torch.ops import kernels, obj_energy, sdf_mlp
from torch_sdf_models import random_model


def _poses(p, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(p, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    rot = np.array(jax_quat_to_matrix(jnp.asarray(q)))
    return rot, (rng.randn(p, 3) * 0.05).astype(np.float32)


def _oracle(jmodel, pcld_cf, rot, t):
    """tests/test_obj_energy.py's composed oracle."""
    rot_t = jnp.swapaxes(jnp.asarray(rot), -1, -2)
    obj = (jnp.einsum("pij,jn->pin", rot_t, jnp.asarray(pcld_cf))
           - jnp.matmul(rot_t, jnp.asarray(t)[..., None]))
    return np.asarray(jnp.sum(jnp.abs(jax_eval_cf(jmodel, obj)), axis=-1))


# P a multiple of the TPU kernel's tile and not, N a multiple of 128 and not
SHAPES = [(16, 256), (10, 200), (7, 129), (1, 1), (33, 1000)]


@pytest.mark.parametrize("p,n", SHAPES)
def test_plain_obj_energy_matches_pallas_and_the_composed_oracle(p, n):
    jmodel, tmodel = random_model(20, widths=(21, 128, 128))
    pcld_cf = (np.random.RandomState(n).randn(3, n) * 0.1).astype(np.float32)
    rot, t = _poses(p, seed=n)
    got = obj_energy.fused_obj_sdf_energy(tmodel, torch.from_numpy(pcld_cf),
                                          torch.from_numpy(rot), torch.from_numpy(t))
    assert tuple(got.shape) == (p,) and got.dtype == torch.float32
    want = _oracle(jmodel, pcld_cf, rot, t)
    assert np.all(want > 0)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=1e-6)
    pallas = np.asarray(jax_kernel.fused_obj_sdf_energy(
        jmodel, jnp.asarray(pcld_cf), jnp.asarray(rot), jnp.asarray(t), interpret=True))
    np.testing.assert_allclose(got.numpy(), pallas, rtol=2e-5, atol=2e-5)
    # translations (P, 3, 1), as the optimiser holds them, give the same
    same = obj_energy.fused_obj_sdf_energy(tmodel, torch.from_numpy(pcld_cf),
                                           torch.from_numpy(rot),
                                           torch.from_numpy(t)[..., None])
    assert torch.equal(same, got)


def test_plain_obj_energy_non_geometric_frequencies_and_depth():
    """Frequencies that are no geometric sequence (the TPU kernel's
    recurrence cannot take them) and a deeper net: the composed oracle only."""
    for seed, widths, freqs in ((21, (15, 32, 48), [1.0, 2.5]),
                                (22, (39, 64, 64, 64, 64), None)):
        jmodel, tmodel = random_model(seed, widths=widths, freqs=freqs)
        pcld_cf = (np.random.RandomState(seed).randn(3, 77) * 0.1).astype(np.float32)
        rot, t = _poses(9, seed)
        got = obj_energy.fused_obj_sdf_energy(tmodel, torch.from_numpy(pcld_cf),
                                              torch.from_numpy(rot), torch.from_numpy(t))
        np.testing.assert_allclose(got.numpy(), _oracle(jmodel, pcld_cf, rot, t),
                                   rtol=2e-6, atol=1e-6)


def test_obj_rts_matches_jax_and_chunking_changes_nothing():
    _, tmodel = random_model(23)
    rot, t = _poses(12, 5)
    rts = obj_energy.obj_rts(torch.from_numpy(rot), torch.from_numpy(t))
    want = np.asarray(jax_kernel.obj_rts(jnp.asarray(rot), jnp.asarray(t)))
    assert tuple(rts.shape) == (12, 12)
    np.testing.assert_allclose(rts.numpy(), want, atol=1e-7, rtol=0)
    pcld_cf = torch.from_numpy((np.random.RandomState(6).randn(3, 50) * 0.1).astype(np.float32))
    whole = obj_energy._obj_sdf_energy_torch(tmodel, pcld_cf, rts)
    parts = obj_energy._obj_sdf_energy_torch(tmodel, pcld_cf, rts, chunk=170)  # 3 poses a pass
    np.testing.assert_allclose(parts.numpy(), whole.numpy(), rtol=1e-6, atol=0)


def test_bad_shapes_and_cpu_tensors_at_the_cuda_wrapper_raise():
    _, tmodel = random_model(24)
    rot, t = _poses(4, 7)
    with pytest.raises(ValueError, match=r"\(3, N\)"):
        obj_energy.fused_obj_sdf_energy(tmodel, torch.zeros(5, 3), torch.from_numpy(rot),
                                        torch.from_numpy(t))
    before = kernels.launch_counts["obj_sdf_energy"]
    with pytest.raises(ValueError, match="CUDA"):
        kernels.obj_sdf_energy_cuda(torch.zeros(3, 5), torch.zeros(4, 12),
                                    sdf_mlp.pack_distilled(tmodel))
    assert kernels.launch_counts["obj_sdf_energy"] == before
    assert set(kernels.launch_counts) >= {"sdf_mlp", "obj_sdf_energy"}
    assert {"sdf_mlp", "obj_energy"} <= set(kernels.SOURCES)


def test_library_name_changes_when_an_included_header_changes(tmp_path, monkeypatch):
    """The build cache is keyed by the source and every csrc/ file it
    includes: an edited header must not load a stale library."""
    csrc = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC_DIR, csrc)
    monkeypatch.setattr(kernels, "CSRC_DIR", csrc)
    monkeypatch.setenv("HOTRACK_KERNEL_BUILD_DIR", str(tmp_path / "build"))
    assert [p.name for p in kernels.source_files("obj_energy")] \
        == ["obj_energy.cu", "sdf_mlp_core.cuh"]
    assert [p.name for p in kernels.source_files("fps")] == ["fps.cu"]
    before = {name: kernels.library_path(name) for name in kernels.SOURCES}
    assert all(p.parent == tmp_path / "build" for p in before.values())
    assert before == {name: kernels.library_path(name) for name in kernels.SOURCES}
    with open(csrc / "sdf_mlp_core.cuh", "a") as f:
        f.write("// edited\n")
    after = {name: kernels.library_path(name) for name in kernels.SOURCES}
    for name in ("sdf_mlp", "obj_energy"):
        assert after[name] != before[name], name
    for name in ("fps", "gather_rows"):
        assert after[name] == before[name], name
    # a header reached through another header counts too
    (csrc / "inner.cuh").write_text("#pragma once\n")
    with open(csrc / "sdf_mlp_core.cuh", "a") as f:
        f.write('#include "inner.cuh"\n')
    nested = kernels.library_path("sdf_mlp")
    assert [p.name for p in kernels.source_files("sdf_mlp")][-1] == "inner.cuh"
    (csrc / "inner.cuh").write_text("#pragma once\n// edited\n")
    assert kernels.library_path("sdf_mlp") != nested
