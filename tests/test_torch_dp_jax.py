"""The port's data-parallel step against the JAX package's: the JAX Trainer
with `dp_devices: 2` on the virtual CPU mesh of tests/conftest.py (GSPMD over
the batch axis, its step under jit) against train/dp.py's two spawned gloo
ranks, from the same weights (the flax tree through the port's exporter) on
the same global batch, dropout off on both sides (`flax.linen.Dropout`
patched to the identity in the test, p = 0 on the port's side), in float64
(`jax.enable_x64`, and `jnp.float32` patched to float64 while the JAX step
is traced, as tests/test_torch_trainer.py does).

Bounds, those of tests/test_torch_trainer.py's float64 step: step-0 losses
rtol 1e-10; the weights and BN statistics after one Adam step within 1e-7.

Sizes: pointnet2_tiny.yml, 64 points, backbone_out_dim 48, global batch 4
(2 rows a rank).
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import NamedSharding, PartitionSpec

from hotrack_tpu.train import trainer as jtrainer
from hotrack_tpu_torch.train import dp
from test_torch_trainer import (_batches, _jax_float64, _no_jax_dropout, _np_tree,
                                _numpy_variables, _trainer_cfg)
from hotrack_tpu_torch.utils import convert


def test_dp_step_matches_the_jax_dp_trainer(tmp_path):
    jb, tb = _batches(str(tmp_path / "data"))
    cfg = {**_trainer_cfg(str(tmp_path / "exp"), "HandTrackNet"), "dp_devices": 2}
    with _jax_float64():
        with _no_jax_dropout():
            jtr = jtrainer.Trainer(cfg)
            jb0 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a), np.float64), jb[0])
            params0, stats0 = jax.tree.map(lambda a: a.astype(np.float64),
                                           _numpy_variables(jtr, jb0, seed=0))
    # the port's two ranks run (spawned, and rank 0 in a thread here) while
    # the JAX step is traced
    weights = convert.handtracknet_state_dict_from_flax(params0, stats0, torch.float64)
    port_cfg = {k: v for k, v in cfg.items() if k != "dp_devices"}
    with ThreadPoolExecutor(1) as pool:
        port = pool.submit(dp.run_ranks, dp.step_report, 2, "cpu", timeout_s=120.0, args=(
            port_cfg, [tb[0]], 1, torch.float64, False, False, (), weights))
        with _jax_float64():
            assert jtr.mesh is not None and jtr.mesh.devices.size == 2
            state = jtrainer.TrainState(
                jax.tree.map(jnp.asarray, params0), jax.tree.map(jnp.asarray, stats0),
                jtr.optimizer.init(params0), jnp.asarray(0), jnp.asarray(0))
            jtr.state = jax.device_put(state, NamedSharding(jtr.mesh, PartitionSpec()))
            # the reachability mask the JAX trainer would probe in a compile of
            # its own: in FFN mode transt.s12 and transt.c12 (flax's
            # AttnModule_1 and _3 of transt, utils/convert.py) are unreachable,
            # the port's parameters without a gradient (test_torch_trainer.py
            # holds the probe's mask to that set)
            jtr._reach_mask = tuple(
                [getattr(k, "key", None) for k in path[:2]]
                not in (["transt", "AttnModule_1"], ["transt", "AttnModule_3"])
                for path, _ in jax.tree_util.tree_flatten_with_path(jtr.state.params)[0])
            assert jtr._reach_mask.count(False) > 0
            with _no_jax_dropout():
                jloss = {k: float(v)
                         for k, v in jtr.update(jb0, jax.random.PRNGKey(0)).items()}
            jstate1 = convert.handtracknet_state_dict_from_flax(
                _np_tree(jtr.state.params), _np_tree(jtr.state.batch_stats), torch.float64)
        ranks = port.result()
    for rank in ranks:
        tloss = rank["losses"][0]
        assert set(tloss) == set(jloss)
        for k, want in jloss.items():
            np.testing.assert_allclose(tloss[k], want, rtol=1e-10, err_msg=k)
        for k, want in jstate1.items():
            if k.endswith("num_batches_tracked"):
                continue
            d = float((rank["state1"][k] - want).abs().max())
            assert d <= 1e-7, (k, d)
