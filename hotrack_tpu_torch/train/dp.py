"""Data-parallel training over D devices: one process a device (port of the
data-parallel parts of hotrack_tpu/train/trainer.py and of
`__graft_entry__.dryrun_multichip`).

`dp_devices: N | all | -1` (CLI `--dp_devices N`) asks for N ranks. The
calling process is rank 0; ranks 1..D-1 are started with
`multiprocessing.get_context("spawn")` and run a function of this package's
modules (never one of a test file, so a child imports only the port). The
ranks meet through a `FileStore` in a fresh temporary directory (no TCP
port to collide on) and form one `torch.distributed` group: NCCL on the card,
rank r on cuda:r, gloo on the CPU. A caller may ask for gloo on cards
(`backend="gloo"`, several ranks on one card, which NCCL refuses); gloo on
CUDA tensors has `all_reduce` and `broadcast` only, and those are the only
collectives the port uses.

The rule for every path is the one GSPMD gives the JAX package: a dp step
is the one-process step at the global batch, apart from the order of float
sums. Every rank reads the same global batch and keeps its equal share of
rows (`shard_rows`); BatchNorm's statistics and dropout's masks are those of
the global batch (nn/global_batch.py); the trainer sums every gradient in one
all-reduce a step (train/trainer.py).

A child's exception fails the run: its traceback comes back to rank 0, which
raises it after its own part. Children are joined with a timeout and killed
on its expiry; a rank waiting in a collective for a rank that died gives up
after the group's timeout.
"""

from __future__ import annotations

import contextlib
import datetime
import multiprocessing
import os
import shutil
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..nn.global_batch import sharding

DEFAULT_TIMEOUT_S = 1800.0


def world_size(cfg: dict) -> int:
    """The number of ranks `cfg['dp_devices']` asks for on cfg['device']'s
    type: 0 / absent / 1 -> 1 (the one-process path); 'all' or -1 -> every
    visible card (on the CPU, which is one device: 1); N -> N. Asking for more
    cards than torch.cuda.device_count() raises, as the JAX trainer's assert
    does; on the CPU N ranks share the host."""
    dp = cfg.get("dp_devices", 0)
    if not dp:
        return 1
    device = torch.device(cfg.get("device") or "cuda")
    have = torch.cuda.device_count() if device.type == "cuda" else 1
    if dp in ("all", -1):
        return max(have, 1)
    n = int(dp)
    if n < 1:
        raise ValueError(f"dp_devices={dp}: asks for no device")
    if device.type == "cuda" and n > have:
        raise ValueError(f"dp_devices={dp} but only {have} devices")
    return n


@dataclass
class Rank:
    """One rank of a data-parallel group: its index, the group's size, its
    device and the collectives (sums in place, a broadcast from rank 0)."""
    rank: int
    world: int
    device: torch.device
    backend: str

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def all_reduce(self, t: torch.Tensor) -> None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM)

    def broadcast(self, t: torch.Tensor) -> None:
        dist.broadcast(t, src=0)

    def barrier(self) -> None:
        """Every rank here before any goes on (an all-reduce of one number)."""
        self.all_reduce(torch.zeros(1, device=self.device))

    def broadcast_module(self, module: torch.nn.Module) -> None:
        """Rank 0's parameters and buffers into every rank's module: one
        broadcast a dtype, of the tensors flattened."""
        tensors = [t for t in (*module.parameters(), *module.buffers())]
        by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        with torch.no_grad():
            for group in by_dtype.values():
                flat = torch.cat([t.reshape(-1) for t in group])
                self.broadcast(flat)
                offset = 0
                for t in group:
                    t.copy_(flat[offset:offset + t.numel()].view_as(t))
                    offset += t.numel()

    def shard(self, batch, strict: bool):
        """The rank's rows of a global batch (every tensor's leading axis),
        or None when the batch does not divide by the world size: with
        `strict` that raises, on every rank alike, before any collective."""
        return shard_rows(batch, self.rank, self.world, strict)


def shard_rows(batch, rank: int, world: int, strict: bool):
    """Rows [rank * b, (rank + 1) * b) of every tensor of a (nested dict)
    batch of world * b rows. A batch whose leading sizes do not divide by
    `world` gives None, or with `strict` raises (the JAX trainer's message)."""
    sizes = set()

    def visit(tree):
        if isinstance(tree, dict):
            for v in tree.values():
                visit(v)
        elif isinstance(tree, torch.Tensor):
            sizes.add(tree.shape[0])
    visit(batch)
    if any(s % world for s in sizes):
        if strict:
            raise ValueError(f"dp_devices={world} needs batch_size divisible by it; got "
                             f"{sorted(sizes)} (set batch_size to a multiple of {world})")
        return None

    def cut(tree):
        if isinstance(tree, dict):
            return {k: cut(v) for k, v in tree.items()}
        if isinstance(tree, torch.Tensor):
            b = tree.shape[0] // world
            return tree[rank * b:(rank + 1) * b]
        return tree
    return cut(batch)


def rank_device(device_type: str, rank: int, devices=None) -> torch.device:
    """Rank r's device: devices[r] where given, else cuda:r or the CPU."""
    if devices is not None:
        return torch.device(devices[rank])
    return torch.device(f"cuda:{rank}") if device_type == "cuda" else torch.device("cpu")


@contextlib.contextmanager
def _group(rank: int, world: int, device: torch.device, backend: str, store_path: str,
           timeout_s: float):
    """This process as rank `rank` of a group met through the FileStore at
    `store_path`; the group is torn down on the way out."""
    if device.type == "cuda":
        torch.cuda.set_device(device)
    store = dist.FileStore(store_path, world)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    me = Rank(rank, world, device, backend)
    try:
        with sharding(rank, world, me.all_reduce):
            yield me
    finally:
        dist.destroy_process_group()


def _child(fn, rank, world, device, backend, store_path, out_path, timeout_s, args):
    """A spawned rank: fn(Rank, *args) in the group; its return value, or its
    traceback, pickled to out_path."""
    torch.set_num_threads(1)
    try:
        with _group(rank, world, device, backend, store_path, timeout_s) as me:
            result = ("ok", fn(me, *args))
    except BaseException:  # the parent raises it
        result = ("error", f"rank {rank}:\n{traceback.format_exc()}")
    torch.save(result, out_path)
    sys.exit(0 if result[0] == "ok" else 1)


def run_ranks(fn, world: int, device_type: str = "cuda", backend: str | None = None,
              devices=None, args: tuple = (), timeout_s: float = DEFAULT_TIMEOUT_S) -> list:
    """fn(Rank, *args) on `world` ranks: rank 0 in this process, the others in
    spawned processes (`fn` and `args` must pickle; `fn` a function of an
    importable module). Returns every rank's return value, rank 0's first.
    `backend` defaults to NCCL for cuda and gloo for the CPU; `devices` (one
    a rank) overrides cuda:r, and may repeat a card with gloo; `timeout_s`
    bounds a collective's wait and the children's join.

    Any rank's failure raises here: rank 0's own exception, with what every
    other rank did attached as notes, or a RuntimeError naming the child that
    raised, died or outlived the join."""
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    if devices is not None and len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    tmp = tempfile.mkdtemp(prefix="hotrack_dp_")
    store_path = os.path.join(tmp, "store")
    spawn = multiprocessing.get_context("spawn")
    procs = []
    try:
        for r in range(1, world):
            p = spawn.Process(target=_child, daemon=True, args=(
                fn, r, world, rank_device(device_type, r, devices), backend, store_path,
                os.path.join(tmp, f"rank{r}.pt"), timeout_s, args))
            p.start()
            procs.append(p)
        failed = None
        try:
            with _group(0, world, rank_device(device_type, 0, devices), backend, store_path,
                        timeout_s) as me:
                results = [fn(me, *args)]
        except BaseException as exc:  # re-raised below, with the children's outcomes
            failed = exc
        # rank 0 tore its group down on the way out: a child left waiting on
        # it fails at once, so after a failure the join is short
        errors = []
        wait = timeout_s if failed is None else min(timeout_s, 60.0)
        for r, p in enumerate(procs, start=1):
            p.join(wait)
            out = os.path.join(tmp, f"rank{r}.pt")
            if p.is_alive():
                errors.append(f"rank {r} still running {wait} s after rank 0 ended")
            elif not os.path.exists(out):
                errors.append(f"rank {r} died (exit code {p.exitcode})")
            else:
                status, value = torch.load(out, weights_only=False)
                if status == "ok" and failed is None:
                    results.append(value)
                elif status != "ok":
                    errors.append(value)
        if failed is not None:
            for e in errors:
                failed.add_note(e)
            raise failed
        if errors:
            raise RuntimeError("data-parallel rank failed:\n" + "\n".join(errors))
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        shutil.rmtree(tmp, ignore_errors=True)


def rank_info(me: Rank) -> dict:
    """What a rank sees: its index, the group's size, its device and backend,
    and the modules its process has imported."""
    return {"rank": me.rank, "world": me.world, "device": str(me.device),
            "backend": me.backend, "world_seen": dist.get_world_size(),
            "modules": sorted(sys.modules)}


def _to(tree, device, dtype=None):
    if isinstance(tree, dict):
        return {k: _to(v, device, dtype) for k, v in tree.items()}
    return tree.to(device, dtype if dtype is not None and tree.is_floating_point() else None)


def step_report(me: Rank | None, cfg: dict, batches: list, steps: int = 1,
                dtype: torch.dtype | None = None, dropout: bool = True,
                record_picks: bool = False, eval_batches: tuple = (),
                weights: dict | None = None, plain: bool = False) -> dict:
    """`steps` train steps of a Trainer built from cfg (seeded weights) on the
    global batches (step i takes batches[i % len]): as rank `me` of a group,
    or with `me` None in one process; the data-parallel holds compare the
    two. The process-wide generators (the dropout masks) are seeded from
    cfg['seed'], as `train_main` seeds them. `dtype` casts the model and the
    batches, `dropout` False sets every dropout's p to 0, `weights` (a state
    dict) replaces the seeded weights on every rank alike, `plain` runs the model's FPS and row gather as their
    plain PyTorch versions (no kernel on a CUDA tensor; float64 on the card).
    Returns on the host: `Trainer.test`'s losses on each of `eval_batches`
    before the first step, the losses and seconds (device synchronised) of
    every step, the gradients the optimizer took at step 0 (None: no
    gradient), the state after step 0 and after the last, the index picks
    (FPS and index_points) of step 0 with `record_picks`, and the launch
    counts of the port's kernels over the steps."""
    from ..nn import pointnet2
    from ..ops import kernels, pointops
    from .trainer import Trainer

    torch.manual_seed(int(cfg.get("seed", 0)))
    device = me.device if me is not None else torch.device(cfg.get("device") or "cuda")
    trainer = Trainer(cfg, device, dp=me)
    if dtype is not None:
        trainer.model.to(dtype)
    if weights is not None:
        trainer.model.load_state_dict(weights, strict=True)
    if not dropout:
        for m in trainer.model.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.0
    fps, gather = pointops.farthest_point_sample, pointops.index_points
    if plain:
        fps = pointops._farthest_point_sample_torch

        def gather(points, idx):
            flat = pointops._gather_rows_torch(points, idx.reshape(points.shape[0], -1))
            return flat.reshape(*idx.shape, points.shape[-1])
    picks = []

    def recording_fps(xyz, npoint, valid_mask=None):
        picks.append(fps(xyz, npoint, valid_mask).cpu())
        return picks[-1].to(xyz.device)

    def recording_gather(points, idx):
        picks.append(idx.cpu().long())
        return gather(points, idx)

    def host(sd):
        return {k: v.detach().cpu().clone() for k, v in sd.items()}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    out = {"evals": [{k: float(v) for k, v in trainer.test(_to(b, device, dtype)).items()}
                     for b in eval_batches], "losses": [], "seconds": []}
    kernels.reset_launch_counts()
    for i in range(steps):
        batch = _to(batches[i % len(batches)], device, dtype)
        if record_picks and i == 0:
            pointnet2.farthest_point_sample, pointnet2.index_points = (recording_fps,
                                                                       recording_gather)
        else:
            pointnet2.farthest_point_sample, pointnet2.index_points = fps, gather
        try:
            sync()
            t0 = time.perf_counter()
            loss = trainer.update(batch)
            sync()
            out["seconds"].append(time.perf_counter() - t0)
        finally:
            pointnet2.farthest_point_sample = pointops.farthest_point_sample
            pointnet2.index_points = pointops.index_points
        out["losses"].append({k: float(v) for k, v in loss.items()})
        if i == 0:
            out["grads"] = {k: None if p.grad is None else p.grad.detach().cpu().clone()
                            for k, p in trainer.model.named_parameters()}
            out["state1"] = host(trainer.model.state_dict())
    out["state"] = host(trainer.model.state_dict())
    out["picks"] = picks
    out["launches"] = dict(kernels.launch_counts)
    return out


def each(me: Rank, calls: list) -> list:
    """Several rank functions in one group, in order: [(fn, args), ...] ->
    [fn(me, *args), ...] (one spawn for several holds)."""
    return [fn(me, *args) for fn, args in calls]


def train_rank(me: Rank, cfg: dict):
    """A rank of `train_main`: the epoch loop of train/cli.py; rank 0 returns
    its Trainer, the others None."""
    from .cli import run_training
    trainer = run_training(cfg, me)
    return trainer if me.is_main else None


def evaluate_rank(me: Rank, cfg: dict):
    """A rank of single-frame evaluation (`track: False`); rank 0 returns
    (mean losses, stats), the others None."""
    from .cli import run_single_frame
    out = run_single_frame(cfg, me)
    return out if me.is_main else None
