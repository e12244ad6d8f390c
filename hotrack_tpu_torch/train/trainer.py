"""Trainer: model factory, schedules, train/eval steps, checkpoints.

Port of hotrack_tpu/train/trainer.py. Reproduced semantics:
  - Adam with coupled L2 weight decay (`torch.optim.Adam(weight_decay=wd)`),
    or SGD with momentum 0.9;
  - the step LR schedule gamma^((epoch+1)//step) with the lr_clip freeze and
    warm-up, and CyclicLR, as closed forms of the 0-based epoch;
  - the BatchNorm momentum schedule momentum_original *
    decay^((epoch+1)//step), floored at momentum_min, written into every
    BatchNorm's `momentum` (torch's convention: the weight of the new batch);
  - xavier re-initialisation (`weight_init: xavier`);
  - the model factory keyed on cfg['network']['type'];
  - checkpoints `<experiment_dir>/ckpt/model_%04d.pt` in the reference's
    format (utils/convert.py), which the tracking entry reads. Like the JAX
    package's, a checkpoint holds weights, BN statistics and the epoch, not
    the optimizer's moments.

The train step is forward (BN in train mode, dropout on), the weighted loss,
backward, the optimizer update. Parameters that take no part in the forward
(FFN mode leaves transt.s12 / transt.c12 out) have `.grad is None`, and torch's
optimizers skip them: no step and no weight decay. That is the behaviour the
JAX trainer's reachability probe and mask imitate, so neither is ported.
"""

from __future__ import annotations

import glob
import math
import os
from os.path import join as pjoin

import torch
from torch import nn

from ..mano.model import get_mano_model
from ..models.hand_network import HandTrackNet, IKNet, hand_tracknet_loss, iknet_loss
from ..models.hand_utils import CanonPose
from ..pose.rotations import mano_axisang2quat
from ..utils.convert import load_reference_checkpoint, save_reference_checkpoint


def pin_fp32() -> None:
    """Full float32 in matmuls and cuDNN convolutions on the card (no TF32):
    the port is held against float32 references."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def lr_schedule(cfg: dict, epoch: int) -> float:
    """Learning rate in effect during 0-based training epoch `epoch`.

    The reference steps its scheduler at the top of each epoch, so during
    epoch e it has stepped e + 1 times. Its lr_clip gate does not clamp at
    lr_clip: it stops stepping one boundary early, which freezes the rate at
    base * gamma^n_max with n_max = min{n >= 1: base * gamma^(n+1) <= clip}
    (1.25e-5 from epoch 59 on for the shipped 1e-4 / 0.5 / 20 / clip 1e-5).
    Warm-up scales the applied rate, as in the JAX package."""
    base = cfg["learning_rate"]
    policy = cfg.get("lr_policy", "constant")
    e1 = epoch + 1
    if policy == "step":
        gamma, step = cfg["lr_gamma"], cfg["lr_step_size"]
        clip = cfg.get("lr_clip", 0.0)
        n = e1 // step
        if clip > 0 and 0 < gamma < 1:
            if base <= clip:
                n = 0  # the gate fails before the first step ever happens
            else:
                n_max = 1
                while base * gamma ** (n_max + 1) > clip:
                    n_max += 1
                n = min(n, n_max)
        lr = base * gamma ** n
    elif policy == "CyclicLR":
        # triangular cycle stepped once per epoch; step_size_up =
        # total_epoch * dataset_len // 6 at base 5e-5 / max 5e-4
        base_lr = cfg.get("cyclic_base_lr", 5e-5)
        max_lr = cfg.get("cyclic_max_lr", 5e-4)
        step = max((cfg["total_epoch"] * cfg.get("dataset_len", 1)) // 6, 1)
        cycle = math.floor(1.0 + e1 / (2.0 * step))
        pos = abs(e1 / step - 2.0 * cycle + 1.0)
        lr = base_lr + (max_lr - base_lr) * max(1.0 - pos, 0.0)
    else:
        lr = base
    warm = cfg.get("warm_up", 0)
    if warm > 0 and epoch < warm:
        lr = base * (epoch + 1) / warm
    return float(lr)


def bn_momentum_schedule(cfg: dict, epoch: int) -> float:
    """momentum_original * decay^((epoch + 1) // step), floored: the
    reference increments its 1-based epoch counter before applying the decay."""
    m = cfg.get("momentum_original", 0.1) * (
        cfg.get("momentum_decay", 0.5)
        ** ((epoch + 1) // cfg.get("momentum_step_size", 20)))
    return float(max(m, cfg.get("momentum_min", 0.01)))


def make_optimizer(cfg: dict, params) -> torch.optim.Optimizer:
    if cfg["optimizer"] == "Adam":
        return torch.optim.Adam(params, lr=cfg["learning_rate"], betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=cfg.get("weight_decay", 0.0))
    if cfg["optimizer"] == "SGD":
        return torch.optim.SGD(params, lr=cfg["learning_rate"], momentum=0.9)
    raise ValueError(cfg["optimizer"])


def summarize_losses(loss_dict: dict, loss_weights: dict):
    """Weighted total: only the keys of loss_weights count."""
    total = 0.0
    for key, w in loss_weights.items():
        total = total + w * loss_dict[key]
    out = dict(loss_dict)
    out["total_loss"] = total
    return total, out


def _default_weights(loss_dict: dict) -> dict:
    """Without an explicit loss_weight: the quaternion loss for IKNet, the
    keypoint loss for HandTrackNet."""
    if "quat_loss" in loss_dict:
        return {"quat_loss": 1.0}
    return {"hand_pred_kp_loss": 1.0}


def xavier_reinit(model: nn.Module, generator: torch.Generator) -> None:
    """`weight_init: xavier`: every Linear weight redrawn from a normal of
    std sqrt(2) * sqrt(2 / (fan_in + fan_out)), its bias zeroed; norm layers
    and attention projections untouched."""
    with torch.no_grad():
        for m in model.modules():
            if type(m) is nn.Linear:
                fan_out, fan_in = m.weight.shape
                std = math.sqrt(2.0) * math.sqrt(2.0 / (fan_in + fan_out))
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator) * std)
                if m.bias is not None:
                    m.bias.zero_()


def build_model(cfg: dict) -> nn.Module:
    """The network of cfg['network']['type'] on the CPU, initialised from
    cfg['seed'] (torch's default init, then xavier if the config asks)."""
    net = cfg["network"]
    seed = int(cfg.get("seed", 0))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        if net["type"] == "HandTrackNet":
            model = HandTrackNet(cfg["pointnet"]["camera"],
                                 backbone_out_dim=net["backbone_out_dim"],
                                 handframe=net.get("handframe", "kp"),
                                 use_attention=net.get("use_attention", False),
                                 procrustes_solver=net.get("procrustes_solver"))
        elif net["type"] == "iknet":
            model = IKNet(iknetframe=net.get("iknetframe", "kp"),
                          procrustes_solver=net.get("procrustes_solver"))
        else:
            raise NotImplementedError(net["type"])
    if cfg.get("weight_init") == "xavier":
        xavier_reinit(model, torch.Generator().manual_seed(seed + 1))
    return model


def _obb_pose(model, batch):
    """CanonPose from the pipeline's OBB entry for handframe='OBB'."""
    if getattr(model, "handframe", None) != "OBB":
        return None
    p = batch["OBB_pose"]
    return CanonPose(p["rotation"], p["translation"], p["scale"])


class Trainer:
    """Model, optimizer and schedules of one experiment on one device."""

    def __init__(self, cfg: dict, device=None):
        self.cfg = cfg
        self.device = torch.device(device or cfg.get("device") or "cuda")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' was asked for and "
                               "torch.cuda.is_available() is false")
        pin_fp32()
        self.ckpt_dir = os.path.abspath(pjoin(cfg["experiment_dir"], "ckpt"))
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self.loss_weights = cfg["network"].get("loss_weight", {})
        self.network_type = cfg["network"]["type"]
        self.mano = get_mano_model(cfg.get("mano_root")).to(self.device)
        self.model = build_model(cfg).to(self.device)
        self.optimizer = make_optimizer(cfg, self.model.parameters())
        self.epoch = 0
        self.iteration = 0
        self._apply_schedules()

    def _apply_schedules(self) -> None:
        """This epoch's learning rate into the optimizer's param groups and
        its BN momentum into every BatchNorm."""
        self.lr = lr_schedule(self.cfg, self.epoch)
        self.bn_momentum = bn_momentum_schedule(self.cfg, self.epoch)
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr
        for m in self.model.modules():
            if isinstance(m, nn.modules.batchnorm._BatchNorm):
                m.momentum = self.bn_momentum

    def _losses(self, batch: dict) -> dict:
        palm = batch["gt_hand_pose"]["palm_template"]
        if self.network_type == "HandTrackNet":
            ret = self.model(batch["hand_points"], batch["jittered_hand_kp"], palm,
                             obb_pose=_obb_pose(self.model, batch))
            return hand_tracknet_loss(ret, batch["gt_hand_kp"],
                                      gt_palm_template=palm)[0]
        ret = self.model(batch["jittered_hand_kp"], palm)
        # annotated MANO joint quaternions, the global one stripped
        gt_quat = mano_axisang2quat(batch["gt_hand_pose"]["mano_pose"])[:, 4:]
        return iknet_loss(ret, gt_quat, batch["gt_hand_kp"])[0]

    def update(self, batch: dict) -> dict:
        """One optimizer step on a prepared batch; returns the losses
        (detached tensors, `total_loss` included)."""
        self.model.train()
        loss_dict = self._losses(batch)
        total, loss_dict = summarize_losses(
            loss_dict, self.loss_weights or _default_weights(loss_dict))
        self.optimizer.zero_grad(set_to_none=True)
        total.backward()
        self.optimizer.step()
        self.iteration += 1
        return {k: v.detach() for k, v in loss_dict.items()}

    @torch.no_grad()
    def test(self, batch: dict) -> dict:
        """Losses of a prepared batch in eval mode."""
        self.model.eval()
        return self._losses(batch)

    def step_epoch(self) -> None:
        self.epoch += 1
        self._apply_schedules()

    def save(self, epoch: int | None = None) -> str:
        epoch = self.epoch if epoch is None else epoch
        path = save_reference_checkpoint(
            self.model, pjoin(self.ckpt_dir, f"model_{epoch:04d}.pt"), epoch=self.epoch)
        print(f"saved checkpoint {path}")
        return path

    def resume(self, path: str | None = None) -> bool:
        """Load the latest checkpoint of the experiment, the one a positive
        cfg['resume_epoch'] pins, or `path`; False when there is none."""
        if path is None:
            want = int(self.cfg.get("resume_epoch") or -1)
            if want > 0:
                path = pjoin(self.ckpt_dir, f"model_{want:04d}.pt")
                if not os.path.exists(path):
                    raise FileNotFoundError(f"no checkpoint {path}")
            else:
                ckpts = sorted(glob.glob(pjoin(self.ckpt_dir, "model_*.pt")))
                if not ckpts:
                    return False
                path = ckpts[-1]
        self.epoch = load_reference_checkpoint(self.model, path)
        self._apply_schedules()
        print(f"resumed from {path} (epoch {self.epoch})")
        return True
