"""Online (streaming) tracking: frames fed one at a time (port of
hotrack_tpu/track/stream.py).

The offline trackers take a whole sequence; a live camera gives one frame
after another. `HandTracker` and `ObjTracker` run the offline trackers' own
per-frame step on one frame at a time, with the frame-to-frame state held
by the caller, on the device:

    tracker = HandTracker(handnet, mano, ...)
    state = tracker.init_state(frame0_points, frame0_kp_estimate)
    for frame in camera:                       # frame 0 included
        state, out = tracker.step(state, frame["hand_points"], ...)

`HandTracker.step` is `track/hand.HandStep.step`, the body of
`track_hand_sequence`'s frame loop, and `ObjTracker.step` is
`optimize_obj_pose`, the body of `track_obj_sequence`'s: a streamed
trajectory is bitwise the offline one on the same device and inputs.

`serve` (and `serve_combined`, both trackers in one loop) is the serving
loop: it launches frame f + depth before it hands out frame f's outputs.
Each selected output is copied to pinned host memory without blocking as
soon as its frame is launched, and a CUDA event is recorded after the
copies; the event is waited on just before the frame is handed out, never
earlier, so the host keeps launching while the card works (a copy read
before its event completes would hand out stale bytes). The state stays on
the device and `step` reads nothing on the host.
"""

from __future__ import annotations

from collections import deque
from typing import Iterable, Iterator, Sequence

import torch

from ..mano.model import ManoModel
from ..opt.obj_pose import optimize_obj_pose
from ..ops.sdf_mlp import pack_distilled
from ..utils.trace import spanned
from .hand import HandStep


def _fetch_async(outputs: dict):
    """Start copying `outputs` to the host: (host tensors, the event after
    the copies, or None where nothing lies on a card)."""
    host, event = {}, None
    for key, value in outputs.items():
        host[key] = value
        if value.is_cuda:
            host[key] = torch.empty(value.shape, dtype=value.dtype, pin_memory=True)
            host[key].copy_(value, non_blocking=True)
            event = torch.cuda.Event()
    if event is not None:
        event.record()
    return host, event


def _ready(pending) -> dict:
    host, event = pending
    if event is not None:
        event.synchronize()
    return {k: v.numpy() for k, v in host.items()}


def _serve(step_fn, state, inputs: Iterable, fetch, depth: int = 1) -> Iterator[dict]:
    """The serving loop both trackers share: frame f's outputs (the `fetch`
    keys, every key for None) are handed out, as numpy arrays, once frame
    f + depth has been launched."""
    if depth < 1:
        raise ValueError(f"depth must be at least 1, got {depth}")
    pending: deque = deque()
    for inp in inputs:
        state, out = step_fn(state, **inp) if isinstance(inp, dict) else step_fn(state, inp)
        pending.append(_fetch_async({k: out[k] for k in fetch} if fetch is not None else out))
        if len(pending) > depth:
            yield _ready(pending.popleft())
    while pending:
        yield _ready(pending.popleft())


class HandTracker:
    """Streaming hand tracking: HandTrackNet, with IKNet, the shape modes
    0-3 and the pose optimiser as `track_hand_sequence` takes them, for one
    sequence (the constructor takes its per-sequence options: the nets, the
    particle banks, the contact zones, the object's SDF and the route)."""

    def __init__(self, handnet, mano_model: ManoModel, iknet=None, use_opt: bool = False,
                 shape_mode: int | bool = False, shape_particles: torch.Tensor | None = None,
                 pose_particles: torch.Tensor | None = None, zones=None,
                 sdf_volume: torch.Tensor | None = None, energy_weight: dict | None = None,
                 sdf_voxel_scale: float = 0.003, distilled=None, hand_energy: str = "skin"):
        self._step = HandStep(handnet, mano_model, False, iknet=iknet, use_opt=use_opt,
                              shape_mode=shape_mode, shape_particles=shape_particles,
                              pose_particles=pose_particles, zones=zones,
                              sdf_volume=sdf_volume, energy_weight=energy_weight,
                              sdf_voxel_scale=sdf_voxel_scale, distilled=distilled,
                              hand_energy=hand_energy)

    @torch.inference_mode()
    def init_state(self, hand_points0: torch.Tensor, init_kp: torch.Tensor,
                   mano_beta: torch.Tensor | None = None) -> dict:
        """The state before frame 0 from frame 0's cloud (N, 3) and keypoint
        estimate (21, 3) (the dataset's jittered ground truth offline, a
        detector's output live). mano_beta (10,): the annotated shape that
        IKNet takes in shape mode 0 (zeros where None). Frame 0 is then fed
        to `step` as the first frame, as the offline tracker does."""
        beta = None
        if self._step.use_iknet and not self._step.shape_mode:
            beta = (torch.zeros((1, 10), dtype=hand_points0.dtype, device=hand_points0.device)
                    if mano_beta is None else mano_beta.reshape(1, 10))
        return self._step.init_state(hand_points0[None], init_kp[None], beta)

    @torch.inference_mode()
    def step(self, state: dict, hand_points: torch.Tensor,
             background_mask: torch.Tensor | None = None,
             obj_rotation: torch.Tensor | None = None,
             obj_translation: torch.Tensor | None = None,
             projection: torch.Tensor | None = None):
        """One frame: hand_points (N, 3); with the pose optimiser the
        frame's background_mask (H, W) bool (True = background; none: no
        silhouette term), object pose obj_rotation (3, 3) and
        obj_translation (3, 1), and projection (fx, fy, cx, cy, w, h).
        Returns (the next state, {pred_kp (21, 3), baseline_pred_kp,
        canon_rotation, canon_translation, global_rotation,
        global_translation, MANO_theta})."""
        frame = {}
        if self._step.use_opt:
            frame = dict(projection=projection[None], obj_rotation=obj_rotation[None],
                         obj_translation=obj_translation[None][..., 0],
                         background_mask=None if background_mask is None
                         else background_mask[None])
        state, out = self._step.step(state, hand_points[None], **frame)
        return state, {k: v[0] for k, v in out.items()}

    def serve(self, state: dict, frames: Iterable,
              fetch: Sequence[str] | None = ("pred_kp",), depth: int = 1) -> Iterator[dict]:
        """The serving loop: one dict of numpy arrays a frame, in order, of
        the `fetch` keys (None: all). `frames` yields `step`'s keyword
        arguments as dicts, or bare hand clouds. `depth` frames are in
        flight before a frame is handed out; `step` carries the state on
        where it is needed after the last frame."""
        return _serve(self.step, state, frames, fetch, depth)


class ObjTracker:
    """Streaming object 6-DoF tracking: the particle optimiser a frame from
    the previous frame's pose, `track_obj_sequence`'s frame loop body. The
    distilled model is packed for its kernels once, here."""

    def __init__(self, sdf_volume: torch.Tensor | None, presampled: torch.Tensor,
                 voxel_scale: float = 0.002, bbox_res: int = 201, distilled=None,
                 obj_energy: str = "fused"):
        self._kwargs = dict(voxel_scale=voxel_scale, bbox_res=bbox_res, distilled=distilled,
                            obj_energy=obj_energy)
        self._volume, self._particles = sdf_volume, presampled
        if distilled is not None and distilled.weights[0].is_cuda:
            self._kwargs["packed"] = pack_distilled(distilled)

    def init_state(self, rotation: torch.Tensor, translation: torch.Tensor):
        """The pose (3, 3), (3, 1) of frame 0's estimate."""
        return rotation, translation

    @spanned("track.obj.frame")
    @torch.no_grad()
    def step(self, state, obj_points: torch.Tensor):
        """One frame: obj_points (N, 3) -> (the next state, {rotation,
        translation, sdf_energy})."""
        r, t = state
        r, t, energy = optimize_obj_pose(self._volume, self._particles, obj_points, r, t,
                                         **self._kwargs)
        return (r, t), {"rotation": r, "translation": t, "sdf_energy": energy}

    def serve(self, state, clouds: Iterable,
              fetch: Sequence[str] | None = ("rotation", "translation"),
              depth: int = 1) -> Iterator[dict]:
        """The serving loop over (N, 3) object clouds; see HandTracker.serve."""
        return _serve(self.step, state, clouds, fetch, depth)


def serve_combined(hand_tracker: HandTracker, obj_tracker: ObjTracker, hand_state: dict,
                   obj_state, frames: Iterable,
                   fetch: Sequence[str] | None = ("pred_kp", "obj_rotation",
                                                  "obj_translation"),
                   depth: int = 1) -> Iterator[dict]:
    """Hand and object serving in one loop, both poses out of every frame:
    each frame's hand step, then its object step, are launched before
    earlier frames are handed out. `frames` yields dicts of `obj_points`
    (N, 3) and HandTracker.step's keyword arguments; the object's outputs
    are prefixed `obj_`. Bitwise stepping both trackers in that order."""
    def step(state, obj_points=None, **hand_kwargs):
        h_state, o_state = state
        h_state, h_out = hand_tracker.step(h_state, **hand_kwargs)
        o_state, o_out = obj_tracker.step(o_state, obj_points)
        return (h_state, o_state), {**h_out, **{f"obj_{k}": v for k, v in o_out.items()}}

    return _serve(step, (hand_state, obj_state), frames, fetch, depth)

