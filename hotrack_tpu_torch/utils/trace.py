"""Spans at the layer boundaries of the trackers, on the profiler's clock.

A span names a stretch of the host's work: a tracked frame, a net's call, an
optimiser, one particle iteration. It is on exactly while a torch profiler is
on (`torch.profiler.profile`, whatever its activities); nothing else turns it
on or off. Off, `span` returns one shared no-op context, so a span costs a
flag read and a call. On, a span

  - enters `torch.profiler.record_function(name)`, so the profiler's own
    timeline carries it (the trace `train/cli.py --profile DIR` writes, or a
    profiler's `key_averages()`);
  - appends one record to this module's buffer: its name, its id, the id of
    the span open around it on the same thread (its parent; None at the
    top), the thread, and its start and end in `time.time_ns()`
    nanoseconds, the clock of the profiler's event list, on which the
    profiler also places the card's operations. A span's device time is
    read from the profiler's trace, not here.

The spans, outermost first (the layers of PERF.md section 3):

  track.hand.init       track/hand.HandStep.init_state (the frame-0 prelude)
  track.hand.frame      track/hand.HandStep.step: the loops, the sharded and
                        the streaming hand trackers
  track.obj.init        the packing of the models before an object loop
  track.obj.frame       a frame of track/obj.track_obj_sequence and
                        track_obj_sequences_batched, and ObjTracker.step
  net.handtracknet      HandTrackNet's calls in HandStep
  net.iknet             IKNet's call in HandStep
  opt.hand_pose         opt/hand_pose.optimize_hand_pose
  opt.hand_shape        opt/hand_shape.optimize_hand_shape
  opt.obj_pose          opt/obj_pose.optimize_obj_pose
  opt.particle.iter     an iteration of opt/particle.run_particle_opt
  opt.particle.energy   the iteration's energy call (the candidates' MANO
                        inputs and the energy kernel); the rest of the
                        iteration is the update's elementwise chain
  sdf.distill           sdf/distill.distill_sdf_volume

Reading them: run the code under a profiler of your own and call
`recorded()`, which returns the finished spans (`Span`) in the order they
ended. The buffer holds them until `clear()` empties it, profile after
profile; it keeps at most `CAP` records and counts the rest in `dropped()`.
Or run `python -m hotrack_tpu_torch.test ... --profile DIR` and open its
trace, where each span is a range of the host's timeline (that command
clears the buffer when its profile ends).
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import threading
import time
from typing import NamedTuple

import torch
import torch.autograd.profiler as _profiler

CAP = 1_000_000


class Span(NamedTuple):
    name: str
    id: int
    parent: int | None
    thread: int
    start_ns: int
    end_ns: int


OFF = contextlib.nullcontext()   # every span while no profiler is on

_lock = threading.Lock()
_buffer: list[Span] = []
_dropped = 0
_ids = itertools.count(1)
_local = threading.local()   # .stack: the ids of the thread's open spans


class _On:
    __slots__ = ("name", "id", "parent", "range", "start_ns")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1] if stack else None
        self.id = next(_ids)
        stack.append(self.id)
        # the record encloses the profiler's range, whose start the profiler
        # stamps up to a millisecond into the entry (the process's first range)
        self.start_ns = time.time_ns()
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        return self

    def __exit__(self, *exc):
        self.range.__exit__(*exc)
        end_ns = time.time_ns()
        _local.stack.pop()
        _append(Span(self.name, self.id, self.parent, threading.get_ident(), self.start_ns,
                     end_ns))
        return False


def _append(record: Span) -> None:
    global _dropped
    with _lock:
        if len(_buffer) < CAP:
            _buffer.append(record)
        else:
            _dropped += 1


def span(name: str):
    """A context that records the span `name` while a torch profiler is on,
    and does nothing otherwise."""
    if not _profiler._is_profiler_enabled:
        return OFF
    return _On(name)


def spanned(name: str):
    """Decorator: each call of the function runs inside span(name)."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def recorded() -> list[Span]:
    """The finished spans in the order they ended."""
    with _lock:
        return list(_buffer)


def dropped() -> int:
    """Spans that ended while the buffer held CAP records."""
    return _dropped


def clear() -> None:
    global _dropped
    with _lock:
        _buffer.clear()
        _dropped = 0
