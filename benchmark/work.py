"""The yardstick's arithmetic: the card's published peaks and the work each
call needs, counted from its shapes, whatever kernel runs it.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the full 700 W
power limit; a run prints the card's own limit beside its numbers): 3.35 TB/s
of HBM, 67 TFLOP/s float32 outside the tensor cores, 495 TFLOP/s TF32, 989
TFLOP/s bf16. An SDF MLP point in 3xTF32 (three TF32 passes, float32-class
results) costs its operations three times at the TF32 peak.

A point of the distilled SDF MLP (Fourier features of 3 + 6F inputs, `depth`
hidden layers of `hidden` units, one output) costs 2 * (K0*H + H*H*(depth-1)
+ H) operations: 71,168 at the shipped 21-128-128-128-1. Skinning a MANO
vertex and reading its silhouette hit costs 1,239 float32 operations more.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12

SKIN_HIT_OPS = 1239   # float32 operations a skinned vertex: blend, transform, project, hit


def mlp_ops_per_point(max_freqs: int, hidden: int, depth: int) -> int:
    k0 = 3 + 6 * max_freqs
    return 2 * (k0 * hidden + hidden * hidden * (depth - 1) + hidden)


def least_seconds(mlp_ops: float = 0.0, fp32_ops: float = 0.0, n_bytes: float = 0.0,
                  precision: str = "3xtf32") -> float:
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the operations over their peaks (MLP operations three TF32
    passes in 3xTF32, one bf16 pass in bf16, float32 FMA in float32)."""
    mlp_rate = {"3xtf32": TF32_FLOPS / 3.0, "bf16": BF16_FLOPS, "float32": FP32_FLOPS}
    by_ops = mlp_ops / mlp_rate[precision] + fp32_ops / FP32_FLOPS
    return max(by_ops, n_bytes / HBM_BYTES_PER_S)


def obj_energy_work(sequences: int, particles: int, points: int, mlp: dict) -> dict:
    """One call of the object energy (#4 / #4b): every candidate's SDF at
    every point of its sequence's cloud."""
    per_point = mlp_ops_per_point(mlp["max_freqs"], mlp["hidden"], mlp["depth"])
    return {"mlp_ops": float(sequences) * particles * points * per_point}


def skin_energy_work(sequences: int, particles: int, vertices: int, mlp: dict) -> dict:
    """One call of the skinned hand energy (#7 / #7b): every candidate's
    vertices skinned, their SDF and silhouette hits."""
    per_point = mlp_ops_per_point(mlp["max_freqs"], mlp["hidden"], mlp["depth"])
    n = float(sequences) * particles * vertices
    return {"mlp_ops": n * per_point, "fp32_ops": n * SKIN_HIT_OPS}
