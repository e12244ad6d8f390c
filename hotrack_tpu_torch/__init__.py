"""hotrack_tpu_torch — the PyTorch and CUDA port of hotrack_tpu for one
NVIDIA H100.

Same module tree and names as `hotrack_tpu/`, which stays the reference: each
file here is held against the file of the same path there
(tests/test_torch_*.py). The port imports `torch` and never `jax`.

This slice covers HandTrackNet sequence tracking (`python -m
hotrack_tpu_torch.test --config handtracknet_test_SimGrasp.yml`), with
farthest point sampling as a hand-written CUDA kernel (csrc/fps.cu). What is
still to be ported is listed in ROADMAP.md.
"""

__version__ = "0.1.0"
