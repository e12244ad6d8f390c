"""hotrack_tpu_torch — the PyTorch and CUDA port of hotrack_tpu for one
NVIDIA H100.

Same module tree and names as `hotrack_tpu/`, which stays the reference: each
file here is held against the file of the same path there
(tests/test_torch_*.py). The port imports `torch` and never `jax`.

It covers training, sequence tracking, object tracking and the full hand
pipeline on the SimGrasp, HO3D and DexYCB layouts (`python -m
hotrack_tpu_torch.train`, `python -m hotrack_tpu_torch.test`), online serving
(`track/stream.py`) and the checkpoint CLI (`python -m
hotrack_tpu_torch.convert`), with every TPU kernel of the JAX package as a
hand-written CUDA kernel (csrc/). What is still to be ported is listed in
ROADMAP.md.
"""

__version__ = "0.1.0"
