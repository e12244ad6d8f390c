"""Small sizes at which the benchmark's cells run on the CPU: the port's
plain versions stand in for its kernels, so the harness, the check and the
faults it must catch can be exercised without a card."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

SMALL = {
    "objopt.s4": {
        "config": {"num_points": 96, "num_particles": 256,
                   "volume": {"size": 41, "voxel_scale": 0.004},
                   "distill": {"steps": 60, "batch": 1024, "lr": 0.002, "pool_batches": 4},
                   "sdf_mlp": {"max_freqs": 3, "hidden": 32, "depth": 2, "clamp": 0.05}},
        "traffic": {"sequences": 2, "frames": 4, "input_sets": 2, "check_items": 8,
                    "check_block": 8},
    },
    "handopt.s4": {
        "config": {"num_particles": 64, "volume": {"size": 33, "voxel_scale": 0.006},
                   "distill": {"steps": 30, "batch": 512, "lr": 0.002, "pool_batches": 4},
                   "sdf_mlp": {"max_freqs": 3, "hidden": 32, "depth": 2, "clamp": 0.05},
                   "mask_hw": [48, 64],
                   "network": {"backbone_out_dim": 48, "head_scale": 0.01, "iknet_layers": 2,
                               "iknet_width": 64, "compute_dtype": None}},
        "traffic": {"sequences": 2, "frames": 3, "input_sets": 2, "check_items": 6,
                    "check_block": 6},
    },
}


@pytest.fixture
def small():
    return SMALL
