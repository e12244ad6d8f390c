"""Seeded inputs for the port's hand-energy tests, as numpy arrays that both
packages take: a background mask, an object pose, pinhole intrinsics scaled
to the image, and camera-frame points or MANO candidates about 0.45 m in
front of the camera."""

import numpy as np


def mask_of(hw, seed=0):
    return np.random.RandomState(seed).rand(*hw) > 0.5


def object_pose(seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(4)
    qw, qx, qy, qz = q / np.linalg.norm(q)
    rot = np.array([
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy)],
        [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qw * qx)],
        [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx), 1 - 2 * (qx * qx + qy * qy)]],
        np.float32)
    return rot, np.array([0.01, -0.02, 0.45], np.float32)


def intrinsics(hw):
    """fx, fy, cx, cy of a 600-pixel focal length at 480 x 640, scaled."""
    h, w = hw
    return (np.float32(600.0 * w / 640.0), np.float32(590.0 * h / 480.0),
            np.float32(w / 2.0), np.float32(h / 2.0))


def camera_points(shape, seed=0, wide=4.0):
    """(..., 3) points with z > 0.3, spread so that pixels clip on every edge."""
    rng = np.random.RandomState(seed)
    pts = rng.randn(*shape, 3).astype(np.float32) * np.float32(0.08)
    pts[..., :2] *= np.float32(wide)
    pts[..., 2] = np.abs(pts[..., 2]) + np.float32(0.3)
    return pts


def candidates(p, seed=0):
    """pose (p, 48), trans (p, 3), beta (1, 10)."""
    rng = np.random.RandomState(seed)
    pose = (rng.randn(p, 48) * 0.2).astype(np.float32)
    trans = (rng.randn(p, 3) * 0.02).astype(np.float32) + np.array([0, 0, 0.45], np.float32)
    beta = (rng.randn(1, 10) * 0.3).astype(np.float32)
    return pose, trans, beta


def pixel_margin(points, fx, fy, cx, cy):
    """Distance (pixels) of each point's pixel coordinates from the nearest
    integer, in float64: where it is large, every float32 route truncates to
    the same pixel."""
    p = points.astype(np.float64)
    v = p[..., 1] / p[..., 2] * float(fy) + float(cy)
    u = p[..., 0] / p[..., 2] * float(fx) + float(cx)
    return np.minimum(np.abs(v - np.round(v)), np.abs(u - np.round(u)))
