"""Matplotlib debug figures (port of hotrack_tpu/utils/vis.py): 3-D scatter
grids (`plot3d_pts`) and the hand skeleton over its cloud (`hand_vis`).

matplotlib is imported only when a figure is asked for, with the Agg
backend (no display needed). Where it is not installed, asking for a figure
raises with a message that says so; nothing else of the package needs it.
"""

from __future__ import annotations

import os

import numpy as np

# the 21-keypoint skeleton: the wrist to each finger's chain (thumb, index,
# middle, ring, pinky)
HAND_EDGES = [(0, 1), (1, 2), (2, 3), (3, 4),
              (0, 5), (5, 6), (6, 7), (7, 8),
              (0, 9), (9, 10), (10, 11), (11, 12),
              (0, 13), (13, 14), (14, 15), (15, 16),
              (0, 17), (17, 18), (18, 19), (19, 20)]
FINGER_COLORS = ["tab:red", "tab:orange", "tab:green", "tab:blue", "tab:purple"]


def _pyplot():
    try:
        import matplotlib
    except ImportError as e:
        raise RuntimeError("the debug figures (--debug, --debug_save, utils/vis.py) need "
                           "matplotlib, which is not installed here") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _axes3d(n, figsize=4.0):
    plt = _pyplot()
    fig = plt.figure(figsize=(figsize * n, figsize))
    axes = [fig.add_subplot(1, n, i + 1, projection="3d") for i in range(n)]
    return fig, axes


def _finish(fig, show_fig: bool, save_fig: bool, save_folder: str, save_name) -> None:
    plt = _pyplot()
    if save_fig:
        os.makedirs(save_folder, exist_ok=True)
        fig.savefig(os.path.join(save_folder, str(save_name).replace("/", "_") + ".png"),
                    dpi=120, bbox_inches="tight")
    if show_fig:  # pragma: no cover - interactive
        plt.show()
    plt.close(fig)


def plot3d_pts(pts_groups, show_fig: bool = False, save_fig: bool = False,
               save_folder: str = "./debug", save_name: str = "plot",
               point_size: float = 2.0):
    """Point sets side by side: pts_groups is a list of subplots, each a
    list of (N, 3) arrays."""
    fig, axes = _axes3d(len(pts_groups))
    for ax, group in zip(axes, pts_groups):
        for pts in group:
            pts = np.asarray(pts).reshape(-1, 3)
            ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=point_size)
        ax.set_box_aspect((1, 1, 1))
    _finish(fig, show_fig, save_fig, save_folder, save_name)
    return fig


def hand_vis(points, init_kp, pred_kp, gt_kp, show_fig: bool = False,
             save_fig: bool = False, save_folder: str = "./debug",
             save_name: str = "hand"):
    """The cloud under the initial, predicted and ground-truth skeletons,
    coloured by finger."""
    fig, axes = _axes3d(3)
    pts = np.asarray(points).reshape(-1, 3)
    for ax, kp, title in zip(axes, [init_kp, pred_kp, gt_kp], ["init", "pred", "gt"]):
        ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=1.5, c="gray", alpha=0.4)
        kp = np.asarray(kp).reshape(-1, 3)
        for e_idx, (a, b) in enumerate(HAND_EDGES):
            ax.plot([kp[a, 0], kp[b, 0]], [kp[a, 1], kp[b, 1]], [kp[a, 2], kp[b, 2]],
                    c=FINGER_COLORS[e_idx // 4], linewidth=1.5)
        ax.scatter(kp[:, 0], kp[:, 1], kp[:, 2], s=8, c="black")
        ax.set_title(title)
        ax.set_box_aspect((1, 1, 1))
    _finish(fig, show_fig, save_fig, save_folder, save_name)
    return fig
