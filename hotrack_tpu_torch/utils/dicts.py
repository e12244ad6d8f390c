"""Loss-dict algebra and logging helpers (the port's own copy of
hotrack_tpu/utils/dicts.py, on tensors)."""

from __future__ import annotations

import numpy as np
import torch


def cvt_numpy(x):
    """Recursively convert tensors to numpy arrays (a device tensor is
    fetched, which waits for the device)."""
    if isinstance(x, dict):
        return {k: cvt_numpy(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(cvt_numpy(v) for v in x)
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return x


def add_dict(total: dict, new: dict) -> None:
    """Accumulate scalar entries recursively (arrays by their mean)."""
    for k, v in new.items():
        if isinstance(v, dict):
            add_dict(total.setdefault(k, {}), v)
        else:
            total[k] = total.get(k, 0.0) + float(np.mean(cvt_numpy(v)))


def divide_dict(total: dict, n: int) -> dict:
    return {k: divide_dict(v, n) if isinstance(v, dict) else v / max(n, 1)
            for k, v in total.items()}


def log_loss_summary(loss_dict: dict, cnt: int, log_fn) -> None:
    """Report averaged losses through log_fn(key, value)."""
    for k, v in loss_dict.items():
        if isinstance(v, dict):
            for kk, vv in v.items():
                log_fn(f"{k}/{kk}", vv / max(cnt, 1))
        else:
            log_fn(k, v / max(cnt, 1))


def dump_csv(path: str, rows: dict, per_instance_keys=None) -> None:
    """A CSV of per-instance values: rows maps a column's name to its list or
    array (shorter columns leave their cells empty)."""
    import csv

    keys = list(per_instance_keys or rows.keys())
    cols = {k: np.asarray(rows[k]).reshape(-1) for k in keys}
    n = max(len(v) for v in cols.values())
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(keys)
        for i in range(n):
            writer.writerow([cols[k][i] if i < len(cols[k]) else "" for k in keys])
