"""Host-side task routing of replay rows (port of the two numpy
functions of ``buffer/striped.py`` that the tiered store uses).

A striped (multi-task) ring tags each flat observation with a task
one-hot in its trailing ``n_stripes`` dims. :func:`rows_task_ids`
recovers each row's task from it and :func:`route_rows_to_stripes`
partitions rows by task, so rows that fall off the device ring keep
their task on the way down the tiers (``replay/tiers.py``'s
``StripedHostRing``). The device striped ring itself
(``init_striped_replay_buffer``, ``push_striped``, ``sample_striped``)
serves the scenario loop and is not ported.
"""

from __future__ import annotations

import typing as t

import numpy as np

__all__ = ["rows_task_ids", "route_rows_to_stripes"]


def rows_task_ids(rows: t.Mapping[str, t.Any], n_stripes: int) -> np.ndarray:
    """Each row's task id (int32) from the one-hot in the trailing
    ``n_stripes`` dims of its flat observation (of the newest step, for
    a history)."""
    states = np.asarray(rows["states"])
    oh = states[..., -n_stripes:]
    oh = oh.reshape(oh.shape[0], -1, n_stripes)[:, -1, :]
    return np.argmax(oh, axis=-1).astype(np.int32)


def route_rows_to_stripes(
    rows: t.Mapping[str, t.Any], n_stripes: int
) -> t.List[t.Optional[t.Dict[str, t.Any]]]:
    """Partition flat-key rows by task stripe: one row dict per stripe
    (``None`` where the stripe got nothing), within-stripe row order
    kept."""
    task = rows_task_ids(rows, n_stripes)
    out: t.List[t.Optional[t.Dict[str, t.Any]]] = []
    for stripe in range(n_stripes):
        mask = task == stripe
        if not mask.any():
            out.append(None)
            continue
        out.append({k: np.asarray(v)[mask] for k, v in rows.items()})
    return out
