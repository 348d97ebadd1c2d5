"""Device mesh construction.

The scaling axis of this workload is the *database* (reads), the analog of
the reference's module-level data parallelism — `MODULES` scoring arrays,
each fed different targets against a broadcast query
(ScoreBank/ScoreBank_v2.v:17, 77-139).  Queries are replicated; reads are
sharded; score/top-K merges are collectives over the mesh axis (NCCL
between GPUs; SURVEY.md §2.7).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(
    n_devices: Optional[int] = None,
    axis_name: str = "data",
    devices: Optional[Sequence] = None,
) -> Mesh:
    """1-D mesh over the database axis; every device in it acts as one
    module of a single big ScoreBank.  A flat 1-D mesh suits GPUs joined
    all to all (NVLink): no axis is cheaper than another."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis_name,))
