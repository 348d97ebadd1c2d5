"""Multi-host deployment API.

Production-facing wrapper over `jax.distributed` for running the ScoreBank
across hosts: each process owns a database shard; queries are replicated;
scores and top-K merge over collectives.  The hardware-free
equivalent (N OS processes on localhost, CPU backend) lives in
swtpu.testing.{worker,regress} — same code path, per the reference's PSLSE
strategy of exercising the full stack without hardware (SURVEY.md §4).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """jax.distributed.initialize, with args optional when the environment
    provides them (cluster launchers that JAX auto-discovers)."""
    import jax

    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    jax.distributed.initialize(**kwargs)


def shard_rows(local_rows: np.ndarray, mesh, axis: str = "data"):
    """Build a globally-sharded array from this process's rows (the host's
    database shard -> its devices' slice of the global batch)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    spec = P(axis, *([None] * (local_rows.ndim - 1)))
    return jax.make_array_from_process_local_data(
        NamedSharding(mesh, spec), local_rows
    )


def score_database_multihost(
    query: np.ndarray,
    local_targets: Sequence[np.ndarray],
    local_ids: np.ndarray,
    mesh=None,
    k: int = 10,
    backend: str = "auto",
    penalties=None,
    n_streams: Optional[int] = None,
    stream_steps: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Score this host's shard within the global job.

    Returns (top_scores [k], top_ids [k], local_scores) where the top-K is
    globally merged and replicated on every host (the bank-wide best-hit
    capability, ScoreBank/ScoreBank_v2.v:42-43).

    backend 'auto' resolves through the platform table (swtpu.device): the
    streamed-wavefront kernel on the GPU, the plain scan on the CPU;
    'stream'/'scan' pick one explicitly ('stream' on the CPU runs the
    kernel in the Pallas interpreter).

    local_targets: a sequence of 1-D code arrays, or the dense
    EncodedDB / (mat, lens) form — the fast path (native per-shard packing,
    no per-read Python objects).

    All hosts must call this collectively.  The stream backend negotiates
    the packed-stream geometry (T, R) across processes automatically (the
    `full`/ready backpressure self-regulation, ScoreBank_v2.v:163-165, made
    collective): ragged per-host length mixes need no manual pinning.
    `stream_steps` remains as an optional pin/override of the stream
    length.  Dense backends still require equal per-host batch shapes (pad
    with sentinel rows, id -1).
    """
    import jax

    from swtpu.config import DEFAULT_PENALTIES
    from swtpu.ops.common import Q_PAD, T_PAD
    from swtpu.parallel.mesh import make_mesh
    from swtpu.parallel.sharded import make_sharded_topk

    pen = penalties or DEFAULT_PENALTIES
    if mesh is None:
        mesh = make_mesh()
    if backend == "auto":
        from swtpu.device import kernel_plan

        backend = kernel_plan().backend
    if backend == "stream":
        return _score_database_multihost_stream(
            query, local_targets, local_ids, mesh, k, pen,
            n_streams=n_streams, stream_steps=stream_steps,
        )

    from swtpu.bank.scorebank import _dense_form

    tmat, tlens = _dense_form(local_targets)
    if tlens is not None:
        B = len(tlens)
        n_max = int(np.max(tlens)) if B else 1
    else:
        B = len(local_targets)
        n_max = max((len(t) for t in local_targets), default=1)
    qw = max(8, -(-len(query) // 8) * 8)
    tw = max(8, -(-n_max // 8) * 8)
    q = np.full((B, qw), Q_PAD, np.int8)
    q[:, : len(query)] = np.asarray(query, np.int8)[None, :]
    t = np.full((B, tw), T_PAD, np.int8)
    if tlens is not None:
        w = min(tw, tmat.shape[1])
        t[:, :w] = tmat[:, :w]
        # restore sentinel pads past each read's true length (the dense
        # matrix may carry arbitrary junk there)
        t[np.arange(tw)[None, :] >= np.asarray(tlens)[:, None]] = T_PAD
    else:
        for i, tt in enumerate(local_targets):
            t[i, : len(tt)] = tt

    qg = shard_rows(q, mesh)
    tg = shard_rows(t, mesh)
    idsg = shard_rows(np.asarray(local_ids, np.int32), mesh)
    if backend != "scan":
        raise ValueError(f"unknown backend {backend!r}")
    topk = make_sharded_topk(mesh, k=k, penalties=pen)
    top_s, top_ids, scores = topk(qg, tg, idsg)
    local_scores = np.concatenate(
        [np.asarray(s.data) for s in scores.addressable_shards]
    )
    return np.asarray(top_s), np.asarray(top_ids), local_scores


def _score_database_multihost_stream(
    query: np.ndarray,
    local_targets: Sequence[np.ndarray],
    local_ids: np.ndarray,
    mesh,
    k: int,
    pen,
    n_streams: Optional[int] = None,
    stream_steps: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The flagship path at multi-host scale: this process packs its shard
    of the database into per-device feeder banks (pack_streams_sharded over
    its local devices), the global mesh dispatches ONE shard_map of the
    streamed wavefront kernel, and the merged top-K replicates everywhere.

    Cross-host geometry is negotiated automatically: every process packs
    its own shard, then the (stream length T, reads-per-shard R) envelope
    all-gathers across processes and each host pads to the global maxima —
    the collective form of the bank's `full`/ready backpressure
    self-regulation (ScoreBank_v2.v:163-165).  Ragged per-host length
    mixes therefore need no manual pinning; `stream_steps` remains as an
    optional override (e.g. to freeze one compiled executable across
    successive jobs) and must cover every host's packed length."""
    import jax

    from swtpu.bank.scorebank import _dense_form
    from swtpu.bank.streams import (
        STREAM_PAD, pack_streams_sharded, scatter_sharded_scores,
    )
    from swtpu.device import kernel_plan, stream_count
    from swtpu.ops.pallas_stream import STEP_CHUNK
    from swtpu.parallel.sharded import make_sharded_stream_scorer

    plan = kernel_plan()
    if stream_steps is not None and stream_steps % STEP_CHUNK:
        # fail here with the contract named, not at kernel trace time
        raise ValueError(
            f"stream_steps={stream_steps} must be a multiple of "
            f"{STEP_CHUNK} (the packers' step rounding)"
        )
    pidx = jax.process_index()
    L = sum(1 for d in mesh.devices.flat if d.process_index == pidx)
    if n_streams is None:
        # every process must pick the same count: size it from the largest
        # per-host shard
        _, tl = _dense_form(local_targets)
        n_local = len(tl) if tl is not None else len(local_targets)
        if jax.process_count() > 1:
            from jax.experimental import multihost_utils

            n_local = int(np.max(multihost_utils.process_allgather(
                np.array([n_local], np.int64))))
        n_streams = stream_count(-(-n_local // L), plan)
    batch = pack_streams_sharded(
        query, local_targets, n_shards=L, n_streams=n_streams
    )
    stream = batch.stream
    T_local = stream.shape[2]
    R_local = batch.emit_stream.shape[1]
    reg_local = batch.emit_regular or (-1, -1, -1)
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        dims = np.asarray(
            multihost_utils.process_allgather(
                np.array([T_local, R_local, *reg_local], np.int64)
            )
        ).reshape(-1, 5)
        T_all, R_all = int(dims[:, 0].max()), int(dims[:, 1].max())
        # the strided-extract fast path is a STATIC arg: every process must
        # trace the identical program, so it applies only when every host
        # reports the same regular pattern AND the same R (no padding
        # anywhere) — agreed here, in the same all-gather as the geometry
        same_pattern = (dims[:, 2:] == dims[0, 2:]).all() and dims[0, 2] >= 0
        same_r = (dims[:, 1] == dims[0, 1]).all()
        emit_regular = tuple(int(x) for x in dims[0, 2:]) if (
            same_pattern and same_r
        ) else None
    else:
        T_all, R_all = T_local, R_local
        emit_regular = batch.emit_regular
    if stream_steps is not None:
        if T_all > stream_steps:
            raise ValueError(
                f"packed stream needs {T_all} steps (max across hosts) > "
                f"pinned stream_steps={stream_steps}; every host's shard "
                "must fit the pinned envelope — raise the pin or drop it "
                "to auto-negotiate"
            )
        T_all = stream_steps
    if T_all != T_local:
        wide = np.full((L, n_streams, T_all), STREAM_PAD, np.int8)
        wide[:, :, :T_local] = stream
        stream = wide
    emit_stream, emit_step, bids = (
        batch.emit_stream, batch.emit_step, batch.ids
    )
    if R_all != R_local:
        emit_stream = np.zeros((L, R_all), emit_stream.dtype)
        emit_step = np.full((L, R_all), -1, batch.emit_step.dtype)
        bids = np.full((L, R_all), -1, np.int32)
        emit_stream[:, :R_local] = batch.emit_stream
        emit_step[:, :R_local] = batch.emit_step
        bids[:, :R_local] = batch.ids
    # emission ids become GLOBAL read ids (the ID-FIFO pairing across the
    # whole job); padding slots stay -1
    gids = np.where(
        bids >= 0,
        np.asarray(local_ids, np.int32)[np.maximum(bids, 0)],
        np.int32(-1),
    ).astype(np.int32)

    qg = shard_rows(batch.q, mesh)
    sg = shard_rows(stream, mesh)
    esg = shard_rows(emit_stream, mesh)
    epg = shard_rows(emit_step.astype(np.int32), mesh)
    idsg = shard_rows(gids, mesh)
    scorer = make_sharded_stream_scorer(
        mesh, penalties=pen, interpret=plan.interpret, k=k, tile=plan.tile,
        block=plan.block, emit_regular=emit_regular,
    )
    s, top_s, top_ids = scorer(qg, sg, esg, epg, idsg)
    shards = sorted(s.addressable_shards, key=lambda x: x.index[0].start or 0)
    # drop the cross-host R padding tail before the read-order scatter
    # (batch holds this host's unpadded emission maps)
    local_shard_scores = np.stack(
        [np.asarray(x.data)[0][:R_local] for x in shards]
    )
    n_local = len(np.asarray(local_ids))
    local_scores = scatter_sharded_scores(local_shard_scores, batch, n_local)
    return np.asarray(top_s), np.asarray(top_ids), local_scores
