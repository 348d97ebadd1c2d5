"""Sharded device-resident serving: a LoadedDatabase spread over a mesh.

The reference's library is resident per scoring module across the whole
bank: `MODULES` feeders each hold their own targets while the query
register broadcasts to every module (ScoreBank/ScoreBank_v2.v:77-139; the
`ld_q` broadcast, v2.v:99-102).  Here each mesh device holds ONE shard of
the packed streams RESIDENT in its memory (kernel layout [T, N], exactly
like the single-device LoadedDatabase), and every query dispatch is one
shard_map of the streamed wavefront kernel — the query is the only H2D
traffic, replicated to every device, and results come back either as the
full per-read score vector or as a
collective top-K merge (2k scalars, the `max`/`vld_max` intent,
ScoreBank_v2.v:42-43).

Build with :meth:`swtpu.bank.ScoreBank.load_database_sharded`, score with
:meth:`score_loaded_sharded` / :meth:`topk_loaded_sharded`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from swtpu.config import DEFAULT_PENALTIES, Penalties


@dataclasses.dataclass
class ShardedLoadedDatabase:
    """A packed database resident across a mesh's devices.

    stream: [D, T, N] int8 global device array, sharded on the mesh axis —
      each device's [T, N] block is its shard's kernel-layout streams.
    emit_stream/emit_step/ids: [D, R] int32 sharded device arrays (R = max
      reads per shard; padding slots carry emit_step = -1, ids = -1).
    ids_host: the same ids on host, for the read-order scatter.
    Scorer executables are cached per (k, full) on the object so serving
    dispatches never re-build the shard_map.
    """

    stream: object
    emit_stream_dev: object
    emit_step_dev: object
    ids_dev: object
    ids_host: np.ndarray
    t_lens: np.ndarray
    total_chars: int
    n_reads: int
    mesh: object
    axis: str
    n_shards: int
    penalties: Penalties
    tile: int
    block: int
    interpret: bool
    score_width: Optional[int] = None
    emit_regular: Optional[tuple] = None  # strided-extract pattern
    _scorers: Dict[tuple, object] = dataclasses.field(default_factory=dict)


def make_sharded_loaded_scorer(
    mesh,
    axis: str = "data",
    penalties: Penalties = DEFAULT_PENALTIES,
    tile: int = 32,
    block: int = 128,
    interpret: bool = False,
    k: int = 0,
    full_scores: bool = True,
    score_width: Optional[int] = None,
    emit_regular: Optional[tuple] = None,
):
    """Jitted shard_map over resident stream shards with a replicated query.

    Signature (leading axis D = mesh shard):
      full_scores, k=0:   scores[D, R] = f(query, stream, es, ep, ids)
      full_scores, k>0:   (scores[D, R], top_s[k], top_ids[k]) = f(...)
      not full_scores:    (top_s[k], top_ids[k]) = f(...)   # k > 0 required

    query is the [L] int8 query, replicated to every device (the `ld_q`
    broadcast).
    """
    import jax
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from swtpu.ops.pallas_stream import sw_scores_stream_kernel_layout
    from swtpu.parallel.sharded import _merge_topk

    if not full_scores and not k:
        raise ValueError("full_scores=False requires k > 0")

    def shard_fn(query, streamT, es, ep, ids):
        s = sw_scores_stream_kernel_layout(
            query, streamT[0], es[0], ep[0], penalties=penalties, tile=tile,
            block=block, interpret=interpret, score_width=score_width,
            emit_regular=emit_regular,
        )
        if not k:
            return s[None, :]
        fs, fids = _merge_topk(s, ids[0], k, axis)
        if not full_scores:
            return fs, fids
        return s[None, :], fs, fids

    in_specs = (
        P(None),
        P(axis, None, None),
        P(axis, None),
        P(axis, None),
        P(axis, None),
    )
    if not k:
        out_specs = P(axis, None)
    elif not full_scores:
        out_specs = (P(), P())
    else:
        out_specs = (P(axis, None), P(), P())
    fn = shard_map(
        shard_fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
        check_vma=False,
    )
    return jax.jit(fn)


def _put_sharded(arr: np.ndarray, mesh, axis: str):
    """Host [D, ...] -> global device array sharded on the leading dim."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    spec = P(axis, *([None] * (arr.ndim - 1)))
    return jax.device_put(arr, NamedSharding(mesh, spec))


def load_database_sharded(
    bank,
    targets,
    mesh,
    axis: str = "data",
) -> ShardedLoadedDatabase:
    """Pack `targets` into per-device feeder banks and leave every shard
    resident on its mesh device (the MODULES-axis serving pattern).

    Reads are dealt round-robin across the mesh axis (the priority
    encoder's load balancing, ScoreBank_v2.v:141-165, made static); each
    shard packs exactly like :meth:`ScoreBank.load_database`, pads to the
    common (T, R) envelope, and the [D, T, N] stack is placed sharded so
    each device holds only its own streams.  Single-process meshes place
    via device_put; multi-process deployments shard their local rows the
    multihost way (swtpu.parallel.multihost.shard_rows).

    Requires the stream backend."""
    import jax

    from swtpu.bank.scorebank import _dense_form
    from swtpu.bank.streams import STREAM_PAD, pack_stream_wire, pack_streams
    from swtpu.device import stream_count

    if bank.backend != "stream":
        raise ValueError(
            f"load_database_sharded requires the stream backend (got "
            f"{bank.backend!r})"
        )
    D = int(mesh.shape[axis])
    tmat, tlens = _dense_form(targets)
    if tlens is not None:
        n_reads = len(tlens)
        t_lens = np.asarray(tlens, np.int64)
    else:
        n_reads = len(targets)
        t_lens = np.fromiter((len(t) for t in targets), np.int64, n_reads)
    S = stream_count(-(-n_reads // D), bank.plan)
    # the stream layout does not depend on the query: pack with an empty one
    probe = np.zeros((0,), np.int8)
    if tlens is not None:
        shard_pack = lambda d: pack_streams(
            probe, tmat[d::D], S, lens=np.asarray(tlens)[d::D]
        )
    else:
        shard_pack = lambda d: pack_streams(
            probe, [targets[i] for i in range(d, n_reads, D)], S
        )
    groups = [list(range(d, n_reads, D)) for d in range(D)]
    batches = [shard_pack(d) for d in range(D)]
    if bank.verify_integrity:
        from swtpu.utils.guards import check_stream_batch

        for b in batches:
            check_stream_batch(b)
    N = batches[0].stream.shape[0]
    T = max(b.stream.shape[1] for b in batches)
    R = max((len(g) for g in groups), default=1) or 1
    stream = np.full((D, N, T), STREAM_PAD, np.int8)
    emit_stream = np.zeros((D, R), np.int32)
    emit_step = np.full((D, R), -1, np.int32)
    ids = np.full((D, R), -1, np.int32)
    for d, (g, b) in enumerate(zip(groups, batches)):
        stream[d, :, : b.stream.shape[1]] = b.stream
        emit_stream[d, : len(g)] = b.emit_stream
        emit_step[d, : len(g)] = b.emit_step.astype(np.int32)
        ids[d, : len(g)] = g
    regs = {b.emit_regular for b in batches}
    emit_regular = (
        regs.pop() if len(regs) == 1 and all(len(g) == R for g in groups)
        else None
    )

    if bank.config.wire_2bit and not bank._interpret:
        # one 2.5-bit/char crossing per shard, expanded + transposed on the
        # owning device (the load itself runs sharded)
        import jax.numpy as jnp
        from jax import shard_map
        from jax.sharding import PartitionSpec as P

        from swtpu.ops.pallas_stream import unpack_stream_wire

        wires = [pack_stream_wire(stream[d]) for d in range(D)]
        codes = np.stack([w[0] for w in wires])
        flags = np.stack([w[1] for w in wires])
        unpack = shard_map(
            lambda c, f: unpack_stream_wire(c[0], f[0]).T[None],
            mesh=mesh,
            in_specs=(P(axis, None, None), P(axis, None, None)),
            out_specs=P(axis, None, None),
            check_vma=False,
        )
        dev_stream = jax.jit(unpack)(
            _put_sharded(codes, mesh, axis), _put_sharded(flags, mesh, axis)
        )
    else:
        dev_stream = _put_sharded(
            np.ascontiguousarray(stream.transpose(0, 2, 1)), mesh, axis
        )
    return ShardedLoadedDatabase(
        stream=dev_stream,
        emit_stream_dev=_put_sharded(emit_stream, mesh, axis),
        emit_step_dev=_put_sharded(emit_step, mesh, axis),
        ids_dev=_put_sharded(ids, mesh, axis),
        ids_host=ids,
        t_lens=t_lens,
        total_chars=int(t_lens.sum()),
        n_reads=n_reads,
        mesh=mesh,
        axis=axis,
        n_shards=D,
        penalties=bank.config.penalties,
        tile=bank.plan.tile,
        block=bank.plan.block,
        interpret=bank._interpret,
        score_width=bank.config.score_width,
        emit_regular=emit_regular,
    )


def _get_scorer(db: ShardedLoadedDatabase, k: int, full_scores: bool):
    key = (k, full_scores)
    fn = db._scorers.get(key)
    if fn is None:
        fn = db._scorers[key] = make_sharded_loaded_scorer(
            db.mesh, axis=db.axis, penalties=db.penalties, tile=db.tile,
            block=db.block, interpret=db.interpret, k=k,
            full_scores=full_scores, score_width=db.score_width,
            emit_regular=db.emit_regular,
        )
    return fn


def dispatch_loaded_sharded(query: np.ndarray, db: ShardedLoadedDatabase,
                            k: int = 0, full_scores: bool = True):
    """Async dispatch of one query over the whole mesh; returns the
    un-materialized device outputs (scores [D, R] and/or top-K)."""
    fn = _get_scorer(db, k, full_scores)
    return fn(np.asarray(query, np.int8), db.stream, db.emit_stream_dev,
              db.emit_step_dev, db.ids_dev)


def _padded_cells(db: ShardedLoadedDatabase, qlen: int) -> int:
    from swtpu.bank.scorebank import _padded_cells

    D, T, N = np.shape(db.stream)
    return D * _padded_cells((T, N), qlen, db.tile)


def score_loaded_sharded(bank, query: np.ndarray, db: ShardedLoadedDatabase,
                         event_log=None):
    """Score `query` against the mesh-resident database; returns a
    read-order ScoreResult (the full score vector, gathered across
    shards)."""
    t0 = time.perf_counter()
    s_g = dispatch_loaded_sharded(query, db)
    return finish_loaded_sharded(bank, query, db, s_g, t0,
                                 event_log=event_log)


def finish_loaded_sharded(bank, query: np.ndarray, db: ShardedLoadedDatabase,
                          s_g, t0, event_log=None):
    """Materialize + scatter the async half's output (serving front-ends
    call dispatch under their job lock and finish outside it, so clients
    pipeline)."""
    from swtpu.bank.scorebank import ScoreResult

    shard_scores = np.asarray(s_g)  # [D, R]
    scores = np.zeros(db.n_reads, np.int32)
    live = db.ids_host >= 0
    scores[db.ids_host[live]] = shard_scores[live]
    if bank.verify_integrity:
        from swtpu.utils.guards import check_scores

        check_scores(
            scores, np.full(db.n_reads, len(query)), db.t_lens,
            db.penalties.match,
        )
    cells = int(len(query)) * db.total_chars
    padded = _padded_cells(db, len(query))
    elapsed = time.perf_counter() - t0
    if event_log is not None:
        from swtpu.utils import BatchEvent

        event_log.emit(
            BatchEvent(
                "loaded_sharded", t_wall=time.time(), elapsed_s=elapsed,
                reads=db.n_reads, cells=cells, padded_cells=padded,
                note=f"qlen={len(query)} shards={db.n_shards}",
            )
        )
    return ScoreResult(scores, cells, padded, elapsed)


def topk_loaded_sharded(bank, query: np.ndarray, db: ShardedLoadedDatabase,
                        k: int = 10, event_log=None) -> List[Tuple[int, int]]:
    """Mesh-wide best-hit reporting: per-shard top-K cut on each device,
    collective merge over the mesh axis, only 2k scalars cross D2H —
    the bank-wide `max`/`vld_max` capability at the MODULES axis.
    Tie order matches ScoreResult.top_k (score desc, id asc)."""
    t0 = time.perf_counter()
    kk = min(k, db.n_reads) or 1
    fs, fids = dispatch_loaded_sharded(query, db, k=kk, full_scores=False)
    fs, fids = np.asarray(fs), np.asarray(fids)
    if event_log is not None:
        from swtpu.utils import BatchEvent

        event_log.emit(
            BatchEvent(
                "loaded_sharded_topk", t_wall=time.time(),
                elapsed_s=time.perf_counter() - t0,
                reads=db.n_reads, cells=int(len(query)) * db.total_chars,
                padded_cells=0,
                note=f"qlen={len(query)} k={k} shards={db.n_shards}",
            )
        )
    out = [(int(s), int(i)) for s, i in zip(fs, fids) if i >= 0]
    return out[:k]


def score_loaded_many_sharded(
    bank, queries: Sequence[np.ndarray], db: ShardedLoadedDatabase,
    event_log=None,
) -> List:
    """Pipelined many-query serving over the mesh: every query's shard_map
    is enqueued before any result materializes (the sharded form of
    ScoreBank.score_loaded_many).  Per-result elapsed_s is the batch wall
    time divided evenly."""
    from swtpu.bank.scorebank import ScoreResult

    t0 = time.perf_counter()
    devs = [dispatch_loaded_sharded(q, db) for q in queries]
    mats = [np.asarray(d) for d in devs]
    share = (time.perf_counter() - t0) / max(len(queries), 1)
    live = db.ids_host >= 0
    results = []
    for q, m in zip(queries, mats):
        scores = np.zeros(db.n_reads, np.int32)
        scores[db.ids_host[live]] = m[live]
        cells = int(len(q)) * db.total_chars
        padded = _padded_cells(db, len(q))
        if event_log is not None:
            from swtpu.utils import BatchEvent

            event_log.emit(
                BatchEvent(
                    "loaded_sharded_many", t_wall=time.time(),
                    elapsed_s=share, reads=db.n_reads, cells=cells,
                    padded_cells=padded,
                    note=f"qlen={len(q)} shards={db.n_shards}",
                )
            )
        results.append(ScoreResult(scores, cells, padded, share))
    return results
