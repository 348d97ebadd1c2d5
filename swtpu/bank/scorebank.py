"""ScoreBank — the high-level batched scoring engine.

The equivalent of the reference's top-level bank
(ScoreBank/ScoreBank_v2.v): load penalties once, load a query, stream a
database of targets through, and collect ID-tagged scores — plus the
capability the reference declared but never finished: bank-wide best-hit /
top-K reporting (the dangling `max`/`vld_max` ports,
ScoreBank/ScoreBank_v2.v:42-43, and the ResBuffer stub,
CAPI_template/ResBuffer.v).

Where the hardware dispatches each read to the first non-full feeder via a
priority encoder (ScoreBank_v2.v:141-165), swtpu buckets reads by length
into a handful of static shapes and lets XLA pipeline the dense batches
through the scoring kernel.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np

from swtpu.bank.packer import pack_many_vs_one
from swtpu.config import SWConfig


def _dense_form(targets):
    """(mat, lens) if `targets` is an EncodedDB or (mat, lens) tuple."""
    from swtpu.io.loader import EncodedDB

    if isinstance(targets, EncodedDB):
        return targets.mat, targets.lens
    if (
        isinstance(targets, tuple)
        and len(targets) == 2
        and isinstance(targets[0], np.ndarray)
        and targets[0].ndim == 2
    ):
        return targets[0], np.asarray(targets[1], np.int32)
    return None, None


@dataclasses.dataclass
class ScoreResult:
    """Scores for one query against a database, in database read order."""

    scores: np.ndarray  # [n_reads] int32
    cells: int  # real DP cells scored (for GCUPS)
    padded_cells: int  # total padded cells dispatched
    elapsed_s: float

    @property
    def gcups(self) -> float:
        return self.cells / self.elapsed_s / 1e9 if self.elapsed_s > 0 else 0.0

    def top_k(self, k: int) -> List[tuple]:
        """(score, read_index) best hits, stable order — the reference's
        unfinished `max`/`vld_max` intent."""
        idx = np.argsort(-self.scores, kind="stable")[:k]
        return [(int(self.scores[i]), int(i)) for i in idx]


@dataclasses.dataclass
class LoadedDatabase:
    """A packed database RESIDENT ON DEVICE across queries.

    The reference re-streams its library from host DRAM through the
    feeders for every query (SM_Feeder2.v); here the packed streams stay in
    device memory and only the query (~bytes) crosses per job: the
    many-queries-vs-one-database serving pattern at kernel speed instead of
    host-link speed.  The stream layout does not depend on the query, so
    one load serves queries of any length.  Build with
    :meth:`ScoreBank.load_database`, score with :meth:`ScoreBank.score_loaded`.
    """

    stream: object  # [T, N] int8 device array (KERNEL layout, resident)
    emit_stream_dev: object  # [n_reads] int32 device
    emit_step_dev: object  # [n_reads] int32 device
    t_lens: np.ndarray  # per-read true lengths (cells + guard bounds)
    total_chars: int
    n_reads: int
    emit_regular: object = None  # strided-extract pattern (streams.py)


def _padded_cells(stream_shape, qlen: int, tile: int) -> int:
    """Cells the wavefront computes: every stream step times the query rows
    its tiles cover (pad rows included)."""
    from swtpu.ops.pallas_stream import tile_rows

    K, th = tile_rows(qlen, tile)
    return int(stream_shape[0]) * int(stream_shape[1]) * K * th


class ScoreBank:
    """Batched many-vs-one scorer with pluggable kernel backend.

    backend: 'auto' (the platform table's choice, swtpu.device), 'stream'
    (the wavefront kernel), 'scan' (plain lax.scan), or a callable
    (q, t, penalties) -> scores for testing.  interpret: run the stream
    kernel in the Pallas interpreter (default: the platform table's).
    """

    def __init__(
        self,
        config: SWConfig = SWConfig(),
        backend: str = "auto",
        interpret: Optional[bool] = None,
        verify_integrity: bool = False,
    ):
        from swtpu.device import kernel_plan

        self.config = config
        plan = kernel_plan()
        if backend == "auto":
            backend = plan.backend
        if not callable(backend) and backend not in ("stream", "scan"):
            raise ValueError(f"unknown backend {backend!r}")
        if config.score_width is not None and callable(backend):
            raise ValueError(
                "score_width requires the 'stream' or 'scan' backend"
            )
        self.backend = backend
        self.plan = dataclasses.replace(
            plan,
            interpret=plan.interpret if interpret is None else interpret,
            tile=config.stream_tile or plan.tile,
            streams=config.streams or plan.streams,
        )
        self._interpret = self.plan.interpret
        # parity-checking analog (SURVEY.md §5): validate packed batches and
        # score bounds; cheap relative to scoring, off by default in prod
        self.verify_integrity = verify_integrity

    def _kernel_kw(self) -> dict:
        """Static arguments every stream-kernel dispatch shares."""
        return dict(
            penalties=self.config.penalties, tile=self.plan.tile,
            block=self.plan.block, interpret=self._interpret,
            score_width=self.config.score_width,
        )

    def _score_batch(self, q: np.ndarray, t: np.ndarray) -> np.ndarray:
        pen = self.config.penalties
        if callable(self.backend):
            return np.asarray(self.backend(q, t, pen))
        from swtpu.ops.scan import sw_scores_scan

        return np.asarray(
            sw_scores_scan(q, t, pen, score_width=self.config.score_width)
        )

    def score_database(
        self,
        query: np.ndarray,
        targets,
        event_log=None,
    ) -> ScoreResult:
        """Score every target read against `query`; returns read-order scores.

        targets: a sequence of 1-D code arrays, or an
        :class:`swtpu.io.loader.EncodedDB` (the fast dense form — the whole
        database stays one int8 matrix, no per-read Python objects).

        event_log: optional swtpu.utils.EventLog receiving one structured
        record per dispatched batch (the trace-array/debug.log analog)."""
        cfg = self.config
        tmat, tlens = _dense_form(targets)
        n_reads = len(tlens) if tlens is not None else len(targets)
        if self.backend == "stream":
            return self._score_database_stream(
                query, targets, event_log, tmat=tmat, tlens=tlens
            )
        t0 = time.perf_counter()
        batches = pack_many_vs_one(
            query,
            tmat if tlens is not None else targets,
            bucket_lens=cfg.target_buckets,
            q_width=max(8, -(-len(query) // 8) * 8),
            lens=tlens,
        )
        scores = np.zeros((n_reads,), dtype=np.int32)
        cells = 0
        padded = 0
        for batch in batches:
            tb = time.perf_counter()
            if self.verify_integrity:
                from swtpu.utils.guards import check_packed_query, check_packed_target

                check_packed_query(batch.q, batch.q_lens)
                check_packed_target(batch.t, batch.t_lens)
            s = self._score_batch(batch.q, batch.t)
            if self.verify_integrity:
                from swtpu.utils.guards import check_scores

                check_scores(s, batch.q_lens, batch.t_lens, cfg.penalties.match)
            live = batch.ids >= 0
            scores[batch.ids[live]] = s[live]
            cells += batch.cells
            padded += batch.padded_cells
            if event_log is not None:
                from swtpu.utils import BatchEvent

                event_log.emit(
                    BatchEvent(
                        "batch",
                        t_wall=time.time(),
                        elapsed_s=time.perf_counter() - tb,
                        reads=int(live.sum()),
                        cells=batch.cells,
                        padded_cells=batch.padded_cells,
                        note=f"bucket_len={batch.t.shape[1]}",
                    )
                )
        elapsed = time.perf_counter() - t0
        return ScoreResult(scores, cells, padded, elapsed)

    def score_pairs(
        self,
        queries: Sequence[np.ndarray],
        targets: Sequence[np.ndarray],
        event_log=None,
    ) -> ScoreResult:
        """Score explicit (query, target) pairs (many-vs-many workloads).

        Pairs are grouped by (query-width, target-bucket) shape and
        dispatched densely; results return in submission order.

        event_log: optional swtpu.utils.EventLog receiving one structured
        record per dispatched chunk (same observability as score_database)."""
        from swtpu.bank.packer import pack_pairs
        from swtpu.bank.buckets import plan_buckets

        if len(queries) != len(targets):
            raise ValueError("queries and targets must pair up")
        if self.backend == "stream":
            # many-vs-many at wavefront speed: per-stream query registers
            # (the reference's per-module ld_q, ScoreBank_v2.v:99-102)
            return self._score_pairs_stream(queries, targets, event_log)
        cfg = self.config
        t0 = time.perf_counter()
        n = len(queries)
        t_plan = plan_buckets([len(t) for t in targets], cfg.target_buckets)
        q_plan = plan_buckets([len(q) for q in queries], cfg.query_buckets)
        scores = np.zeros((n,), dtype=np.int32)
        cells = padded = 0
        groups = {}
        for i in range(n):
            groups.setdefault((q_plan.assignments[i], t_plan.assignments[i]), []).append(i)
        for (qb, tb), idxs in groups.items():
            tc = time.perf_counter()
            batch = pack_pairs(
                [queries[i] for i in idxs],
                [targets[i] for i in idxs],
                q_width=q_plan.bucket_lens[qb],
                t_width=t_plan.bucket_lens[tb],
                ids=np.asarray(idxs, np.int32),
            )
            s = self._score_batch(batch.q, batch.t)
            scores[batch.ids] = s
            cells += batch.cells
            padded += batch.padded_cells
            if event_log is not None:
                from swtpu.utils import BatchEvent

                event_log.emit(
                    BatchEvent(
                        "pair_batch", t_wall=time.time(),
                        elapsed_s=time.perf_counter() - tc,
                        reads=len(idxs), cells=batch.cells,
                        padded_cells=batch.padded_cells,
                        note=f"q_width={q_plan.bucket_lens[qb]} "
                        f"t_width={t_plan.bucket_lens[tb]}",
                    )
                )
        return ScoreResult(scores, cells, padded, time.perf_counter() - t0)

    def load_database(self, targets) -> LoadedDatabase:
        """Pack `targets` once and leave the streams resident on device.

        The stream crosses the host link ONCE (2-bit wire + on-device
        expansion when wire_2bit is set); every subsequent
        :meth:`score_loaded` ships only the query and reads back n_reads
        int32 scores.  Requires the stream backend."""
        import jax

        from swtpu.bank.streams import pack_stream_wire, pack_streams
        from swtpu.device import stream_count

        if self.backend != "stream":
            raise ValueError(
                f"load_database requires the stream backend (got "
                f"{self.backend!r})"
            )
        tmat, tlens = _dense_form(targets)
        if tlens is not None:
            t_lens = np.asarray(tlens, np.int64)
        else:
            t_lens = np.fromiter((len(t) for t in targets), np.int64)
        # the stream layout and emission coordinates do not depend on the
        # query: pack with an empty one
        batch = pack_streams(
            np.zeros((0,), np.int8), tmat if tlens is not None else targets,
            n_streams=stream_count(len(t_lens), self.plan), lens=tlens,
        )
        if self.verify_integrity:
            from swtpu.utils.guards import check_stream_batch

            check_stream_batch(batch)
        # resident layout is the KERNEL's [T, N]: per-query dispatches skip
        # the full-stream relayout — the one-time transpose happens on
        # device at load
        if self.config.wire_2bit and not self._interpret:
            # one 2.5-bit/char crossing, expanded + transposed on device
            from swtpu.ops.pallas_stream import unpack_stream_wire

            codes, flags = pack_stream_wire(batch.stream)
            dev_stream = jax.jit(
                lambda c, f: unpack_stream_wire(c, f).T
            )(jax.device_put(codes), jax.device_put(flags))
        else:
            dev_stream = jax.device_put(np.ascontiguousarray(batch.stream.T))
        return LoadedDatabase(
            stream=dev_stream,
            emit_stream_dev=jax.device_put(batch.emit_stream),
            emit_step_dev=jax.device_put(batch.emit_step.astype(np.int32)),
            t_lens=t_lens,
            total_chars=int(t_lens.sum()),
            n_reads=len(t_lens),
            emit_regular=batch.emit_regular,
        )

    def _dispatch_loaded(self, query: np.ndarray, db: LoadedDatabase):
        """Async device dispatch for one query against a loaded database;
        returns the un-materialized device scores array."""
        from swtpu.ops.pallas_stream import sw_scores_stream_kernel_layout

        return sw_scores_stream_kernel_layout(
            np.asarray(query, np.int8), db.stream, db.emit_stream_dev,
            db.emit_step_dev, emit_regular=db.emit_regular,
            **self._kernel_kw(),
        )

    def _finish_loaded(self, dev_scores, query, db: LoadedDatabase, t0,
                       elapsed_override=None, event_log=None, kind="loaded"):
        scores = np.asarray(dev_scores)
        if self.verify_integrity:
            from swtpu.utils.guards import check_scores

            check_scores(
                scores, np.full(db.n_reads, len(query)), db.t_lens,
                self.config.penalties.match,
            )
        cells = int(len(query)) * db.total_chars
        padded = _padded_cells(np.shape(db.stream), len(query), self.plan.tile)
        elapsed = (
            elapsed_override if elapsed_override is not None
            else time.perf_counter() - t0
        )
        if event_log is not None:
            # per-query serving record (the per-alignment cycle accounting,
            # afu.v:497-532) so `swtpu events` can summarize serve sessions
            from swtpu.utils import BatchEvent

            event_log.emit(
                BatchEvent(
                    kind, t_wall=time.time(), elapsed_s=elapsed,
                    reads=db.n_reads, cells=cells, padded_cells=padded,
                    note=f"qlen={len(query)} resident_reads={db.n_reads}",
                )
            )
        return ScoreResult(scores, cells, padded, elapsed)

    def score_loaded(
        self, query: np.ndarray, db: LoadedDatabase, event_log=None
    ) -> ScoreResult:
        """Score `query` against a device-resident database: only the query
        register crosses H2D; the packed streams never leave HBM."""
        t0 = time.perf_counter()
        return self._finish_loaded(
            self._dispatch_loaded(query, db), query, db, t0,
            event_log=event_log,
        )

    def score_loaded_many(
        self, queries: Sequence[np.ndarray], db: LoadedDatabase,
        event_log=None,
    ) -> List[ScoreResult]:
        """Score a batch of queries against one loaded database with
        pipelined dispatch: every query's kernel is enqueued before any
        result materializes, so per-call dispatch/sync overhead amortizes
        across the batch (the serving form of the feeders' back-to-back
        target streaming).

        Per-result `elapsed_s` is the batch wall time divided evenly —
        under pipelined dispatch individual query timings don't exist;
        summing the results' elapsed_s gives the true batch time."""
        t0 = time.perf_counter()
        devs = [self._dispatch_loaded(q, db) for q in queries]
        for d in devs:
            np.asarray(d)  # materialize in dispatch order
        share = (time.perf_counter() - t0) / max(len(queries), 1)
        return [
            self._finish_loaded(
                d, q, db, t0, elapsed_override=share, event_log=event_log,
                kind="loaded_many",
            )
            for d, q in zip(devs, queries)
        ]

    def topk_loaded(
        self, query: np.ndarray, db: LoadedDatabase, k: int = 10,
        event_log=None,
    ) -> List[tuple]:
        """Best-hit reporting straight off the device: the top-K cut runs
        on-chip (two-level O(n) pass) and only 2k scalars cross D2H —
        for serving workloads that never need the full score vector.
        Tie order matches ScoreResult.top_k (score desc, id asc)."""
        t0 = time.perf_counter()
        devs = self._dispatch_topk_loaded(query, db, k)
        return self._finish_topk_loaded(devs, query, db, t0,
                                        event_log=event_log)

    def _finish_topk_loaded(self, devs, query, db: LoadedDatabase, t0,
                            event_log=None):
        """Materializing half of topk_loaded (+ the serving event)."""
        fs, fids = np.asarray(devs[0]), np.asarray(devs[1])
        if event_log is not None:
            from swtpu.utils import BatchEvent

            event_log.emit(
                BatchEvent(
                    "loaded_topk", t_wall=time.time(),
                    elapsed_s=time.perf_counter() - t0,
                    reads=db.n_reads,
                    cells=int(len(query)) * db.total_chars,
                    padded_cells=0,
                    note=f"qlen={len(query)} k={len(fs)}",
                )
            )
        return [(int(s), int(i)) for s, i in zip(fs, fids)]

    def load_database_sharded(self, targets, mesh, axis: str = "data"):
        """Mesh-wide :meth:`load_database`: per-device resident stream
        shards (the reference's per-module resident feeders,
        ScoreBank_v2.v:77-139) serving any query with one shard_map
        dispatch.  See swtpu.bank.serving."""
        from swtpu.bank.serving import load_database_sharded

        return load_database_sharded(self, targets, mesh, axis=axis)

    def score_loaded_sharded(self, query, db, event_log=None) -> ScoreResult:
        """Score one query against a mesh-resident database (full read-order
        score vector; the query register broadcasts, `ld_q` v2.v:99-102)."""
        from swtpu.bank.serving import score_loaded_sharded

        return score_loaded_sharded(self, query, db, event_log=event_log)

    def score_loaded_many_sharded(
        self, queries, db, event_log=None
    ) -> List[ScoreResult]:
        """Pipelined many-query serving over the mesh."""
        from swtpu.bank.serving import score_loaded_many_sharded

        return score_loaded_many_sharded(self, queries, db, event_log=event_log)

    def topk_loaded_sharded(self, query, db, k: int = 10, event_log=None):
        """Mesh-wide best hits: per-shard cut + collective merge; only 2k
        scalars cross D2H (the `max`/`vld_max` intent at the MODULES axis)."""
        from swtpu.bank.serving import topk_loaded_sharded

        return topk_loaded_sharded(self, query, db, k=k, event_log=event_log)

    def _dispatch_topk_loaded(self, query, db: LoadedDatabase, k: int):
        """Async half of topk_loaded: enqueue the kernel + on-device top-K
        cut, return un-materialized (scores [k], ids [k]) device arrays —
        lets serving front-ends pipeline dispatches across clients."""
        import jax.numpy as jnp

        from swtpu.parallel.sharded import local_topk_jit

        dev = self._dispatch_loaded(query, db)
        ids = jnp.arange(db.n_reads, dtype=jnp.int32)
        return local_topk_jit(dev, ids, min(k, db.n_reads))

    def _score_pairs_stream(
        self, queries: Sequence[np.ndarray], targets: Sequence[np.ndarray],
        event_log=None,
    ) -> ScoreResult:
        """Many-vs-many on the streamed wavefront: distinct queries load
        into per-stream query registers (pack_pair_streams), targets ride
        streams owned by their query.  Pair sets with more distinct queries
        than streams split into multiple kernel invocations."""
        from swtpu.bank.streams import dedupe_queries, pack_pair_streams
        from swtpu.ops.pallas_stream import sw_scores_stream

        t0 = time.perf_counter()
        n = len(queries)
        S = self.plan.streams
        # group pair indices by distinct query (the packer's own dedup, so
        # the chunk bound and the packer's count always agree); chunk groups
        # to <= S queries
        qlist, uid = dedupe_queries(queries)
        groups: list = [[] for _ in qlist]
        for i, u in enumerate(uid):
            groups[u].append(i)
        chunks = [groups[i : i + S] for i in range(0, len(groups), S)]
        scores = np.zeros((n,), dtype=np.int32)
        cells = padded = 0
        for chunk in chunks:
            tc = time.perf_counter()
            idxs = [i for g in chunk for i in g]
            batch = pack_pair_streams(
                [queries[i] for i in idxs], [targets[i] for i in idxs],
                n_streams=S,
            )
            if self.verify_integrity:
                from swtpu.utils.guards import check_stream_batch

                check_stream_batch(batch)
            s = np.asarray(
                sw_scores_stream(
                    batch.q, batch.stream,
                    batch.emit_stream, batch.emit_step.astype(np.int32),
                    emit_regular=batch.emit_regular, **self._kernel_kw(),
                )
            )
            if self.verify_integrity:
                from swtpu.utils.guards import check_scores

                check_scores(
                    s,
                    np.fromiter((len(queries[i]) for i in idxs), np.int64),
                    np.fromiter((len(targets[i]) for i in idxs), np.int64),
                    self.config.penalties.match,
                )
            scores[np.asarray(idxs, np.int64)] = s
            cells += batch.cells
            chunk_padded = _padded_cells(
                batch.stream.shape, batch.q.shape[1], self.plan.tile
            )
            padded += chunk_padded
            if event_log is not None:
                from swtpu.utils import BatchEvent

                event_log.emit(
                    BatchEvent(
                        "pair_stream", t_wall=time.time(),
                        elapsed_s=time.perf_counter() - tc,
                        reads=len(idxs), cells=batch.cells,
                        padded_cells=chunk_padded,
                        note=f"streams={batch.stream.shape[0]} "
                        f"T={batch.stream.shape[1]} queries={len(chunk)}",
                    )
                )
        return ScoreResult(scores, cells, padded, time.perf_counter() - t0)

    def _score_database_stream_chunked(
        self, query, targets, event_log, tmat, tlens, S: int, t0: float,
    ) -> ScoreResult:
        """Pipelined stream scoring: the database splits into chunks of
        `SWConfig.stream_chunk_reads`; each chunk's pack + wire-compress runs
        on the host WHILE the previous chunk's H2D transfer and kernel are in
        flight, and nothing blocks until every chunk is dispatched.  The
        form of the feeders' double buffering — the next target stages while
        the current one streams (SM_Feeder2.v:104-110) over the pipelined
        tagged DMA (dma.v:472-491).

        Chunk stream lengths snap to a power-of-two ladder so equal-rung
        chunks reuse ONE compiled executable (static shapes under jit).

        Dispatch runs on one worker thread so the numpy packing of the next
        chunk (which releases the GIL) overlaps the current dispatch.
        Whether that pays on a PCIe host is not measured."""
        import jax
        from concurrent.futures import ThreadPoolExecutor

        from swtpu.bank.streams import (
            STREAM_PAD, pack_stream_wire, pack_streams,
        )
        from swtpu.ops.pallas_stream import (
            STEP_CHUNK, sw_scores_stream, sw_scores_stream_packed,
        )

        C = self.config.stream_chunk_reads
        n_reads = len(tlens) if tlens is not None else len(targets)
        pending = []  # (lo, hi, future -> device scores [C], cells, padded)
        cells = padded = 0
        kw = self._kernel_kw()
        wire = self.config.wire_2bit and not self._interpret
        dq = jax.device_put(np.asarray(query, np.int8))

        def dispatch(stream, es, ep, regular):
            if wire:
                codes, flags = pack_stream_wire(stream)
                return sw_scores_stream_packed(
                    dq, codes, flags, es, ep, emit_regular=regular, **kw
                )
            return sw_scores_stream(dq, stream, es, ep, emit_regular=regular,
                                    **kw)

        ex = ThreadPoolExecutor(max_workers=1)
        try:
            for lo in range(0, n_reads, C):
                hi = min(lo + C, n_reads)
                if tlens is not None:
                    batch = pack_streams(
                        query, tmat[lo:hi], n_streams=S, lens=tlens[lo:hi],
                    )
                else:
                    batch = pack_streams(
                        query, [targets[i] for i in range(lo, hi)],
                        n_streams=S,
                    )
                if self.verify_integrity:
                    from swtpu.utils.guards import check_stream_batch

                    check_stream_batch(batch)
                # snap T to the power-of-two ladder (extra pads are
                # score-inert; every emission precedes them)
                T = batch.stream.shape[1]
                Tq = STEP_CHUNK
                while Tq < T:
                    Tq *= 2
                stream = batch.stream
                if Tq != T:
                    stream = np.full((S, Tq), STREAM_PAD, np.int8)
                    stream[:, :T] = batch.stream
                # fixed-width emission maps (pad slots emit 0, discarded)
                es = np.zeros((C,), np.int32)
                ep = np.full((C,), -1, np.int32)
                es[: hi - lo] = batch.emit_stream
                ep[: hi - lo] = batch.emit_step.astype(np.int32)
                # full chunks reuse the packer's own pattern; the padded
                # tail chunk (-1 rows) can never be regular
                regular = batch.emit_regular if hi - lo == C else None
                fut = ex.submit(dispatch, stream, es, ep, regular)
                chunk_padded = _padded_cells(
                    stream.shape, len(query), self.plan.tile
                )
                pending.append((lo, hi, fut, batch.cells, chunk_padded))
            scores = np.zeros((n_reads,), dtype=np.int32)
            for lo, hi, fut, c, p in pending:
                scores[lo:hi] = np.asarray(fut.result())[: hi - lo]
                cells += c
                padded += p
        finally:
            ex.shutdown(wait=True)
        if self.verify_integrity:
            from swtpu.utils.guards import check_scores

            t_lens = tlens if tlens is not None else np.fromiter(
                (len(t) for t in targets), np.int64, n_reads
            )
            check_scores(
                scores, np.full(n_reads, len(query)), t_lens,
                self.config.penalties.match,
            )
        elapsed = time.perf_counter() - t0
        if event_log is not None:
            from swtpu.utils import BatchEvent

            event_log.emit(
                BatchEvent(
                    "stream_pipelined", t_wall=time.time(), elapsed_s=elapsed,
                    reads=n_reads, cells=cells, padded_cells=padded,
                    note=f"chunks={len(pending)} chunk_reads={C} streams={S}",
                )
            )
        return ScoreResult(scores, cells, padded, elapsed)

    def _score_database_stream(
        self, query, targets, event_log=None, tmat=None, tlens=None
    ) -> ScoreResult:
        """Streamed wavefront path: no length buckets at all — ragged reads
        concatenate back-to-back per stream (the systolic feeder design),
        and queries of any length chain query tiles."""
        from swtpu.bank.streams import pack_streams
        from swtpu.device import stream_count
        from swtpu.ops.pallas_stream import sw_scores_stream

        t0 = time.perf_counter()
        n_reads = len(tlens) if tlens is not None else len(targets)
        S = stream_count(n_reads, self.plan)
        chunk_reads = self.config.stream_chunk_reads
        if chunk_reads and n_reads > chunk_reads:
            return self._score_database_stream_chunked(
                query, targets, event_log, tmat=tmat, tlens=tlens, S=S, t0=t0,
            )
        batch = pack_streams(
            query, tmat if tlens is not None else targets, n_streams=S,
            lens=tlens,
        )
        if self.verify_integrity:
            # in-situ parity checking on the DEFAULT path — the reference
            # guards every bus (afu.v:73-76), not just slow ones
            from swtpu.utils.guards import check_stream_batch

            check_stream_batch(batch)
        q = np.asarray(query, np.int8)  # one query for every stream
        es, ep = batch.emit_stream, batch.emit_step.astype(np.int32)
        kw = dict(emit_regular=batch.emit_regular, **self._kernel_kw())
        if self.config.wire_2bit and not self._interpret:
            # ship the stream at 2.5 bits/char and expand on device — the
            # reference's 4-bases/byte transfer economy (aligner_Header.c:30-41)
            from swtpu.bank.streams import pack_stream_wire
            from swtpu.ops.pallas_stream import sw_scores_stream_packed

            codes, flags = pack_stream_wire(batch.stream)
            scores = np.asarray(
                sw_scores_stream_packed(q, codes, flags, es, ep, **kw)
            )
        else:
            scores = np.asarray(sw_scores_stream(q, batch.stream, es, ep, **kw))
        if self.verify_integrity:
            from swtpu.utils.guards import check_scores

            t_lens = tlens if tlens is not None else np.fromiter(
                (len(t) for t in targets), np.int64, n_reads
            )
            check_scores(
                scores, np.full(n_reads, len(query)), t_lens,
                self.config.penalties.match,
            )
        elapsed = time.perf_counter() - t0
        padded = _padded_cells(batch.stream.shape, len(query), self.plan.tile)
        if event_log is not None:
            from swtpu.utils import BatchEvent

            event_log.emit(
                BatchEvent(
                    "stream", t_wall=time.time(), elapsed_s=elapsed,
                    reads=n_reads, cells=batch.cells,
                    padded_cells=padded,
                    note=f"streams={batch.stream.shape[0]} T={batch.stream.shape[1]}",
                )
            )
        return ScoreResult(scores, batch.cells, padded, elapsed)
