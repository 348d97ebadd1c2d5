"""Host-side packing for the streamed wavefront kernel.

The reference's feeders stage targets and shift them into the PE array
back-to-back, pairing completions with IDs via per-toggle FIFOs
(ScoreBank/SM_Feeder2.v); the bank's priority encoder picks the first
feeder with room (ScoreBank/PrioEncoder.v:16-22).  Here: each of S streams
is one feeder lane; reads are assigned greedily to the currently-shortest
stream (the load-balancing the priority encoder approximates), concatenated
with a first-char flag, and every read's score-emission coordinate
(stream, step) is computed up front — the ID-FIFO pairing made static.

The kernel computes a whole DP column per step, so a read's score is ready
at its last char: emission step = offset + len - 1.  The stream layout is
therefore independent of the query, and one packed database serves queries
of any length.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from swtpu.ops.common import Q_PAD

STREAM_PAD = 4  # pad char (never matches; no flag)
FLAG = 8


def _round_steps(T: int) -> int:
    from swtpu.ops.pallas_stream import STEP_CHUNK

    return max(-(-T // STEP_CHUNK) * STEP_CHUNK, STEP_CHUNK)


def _query_register(query: np.ndarray, S: int) -> np.ndarray:
    """[S, len] copy of one query for every stream (at least one column)."""
    q = np.full((S, max(len(query), 1)), Q_PAD, dtype=np.int8)
    q[:, : len(query)] = np.asarray(query, dtype=np.int8)[None, :]
    return q


@dataclasses.dataclass
class StreamBatch:
    """Packed streams + emission map.

    q: [N, L] int8 per-stream query (replicated, sentinel-padded).
    stream: [N, T] int8 flagged char streams, T % STEP_CHUNK == 0.
    emit_stream / emit_step: [n_reads] gather coordinates into the strip.
    cells: real DP cells (query_len * sum target lens).
    emit_regular: (first_step, stride, count) when the emission map is
      REGULAR — read r emits at (stream r % S, step first + (r // S) *
      stride), the shape equal-length round-robin packing produces.
      Kernels then extract scores with a strided strip slice + reshape
      instead of a scattered gather.  None = ragged.
    """

    q: np.ndarray
    stream: np.ndarray
    emit_stream: np.ndarray
    emit_step: np.ndarray
    cells: int
    emit_regular: Optional[tuple] = None

    @property
    def total_steps(self) -> int:
        return self.stream.shape[0] * self.stream.shape[1]


def detect_regular_emissions(
    emit_stream: np.ndarray, emit_step: np.ndarray, S: int
) -> Optional[tuple]:
    """(first, stride, count) if read r emits at (r % S, first + (r//S)*stride)
    for every r — one vectorized O(R) check at pack time (the result-mux
    address pattern of a full equal-length round-robin bank)."""
    R = len(emit_step)
    if R == 0 or R % S:
        return None
    per = R // S
    r = np.arange(R, dtype=np.int64)
    if not np.array_equal(np.asarray(emit_stream, np.int64), r % S):
        return None
    first = int(emit_step[0])
    if first < 0:
        return None
    stride = int(emit_step[S]) - first if per > 1 else 1
    if stride <= 0:
        return None
    if not np.array_equal(
        np.asarray(emit_step, np.int64), (r // S) * stride + first
    ):
        return None
    return (first, stride, per)


def pack_streams(
    query: np.ndarray,
    targets: Sequence[np.ndarray],
    n_streams: int = 256,
    lens: Optional[np.ndarray] = None,
) -> StreamBatch:
    """Assign reads to streams (greedy shortest-stream), concatenate with
    flags, compute emission coordinates.

    targets: either a sequence of 1-D code arrays, or — the fast dense form —
    a [n_reads, width] int8 matrix with `lens` giving each read's real
    length (the rest of each row is ignored).  The dense form takes the
    native C++ plan/fill path when the toolchain is available."""
    if lens is not None:
        tmat = np.asarray(targets)
        if tmat.ndim != 2:
            raise ValueError("lens requires a dense [n, width] target matrix")
        return _pack_streams_dense(
            query, tmat.astype(np.int8, copy=False),
            np.asarray(lens, np.int32), n_streams,
        )
    n_reads = len(targets)
    S = n_streams
    # Large ragged lists: densify (vectorized mask scatter) and take the
    # native plan/fill path instead of the per-read Python greedy loop
    # (~50x on multi-100k-read databases).  A 2-D ndarray skips this — the
    # equal-length fast path below uses the matrix with zero copies.
    if n_reads >= 1024 and not isinstance(targets, np.ndarray) and all(
        isinstance(t, np.ndarray) and t.ndim == 1 for t in targets[:64]
    ):
        try:
            tlens = np.fromiter((len(t) for t in targets), np.int32, n_reads)
            flat = np.concatenate(targets).astype(np.int8, copy=False)
            w = max(int(tlens.max()), 1)
            tmat = np.zeros((n_reads, w), np.int8)
            tmat[np.arange(w)[None, :] < tlens[:, None]] = flat
            return _pack_streams_dense(query, tmat, tlens, S)
        except (ValueError, TypeError):
            pass  # odd element shapes/dtypes: fall through to greedy
    # Fast path: equal-length reads, count divisible by S.  Greedy
    # shortest-stream degenerates to round-robin there, so this produces the
    # identical packing without the per-read Python loop.
    if n_reads and n_reads % S == 0 and len(targets[0]) > 0:
        tmat = targets if isinstance(targets, np.ndarray) else None
        if tmat is None and all(
            isinstance(t, np.ndarray) and t.ndim == 1 and len(t) == len(targets[0])
            for t in targets[: min(n_reads, 64)]
        ):
            if len({len(t) for t in targets}) == 1:
                tmat = np.stack(targets)
        if tmat is not None and tmat.ndim == 2:
            return _pack_streams_equal(query, tmat.astype(np.int8), S)
    # large equal-width matrix that misses the divisibility condition above:
    # still take the native dense path rather than the per-row Python loop
    if (
        isinstance(targets, np.ndarray) and targets.ndim == 2
        and n_reads >= 1024 and targets.shape[1] > 0
    ):
        return _pack_streams_dense(
            query, targets.astype(np.int8, copy=False),
            np.full(n_reads, targets.shape[1], np.int32), S,
        )
    return _pack_streams_greedy(query, targets, S)


def _finish_batch(batch: StreamBatch) -> StreamBatch:
    """Stamp the regular-emission pattern (strided-extract fast path) when
    present."""
    batch.emit_regular = detect_regular_emissions(
        batch.emit_stream, batch.emit_step, batch.stream.shape[0]
    )
    return batch


def _fill(chunks: List[List[np.ndarray]], fill: np.ndarray, S: int):
    """Concatenate each stream's flagged reads into an [S, T] pad matrix."""
    T = _round_steps(int(fill.max()) if len(fill) else 0)
    stream = np.full((S, T), STREAM_PAD, dtype=np.int8)
    for s in range(S):
        if chunks[s]:
            cat = np.concatenate(chunks[s])
            stream[s, : len(cat)] = cat
    return stream


def _pack_streams_greedy(
    query: np.ndarray, targets: Sequence[np.ndarray], S: int,
) -> StreamBatch:
    """Pure-Python greedy shortest-stream packing (the reference semantics);
    terminal — never re-dispatches to the dense/native paths, so it is the
    safe fallback when the native toolchain is unavailable."""
    n_reads = len(targets)
    chunks: List[List[np.ndarray]] = [[] for _ in range(S)]
    fill = np.zeros(S, dtype=np.int64)
    emit_stream = np.zeros(n_reads, dtype=np.int32)
    emit_step = np.zeros(n_reads, dtype=np.int64)
    cells = 0
    for r, t in enumerate(targets):
        t = np.asarray(t, dtype=np.int8)
        if len(t) == 0:
            emit_stream[r] = 0
            emit_step[r] = -1  # zero-length read: score 0 by definition
            continue
        s = int(np.argmin(fill))
        flagged = t.copy()
        flagged[0] |= FLAG
        chunks[s].append(flagged)
        emit_stream[r] = s
        emit_step[r] = fill[s] + len(t) - 1
        fill[s] += len(t)
        cells += len(query) * len(t)
    return _finish_batch(StreamBatch(
        _query_register(query, S), _fill(chunks, fill, S), emit_stream,
        _check_emit_step(emit_step), cells,
    ))


def _check_emit_step(emit_step: np.ndarray) -> np.ndarray:
    """Emission steps index the [S, T] strip and every kernel consumes them
    as int32; a stream longer than 2^31 steps would silently wrap at the
    cast.  Validate once at pack time (the only place the true int64 value
    exists)."""
    if emit_step.size and int(emit_step.max()) >= 2**31:
        raise ValueError(
            "stream exceeds 2^31 steps; emission coordinates would overflow "
            "int32 — split the database into smaller batches"
        )
    return emit_step


def _pack_streams_dense(
    query: np.ndarray, tmat: np.ndarray, lens: np.ndarray, S: int,
) -> StreamBatch:
    """Ragged dense-matrix packing via the native C++ plan/fill pipeline
    (swtpu_native.cpp); pure-Python greedy fallback if the toolchain is
    missing.  Bit-identical to the per-read greedy path."""
    n_reads = tmat.shape[0]
    try:
        from swtpu.runtime.native import NativePacker, native_available

        if not native_available():
            raise RuntimeError("native unavailable")
        packer = NativePacker()
        emit_stream, emit_step, max_fill = packer.plan_streams(lens, S, 0)
        T = _round_steps(max_fill if n_reads else 0)
        stream = packer.fill_streams(
            tmat, lens, emit_stream, emit_step, 0, FLAG, T, S, STREAM_PAD
        )
    except RuntimeError:
        # no native toolchain: run the terminal greedy packer directly (a
        # pack_streams() call here would re-enter the densify branch and
        # recurse forever on >=1024-read ragged lists)
        return _pack_streams_greedy(
            query, [tmat[i, : lens[i]] for i in range(n_reads)], S,
        )
    cells = int(len(query)) * int(lens.astype(np.int64).sum())
    return _finish_batch(StreamBatch(
        _query_register(query, S), stream, emit_stream,
        _check_emit_step(emit_step), cells,
    ))


def _pack_streams_equal(
    query: np.ndarray, tmat: np.ndarray, S: int
) -> StreamBatch:
    """Vectorized round-robin packing of a [B, n] equal-length read matrix."""
    B, n = tmat.shape
    per = B // S  # reads per stream
    flagged = tmat.copy()
    flagged[:, 0] |= FLAG
    # read r -> stream r % S, slot r // S (greedy == round-robin here)
    body = flagged.reshape(per, S, n).transpose(1, 0, 2).reshape(S, per * n)
    stream = np.full((S, _round_steps(per * n)), STREAM_PAD, dtype=np.int8)
    stream[:, : per * n] = body
    r = np.arange(B, dtype=np.int64)
    emit_stream = (r % S).astype(np.int32)
    emit_step = (r // S) * n + (n - 1)
    return StreamBatch(
        _query_register(query, S), stream, emit_stream,
        _check_emit_step(emit_step), len(query) * B * n,
        emit_regular=(n - 1, n, per),  # regular by construction
    )


def dedupe_queries(queries) -> tuple:
    """(distinct int8 query arrays, [n] int32 uid per input) — the single
    content-keyed dedup used by both the pair packer and ScoreBank's
    chunker, so their distinct-query counts can never disagree."""
    uid_by_key = {}
    qlist: List[np.ndarray] = []
    uid = np.empty(len(queries), np.int32)
    for i, qq in enumerate(queries):
        qq = np.asarray(qq, dtype=np.int8)
        u = uid_by_key.get(qq.tobytes())
        if u is None:
            u = uid_by_key[qq.tobytes()] = len(qlist)
            qlist.append(qq)
        uid[i] = u
    return qlist, uid


def pack_pair_streams(
    queries: Sequence[np.ndarray],
    targets: Sequence[np.ndarray],
    n_streams: int = 256,
) -> StreamBatch:
    """Pack explicit (query, target) pairs onto the wavefront: each stream
    holds ONE query in its per-stream query register (the reference's
    per-module `ld_q`, ScoreBank/ScoreBank_v2.v:99-102), and every pair's
    target rides a stream owned by its query.

    Streams are allocated to distinct queries proportionally to their total
    target chars (at least one each); within a query's streams, targets go
    greedy-shortest-stream.  Raises if there are more distinct queries than
    streams — chunk the pair set upstream (ScoreBank.score_pairs does)."""
    if len(queries) != len(targets):
        raise ValueError("queries and targets must pair up")
    n = len(queries)
    S = n_streams
    # dedupe queries by content; pairs sharing a query share its streams
    qlist, uid = dedupe_queries(queries)
    U = len(qlist)
    if U > S:
        raise ValueError(
            f"{U} distinct queries exceed {S} streams; split the pair set "
            "into chunks of <= n_streams distinct queries"
        )
    load = np.zeros(U, np.int64)
    for i in range(n):
        load[uid[i]] += len(targets[i])
    # largest-remainder proportional stream allocation, >= 1 per query
    total = max(int(load.sum()), 1)
    want = load.astype(np.float64) * S / total
    alloc = np.maximum(np.floor(want).astype(np.int64), 1)
    while alloc.sum() > S:
        alloc[int(np.argmax(alloc))] -= 1
    # spread leftovers to the largest fractional remainders
    rema = want - np.floor(want)
    while alloc.sum() < S:
        k = int(np.argmax(rema))
        alloc[k] += 1
        rema[k] = -1.0
    first = np.zeros(U, np.int64)
    np.cumsum(alloc[:-1], out=first[1:])
    # greedy shortest-stream within each query's stream span
    fill = np.zeros(S, dtype=np.int64)
    chunks: List[List[np.ndarray]] = [[] for _ in range(S)]
    emit_stream = np.zeros(n, dtype=np.int32)
    emit_step = np.zeros(n, dtype=np.int64)
    cells = 0
    for i in range(n):
        t = np.asarray(targets[i], dtype=np.int8)
        if len(t) == 0:
            emit_stream[i] = 0
            emit_step[i] = -1
            continue
        u = uid[i]
        lo, hi = int(first[u]), int(first[u] + alloc[u])
        s = lo + int(np.argmin(fill[lo:hi]))
        flagged = t.copy()
        flagged[0] |= FLAG
        chunks[s].append(flagged)
        emit_stream[i] = s
        emit_step[i] = fill[s] + len(t) - 1
        fill[s] += len(t)
        cells += len(qlist[u]) * len(t)
    q = np.full((S, max([len(qq) for qq in qlist] + [1])), Q_PAD, np.int8)
    for u in range(U):
        qq = qlist[u]
        q[int(first[u]) : int(first[u] + alloc[u]), : len(qq)] = qq[None, :]
    return _finish_batch(StreamBatch(
        q, _fill(chunks, fill, S), emit_stream, _check_emit_step(emit_step),
        cells,
    ))


@dataclasses.dataclass
class ShardedStreamBatch:
    """Per-device stacks of stream batches (leading axis = mesh shard).

    The multi-device form of the feeder bank: each device is one ScoreBank
    (the `MODULES` scaling axis, ScoreBank/ScoreBank_v2.v:17,77-139), reads
    are dealt round-robin across shards, and every shard's streams pad to a
    common length so one shard_map dispatch covers the mesh.

    q: [D, N, L] int8; stream: [D, N, T] int8.
    emit_stream/emit_step: [D, R] gather coordinates (R = max reads/shard).
    ids: [D, R] global read index, -1 on padding slots.
    cells: total real DP cells across shards.
    """

    q: np.ndarray
    stream: np.ndarray
    emit_stream: np.ndarray
    emit_step: np.ndarray
    ids: np.ndarray
    cells: int
    emit_regular: Optional[tuple] = None  # common per-shard pattern, if any


def pack_streams_sharded(
    query: np.ndarray,
    targets: Sequence[np.ndarray],
    n_shards: int,
    n_streams: int = 256,
) -> ShardedStreamBatch:
    """Deal reads round-robin to `n_shards` device shards and pack each with
    :func:`pack_streams`; pad stream length and read count to shard maxima.

    targets: a sequence of 1-D code arrays, or the dense EncodedDB /
    (mat, lens) form — dense shards slice the matrix round-robin and take
    the native plan/fill path per shard (no per-read Python objects)."""
    from swtpu.bank.scorebank import _dense_form

    tmat, tlens = _dense_form(targets)
    n_reads = len(tlens) if tlens is not None else len(targets)
    groups = [list(range(d, n_reads, n_shards)) for d in range(n_shards)]
    if tlens is not None:
        batches = [
            pack_streams(
                query, tmat[d::n_shards], n_streams=n_streams,
                lens=np.asarray(tlens)[d::n_shards],
            )
            for d in range(n_shards)
        ]
    else:
        batches = [
            pack_streams(query, [targets[i] for i in g], n_streams=n_streams)
            for g in groups
        ]
    T = max(b.stream.shape[1] for b in batches)
    R = max(len(g) for g in groups)
    D = n_shards
    q = np.stack([b.q for b in batches])
    stream = np.full((D, n_streams, T), STREAM_PAD, dtype=np.int8)
    emit_stream = np.zeros((D, R), np.int32)
    emit_step = np.full((D, R), -1, np.int64)
    ids = np.full((D, R), -1, np.int32)
    cells = 0
    for d, (g, b) in enumerate(zip(groups, batches)):
        stream[d, :, : b.stream.shape[1]] = b.stream
        emit_stream[d, : len(g)] = b.emit_stream
        emit_step[d, : len(g)] = b.emit_step
        ids[d, : len(g)] = g
        cells += b.cells
    # the strided-extract fast path applies mesh-wide only when every shard
    # shares one regular pattern and no shard needed read-count padding
    regs = {b.emit_regular for b in batches}
    common = (
        regs.pop() if len(regs) == 1 and all(len(g) == R for g in groups)
        else None
    )
    return ShardedStreamBatch(
        q, stream, emit_stream, emit_step, ids, cells, emit_regular=common,
    )


def scatter_sharded_scores(
    shard_scores: np.ndarray, batch: ShardedStreamBatch, n_reads: int
) -> np.ndarray:
    """[D, R] per-shard scores -> [n_reads] read-order scores."""
    out = np.zeros(n_reads, np.int32)
    live = batch.ids >= 0
    out[batch.ids[live]] = np.asarray(shard_scores)[live]
    return out


def pack_stream_wire(stream: np.ndarray):
    """Compress a flagged char-stream matrix for the host->device wire:
    2-bit codes packed 4/byte LSB-first (the reference's transfer packing,
    aligner_Header.c:30-41) plus a first-char flag bitmap packed 8/byte —
    2.5 bits/char instead of 8, a 3.2x cut of host-to-device bytes.

    Pad chars lose their identity (code 4 -> 0), which is score-safe: pad
    columns sit after every gathered emission step, and read boundaries are
    re-established by the flag bits (see sw_scores_stream_packed).

    stream: [N, T] int8, T % 8 == 0.  Returns (codes [N, T//4] uint8,
    flags [N, T//8] uint8)."""
    N, T = stream.shape
    if T % 8:
        raise ValueError(f"stream length {T} must be a multiple of 8")
    try:
        # per-dispatch hot path: one C++ pass instead of numpy temporaries
        from swtpu.runtime.native import NativePacker, native_available

        if native_available():
            return NativePacker().pack_wire(stream)
    except RuntimeError:
        pass
    u = stream.astype(np.uint8)
    quads = (u & 3).reshape(N, T // 4, 4)
    shifts = np.array([0, 2, 4, 6], dtype=np.uint8)
    codes = np.bitwise_or.reduce(quads << shifts, axis=2).astype(np.uint8)
    flags = np.packbits(
        (u & FLAG) != 0, axis=1, bitorder="little"
    )
    return codes, flags


def score_streams(
    query: np.ndarray,
    targets: Sequence[np.ndarray],
    n_streams: int = 256,
    penalties=None,
    interpret: bool = False,
    tile: int = 32,
    block: int = 128,
) -> np.ndarray:
    """End-to-end streamed scoring: pack -> wavefront kernel -> gather."""
    from swtpu.config import DEFAULT_PENALTIES
    from swtpu.ops.pallas_stream import sw_scores_stream

    batch = pack_streams(query, targets, n_streams)
    return np.asarray(
        sw_scores_stream(
            batch.q, batch.stream, batch.emit_stream,
            batch.emit_step.astype(np.int32), penalties or DEFAULT_PENALTIES,
            tile=tile, block=block, interpret=interpret,
            emit_regular=batch.emit_regular,
        )
    )
