"""Data-parallel scoring and collective top-K merge over a device mesh.

Scaling the reference beyond one ScoreBank: the database batch is sharded
across the mesh's `data` axis (each device = one "scoring module" bank,
ScoreBank/ScoreBank_v2.v:77-139), the query is replicated (the bank
broadcasts `ld_q` to every module, ScoreBank_v2.v:99-102), and per-shard
results are merged with XLA collectives — implementing, across devices and
hosts, the best-hit/top-K capability the reference declared but never
drove (the dangling `max`/`vld_max` ports,
ScoreBank_v2.v:42-43, and the ResBuffer stub, CAPI_template/ResBuffer.v).

Collectives go to NCCL between the GPUs of a host; the same code runs
multi-process under `jax.distributed.initialize` (swtpu.testing provides the
hardware-free localhost harness, the PSLSE analog).
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from swtpu.config import DEFAULT_PENALTIES, Penalties


def make_sharded_scorer(
    mesh: Mesh,
    axis: str = "data",
    penalties: Penalties = DEFAULT_PENALTIES,
    score_width=None,
) -> Callable:
    """Returns jitted scores = f(q [B,m], t [B,n]) with B sharded over
    `axis` (the plain scan per shard).  B must divide by the axis size (the
    packer's batch_align)."""
    from swtpu.ops.scan import sw_scores_scan

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis, None)),
        out_specs=P(axis),
        check_vma=False,
    )
    def score(q, t):
        return sw_scores_scan(q, t, penalties, score_width=score_width)

    return jax.jit(score)


def make_sharded_stream_scorer(
    mesh: Mesh,
    axis: str = "data",
    penalties: Penalties = DEFAULT_PENALTIES,
    interpret: bool = False,
    k: int = 0,
    tile: int = 32,
    block: int = 128,
    score_width=None,
    emit_regular=None,
) -> Callable:
    """Shard the streamed-wavefront backend (the headline kernel) over the
    mesh: each device runs one feeder bank's streams and emits its shard's
    read scores; with k > 0 a collective top-K merge also returns the mesh's
    best hits (the `max`/`vld_max` intent, ScoreBank/ScoreBank_v2.v:42-43).

    Inputs are a ShardedStreamBatch's arrays (leading axis = shard):
      scores[D, R] = f(q[D, N, L], stream[D, N, T],
                       emit_stream[D, R], emit_step[D, R], ids[D, R])
    With k > 0 returns (scores[D, R], top_scores[k], top_ids[k]).
    """
    from swtpu.ops.pallas_stream import sw_scores_stream

    def shard_fn(q, stream, es, ep, ids):
        s = sw_scores_stream(
            q[0], stream[0], es[0], ep[0], penalties=penalties, tile=tile,
            block=block, interpret=interpret, score_width=score_width,
            emit_regular=emit_regular,
        )
        if not k:
            return s[None, :]
        fin_s, fin_ids = _merge_topk(s, ids[0], k, axis)
        return s[None, :], fin_s, fin_ids

    specs5 = (
        P(axis, None, None),
        P(axis, None, None),
        P(axis, None),
        P(axis, None),
        P(axis, None),
    )
    out_specs = P(axis, None) if not k else (P(axis, None), P(), P())
    fn = shard_map(
        shard_fn, mesh=mesh, in_specs=specs5, out_specs=out_specs,
        check_vma=False,
    )
    return jax.jit(fn)


def make_sharded_topk(
    mesh: Mesh,
    k: int,
    axis: str = "data",
    penalties: Penalties = DEFAULT_PENALTIES,
    score_width=None,
) -> Callable:
    """Returns jitted (top_scores [k], top_ids [k], scores [B]) =
    f(q [B,m], t [B,n], ids [B]).

    Per-shard `lax.top_k` first, then an all-gather of the K·n_shards
    candidates and a final top-K — the stable merge of (score, db-index)
    pairs across shards (SURVEY.md §7 'hard parts').  Sentinel rows carry
    id -1 and score 0; callers filter them if k exceeds live rows.
    """
    from swtpu.ops.scan import sw_scores_scan

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis, None), P(axis)),
        out_specs=(P(), P(), P(axis)),
        check_vma=False,
    )
    def score_topk(q, t, ids):
        s = sw_scores_scan(q, t, penalties, score_width=score_width)
        fin_s, fin_ids = _merge_topk(s, ids, k, axis)
        return fin_s, fin_ids, s

    return jax.jit(score_topk)


def _merge_topk(s, ids, k: int, axis: str):
    """Collective top-K with host-consistent tie ordering: equal scores
    rank by ascending database id, exactly like ScoreResult.top_k's stable
    argsort — so the single-chip and sharded answers agree bit-for-bit on
    tied databases.  Sentinel rows (id < 0) are masked below every real
    score and can only appear when k exceeds live rows."""
    live = ids >= 0
    masked = jnp.where(live, s, -(2 ** 30))
    kk = min(k, masked.shape[0])
    loc_s, loc_ids = _local_topk(masked, ids, kk)
    all_s = jax.lax.all_gather(loc_s, axis, tiled=True)
    all_ids = jax.lax.all_gather(loc_ids, axis, tiled=True)
    # final cut: explicit (score desc, id asc) lexicographic order — a
    # plain top_k here would break ties by shard position instead of id
    order = jnp.lexsort((all_ids, -all_s))[:k]
    return all_s[order], all_ids[order]


def _local_topk(masked, ids, kk: int):
    """Per-shard top-kk, lowest ids first among equal scores.

    For large shards a flat `lax.top_k` lowers to an O(R log R)-ish sort.
    Two-level form:
    row-wise top-kk on a [R/128, 128] view (one O(R) pass), then top-kk of
    the R/128*kk candidates.  Exact, incl. tie order: an element dropped by
    its row's cut has >= kk elements in that row scoring >= it with lower
    ids (lax.top_k is stable by position and rows are index-contiguous),
    so it cannot belong to the true top-kk; candidate positions among
    equal scores remain (row, in-row-index)-ascending = id-ascending."""
    R = masked.shape[0]
    cols = 128
    if R <= 4 * cols or kk > cols:
        loc_s, loc_i = jax.lax.top_k(masked, kk)
        return loc_s, ids[loc_i]
    pad = (-R) % cols
    if pad:
        masked = jnp.concatenate(
            [masked, jnp.full((pad,), -(2 ** 30), masked.dtype)]
        )
    grid = masked.reshape(-1, cols)
    rs, ri = jax.lax.top_k(grid, kk)  # [R/cols, kk]
    base = (jnp.arange(grid.shape[0], dtype=jnp.int32) * cols)[:, None]
    cand_idx = (base + ri).reshape(-1)
    cand_s = rs.reshape(-1)
    fs, fi = jax.lax.top_k(cand_s, kk)
    src = cand_idx[fi]
    live_src = src < R  # padding tail can only surface when kk > live rows
    return fs, jnp.where(live_src, ids[jnp.minimum(src, R - 1)], -1)


# one-dispatch form for eager callers (ScoreBank.topk_loaded)
local_topk_jit = jax.jit(_local_topk, static_argnums=2)
