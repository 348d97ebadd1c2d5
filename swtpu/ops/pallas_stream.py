"""Streamed Smith-Waterman wavefront: a Pallas kernel for the GPU (Triton).

The reference's feeders shift each module's targets back-to-back through a
chain of processing elements, one query base per PE (ScoreBank/
ScoringModule_v1.1.v:155-235).  Here every GPU thread is one such feeder
lane ("stream"): the host concatenates a stream's targets back-to-back,
marking each target's first char with FLAG_BIT (swtpu.bank.streams), and
the thread walks the stream one target char per step.  A step computes one
whole DP column of a query tile, row by row, in the thread's registers: the
PE chain folded into one thread, so the up-neighbour hand-off never leaves
the register file and a read's score is ready at its own last char (no
emission drain).

Layout: streams on the minor axis everywhere ([T, N] stream, [L, N] query
rows, [T, N] strips), so each step's loads and stores are coalesced across
the threads of a warp.  The grid runs over blocks of `block` streams and
is parallel; the T-step loop runs inside the block.

Reduced-op state (algebraically identical to carrying M/I):
  D = max(M, I)            — all the diagonal ever reads (one step back)
  G = max(M + (oe-e), I)   — the merged-I gap source:
    I_new = max(max(M_up,M_left)+oe, max(I_up,I_left)+e)
          = max(G_up, G_left) + e
  boundary G := 0 is exact: a boundary neighbour has M=0, I=0, so its gap
  contribution is max(oe, e) = e = (G=0) + e; and since M>=0, interior
  G >= oe-e, so the clamp never clips a real value.

Queries longer than one tile chain tiles (the reference's reserved
chaining ports, ScoreBank/ScoringModule_v1.1.v:36-54): a tile writes its
last row's D/G per step and the next tile's row 0 reads them as its
up-neighbour.  The running best score is a max over columns and rows, so
each tile keeps its own per-read maximum and the read's score is the max
over tiles.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from swtpu.config import DEFAULT_PENALTIES, Penalties
from swtpu.ops.common import Q_PAD

FLAG_BIT = 8  # first-char-of-target marker in the stream bytes
# packers round stream length T up to this (the 2-bit wire packs 8 chars
# per flag byte; the chunked path's power-of-two ladder starts here)
STEP_CHUNK = 32


def _wavefront_kernel(*refs, ma, mi, go, ge, width, chain_in, chain_out):
    """One tile of query rows against `block` streams, all T steps.

    refs: q [tile, B] int8, stream [T, B] int8, (bD, bG [T, B] int32 if
    chain_in), acc [T, B] int32, (oD, oG [T, B] int32 if chain_out)."""
    q_ref, s_ref = refs[:2]
    k = 2
    if chain_in:
        bd_ref, bg_ref = refs[2:4]
        k = 4
    acc_ref = refs[k]
    if chain_out:
        od_ref, og_ref = refs[k + 1 : k + 3]
    T, B = s_ref.shape
    tile = q_ref.shape[0]
    # boundary value: 0 exact; in wrap mode the RTL's ZERO = 2^(W-1)
    # (SW_ProcessingElement_v1.0.v:15-20)
    zero = 0 if width is None else 1 << (width - 1)
    z = jnp.full((B,), zero, jnp.int32)
    qs = [q_ref[r, :].astype(jnp.int32) for r in range(tile)]

    def m_update(x):
        if width is None:
            return jnp.maximum(x, 0)
        # SCORE_WIDTH wrap-parity: state holds W-bit biased unsigned values
        # (score + 2^(W-1)) in 32-bit lanes.  Only the M update wraps
        # (& mask) and clamps on the sign bit; the I/G chain provably never
        # wraps (every cell's merged-I includes an M + open + extend
        # candidate with M >= ZERO, so I stays in [ZERO+open+extend, mask]).
        ms = x & ((1 << width) - 1)
        return jnp.where((ms & zero) != 0, ms, zero)

    def step(t, carry):
        D, G, acc, d_up = carry
        c = s_ref[t, :].astype(jnp.int32)
        f0 = c >= FLAG_BIT  # target start: column -1 is the zero boundary
        cv = c & 7
        if chain_in:
            # row 0's up-neighbour is the previous tile's last row: its G
            # at this column, its D one column back
            g_up = bg_ref[t, :]
            diag = jnp.where(f0, zero, d_up)
            d_up = bd_ref[t, :]
        else:
            g_up = z
            diag = z
        h = z
        new_d, new_g = [], []
        for r in range(tile):
            if r:
                diag = jnp.where(f0, zero, D[r - 1])
                g_up = new_g[r - 1]
            m = m_update(diag + jnp.where(cv == qs[r], ma, mi))
            i = jnp.maximum(g_up, jnp.where(f0, zero, G[r])) + ge
            h = jnp.maximum(h, m)
            new_d.append(jnp.maximum(m, i))
            new_g.append(jnp.maximum(m + go, i))
        # per-read running best: reset at each target start
        acc = jnp.maximum(jnp.where(f0, zero, acc), h)
        acc_ref[t, :] = acc
        if chain_out:
            od_ref[t, :] = new_d[-1]
            og_ref[t, :] = new_g[-1]
        return tuple(new_d), tuple(new_g), acc, d_up

    init = ((z,) * tile, (z,) * tile, z, z)
    jax.lax.fori_loop(0, T, step, init)


def _tile_call(qt, sk, bd, bg, *, penalties, block, interpret, width,
               chain_out):
    """One tile: qt [tile, N] int8, sk [T, N] int8, optional boundary
    strips -> acc strip [T, N] (+ last-row D/G strips if chain_out)."""
    ma, mi, go, ge = penalties.astuple()
    T, N = sk.shape
    chain_in = bd is not None
    spec = lambda rows: pl.BlockSpec((rows, block), lambda i: (0, i))
    ins = [qt, sk] + ([bd, bg] if chain_in else [])
    in_specs = [spec(qt.shape[0]), spec(T)] + [spec(T)] * (2 * chain_in)
    n_out = 3 if chain_out else 1
    kernel = functools.partial(
        _wavefront_kernel, ma=ma, mi=mi, go=go, ge=ge, width=width,
        chain_in=chain_in, chain_out=chain_out,
    )
    outs = pl.pallas_call(
        kernel,
        grid=(N // block,),
        in_specs=in_specs,
        out_specs=[spec(T)] * n_out,
        out_shape=[jax.ShapeDtypeStruct((T, N), jnp.int32)] * n_out,
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=max(1, min(block // 32, 8)), num_stages=1
        ),
        interpret=interpret,
        name="sw_wavefront",
    )(*ins)
    return outs if chain_out else (outs[0], None, None)


def tile_rows(qlen: int, tile: int):
    """(K, height): a query of `qlen` rows runs as K chained tiles of equal
    height at most `tile`, so a short query takes a short tile."""
    K = -(-max(qlen, 1) // tile)
    return K, -(-max(qlen, 1) // K)


def _validate(N, T, tile, block, score_width, penalties):
    if tile < 1:
        raise ValueError(f"tile={tile} must be >= 1")
    if block < 1 or block & (block - 1):
        raise ValueError(f"block={block} must be a power of two")
    if N % min(block, N):
        raise ValueError(f"{N} streams do not divide into blocks of {block}")
    if T % STEP_CHUNK:
        raise ValueError(f"stream length {T} not a multiple of {STEP_CHUNK}")
    if score_width is not None:
        if not 2 <= score_width <= 30:
            raise ValueError(
                f"score_width={score_width} out of range (need 2..30)"
            )
        _, _, go, ge = penalties.astuple()
        if (1 << (score_width - 1)) + (go + ge) + ge < 0:
            # the I-chain no-wrap proof needs ZERO + open + extend >= -extend
            raise ValueError(
                f"score_width={score_width} too narrow for penalties "
                f"(need 2^(W-1) >= |open+extend| + |extend|)"
            )


def _scores(qT, sk, emit_stream, emit_step, penalties, tile, block,
            interpret, score_width, emit_regular):
    """Shared body: qT [L, N] per-stream query rows (or [L], one query for
    every stream), sk [T, N] stream -> per-read scores."""
    T, N = sk.shape
    _validate(N, T, tile, block, score_width, penalties)
    if qT.ndim == 1:
        qT = jnp.broadcast_to(qT[:, None], (qT.shape[0], N))
    # pad rows (Q_PAD never matches) cannot raise the best score
    K, th = tile_rows(qT.shape[0], tile)
    qT = jnp.pad(qT.astype(jnp.int8), ((0, K * th - qT.shape[0]), (0, 0)),
                 constant_values=Q_PAD)
    qtiles = qT.reshape(K, th, N)
    bias = 0 if score_width is None else 1 << (score_width - 1)
    kw = dict(penalties=penalties, block=min(block, N), interpret=interpret,
              width=score_width)
    gather = lambda acc: _gather_emissions(acc, emit_stream, emit_step,
                                           bias=bias, regular=emit_regular)
    acc, bd, bg = _tile_call(qtiles[0], sk, None, None, chain_out=K > 1, **kw)
    best = gather(acc)
    if K > 2:
        def middle(carry, qt):
            bd, bg, best = carry
            acc, bd, bg = _tile_call(qt, sk, bd, bg, chain_out=True, **kw)
            return (bd, bg, jnp.maximum(best, gather(acc))), None

        (bd, bg, best), _ = jax.lax.scan(middle, (bd, bg, best),
                                         qtiles[1:-1])
    if K > 1:
        acc, _, _ = _tile_call(qtiles[-1], sk, bd, bg, chain_out=False, **kw)
        best = jnp.maximum(best, gather(acc))
    return best


_STATIC = ("penalties", "tile", "block", "interpret", "score_width",
           "emit_regular")


@functools.partial(jax.jit, static_argnames=_STATIC)
def sw_scores_stream_kernel_layout(
    qT: jnp.ndarray,
    streamT: jnp.ndarray,
    emit_stream: jnp.ndarray,
    emit_step: jnp.ndarray,
    penalties: Penalties = DEFAULT_PENALTIES,
    tile: int = 32,
    block: int = 128,
    interpret: bool = False,
    score_width=None,
    emit_regular=None,
) -> jnp.ndarray:
    """Score a device-resident [T, N] stream (the kernel's layout, so a
    loaded database is never relaid out per query).

    qT: [L] int8, one query for every stream, or [L, N] per-stream query
    rows (pairs), sentinel-padded with Q_PAD."""
    return _scores(qT, streamT, emit_stream, emit_step, penalties, tile,
                   block, interpret, score_width, emit_regular)


@functools.partial(jax.jit, static_argnames=_STATIC)
def sw_scores_stream(
    q: jnp.ndarray,
    stream: jnp.ndarray,
    emit_stream: jnp.ndarray,
    emit_step: jnp.ndarray,
    penalties: Penalties = DEFAULT_PENALTIES,
    tile: int = 32,
    block: int = 128,
    interpret: bool = False,
    score_width=None,
    emit_regular=None,
) -> jnp.ndarray:
    """Wavefront scoring of packed streams with the on-device emission
    gather: only per-read scores leave the device — the analog of the
    result-mux tap at `output_select` (ScoreBank/ScoringModule_v1.1.v:
    102-107).

    Args:
      q: [N, L] int8 per-stream query codes, sentinel-padded (Q_PAD).
      stream: [N, T] int8 concatenated target chars (codes 0..3, +FLAG_BIT
        on each target's first char, 4 = pad), T % STEP_CHUNK == 0.
      emit_stream / emit_step: each read's (stream, last-char step);
        emit_step < 0 marks a zero-length read (score 0).
      tile: query rows one thread holds; longer queries chain tiles.
      block: streams per kernel program (a power of two).
      score_width: emulate the RTL's W-bit biased-register arithmetic
        including overflow wrap; scores match oracle.sw_score_single_biased.
      emit_regular: static (first, stride, count) strided-extract pattern
        from swtpu.bank.streams.detect_regular_emissions, or None.

    Returns [n_reads] int32 scores.
    """
    return _scores(q.T, stream.T, emit_stream, emit_step, penalties, tile,
                   block, interpret, score_width, emit_regular)


@functools.partial(jax.jit, static_argnames=_STATIC)
def sw_scores_stream_packed(
    q: jnp.ndarray,
    codes: jnp.ndarray,
    flags: jnp.ndarray,
    emit_stream: jnp.ndarray,
    emit_step: jnp.ndarray,
    penalties: Penalties = DEFAULT_PENALTIES,
    tile: int = 32,
    block: int = 128,
    interpret: bool = False,
    score_width=None,
    emit_regular=None,
) -> jnp.ndarray:
    """sw_scores_stream on the 2-bit wire format: the stream crosses H2D at
    2.5 bits/char (pack_stream_wire) and expands on device."""
    return _scores(q.T, unpack_stream_wire(codes, flags).T, emit_stream,
                   emit_step, penalties, tile, block, interpret, score_width,
                   emit_regular)


def unpack_stream_wire(codes: jnp.ndarray, flags: jnp.ndarray) -> jnp.ndarray:
    """Device-side inverse of swtpu.bank.streams.pack_stream_wire: expand
    4-bases/byte codes + 8-flags/byte bitmap back to the [N, T] int8 flagged
    char stream (the analog of the AFU's on-chip 2-bit unpack as it shifts
    bases into the array, capi_sample_aligner/hdl-verliog/afu.v:408)."""
    N, nb = codes.shape
    c = codes[:, :, None]
    shifts2 = (jnp.arange(4, dtype=jnp.uint8) * 2)[None, None, :]
    chars = ((c >> shifts2) & 3).reshape(N, nb * 4)
    f = flags[:, :, None]
    shifts1 = jnp.arange(8, dtype=jnp.uint8)[None, None, :]
    fbits = ((f >> shifts1) & 1).reshape(N, flags.shape[1] * 8)
    return (chars | (fbits << 3)).astype(jnp.int8)


def _gather_emissions(strip, emit_stream, emit_step, bias=0, regular=None):
    """[T, N] strip -> per-read scores (emit_step < 0 = zero-length read).
    The one emission-gather every scoring entry shares.  `bias` unbiases
    wrap-mode strips; zero-length reads stay at score 0 either way.

    regular: static (first, stride, count) from
    swtpu.bank.streams.detect_regular_emissions — read r emits at
    (r % N, first + (r // N) * stride), so read-order scores are a strided
    row slice reshaped row-major: [count, N].reshape(-1)[r] is exactly
    element (r // N, r % N).  This replaces the scattered gather with a
    strided slice touching only count*N*4 bytes."""
    if regular is not None:
        first, stride, count = regular
        ex = jax.lax.slice_in_dim(
            strip, first, first + (count - 1) * stride + 1, stride, axis=0
        )  # [count, N]
        return (ex.reshape(-1) - bias).astype(jnp.int32)
    live = emit_step >= 0
    safe_step = jnp.where(live, emit_step, 0)
    scores = strip[safe_step, emit_stream] - bias
    return jnp.where(live, scores, 0).astype(jnp.int32)
