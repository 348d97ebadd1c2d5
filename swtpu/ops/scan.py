"""Batched Smith-Waterman scoring as a `lax.scan` over target columns.

This is the portable JAX formulation of the recurrence (SURVEY.md §7 step 2)
— the plain reference the wavefront kernel is measured against, and the
backend wherever no kernel runs.  It is the "ScoringModule" of swtpu in
functional form: where the FPGA assigns one
query base per processing element and streams target bases one per cycle
(ScoreBank/ScoringModule_v1.1.v:155-235), here the *batch of pairs* is the
vector dimension and one `scan` step computes an entire DP column (all query
rows) for every pair at once.

The intra-column serial dependency of the merged in-del matrix

    I[i][j] = max(base[i], I[i-1][j] + gap_extend)

is a max-plus (tropical) prefix scan along the query dimension; it is
evaluated in log2(m) Hillis-Steele steps of shift+add+max, which XLA
vectorizes — the analog of the ripple the PE chain resolves with its
per-cycle systolic hand-off (SW_ProcessingElement_v1.0.v:126-129).

Inputs must follow the sentinel-padding contract (swtpu.ops.common): pads
never match, so no masks appear anywhere in the recurrence.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from swtpu.config import DEFAULT_PENALTIES, Penalties


def _shift_down(x: jnp.ndarray, fill) -> jnp.ndarray:
    """Shift one step along the query axis (axis 1): out[:, 0] = fill,
    out[:, i] = x[:, i-1].  The 'comes from the previous PE' hand-off."""
    pad = jnp.full((x.shape[0], 1), fill, dtype=x.dtype)
    return jnp.concatenate([pad, x[:, :-1]], axis=1)


def _maxplus_prefix(base: jnp.ndarray, ge: int) -> jnp.ndarray:
    """I[i] = max_{k<=i} base[k] + (i-k)*ge, vectorized in log2(m) steps."""
    m = base.shape[1]
    x = base
    shift = 1
    neg = jnp.array(jnp.iinfo(base.dtype).min // 4, dtype=base.dtype)
    while shift < m:
        pad = jnp.full((x.shape[0], shift), neg, dtype=x.dtype)
        shifted = jnp.concatenate([pad, x[:, :-shift]], axis=1)
        x = jnp.maximum(x, shifted + jnp.array(shift * ge, dtype=x.dtype))
        shift *= 2
    return x


@functools.partial(jax.jit, static_argnames=("penalties", "score_width"))
def sw_scores_scan(
    q: jnp.ndarray,
    t: jnp.ndarray,
    penalties: Penalties = DEFAULT_PENALTIES,
    score_width=None,
) -> jnp.ndarray:
    """Score a batch of (query, target) pairs.

    Args:
      q: [B, m] int base codes, sentinel-padded (Q_PAD).
      t: [B, n] int base codes, sentinel-padded (T_PAD).
      penalties: static scoring penalties.
      score_width: emulate the RTL's W-bit biased-register arithmetic
        including overflow wrap + sign-bit clamp (oracle:
        `sw_score_single_biased`; SW_ProcessingElement_v1.0.v:15-20).
        None = exact int32 scoring.

    Returns: [B] int32 local-alignment scores.
    """
    ma, mi, go, ge = penalties.astuple()
    dt = jnp.int32
    q = q.astype(dt)
    t = t.astype(dt)
    B, m = q.shape
    neg = jnp.array(jnp.iinfo(dt).min // 4, dtype=dt)
    zero = jnp.array(0, dt)
    if score_width is not None:
        # SCORE_WIDTH wrap-parity mode: state holds W-bit *biased unsigned*
        # values (score + 2^(W-1)) in 32-bit lanes — the RTL's register
        # width is emulated, not stored.  Only the M update needs the wrap
        # (`& mask`) + sign-bit clamp (the M_bus select): the I chain
        # provably never wraps step-wise, because every cell refreshes it
        # with M_open >= ZERO + open + extend > 0 (requires
        # 2^(W-1) >= |open+extend| + |extend|, checked below), so its
        # max-plus prefix scan runs in plain arithmetic — masking inside the
        # scan would be WRONG: a k-jump (x + k*ge) can dip below zero and
        # wrap even though no sequential step would.
        if not 2 <= score_width <= 30:
            raise ValueError(
                f"score_width={score_width} out of range (need 2..30)"
            )
        if (1 << (score_width - 1)) + (go + ge) + ge < 0:
            raise ValueError(
                f"score_width={score_width} too narrow for penalties "
                f"(need 2^(W-1) >= {-(go + 2 * ge)})"
            )
        mask = jnp.array((1 << score_width) - 1, dt)
        zero = jnp.array(1 << (score_width - 1), dt)

    def m_update(x):
        if score_width is None:
            return jnp.maximum(x, 0)
        ms = x & mask
        return jnp.where((ms & zero) != 0, ms, zero)

    # Boundary I[-1][j] = 0 (the RTL ties every chain input to ZERO,
    # SW_ProcessingElement_v1.0.v:156-164): contributes candidate 0+ge to
    # row 0 of every column's prefix scan.
    i0_bias = jnp.where(
        jnp.arange(m)[None, :] == 0, zero + jnp.array(ge, dt), neg
    )

    def step(carry, t_col):
        M, I, H = carry
        s = jnp.where(q == t_col[:, None], ma, mi).astype(dt)
        diag = jnp.maximum(M, I)
        diag_s = _shift_down(diag, zero)
        M_new = m_update(diag_s + s)
        M_up = _shift_down(M_new, zero)
        base = jnp.maximum(
            jnp.maximum(M_up, M) + jnp.array(go + ge, dt),
            jnp.maximum(I + jnp.array(ge, dt), i0_bias),
        )
        I_new = _maxplus_prefix(base, ge)
        H = jnp.maximum(H, M_new)
        return (M_new, I_new, H), None

    # boundary column j=-1: M = I = 0 (the RTL ZERO tie)
    init = (jnp.full((B, m), zero, dt),) * 3
    (_, _, H), _ = jax.lax.scan(step, init, t.T)
    return jnp.max(H, axis=1) - zero
