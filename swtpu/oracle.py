"""Exact software oracle for affine-gap (Gotoh) Smith-Waterman scoring.

This is the executable semantic contract of the whole framework — the
analog of the reference's oracle chain (data/sw-testing.py's
`swalign` pass and the ssearch36 golden files; SURVEY.md §0).  Every kernel
in swtpu must match it bit-exactly, and it in turn is validated against the
reference repo's bundled goldens (RTL `data/*_out.txt`, swalign
`data/sw_testing.txt`, ssearch36 `data/score.txt` / `data/score500.txt`) in
tests/test_oracle_parity.py.

Recurrence (merged insert/delete matrix, exactly the reference PE's
semantics — ScoreBank/SW_ProcessingElement_v1.0.v:109-299):

    s(i, j)  = match    if q[i] == t[j] else mismatch
    M[i][j]  = max(max(M[i-1][j-1], I[i-1][j-1]) + s(i, j), 0)
    I[i][j]  = max(max(M[i-1][j], M[i][j-1]) + gap_open + gap_extend,
                   max(I[i-1][j], I[i][j-1]) + gap_extend)
    score    = max over all (i, j) of M[i][j]

Reference quirks reproduced deliberately:

* Gap *opening* costs ``gap_open + gap_extend`` (−16 at defaults), not just
  ``gap_open`` (SW_ProcessingElement_v1.0.v:139, the "!X!" comment trail).
  This matches swalign's semantics and is required for golden parity.
* A single merged in-del matrix ``I`` serves both gap directions
  (SW_ProcessingElement_v1.0.v:126-129) instead of Gotoh's separate E/F.
* All boundary cells (virtual row −1 / column −1) hold 0 for *both* M and I
  (the RTL ties PE-chain inputs and diagonal registers to ZERO,
  SW_ProcessingElement_v1.0.v:156-164, 184-185).  Because M is clamped at
  zero and I only ever derives from M/I minus positive penalties, boundary
  I=0 vs −inf is provably indistinguishable in the final score, and the max
  over M cells alone equals the max over max(M, I) — the kernels exploit
  both facts.

The batch oracle is vectorized across pairs (numpy), looping the DP cells in
Python; it is the *correctness* anchor, not a performance path.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from swtpu.config import DEFAULT_PENALTIES, Penalties

NEG_INF = np.int32(-(2**30))


def sw_score_single(
    query: np.ndarray,
    target: np.ndarray,
    penalties: Penalties = DEFAULT_PENALTIES,
) -> int:
    """Score one query/target pair. Inputs are integer base codes (any
    alphabet — only equality matters). Plain O(m·n) loops; for tests."""
    q = np.asarray(query)
    t = np.asarray(target)
    ma, mi, go, ge = penalties.astuple()
    m, n = len(q), len(t)
    # One extra boundary row/col of zeros for both matrices (RTL ZERO ties).
    M = np.zeros((m + 1, n + 1), dtype=np.int64)
    I = np.zeros((m + 1, n + 1), dtype=np.int64)
    best = 0
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            s = ma if q[i - 1] == t[j - 1] else mi
            M[i, j] = max(max(M[i - 1, j - 1], I[i - 1, j - 1]) + s, 0)
            I[i, j] = max(
                max(M[i - 1, j], M[i, j - 1]) + go + ge,
                max(I[i - 1, j], I[i, j - 1]) + ge,
            )
            if M[i, j] > best:
                best = int(M[i, j])
    return best


def sw_score_batch(
    queries: np.ndarray,
    targets: np.ndarray,
    q_lens: Optional[np.ndarray] = None,
    t_lens: Optional[np.ndarray] = None,
    penalties: Penalties = DEFAULT_PENALTIES,
) -> np.ndarray:
    """Score a batch of pairs, vectorized across the batch dimension.

    Args:
      queries: [B, m_max] int array of base codes (padded).
      targets: [B, n_max] int array of base codes (padded).
      q_lens:  [B] true query lengths (defaults to full width).
      t_lens:  [B] true target lengths (defaults to full width).

    Returns: [B] int32 scores.

    Padding is handled with length masks: cells beyond a sequence's true
    length can never contribute to the score (their M is forced to 0 and
    their I to a large negative), mirroring how the RTL only clocks
    ``length`` bases through the array (ScoreBank/SM_Feeder2.v:148-171).
    """
    q = np.asarray(queries)
    t = np.asarray(targets)
    if q.ndim != 2 or t.ndim != 2 or q.shape[0] != t.shape[0]:
        raise ValueError(f"bad batch shapes {q.shape} vs {t.shape}")
    B, m = q.shape
    _, n = t.shape
    ma, mi, go, ge = (np.int64(x) for x in penalties.astuple())
    if q_lens is None:
        q_lens = np.full((B,), m, dtype=np.int64)
    if t_lens is None:
        t_lens = np.full((B,), n, dtype=np.int64)
    q_lens = np.asarray(q_lens, dtype=np.int64)
    t_lens = np.asarray(t_lens, dtype=np.int64)

    # Column state, vectorized over B: M_col[b, i], I_col[b, i] for i in 0..m
    # (index 0 = boundary row).  Iterate target positions (columns) outward,
    # query positions (rows) inward — the inner loop carries the serial
    # I-dependency exactly.
    M_col = np.zeros((B, m + 1), dtype=np.int64)
    I_col = np.zeros((B, m + 1), dtype=np.int64)
    best = np.zeros((B,), dtype=np.int64)
    neg = np.int64(NEG_INF)
    row_idx = np.arange(m)  # i-1 values
    q_valid = row_idx[None, :] < q_lens[:, None]  # [B, m]

    for j in range(n):
        col_valid = j < t_lens  # [B]
        tj = t[:, j]  # [B]
        s = np.where(q == tj[:, None], ma, mi)  # [B, m]
        M_new = np.zeros_like(M_col)
        I_new = np.zeros_like(I_col)
        # Boundary row i=0 of the new column: M=0, I=0 (RTL ZERO ties).
        for i in range(1, m + 1):
            diag = np.maximum(M_col[:, i - 1], I_col[:, i - 1])
            Mv = np.maximum(diag + s[:, i - 1], 0)
            Iv = np.maximum(
                np.maximum(M_new[:, i - 1], M_col[:, i]) + go + ge,
                np.maximum(I_new[:, i - 1], I_col[:, i]) + ge,
            )
            valid = col_valid & q_valid[:, i - 1]
            M_new[:, i] = np.where(valid, Mv, 0)
            I_new[:, i] = np.where(valid, Iv, neg)
            np.maximum(best, M_new[:, i], out=best)
        keep = col_valid
        M_col = np.where(keep[:, None], M_new, M_col)
        I_col = np.where(keep[:, None], I_new, I_col)
    return best.astype(np.int32)


def biased_view(scores: np.ndarray, score_width: int = 12) -> np.ndarray:
    """Render scores in the RTL's biased unsigned arithmetic: the hardware
    carries score + ZERO where ZERO = 2**(score_width-1) and reports
    `result - ZERO` (SW_ProcessingElement_v1.0.v:15-20,
    ScoreBank/ScoreBank_v1_tb.sv:280-281).  Values are reduced modulo the
    register width, reproducing the wrap a too-narrow SCORE_WIDTH would
    exhibit; for in-range scores this is the identity, which is what makes
    int32 kernels bit-compatible with the 12-bit hardware."""
    zero = 1 << (score_width - 1)
    mask = (1 << score_width) - 1
    return ((np.asarray(scores, np.int64) + zero) & mask) - zero


def sw_score_single_biased(
    query: np.ndarray,
    target: np.ndarray,
    penalties: Penalties = DEFAULT_PENALTIES,
    score_width: int = 12,
) -> int:
    """Score one pair in the RTL's *actual* register arithmetic: every
    quantity is a SCORE_WIDTH-bit unsigned value biased by ZERO =
    2**(score_width-1); additions wrap modulo 2**score_width; max is the
    unsigned compare; and the clamp-at-zero is the sign-bit test
    ``M_bus = M_score if M_score[W-1] else ZERO``
    (SW_ProcessingElement_v1.0.v:15-20, 88-97 of the score stage).

    Consequence: a score that crosses 2**(score_width-1)-1 wraps, loses its
    sign bit, and is clamped back to zero in that cell — the hardware's
    overflow behavior, reproduced here as the semantic contract for the
    kernels' ``state_dtype="int16_biased"`` mode.  For scores that stay in
    range this equals ``sw_score_single`` (and ``biased_view`` is the
    identity), which is what makes the int32 kernels bit-compatible with
    the 12-bit hardware on the reference datasets.
    """
    q = np.asarray(query)
    t = np.asarray(target)
    ma, mi, go, ge = penalties.astuple()
    w = score_width
    mask = (1 << w) - 1
    zero = 1 << (w - 1)  # biased representation of score 0
    m, n = len(q), len(t)
    # biased state, boundary = ZERO (the RTL ties chain inputs to ZERO)
    M = np.full((m + 1, n + 1), zero, dtype=np.int64)
    I = np.full((m + 1, n + 1), zero, dtype=np.int64)
    best = zero
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            s = ma if q[i - 1] == t[j - 1] else mi
            diag_max = max(M[i - 1, j - 1], I[i - 1, j - 1])  # unsigned max
            M_score = (diag_max + s) & mask  # wraps mod 2^W
            M[i, j] = M_score if (M_score & zero) else zero  # sign-bit clamp
            M_open = (max(M[i - 1, j], M[i, j - 1]) + go + ge) & mask
            I_extend = (max(I[i - 1, j], I[i, j - 1]) + ge) & mask
            I[i, j] = max(M_open, I_extend)
            best = max(best, M[i, j])
    return int(best - zero)


def score_many_vs_one(
    query: np.ndarray,
    targets: Sequence[np.ndarray],
    penalties: Penalties = DEFAULT_PENALTIES,
) -> np.ndarray:
    """Score many (ragged) targets against one query — the reference's
    main workload shape (one query FASTA vs a database FASTA,
    data/sw-testing.py:44-46)."""
    B = len(targets)
    if B == 0:
        return np.zeros((0,), dtype=np.int32)
    n_max = max(len(t) for t in targets)
    t_pad = np.zeros((B, n_max), dtype=np.int64)
    t_lens = np.zeros((B,), dtype=np.int64)
    for k, tt in enumerate(targets):
        t_pad[k, : len(tt)] = tt
        t_lens[k] = len(tt)
    q_tile = np.tile(np.asarray(query)[None, :], (B, 1))
    q_lens = np.full((B,), len(query), dtype=np.int64)
    return sw_score_batch(q_tile, t_pad, q_lens, t_lens, penalties)
