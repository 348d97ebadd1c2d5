"""Unified configuration for swtpu.

The reference scatters configuration over four mechanisms (SURVEY.md §5):
Verilog parameters (ScoreBank/ScoreBank_v2.v:12-29), testbench `define`s
(ScoreBank/ScoreBank_v1_tb.sv:16-39), the PSLSE `pslse.parms` randomization
file, and host getopt flags (capi_sample_aligner/software-C,C++/src/
main_test.c:231-239).  swtpu carries all of it in one dataclass.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Penalties:
    """Affine (Gotoh) gap scoring penalties, signed and *added* to scores.

    Defaults mirror the reference testbench / oracle configuration
    (ScoreBank/ScoreBank_v1_tb.sv:16-19, data/sw-testing.py:31-34,
    data/ssearch36_command — "+5/-4 matrix, open/ext: -12/-4").

    Note the reference quirk reproduced throughout swtpu: *opening* a gap
    costs ``gap_open + gap_extend`` (= -16 by default), matching both the
    RTL (ScoreBank/SW_ProcessingElement_v1.0.v:139, the "!X!" comment) and
    the `swalign` library semantics the RTL was debugged against.
    """

    match: int = 5
    mismatch: int = -4
    gap_open: int = -12
    gap_extend: int = -4

    def astuple(self) -> Tuple[int, int, int, int]:
        return (self.match, self.mismatch, self.gap_open, self.gap_extend)


DEFAULT_PENALTIES = Penalties()


@dataclasses.dataclass(frozen=True)
class SWConfig:
    """Top-level framework configuration.

    Attributes:
      penalties: scoring penalties (see :class:`Penalties`).
      target_buckets: static target-length buckets the scan path rounds
        reads up to — the analog of ``TARGET_LENGTH``
        (ScoreBank/ScoreBank_v2.v:16).
      query_buckets: the scan path's query-length buckets for pairs.
      mesh_shape / mesh_axes: device mesh for data-parallel database
        sharding (the multi-module / multi-card scaling axis; the analog of
        ``MODULES`` in ScoreBank/ScoreBank_v2.v:17).
      seed: RNG seed for data generation and fault injection, like
        PSLSE's ``SEED`` parm (pslse-master/pslse/pslse.parms).
      strict_n_parity: if True, unknown bases ('N' etc.) encode to 0b00
        exactly like the reference host encoder (software-C,C++/include/
        aligner_Header.c:34-39 — its comment says "treat as A" but 0b00 is
        T's code).  Scoring only cares about equality, so this only matters
        when diffing against reference-encoded outputs.
    """

    penalties: Penalties = DEFAULT_PENALTIES
    target_buckets: Sequence[int] = (32, 128, 512, 2048)
    # the top rung matches LEN_WIDTH=12 -> 4095-base intent (ScoreBank_v2.v:14-15)
    query_buckets: Sequence[int] = (32, 128, 512, 2048, 4096)
    mesh_shape: Optional[Tuple[int, ...]] = None
    mesh_axes: Tuple[str, ...] = ("data",)
    seed: int = 0
    strict_n_parity: bool = True
    # ship stream batches host->device 2-bit packed (4 bases/byte + flag
    # bitmap), expanding on device — the reference's transfer packing
    # (aligner_Header.c:30-41); cuts host-to-device bytes 3.2x
    wire_2bit: bool = True
    # query rows one thread of the stream kernel holds (longer queries
    # chain tiles); 0 = the platform table's (swtpu.device)
    stream_tile: int = 0
    # reads per pipelined stream dispatch in score_database (0 = one
    # monolithic dispatch).  With chunking, the host packs chunk i+1 while
    # chunk i's H2D + kernel are in flight (JAX async dispatch) — the
    # feeder double-buffering analog (SM_Feeder2.v:104-110 staging buffer,
    # dma.v:472-491 pipelined tagged reads).  Chunk stream lengths snap to
    # a power-of-two ladder so every equal rung reuses one compiled
    # executable.
    stream_chunk_reads: int = 0
    # most streams one stream-kernel dispatch packs a database into;
    # 0 = the platform table's (swtpu.device)
    streams: int = 0
    # SCORE_WIDTH wrap-parity: when set, score in the RTL's W-bit biased
    # register arithmetic including overflow wrap + sign-bit clamp
    # (SW_ProcessingElement_v1.0.v:15-20), on either backend.  None
    # (default) = exact int32 scoring, which is bit-identical to the 12-bit
    # hardware for in-range scores.
    score_width: Optional[int] = None
