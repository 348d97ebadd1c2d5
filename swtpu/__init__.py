"""swtpu — a Smith-Waterman scoring engine in JAX, for the GPU.

A JAX/XLA/Pallas framework with the capabilities of the
`ilirlikalla/Smith-Waterman-FPGA-module` reference design: batched, score-only
Smith-Waterman local alignment with affine (Gotoh) gaps, length-bucketed
sequence packing, ID-tagged result collection, top-K hit reporting, and
multi-device / multi-host data-parallel scaling.

Layer map (re-design of the reference's layers, SURVEY.md §1):

  reference layer                      swtpu equivalent
  -----------------------------------  -------------------------------------
  L1 SW_ProcessingElement (PE cell)    ops/ kernels: the Gotoh recurrence
  L2 ScoringModule (systolic array)    ops.pallas_stream (Triton wavefront)
                                       / ops.scan (plain lax.scan)
  L3 ScoreBank (feeders+dispatch)      bank/ (length buckets, packer, IDs)
  L4 CAPI AFU shell                    JAX runtime (device_put / jit dispatch)
  L5 RTL testbenches                   tests/ (golden-file parity)
  L6 host C runtime (main_test.c)      cli.py + runtime/ (native packer)
  L7 PSLSE emulation backend           testing/ (CPU mesh + fault injection)
  L8 data & oracles                    oracle.py + io/ (FASTA, 2-bit encode)
"""

from swtpu.config import SWConfig, Penalties, DEFAULT_PENALTIES
from swtpu.oracle import sw_score_single, sw_score_batch, score_many_vs_one

__version__ = "0.5.0"

__all__ = [
    "SWConfig",
    "Penalties",
    "DEFAULT_PENALTIES",
    "sw_score_single",
    "sw_score_batch",
    "score_many_vs_one",
    "ScoreBank",
    "ScoreResult",
]


def __getattr__(name):
    # heavier layers load lazily (they import jax)
    if name in ("ScoreBank", "ScoreResult"):
        from swtpu.bank import ScoreBank, ScoreResult

        return {"ScoreBank": ScoreBank, "ScoreResult": ScoreResult}[name]
    raise AttributeError(name)
