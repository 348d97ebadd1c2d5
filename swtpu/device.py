"""One table from JAX platform to scoring kernel and its knobs.

Every consumer (ScoreBank, sharded serving, multi-host, the CLI) reads its
kernel choice here instead of testing the platform itself.  A platform
missing from the table is an error, never a silent fallback.

The GPU row was measured on one NVIDIA H100 (PERF.md): the Triton
wavefront kernel against the plain `lax.scan` path, and the tile height,
block width and stream count that kernel runs fastest at.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path


@dataclasses.dataclass(frozen=True)
class KernelPlan:
    """backend: what ScoreBank(backend="auto") resolves to ("stream" =
    the wavefront kernel, "scan" = plain lax.scan).
    interpret: run Pallas kernels in the interpreter (CPU only).
    streams: most streams one dispatch packs a database into.
    tile: query rows one thread holds; longer queries chain tiles.
    block: streams per kernel program (a power of two)."""

    backend: str
    interpret: bool
    streams: int
    tile: int
    block: int


PLANS = {
    # the CPU runs the scan; a stream kernel there runs in the interpreter
    # at sizes small enough for tests
    "cpu": KernelPlan("scan", True, streams=8, tile=16, block=8),
    # tile 64 against 32/128 and 32768 streams against 65536/131072: the
    # fastest on one H100 at 2^20 reads of 100-250 nt (PERF.md); fewer
    # streams keep small databases better balanced
    "gpu": KernelPlan("stream", False, streams=32768, tile=64, block=128),
}


def kernel_plan(platform: str | None = None) -> KernelPlan:
    """The plan for `platform` (default: JAX's default backend)."""
    if platform is None:
        import jax

        platform = jax.default_backend()
    try:
        return PLANS[platform]
    except KeyError:
        raise ValueError(
            f"no scoring kernel for platform {platform!r} "
            f"(known: {', '.join(sorted(PLANS))})"
        ) from None


def stream_count(n_reads: int, plan: KernelPlan) -> int:
    """Streams for a dispatch of `n_reads` reads: the plan's count, cut to
    whole blocks of at most one read per stream for small databases."""
    blocks = -(-max(int(n_reads), 1) // plan.block)
    return min(plan.streams, blocks * plan.block)


CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
CACHE_DIR = Path(__file__).resolve().parent.parent / ".jaxcache"


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache and return its directory.

    If JAX_COMPILATION_CACHE_DIR is set, JAX already reads it and nothing
    is changed.  Otherwise the cache goes to <checkout>/.jaxcache, a fixed
    path, so later runs from the same checkout find it again."""
    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    return str(CACHE_DIR)
