"""Observability: per-batch event log, GCUPS meters, profiler hooks.

The reference instruments four ways (SURVEY.md §5): MMIO-readable trace
arrays, testbench `$fdisplay` score logs (which *are* the golden files),
a cycle-accounting debug block printing per-alignment runtime
(capi_sample_aligner/hdl-verliog/afu.v:497-532), and PSLSE's binary
debug.log with an offline parser.  swtpu's equivalents:

  * EventLog — structured JSONL event records (the debug.log + parser,
    human-readable from the start);
  * GcupsMeter — real-cell throughput accounting (the cycle counter);
  * profile_trace — context manager around jax.profiler (the waveforms).

GCUPS counts *real* cells (sum len_q*len_t), never padded capacity, so
bucketing efficiency is visible rather than flattering (SURVEY.md §7).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from pathlib import Path
from typing import IO, Iterator, List, Optional, Union


@dataclasses.dataclass
class BatchEvent:
    kind: str  # "batch" | "bucket" | "job" | ...
    t_wall: float
    elapsed_s: float
    reads: int = 0
    cells: int = 0
    padded_cells: int = 0
    note: str = ""

    @property
    def gcups(self) -> float:
        return self.cells / self.elapsed_s / 1e9 if self.elapsed_s > 0 else 0.0

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["gcups"] = round(self.gcups, 3)
        return json.dumps(d)


class EventLog:
    """Append-only JSONL event log with a parser (debug.log analog)."""

    def __init__(self, path: Optional[Union[str, Path]] = None):
        self.path = Path(path) if path else None
        self.events: List[BatchEvent] = []
        self._fh: Optional[IO] = None
        if self.path:
            self._fh = open(self.path, "a")

    def emit(self, event: BatchEvent) -> None:
        self.events.append(event)
        if self._fh:
            self._fh.write(event.to_json() + "\n")
            self._fh.flush()

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None

    @staticmethod
    def parse(path: Union[str, Path]) -> List[BatchEvent]:
        out: List[BatchEvent] = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                d = json.loads(line)
                d.pop("gcups", None)
                out.append(BatchEvent(**d))
        return out


class GcupsMeter:
    """Running real-cell throughput accounting."""

    def __init__(self) -> None:
        self.cells = 0
        self.padded_cells = 0
        self.reads = 0
        self.elapsed_s = 0.0

    @contextlib.contextmanager
    def batch(self, cells: int, padded_cells: int, reads: int) -> Iterator[None]:
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self.cells += cells
        self.padded_cells += padded_cells
        self.reads += reads
        self.elapsed_s += dt

    @property
    def gcups(self) -> float:
        return self.cells / self.elapsed_s / 1e9 if self.elapsed_s > 0 else 0.0

    @property
    def reads_per_s(self) -> float:
        return self.reads / self.elapsed_s if self.elapsed_s > 0 else 0.0

    @property
    def pad_efficiency(self) -> float:
        return self.cells / self.padded_cells if self.padded_cells else 0.0


@contextlib.contextmanager
def profile_trace(log_dir: Optional[Union[str, Path]]) -> Iterator[None]:
    """jax.profiler trace (xprof/Perfetto) around a scoring region — the
    waveform dump of the accelerator world.  No-op when log_dir is None."""
    if not log_dir:
        yield
        return
    import jax

    jax.profiler.start_trace(str(log_dir))
    try:
        yield
    finally:
        jax.profiler.stop_trace()
