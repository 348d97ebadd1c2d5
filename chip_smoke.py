"""Smoke test of swtpu's scoring path on the GPU, through its user entry points.

    python chip_smoke.py              # one card: phases 1-5 below
    python chip_smoke.py --cards 4    # only the four-card sharded path

One process drives every card.  The library is a read set made from --seed
(lengths uniform in 100-250 nt) and held on the card.  Every phase checks its
scores bit-exactly against the numpy oracle on a seeded sample plus the top
hits, and any failure ends the run with a non-zero exit.  The last line of
output is one JSON object naming the device.  Without a GPU the script fails
before it prints any result.

Phases on one card:
  1. main path: ScoreBank().score_database and `swtpu score` on 2^20 reads
     against one 128-nt query;
  2. resident serving: `swtpu serve --input` answering SEQ/TOP queries of
     32-512 nt;
  3. long query: a 512-nt query (chained tiles) against 2^18 reads;
  4. wrap-parity: score_width=12 (and 9, where the wrap fires) on 2^16 reads;
  5. the wavefront kernel against the plain lax.scan on phase 1's library,
     timed in turns (plain, kernel, kernel, plain).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"  # .gitignore lists build/


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    raise SystemExit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def make_library(rng, n_reads: int, lo: int = 100, hi: int = 250):
    """[n, hi] int8 codes (T_PAD past each length) and [n] int32 lengths."""
    from swtpu.ops.common import T_PAD

    lens = rng.integers(lo, hi + 1, size=n_reads).astype(np.int32)
    mat = rng.integers(0, 4, size=(n_reads, hi), dtype=np.int8)
    mat[np.arange(hi)[None, :] >= lens[:, None]] = T_PAD
    return mat, lens


def oracle_check(what, query, mat, lens, scores, idx, width=None):
    """Scores of reads `idx` must equal the oracle's, bit for bit."""
    from swtpu.oracle import sw_score_batch, sw_score_single_biased

    idx = np.unique(np.asarray(idx))
    if width is None:
        want = sw_score_batch(
            np.tile(query, (len(idx), 1)), mat[idx],
            np.full(len(idx), len(query)), lens[idx],
        )
    else:
        want = np.array([
            sw_score_single_biased(query, mat[i, : lens[i]], score_width=width)
            for i in idx
        ], np.int32)
    got = np.asarray(scores)[idx]
    bad = np.flatnonzero(got != want)
    check(not len(bad), f"{what}: {len(bad)}/{len(idx)} reads differ from "
          f"the oracle (first read {idx[bad[0]] if len(bad) else -1})")
    print(f"  {what}: {len(idx)} reads bit-exact vs oracle")


def peak_bytes() -> int:
    import jax

    return max(int((d.memory_stats() or {}).get("peak_bytes_in_use", 0))
               for d in jax.local_devices())


def report(phase, setup_s, wall_s, n_reads, cells):
    print(f"  {phase}: set-up (compile + first call) {setup_s:.3f} s; "
          f"warm {wall_s:.6f} s; {n_reads / wall_s:.1f} reads/s; "
          f"{cells / wall_s / 1e9:.2f} GCUPS over real cells; "
          f"peak device memory {peak_bytes()} B", flush=True)


def timed(fn, reps=2):
    """(first-call seconds, best warm seconds, last result); results are
    host numpy arrays, so the device work has finished when fn returns."""
    t0 = time.perf_counter()
    out = fn()
    first = time.perf_counter() - t0
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        best = min(best, time.perf_counter() - t0)
    return first, best, out


def write_fasta(path, names, mat, lens):
    from swtpu.io.encode import CODE_BASES

    lut = np.array([ord(CODE_BASES[c]) for c in range(4)] + [ord("N")] * 4,
                   np.uint8)
    with open(path, "wb") as f:
        for name, row, n in zip(names, mat, lens):
            f.write(b">" + name.encode() + b"\n" + lut[row[:n]].tobytes()
                    + b"\n")


def seq_text(codes) -> str:
    from swtpu.io.encode import decode_seq

    return decode_seq(codes)


def run_cli(argv):
    """swtpu.cli.main in-process with stdout captured."""
    from swtpu.cli import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    check(rc == 0, f"swtpu {argv[0]} exited {rc}")
    return buf.getvalue()


def phase_main(rng, query, mat, lens):
    from swtpu.bank import ScoreBank
    from swtpu.testing.goldens import parse_rtl_out_file

    print("phase 1: main path (ScoreBank.score_database, swtpu score)")
    bank = ScoreBank()
    R = len(lens)
    cells = int(lens.astype(np.int64).sum()) * len(query)
    first, wall, res = timed(lambda: bank.score_database(query, (mat, lens)))
    scores = res.scores
    check(scores.shape == (R,) and scores.dtype == np.int32,
          f"scores shape {scores.shape} {scores.dtype}")
    check(0 <= scores.min() and scores.max() <= 5 * len(query),
          "scores outside [0, match * query length]")
    report("ScoreBank.score_database", first, wall, R, cells)
    top = [i for _, i in res.top_k(10)]
    oracle_check("score_database", query, mat, lens, scores,
                 np.concatenate([rng.choice(R, 2000, replace=False), top]))
    # the CLI on a FASTA of the same library
    names = [f"db{i}" for i in range(R)]
    write_fasta(WORK / "library.fa", names, mat, lens)
    (WORK / "query.fa").write_text(">query\n" + seq_text(query) + "\n")
    out = WORK / "scores.txt"
    t0 = time.perf_counter()
    run_cli(["score", "-q", str(WORK / "query.fa"),
             "-l", str(WORK / "library.fa"), "-o", str(out), "--topk", "10"])
    cli_s = time.perf_counter() - t0
    got = parse_rtl_out_file(out)
    cli_scores = np.array([got[n] for n in names], np.int32)
    check(np.array_equal(cli_scores, scores),
          "swtpu score output differs from ScoreBank.score_database")
    print(f"  swtpu score: {R} reads in {cli_s:.3f} s wall (FASTA parse, "
          "compile and output included); equal to score_database")
    return scores, names


def phase_serve(rng, mat, lens, names):
    print("phase 2: resident serving (swtpu serve --input)")
    R = len(lens)
    qlens = (32, 64, 100, 128, 200, 256, 400, 512)
    queries = [rng.integers(0, 4, size=n).astype(np.int8) for n in qlens]
    seq_at = {1, 6}  # full score vectors for these; TOP 10 for the rest
    cmds = [
        (f"SEQ {seq_text(q)}" if i in seq_at else f"TOP 10 {seq_text(q)}")
        for i, q in enumerate(queries)
    ]
    (WORK / "serve.in").write_text("\n".join(cmds + ["QUIT"]) + "\n")
    t0 = time.perf_counter()
    text = run_cli(["serve", "-l", str(WORK / "library.fa"),
                    "--input", str(WORK / "serve.in")])
    wall = time.perf_counter() - t0
    lines = text.splitlines()
    index = {n: i for i, n in enumerate(names)}
    score_re = re.compile(r">(\S+) score:\s+(-?\d+)")
    pos = 0
    cells = 0
    for i, q in enumerate(queries):
        n = R if i in seq_at else 10
        block = lines[pos : pos + n]
        pos += n
        check(len(block) == n and not any("error" in b for b in block),
              f"serve query {i}: short or failed response")
        hits = [score_re.search(b) for b in block]
        check(all(hits), f"serve query {i}: unparsable response")
        ids = np.array([index[h.group(1)] for h in hits])
        got = np.zeros(R, np.int32)
        got[ids] = [int(h.group(2)) for h in hits]
        sample = (rng.choice(R, 300, replace=False) if i in seq_at else ids)
        if i in seq_at:
            check(np.array_equal(ids, np.arange(R)), "SEQ order differs")
            sample = np.concatenate([sample, np.argsort(-got)[:10]])
        oracle_check(f"serve {'SEQ' if i in seq_at else 'TOP'} "
                     f"{len(q)} nt", q, mat, lens, got, sample)
        cells += len(q) * int(lens.astype(np.int64).sum())
    print(f"  swtpu serve: {len(queries)} queries on {R} resident reads in "
          f"{wall:.3f} s wall (FASTA parse, load and compile included); "
          f"{cells / wall / 1e9:.2f} GCUPS over real cells, all included; "
          f"peak device memory {peak_bytes()} B", flush=True)


def phase_long(rng, mat, lens):
    from swtpu.bank import ScoreBank

    print("phase 3: long query (512 nt, chained tiles)")
    R = 1 << 18
    mat, lens = mat[:R], lens[:R]
    query = rng.integers(0, 4, size=512).astype(np.int8)
    bank = ScoreBank()
    first, wall, res = timed(lambda: bank.score_database(query, (mat, lens)))
    report("score_database 512 nt", first, wall, R,
           int(lens.astype(np.int64).sum()) * 512)
    top = [i for _, i in res.top_k(10)]
    oracle_check("long query", query, mat, lens, res.scores,
                 np.concatenate([rng.choice(R, 1000, replace=False), top]))


def phase_wrap(rng, query, mat, lens):
    from swtpu.bank import ScoreBank
    from swtpu.config import SWConfig

    print("phase 4: wrap-parity (score_width)")
    R = 1 << 16
    mat, lens = mat[:R].copy(), lens[:R].copy()
    # plant reads that contain the query's head: scores up to 640 cross a
    # 9-bit register's 255 ceiling, where the wrap fires
    planted = np.arange(0, R, R // 32)
    for i in planted:
        k = int(rng.integers(60, 129))
        mat[i, :k], lens[i] = query[:k], max(lens[i], k)
    exact = ScoreBank().score_database(query, (mat, lens)).scores
    for width in (12, 9):
        bank = ScoreBank(SWConfig(score_width=width))
        first, wall, res = timed(
            lambda: bank.score_database(query, (mat, lens)))
        report(f"score_width={width}", first, wall, R,
               int(lens.astype(np.int64).sum()) * len(query))
        fired = int((res.scores != exact).sum())
        print(f"  score_width={width}: wrap changed {fired} scores")
        if width == 9:
            check(fired > 0, "score_width=9 never wrapped")
        top = [i for _, i in res.top_k(10)]
        oracle_check(f"score_width={width}", query, mat, lens, res.scores,
                     np.concatenate([rng.choice(R, 200, replace=False),
                                     planted, top]), width=width)


def phase_against_plain(query, mat, lens, kernel_scores):
    from swtpu.bank import ScoreBank

    print("phase 5: wavefront kernel against the plain lax.scan, in turns")
    R = len(lens)
    cells = int(lens.astype(np.int64).sum()) * len(query)
    banks = {"plain": ScoreBank(backend="scan"), "kernel": ScoreBank()}
    setup = {}
    for name, bank in banks.items():
        t0 = time.perf_counter()
        out = bank.score_database(query, (mat, lens)).scores
        setup[name] = time.perf_counter() - t0
        check(np.array_equal(out, kernel_scores),
              f"{name} scores differ from phase 1")
    times = {"plain": [], "kernel": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        t0 = time.perf_counter()
        banks[name].score_database(query, (mat, lens))
        times[name].append(time.perf_counter() - t0)
    for name, ts in times.items():
        best = min(ts)
        print(f"  {name}: set-up {setup[name]:.3f} s; warm {ts} s; "
              f"{R / best:.1f} reads/s; {cells / best / 1e9:.2f} GCUPS "
              "end to end")
    ratio = min(times["plain"]) / min(times["kernel"])
    print(f"  kernel is {ratio:.2f}x the plain scan end to end; all "
          f"{R} scores equal")
    # device only: the kernel on a resident database against the scan on
    # its padded length buckets already on the card; scores come back in
    # both, and the host packing is left out
    import jax

    from swtpu.bank.packer import pack_many_vs_one
    from swtpu.ops.scan import sw_scores_scan

    buckets = [
        (jax.device_put(b.q), jax.device_put(b.t))
        for b in pack_many_vs_one(
            query, mat, banks["plain"].config.target_buckets, lens=lens)
    ]
    db = banks["kernel"].load_database((mat, lens))
    runs = {
        "plain": lambda: [np.asarray(sw_scores_scan(q, t)) for q, t in buckets],
        "kernel": lambda: banks["kernel"].score_loaded(query, db).scores,
    }
    check(np.array_equal(runs["kernel"](), kernel_scores),
          "resident kernel scores differ from phase 1")
    runs["plain"]()
    times = {"plain": [], "kernel": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        t0 = time.perf_counter()
        runs[name]()
        times[name].append(time.perf_counter() - t0)
    print(f"  plain buckets: {[tuple(t.shape) for _, t in buckets]}")
    for name, ts in times.items():
        print(f"  {name}, device only: warm {ts} s; "
              f"{cells / min(ts) / 1e9:.2f} GCUPS over real cells")
    print(f"  kernel is {min(times['plain']) / min(times['kernel']):.2f}x "
          f"the plain scan on the device; peak device memory {peak_bytes()} B")
    return ratio


def four_cards(rng, n_reads=1 << 22):
    import jax

    from swtpu.bank import ScoreBank
    from swtpu.parallel import make_mesh
    from swtpu.parallel.multihost import score_database_multihost

    print("four cards: load_database_sharded, score_loaded_sharded, "
          "topk_loaded_sharded, score_database_multihost")
    check(len(jax.devices()) >= 4, f"{len(jax.devices())} devices, need 4")
    R = n_reads
    mat, lens = make_library(rng, R)
    query = rng.integers(0, 4, size=128).astype(np.int8)
    cells = int(lens.astype(np.int64).sum()) * len(query)
    mesh = make_mesh(4)
    bank = ScoreBank()
    t0 = time.perf_counter()
    db = bank.load_database_sharded((mat, lens), mesh)
    print(f"  sharded load: {time.perf_counter() - t0:.3f} s")
    first, wall, res = timed(lambda: bank.score_loaded_sharded(query, db))
    report("score_loaded_sharded", first, wall, R, cells)
    first, wall, top = timed(
        lambda: np.asarray(bank.topk_loaded_sharded(query, db, k=10)))
    report("topk_loaded_sharded", first, wall, R, cells)
    ids = np.arange(R, dtype=np.int32)
    first, wall, (ms, mids, mloc) = timed(lambda: score_database_multihost(
        query, (mat, lens), ids, mesh=mesh, k=10, backend=bank.backend))
    report("score_database_multihost", first, wall, R, cells)
    # the one-card run of the same library
    first, wall, one = timed(lambda: bank.score_database(query, (mat, lens)),
                             reps=1)
    report("one card, score_database", first, wall, R, cells)
    check(np.array_equal(res.scores, one.scores),
          "sharded scores differ from the one-card run")
    check(np.array_equal(mloc, one.scores),
          "multihost scores differ from the one-card run")
    want_top = one.top_k(10)
    check([tuple(t) for t in top.tolist()] == want_top,
          "sharded top-10 differs from the one-card run")
    check(list(zip(ms.tolist(), mids.tolist())) == want_top,
          "multihost top-10 differs from the one-card run")
    print(f"  sharded and multihost scores and top-10 equal the one-card "
          f"run over all {R} reads")
    oracle_check("four cards", query, mat, lens, one.scores,
                 np.concatenate([rng.choice(R, 2000, replace=False),
                                 [i for _, i in want_top]]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import jax

    devs = jax.devices()
    print(f"platform {devs[0].platform}; device_kind {devs[0].device_kind}; "
          f"count {len(devs)}")
    if devs[0].platform != "gpu":
        fail(f"no GPU: JAX's first device is on {devs[0].platform!r}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    print(smi)
    from swtpu.device import enable_compile_cache, kernel_plan
    from swtpu.runtime.native import native_available

    print(f"jax {jax.__version__}; compile cache {enable_compile_cache()}")
    print(f"native packer built: {native_available()}")
    plan = kernel_plan()
    print(f"platform table: {plan}")
    check(plan.backend == "stream" and not plan.interpret,
          "the platform table does not run the compiled kernel here")
    WORK.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    t_start = time.perf_counter()
    try:
        if args.cards == 4:
            four_cards(rng)
        else:
            mat, lens = make_library(rng, 1 << 20)
            query = rng.integers(0, 4, size=128).astype(np.int8)
            scores, names = phase_main(rng, query, mat, lens)
            phase_serve(rng, mat, lens, names)
            phase_long(rng, mat, lens)
            phase_wrap(rng, query, mat, lens)
            phase_against_plain(query, mat, lens, scores)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    print(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
