"""End-to-end demo mirroring the reference's run recipe
(capi_sample_aligner/software-C,C++/README:11-15: simulator + pslse +
./main_test -q query -l library): generate data, score on the accelerator
path, verify against the oracle, report top hits and throughput."""

import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np

from swtpu.bank import ScoreBank
from swtpu.cli import main as cli
from swtpu.io import encode_seq, read_query_and_db, read_fasta
from swtpu.oracle import score_many_vs_one


def run():
    with tempfile.TemporaryDirectory() as td:
        fa = Path(td) / "demo.fa"
        cli(["generate", "-n", "200", "-L", "128", "-o", str(fa), "--seed", "42"])

        qrec = read_fasta(fa)[0]
        _, db = read_query_and_db(fa)
        query = encode_seq(qrec.seq)
        targets = [encode_seq(r.seq) for r in db]

        bank = ScoreBank()  # the wavefront kernel on the GPU, scan elsewhere
        res = bank.score_database(query, targets)
        want = score_many_vs_one(query, targets)
        assert (res.scores == want).all(), "kernel != oracle"

        print(f"scored {len(targets)} reads: {res.gcups:.2f} GCUPS, "
              f"pad efficiency {res.cells/res.padded_cells:.1%}")
        for s, i in res.top_k(5):
            print(f"  top hit >{db[i].name}: {s}")


if __name__ == "__main__":
    run()
