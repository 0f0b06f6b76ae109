"""Trained-model scanner parity: scan.raw record-for-record against the
reference binary on the CONVERGED tRNA model — the regime `elem train`
hands to `scan`.

Golden provenance (generated on this machine, reference built per
BASELINE.md):

  RNAelem scan -f trna76.fq -q tests/golden/trna_noshuffle_ref.model \
      -t 1 --out1 tests/golden/trna_scan_ref.raw

where trna76.fq is material/positive.fa (T->U, flat '+' qualities,
has-motif sentinel '!'; tests/test_lbfgsb_golden._write_trna_fq).
Reference self-timing: 7.87 s single-core for the 76 reads
(motif_scanner.hpp:948), recorded in BASELINE.md as the scan baseline.
"""
import io
import os

import numpy as np
import pytest

from rnaelem_tpu.model import io as MIO
from rnaelem_tpu.scan.driver import Scanner

from tests.test_lbfgsb_golden import _write_trna_fq
from tests.test_scan_golden import parse_raw, vec

HERE = os.path.dirname(__file__)
GOLD = os.path.join(HERE, "golden")


@pytest.mark.slow
def test_trained_model_scan_matches_reference(tmp_path):
    fq = str(tmp_path / "trna76.fq")
    assert _write_trna_fq(fq) == 76
    cfg, params = MIO.read_model(
        os.path.join(GOLD, "trna_noshuffle_ref.model"), Lp=96,
        dtype="float64")
    buf, log = io.StringIO(), io.StringIO()
    Scanner(cfg, params).scan(fq, buf, log=log)
    mine = parse_raw(buf.getvalue())
    with open(os.path.join(GOLD, "trna_scan_ref.raw")) as f:
        gold = parse_raw(f.read())
    assert len(mine) == len(gold) == 76
    n_path_diff = 0
    for m, g in zip(mine, gold):
        assert m["seq"] == g["seq"]
        # posterior vectors at the enforced tolerance (see BASELINE.md
        # "Equivalence criteria": atol 2e-4 / rtol 1e-3 on log posteriors)
        for key in ("start", "end", "inner"):
            a, b = vec(m[key]), vec(g[key])
            assert a.shape == b.shape, (key, m["id"])
            assert (np.isfinite(a) == np.isfinite(b)).all(), \
                (key, m["id"])
            both = np.isfinite(a) & np.isfinite(b)
            np.testing.assert_allclose(
                a[both], b[both], atol=2e-4, rtol=1e-3,
                err_msg=f"{key} {m['id']}")
        assert m["motif region"] == g["motif region"], m["id"]
        assert float(m["exist prob"]) == pytest.approx(
            float(g["exist prob"]), abs=1e-3)
        # alignment strings: converged models can have near-degenerate
        # CYK optima where argmax tie-breaks differ across engines; the
        # motif path must still agree wherever the reference places the
        # motif (the positional-inference contract)
        if (m["psihat"], m["rss"]) != (g["psihat"], g["rss"]):
            n_path_diff += 1
        assert m["mot"] == g["mot"], m["id"]
    # the overwhelming majority of alignments must be byte-identical
    assert n_path_diff <= 2, n_path_diff
