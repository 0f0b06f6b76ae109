"""Shuffled-mode (default Adam) equivalence criterion: the e2e pipeline
must SELECT the planted motif and its held-out exist-prob AUC must
exceed 0.9 (BASELINE.md "Equivalence criteria"; the reference's own
de-novo discovery contract, /root/reference/script/elem:275-299).

Synthetic set: positives carry a planted GC-stem hairpin with a
conserved 5-nt loop at a random offset; negatives are the pipeline's
own dinucleotide shuffles (elem init), which destroy both the stem and
the loop.  The pattern list offers the true shape `(.....)` against an
unstructured decoy `.....`.
"""
import math
import os
import subprocess
import sys

import numpy as np
import pytest

STEM = "GGCAGC"
STEM_RC = "GCUGCC"
LOOP = "UUCGA"


def _planted(rng, n):
    seqs = []
    for _ in range(n):
        pre = "".join("ACGU"[c] for c in rng.randint(0, 4, rng.randint(4, 9)))
        suf = "".join("ACGU"[c] for c in rng.randint(0, 4, rng.randint(4, 9)))
        seqs.append(pre + STEM + LOOP + STEM_RC + suf)
    return seqs


@pytest.mark.slow
def test_pipeline_selects_planted_motif(tmp_path):
    rng = np.random.RandomState(11)
    pos = tmp_path / "positive.fa"
    with open(pos, "w") as f:
        for i, s in enumerate(_planted(rng, 24)):
            f.write(f">p{i}\n{s}\n")
    plist = tmp_path / "pattern_list"
    plist.write_text("(.....)\n.....\n")
    out = tmp_path / "out"

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"

    def run(args):
        r = subprocess.run(
            [sys.executable, "-m", "rnaelem_tpu.pipeline.elem"] + args,
            env=env, capture_output=True, text=True, timeout=2400)
        assert r.returncode == 0, r.stderr[-2000:]
        return r

    run(["init", "-p", str(pos), "-m", str(plist), "-o", str(out)])
    run(["train", "-M", str(out), "-i", "12", "-b", "8", "-w", "24"])
    run(["select", "-M", str(out), "-N", "1"])

    sel = (out / "select.txt").read_text().strip().splitlines()
    assert sel, "select.txt empty"
    assert "pattern-1" in sel[0], f"planted motif not selected: {sel}"

    # the planted pattern's held-out AUC must clear 0.9 on every fold
    aucs = []
    for line in open(out / "cv"):
        k, pi, llik, auc = line.split("\t")
        if pi == "1":
            aucs.append(float(auc))
    assert aucs and min(aucs) > 0.9, f"planted AUC too low: {aucs}"
