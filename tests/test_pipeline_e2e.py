"""End-to-end pipeline smoke: elem init -> train -> select on a tiny
dataset with two patterns, exercising the CLI subprocesses, CV splits,
kmer-psp, scanning, AUC selection and the directory layout."""
import os
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(__file__)
FIX = os.path.join(HERE, "fixtures")


@pytest.mark.slow
def test_elem_init_train_select(tmp_path):
    # tiny positive set: 8 short reads from the toy tRNA file
    seqs = []
    with open(os.path.join(FIX, "material", "positive.fa")) as f:
        for line in f:
            if not line.startswith(">"):
                seqs.append(line.strip().replace("T", "U")[:48])
            if len(seqs) >= 8:
                break
    pos = tmp_path / "positive.fa"
    with open(pos, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f">p{i}\n{s}\n")
    plist = tmp_path / "pattern_list"
    plist.write_text("(...)\n.....\n")
    out = tmp_path / "out"

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"

    def run(args):
        r = subprocess.run(
            [sys.executable, "-m", "rnaelem_tpu.pipeline.elem"] + args,
            env=env, capture_output=True, text=True, timeout=1500)
        assert r.returncode == 0, r.stderr[-2000:]
        return r

    run(["init", "-p", str(pos), "-m", str(plist), "-o", str(out)])
    assert (out / "train.fq").exists()
    assert (out / "cv-0" / "train" / "train.fq").exists()
    run(["train", "-M", str(out), "-i", "2", "-b", "4", "-w", "24"])
    assert (out / "cv-0" / "train" / "pattern-1" / "train.model").exists()
    assert (out / "cv-1" / "test" / "pattern-2" / "positive.raw").exists()
    run(["select", "-M", str(out), "-N", "1"])
    sel = (out / "select.txt").read_text().strip()
    assert sel.endswith("train.model")
    assert (out / "cv").exists()
