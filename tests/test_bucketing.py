"""Length bucketing (SURVEY §7.1 'Batching'): mixed-length
FASTQ trains and scans through per-bucket kernels (pad to the next
32-multiple) instead of specializing on the file max — and bucketed
results equal full-pad results exactly."""
import io

import numpy as np

import jax

from rnaelem_tpu.alphabet import seq_to_ints
from rnaelem_tpu.model import joint as J
from rnaelem_tpu.train import objective as OBJ
from rnaelem_tpu.train.trainer import Trainer
from rnaelem_tpu.scan.driver import Scanner, _bucket_of


def _fq(path, lens, seed=5):
    rng = np.random.RandomState(seed)
    with open(path, "w") as f:
        for i, L in enumerate(lens):
            s = "".join("ACGU"[c] for c in rng.randint(0, 4, L))
            f.write(f"@r{i}\n{s}\n+\n{'+' * L}!\n")


def test_bucket_of():
    assert _bucket_of(1) == 32
    assert _bucket_of(32) == 32
    assert _bucket_of(33) == 64
    assert _bucket_of(100) == 128


def test_bucketed_objective_equals_full_pad():
    """The same reads evaluated in a small bucket and in a much larger
    padding give identical per-read objectives (padding is inert)."""
    reads = []
    rng = np.random.RandomState(2)
    for L in (12, 17, 20):
        s = "".join("ACGU"[c] for c in rng.randint(0, 4, L))
        q = np.full(L + 1, 10)
        q[-1] = 0
        reads.append((seq_to_ints(s), q))
    import dataclasses as dc
    cfg_small = J.ModelConfig(pattern="(...)", Lp=32, max_span=20,
                              max_iloop=8, min_bpp=1e-4, tau=0.1,
                              dtype="float64")
    cfg_big = dc.replace(cfg_small, Lp=64)
    params = J.init_params(J.kernels(cfg_small).g, cfg_small, np.float64)
    f1, _, _ = OBJ.batch_fn_grad_pr(
        cfg_small, params, OBJ.stack_reads(cfg_small, reads))
    f2, _, _ = OBJ.batch_fn_grad_pr(
        cfg_big, params, OBJ.stack_reads(cfg_big, reads))
    np.testing.assert_allclose(np.asarray(f1), np.asarray(f2),
                               rtol=1e-12)


def test_mixed_length_train_and_scan(tmp_path):
    fq = str(tmp_path / "mixed.fq")
    _fq(fq, [14, 18, 40, 44, 15, 41])
    cfg = J.ModelConfig(pattern="(...)", Lp=64, max_span=20, max_iloop=8,
                        min_bpp=1e-4, tau=0.1, dtype="float64")
    params = J.init_params(J.kernels(cfg).g, cfg, np.float64)
    tr = Trainer(cfg, params, max_iter=2, batch_size=3, kmer_shuf=2)
    tr.set_fq(fq)
    p = tr.train()
    assert all(np.isfinite(x).all() for x in jax.tree.leaves(p))
    # two distinct buckets were actually used
    out = io.StringIO()
    Scanner(cfg, p).scan(fq, out)
    raw = out.getvalue()
    assert raw.count("id: ") == 6
    # records come back in input order despite bucketed execution
    order = [line.split()[1] for line in raw.splitlines()
             if line.startswith("id: ")]
    assert order == [f"@r{i}" for i in range(6)]
