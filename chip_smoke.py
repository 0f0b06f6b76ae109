"""Smoke test of rnaelem's main path on NVIDIA GPUs, against references.

Phases (one process, dtype / matmul precision / compilation cache from
rnaelem_tpu.runtime.setup, as on the `rnaelem` CLI):

  1. fn/grad of fixtures {0..3}.model x 0.fq at Lp=48 vs the reference
     binary's goldens tests/golden/eval_{0..3}.{fn,gr};
  2. the flagship config (pattern (.....), W=50, C=30, min_bpp=1e-4) at
     Lp=100 on 8 seeded random 100-nt reads vs the CPU float64 golden
     tests/golden/flagship_fn_gr.npz (tools/flagship_golden.py);
  3. `rnaelem train` (default shuffle mode, 3 iterations, batch 64) on
     the 76 tRNA reads of tests/fixtures/material/positive.fa;
  4. `rnaelem scan` of the converged reference tRNA model over the same
     reads vs tests/golden/trna_scan_ref.raw, and of fixtures
     {0..3}.model over 0.fq vs tests/golden/scan_{0..3}.raw.

Each phase runs twice and prints its first (compile) and second
(steady) wall time and its errors beside their tolerances.  With
--multi-gpu only phase 5 runs: the phase-3 training on a 4-device mesh
and on one device, compared iteration by iteration.

There is no CPU fallback: without a GPU, or when a phase fails, it exits
non-zero and prints no result.  Otherwise the last stdout line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.

Usage: python chip_smoke.py [--multi-gpu]
"""
import argparse
import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import numpy as np

FIX = os.path.join(HERE, "tests", "fixtures")
GOLD = os.path.join(HERE, "tests", "golden")
TRNA_FA = os.path.join(FIX, "material", "positive.fa")

# float32 against float64 references: the TPU round's gradient bar
FN_RTOL = 1e-5        # |fn - fn_ref| / |fn_ref|
GR_RTOL = 1e-4        # max|gr - gr_ref| / max|gr_ref|
EXIST_ATOL = 1e-3     # scan exist prob, where both are finite
MESH_DEVICES = 4


def say(*a):
    print(*a, flush=True)


def test_module(name):
    """tests/<name>.py loaded by path: the reference checks live there,
    and an installed package named `tests` can shadow the directory."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HERE, "tests", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def twice(fn):
    """(result, first-call seconds, second-call seconds)."""
    t0 = time.time()
    fn()
    t1 = time.time()
    res = fn()
    return res, t1 - t0, time.time() - t1


def fn_gr_errors(fn, gr, fn_ref, gr_ref):
    gr, gr_ref = np.asarray(gr, np.float64), np.asarray(gr_ref, np.float64)
    return (abs(fn - fn_ref) / abs(fn_ref),
            float(np.abs(gr - gr_ref).max() / np.abs(gr_ref).max()))


def report_fn_gr(label, fn_rel, gr_rel):
    ok = fn_rel <= FN_RTOL and gr_rel <= GR_RTOL
    say(f"  {label}: fn rel err {fn_rel:.3e} (tol {FN_RTOL:g}), "
        f"grad rel err {gr_rel:.3e} (tol {GR_RTOL:g}) "
        f"{'ok' if ok else 'FAIL'}")
    return ok


def phase_goldens(dtype):
    """Phase 1: reference-binary fn/grad goldens at Lp=48."""
    from rnaelem_tpu.model import io as MIO
    from rnaelem_tpu.train.objective import eval_file
    load_golden = test_module("test_grad_golden").load_golden

    def run():
        out = []
        for x in "0123":
            cfg, params = MIO.read_model(
                os.path.join(FIX, f"{x}.model"), Lp=48, dtype=dtype)
            fn, gr, _ = eval_file(cfg, params, os.path.join(FIX, "0.fq"))
            out.append((fn, gr))
        return out

    res, t_first, t_steady = twice(run)
    say(f"phase 1 reference fn/grad goldens (Lp=48): first "
        f"{t_first:.2f} s, steady {t_steady:.2f} s")
    ok = True
    for x, (fn, gr) in zip("0123", res):
        ok &= report_fn_gr(f"model {x}", *fn_gr_errors(fn, gr,
                                                       *load_golden(x)))
    return ok


def phase_flagship(dtype):
    """Phase 2: flagship width at Lp=100 vs the CPU float64 golden."""
    import bench
    (fn, gr), t_first, t_steady = twice(lambda: bench.flagship_fn_gr(dtype))
    ref = np.load(bench.FLAGSHIP_GOLDEN)
    say(f"phase 2 flagship fn/grad (Lp=100, 8 reads): first "
        f"{t_first:.2f} s, steady {t_steady:.2f} s")
    return report_fn_gr("vs CPU float64", *fn_gr_errors(
        fn, gr, float(ref["fn"]), ref["gr"]))


def train_cli(td, extra=()):
    """`rnaelem train` on the tRNA reads; returns (per-iteration fn,
    model path, stderr text)."""
    from rnaelem_tpu import cli
    from rnaelem_tpu.io.fastq import write_flat_fastq
    fq = os.path.join(td, "trna76.fq")
    write_flat_fastq(TRNA_FA, fq)
    model = os.path.join(td, "train.model")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        cli.main(["train", "-f", fq, "-m", "(.....)", "-i", "3",
                  "--batch-size", "64", "--out1", model,
                  "--out3", "~NULL~", *extra])
    fns = [float(line.split(" , ")[1].split(":")[1])
           for line in err.getvalue().splitlines()
           if line.startswith("iter: ")]
    return fns, model, err.getvalue()


def phase_train(dtype):
    """Phase 3: `rnaelem train` through the CLI."""
    from rnaelem_tpu.model import io as MIO
    with tempfile.TemporaryDirectory() as td:
        (fns, model, _), t_first, t_steady = twice(lambda: train_cli(td))
        cfg, params = MIO.read_model(model, Lp=96, dtype=dtype)
        finite = all(np.isfinite(np.asarray(p)).all() for p in params)
    ok = len(fns) == 3 and bool(np.isfinite(fns).all()) and finite
    say(f"phase 3 rnaelem train (76 tRNA reads, 3 iterations, batch 64): "
        f"first {t_first:.2f} s, steady {t_steady:.2f} s")
    say(f"  fn per iteration {fns}; model parses, pattern {cfg.pattern}, "
        f"finite parameters {finite} {'ok' if ok else 'FAIL'}")
    return ok


def scan_cli(fq, model, raw):
    from rnaelem_tpu import cli
    with contextlib.redirect_stderr(io.StringIO()):
        cli.main(["scan", "-f", fq, "-q", model, "--out1", raw])
    with open(raw) as f:
        return f.read()


def fixture_scan_failures(x, text, dtype):
    """The checks of tests/test_scan_golden.py on one fixture model."""
    from rnaelem_tpu.model import io as MIO
    T = test_module("test_scan_golden")
    parse_raw, vec = T.parse_raw, T.vec
    cfg, params = MIO.read_model(os.path.join(FIX, f"{x}.model"), Lp=48,
                                 dtype=dtype)
    mine = parse_raw(text)
    with open(os.path.join(GOLD, f"scan_{x}.raw")) as f:
        gold = parse_raw(f.read())
    if len(mine) != len(gold):
        return [f"{len(mine)} records, golden has {len(gold)}"]
    bad = []
    for m, g in zip(mine, gold):
        for key in ("start", "end", "inner"):
            a, b = vec(m[key]), vec(g[key])
            if a.shape != b.shape or \
                    (np.isfinite(a) != np.isfinite(b)).any():
                bad.append(f"{m['id']} {key} shape/-inf pattern")
                continue
            both = np.isfinite(a)
            if not np.allclose(a[both], b[both], atol=2e-4, rtol=1e-3):
                bad.append(f"{m['id']} {key} max err "
                           f"{np.abs(a[both] - b[both]).max():.3e}")
        d = abs(float(m["exist prob"]) - float(g["exist prob"]))
        if d > EXIST_ATOL:
            bad.append(f"{m['id']} exist prob err {d:.3e}")
        for key in ("id", "motif region", "seq", "rss", "mot"):
            if m[key] != g[key]:
                bad.append(f"{m['id']} {key} differs")
        if m["psihat"] != g["psihat"]:
            sa = T._chain_path_score(cfg, params, m["seq"],
                                     T.vecint(m["psihat"]))
            sb = T._chain_path_score(cfg, params, g["seq"],
                                     T.vecint(g["psihat"]))
            if abs(sa - sb) > 1e-9:
                bad.append(f"{m['id']} psihat scores {sa} vs {sb}")
    return bad


def host_traceback_failures(dtype):
    """The per-read max-semiring kernel (ops/dp_max.py) behind the
    scanner's exact host traceback (its fallback for tied reads), run on
    fixture 1's reads at the reference scanner's motif regions and held
    to the reference's alignments."""
    from rnaelem_tpu.io.fastq import FastqReader
    from rnaelem_tpu.model import io as MIO
    from rnaelem_tpu.model import joint as J
    from rnaelem_tpu.scan import cyk as CYK
    from rnaelem_tpu.scan.driver import _bucket_of, scan_config
    T = test_module("test_scan_golden")
    cfg0, params0 = MIO.read_model(os.path.join(FIX, "1.model"), Lp=48,
                                   dtype=dtype)
    with open(os.path.join(GOLD, "scan_1.raw")) as f:
        gold = T.parse_raw(f.read())
    reads = list(FastqReader(os.path.join(FIX, "0.fq")).reads())
    bad = []
    for r, g in zip(reads, gold):
        cfg, params = scan_config(cfg0, params0, _bucket_of(len(r.seq)))
        ys, ye = (int(v) for v in g["motif region"].split(" - "))
        path, rss = CYK.viterbi_alignment(
            cfg, params, J.make_seqdata(cfg, r.seq, r.qual), ys, ye)
        if rss != g["rss"] or \
                [int(v) for v in path[:len(r.seq)]] != T.vecint(g["psihat"]):
            bad.append(f"{r.id} alignment differs")
    return bad


def phase_scan(dtype):
    """Phase 4: `rnaelem scan` through the CLI vs reference scan.raw."""
    from rnaelem_tpu.io.fastq import write_flat_fastq
    T = test_module("test_scan_golden")
    parse_raw, vec = T.parse_raw, T.vec
    with tempfile.TemporaryDirectory() as td:
        fq = os.path.join(td, "trna76.fq")
        write_flat_fastq(TRNA_FA, fq)

        def run():
            trna = scan_cli(fq, os.path.join(GOLD,
                                             "trna_noshuffle_ref.model"),
                            os.path.join(td, "trna.raw"))
            fixt = [scan_cli(os.path.join(FIX, "0.fq"),
                             os.path.join(FIX, f"{x}.model"),
                             os.path.join(td, f"scan_{x}.raw"))
                    for x in "0123"]
            return trna, fixt

        (trna, fixt), t_first, t_steady = twice(run)
    say(f"phase 4 rnaelem scan (76 tRNA reads + fixtures 0-3): first "
        f"{t_first:.2f} s, steady {t_steady:.2f} s")
    mine = parse_raw(trna)
    with open(os.path.join(GOLD, "trna_scan_ref.raw")) as f:
        gold = parse_raw(f.read())
    ok = len(mine) == len(gold) == 76
    exist_err, n_inf, n_rss, n_mot = 0.0, 0, 0, 0
    for m, g in zip(mine, gold):
        a, b = float(m["exist prob"]), float(g["exist prob"])
        if np.isfinite(a) and np.isfinite(b):
            exist_err = max(exist_err, abs(a - b))
        n_inf += any(vec(m[k]).shape != vec(g[k]).shape
                     or (np.isfinite(vec(m[k])) != np.isfinite(vec(g[k])))
                     .any() for k in ("start", "end", "inner"))
        n_rss += m["rss"] != g["rss"]
        n_mot += m["mot"] != g["mot"]
    ok &= exist_err <= EXIST_ATOL
    say(f"  tRNA: {len(mine)} records, exist prob max err "
        f"{exist_err:.3e} (tol {EXIST_ATOL:g}) {'ok' if ok else 'FAIL'}; "
        f"not gated: {n_inf} reads with -inf mismatches, {n_rss} rss and "
        f"{n_mot} mot strings differ")
    for x, text in zip("0123", fixt):
        bad = fixture_scan_failures(x, text, dtype)
        say(f"  fixture {x}: " + ("ok (tests/test_scan_golden.py "
                                  "tolerances)" if not bad
                                  else "FAIL " + "; ".join(bad)))
        ok &= not bad
    t0 = time.time()
    bad = host_traceback_failures(dtype)
    say(f"  host traceback (ops/dp_max.py) on fixture 1, "
        f"{time.time() - t0:.2f} s: "
        + ("psihat and rss equal the reference" if not bad
           else "FAIL " + "; ".join(bad)))
    return ok and not bad


def phase_multi_gpu(dtype):
    """Phase 5: phase-3 training on a 4-device mesh vs one device."""
    import jax
    from rnaelem_tpu.model import io as MIO
    devs = jax.devices()
    if len(devs) < MESH_DEVICES:
        say(f"phase 5 needs {MESH_DEVICES} GPUs, found {len(devs)} FAIL")
        return False
    with tempfile.TemporaryDirectory() as td:
        t0 = time.time()
        fn_mesh, model_mesh, log = train_cli(
            td, ["--mesh", str(MESH_DEVICES)])
        t_mesh = time.time() - t0
        peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use", 0)
                 for d in devs]
        cfg, p_mesh = MIO.read_model(model_mesh, Lp=96, dtype=dtype)
        with open(model_mesh) as f:
            text_mesh = f.read()
        t0 = time.time()
        fn_one, model_one, _ = train_cli(td, ["--mesh", "0"])
        t_one = time.time() - t0
        _, p_one = MIO.read_model(model_one, Lp=96, dtype=dtype)
        with open(model_one) as f:
            text_one = f.read()
    say(f"phase 5 rnaelem train --mesh {MESH_DEVICES} vs --mesh 0: "
        f"{t_mesh:.2f} s vs {t_one:.2f} s (both incl. compile)")
    say("  " + next(l for l in log.splitlines() if l.startswith("mesh:")))
    say("  peak bytes per device after the mesh run: " +
        ", ".join(f"{d.id}: {p}" for d, p in zip(devs, peaks)))
    used = peaks[:MESH_DEVICES]
    spread = min(used) > 0 and min(used) >= 0.25 * max(used)
    fn_rel = max(abs(a - b) / abs(b) for a, b in zip(fn_mesh, fn_one))
    p_err = max(float(np.abs(np.asarray(a, np.float64)
                             - np.asarray(b, np.float64)).max())
                for a, b in zip(p_mesh, p_one))
    same_fn = fn_mesh == fn_one
    ok = (spread and len(fn_mesh) == len(fn_one) == 3
          and fn_rel <= FN_RTOL and p_err <= 1e-3)
    say(f"  fn per iteration mesh {fn_mesh} vs one {fn_one}: max rel "
        f"diff {fn_rel:.3e} (tol {FN_RTOL:g}), bit-identical {same_fn}")
    say(f"  written models: max abs parameter diff {p_err:.3e} (tol 1e-3),"
        f" byte-identical {text_mesh == text_one}; work on every device "
        f"{spread} {'ok' if ok else 'FAIL'}")
    return ok


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi-gpu", action="store_true",
                    help=f"run only phase 5 on {MESH_DEVICES} GPUs")
    args = ap.parse_args(argv)

    from rnaelem_tpu import runtime
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU; JAX found {devs[0].platform}",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    if smi.returncode != 0:
        print("chip_smoke: nvidia-smi failed:", smi.stderr, file=sys.stderr)
        return 1
    dtype = runtime.setup(platform="gpu")
    say("nvidia-smi name, power.limit:")
    for line in smi.stdout.strip().splitlines():
        say(line.strip())
    say(f"jax {jax.__version__}, {len(devs)} x {devs[0].device_kind}")
    say(f"cache dir {runtime.cache_dir()}, dtype {dtype}, matmul "
        f"precision {jax.config.jax_default_matmul_precision}")
    phases = [phase_multi_gpu] if args.multi_gpu else \
        [phase_goldens, phase_flagship, phase_train, phase_scan]
    ok = True
    for phase in phases:
        try:
            ok &= phase(dtype)
        except Exception:
            traceback.print_exc()
            say(f"{phase.__name__} FAIL (exception)")
            ok = False
    if not ok:
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
