"""``elem``: the de-novo motif discovery pipeline orchestrator.

Subcommands init / train / select / refine / scan / pipeline with the
reference driver's directory layout and selection logic (script/elem):

  outdir/
    train.fq  pattern_list  negative.fa?
    cv-<k>/{train.fq under train/, test/{positive,negative}.fq}
    cv-<k>/{train,test}/pattern-<i>/...   (per pattern x fold)
    cv  select.txt  model-<i>/...

Cluster array jobs are replaced by a local worker pool (--jobs) running
``python -m rnaelem_tpu.cli`` subprocesses, one GPU card each on a GPU
host (runtime.fan_out); multi-device data parallelism inside a single
training run lives in parallel/mesh.py.
"""
from __future__ import annotations

import argparse
import math
import os
import random
import subprocess
import sys
from pathlib import Path

import numpy as np

from .. import runtime
from .kmer_psp import parse_fasta


def _svg_to_png(svg_path, png_path):
    """Optional PNG rendering of the refine figures via rsvg-convert or
    ImageMagick, matching script/elem:444-456; silently skipped when
    neither tool is installed (the SVGs remain the primary output)."""
    import shutil
    if shutil.which("rsvg-convert"):
        cmd = ["rsvg-convert", "-o", png_path, svg_path]
    elif shutil.which("convert"):
        cmd = ["convert", svg_path, png_path]
    else:
        return False
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        return True
    except Exception as e:
        cry("svg->png failed:", e)
        return False


def cry(*a):
    print(*a, file=sys.stderr, flush=True)


def _run_cli(args, log_path, env=None):
    cmd = [sys.executable, "-m", "rnaelem_tpu.cli"] + [str(a) for a in args]
    with open(log_path, "a") as log:
        subprocess.run(cmd, check=True, stderr=log, env=env)


def parse_raw(path):
    recs = []
    with open(path) as f:
        lines = [l.rstrip("\n") for l in f if l.strip()]
    for k in range(0, len(lines) - 9, 10):
        rec = dict(l.split(": ", 1) for l in lines[k:k + 10])
        recs.append(rec)
    return recs


def calc_auc(ox, score):
    """Trapezoid AUC with tie aggregation (script/elem:95-107)."""
    pairs = sorted(zip(score, ox))
    # aggregate equal scores
    agg = []
    for s, o in pairs:
        if agg and agg[-1][0] == s:
            agg[-1][1] += o
            agg[-1][2] += 1
        else:
            agg.append([s, o, 1])
    tp = sum(o for _, o, _ in agg)
    fp = sum(n for _, _, n in agg) - tp
    tn = fn = 0
    x = y = 1.0
    auc = 0.0
    for s, o, n in agg:
        if isinstance(s, float) and math.isnan(s):
            continue
        tp, fn = tp - o, fn + o
        fp, tn = fp - (n - o), tn + (n - o)
        FPR = fp / (tn + fp) if (tn + fp) else 0.0
        TPR = tp / (tp + fn) if (tp + fn) else 0.0
        auc += (x - FPR) * (y + TPR) / 2.0
        x, y = FPR, TPR
    return auc + x * y / 2.0


def calc_auc_raw(pos_raw, neg_raw):
    ox, score = [], []
    for r in parse_raw(pos_raw):
        ox.append(1)
        score.append(float(r["exist prob"]))
    for r in parse_raw(neg_raw):
        ox.append(0)
        score.append(float(r["exist prob"]))
    return calc_auc(ox, score)


def n_fa(path):
    return sum(1 for l in open(path) if l.startswith(">"))


def chunk(x, n):
    j, r = 0, []
    for w in [len(x) // n + int(i < len(x) % n) for i in range(n)]:
        r.append(x[j:j + w])
        j += w
    return r


def cross_divide_inputs(positive, negative, kfold, outdir):
    """k-fold CV FASTA split, deterministically seeded by the positive
    filename (script/elem:242-274)."""
    random.seed(positive)
    sets = {"posi": positive}
    if negative:
        sets["nega"] = negative
    folds = {}
    for pn, path in sets.items():
        idx = list(range(n_fa(path)))
        random.shuffle(idx)
        folds[pn] = [sorted(c) for c in chunk(idx, kfold)]
    for k in range(kfold):
        os.makedirs(f"{outdir}/cv-{k}", exist_ok=True)
    for pn, path in sets.items():
        name = "positive" if pn == "posi" else "negative"
        fps = {}
        for k in range(kfold):
            fps[k] = {
                "train": open(f"{outdir}/cv-{k}/train.{name}.fa", "w"),
                "test": open(f"{outdir}/cv-{k}/test.{name}.fa", "w"),
            }
        for i, (ann, seq) in enumerate(parse_fasta(path)):
            for k in range(kfold):
                which = "test" if i in folds[pn][k] else "train"
                fps[k][which].write(f"{ann}\n{seq}\n")
        for k in range(kfold):
            for f in fps[k].values():
                f.close()


def run_init(positive, negative, pattern_list, outdir, kfold_cv, **_):
    from . import kmer_psp, dishuffle
    os.makedirs(outdir, exist_ok=True)
    logp = f"{outdir}/log"
    if negative is None:
        cry("info: generate negative sequence by 2mer shuffling")
        negative = f"{outdir}/negative.fa"
        with open(negative, "w") as f:
            dishuffle.run(positive, f)
    with open(f"{outdir}/train.fq", "w") as f, open(logp, "a") as lg:
        _stderr_to(lg, kmer_psp.run, positive, negative, f)
    cross_divide_inputs(positive, negative, kfold_cv, outdir)
    with open(pattern_list) as src, open(f"{outdir}/pattern_list",
                                         "w") as dst:
        dst.write(src.read())
    for k in range(kfold_cv):
        os.makedirs(f"{outdir}/cv-{k}/train", exist_ok=True)
        os.makedirs(f"{outdir}/cv-{k}/test", exist_ok=True)
        with open(f"{outdir}/cv-{k}/train/train.fq", "w") as f, \
                open(logp, "a") as lg:
            _stderr_to(lg, kmer_psp.run,
                       f"{outdir}/cv-{k}/train.positive.fa",
                       f"{outdir}/cv-{k}/train.negative.fa"
                       if negative else None, f)
        with open(f"{outdir}/cv-{k}/test/positive.fq", "w") as f, \
                open(logp, "a") as lg:
            _stderr_to(lg, kmer_psp.run,
                       f"{outdir}/cv-{k}/test.positive.fa", None, f)
        if negative:
            with open(f"{outdir}/cv-{k}/test/negative.fq", "w") as f, \
                    open(logp, "a") as lg:
                _stderr_to(lg, kmer_psp.run,
                           f"{outdir}/cv-{k}/test.negative.fa", None, f)


def _stderr_to(log, fn, *args):
    old = sys.stderr
    sys.stderr = log
    try:
        fn(*args)
    finally:
        sys.stderr = old


def _patterns(elem_out):
    return [p.strip() for p in open(f"{elem_out}/pattern_list")
            if p.strip()]


def _folds(elem_out):
    return sorted(int(d.name.split("-")[1])
                  for d in Path(elem_out).glob("cv-*") if d.is_dir())


def _train_task_cmds(elem_out, pi, k, motif, max_span, max_iter,
                     batch_size, no_shuffle):
    """CLI command steps of one pattern x fold training task: train on
    the fold's train.fq, then scan the held-out positives/negatives
    (script/elem:326-364).  Returns [(argv, log_path), ...]."""
    tdir = f"{elem_out}/cv-{k}/train/pattern-{pi}"
    sdir = f"{elem_out}/cv-{k}/test/pattern-{pi}"
    os.makedirs(tdir, exist_ok=True)
    os.makedirs(sdir, exist_ok=True)
    ns = ["--no-shuffle"] if no_shuffle else []
    cmds = [(["--fastq", f"{elem_out}/cv-{k}/train/train.fq",
              "--max-span", max_span, "--motif-pattern", motif,
              "--max-iter", max_iter, "--batch-size", batch_size,
              *ns,
              "--out1", f"{tdir}/train.model",
              "--out2", f"{tdir}/train.raw",
              "--out3", f"{tdir}/train.interim"], f"{tdir}/log")]
    for name in ("positive", "negative"):
        fq = f"{elem_out}/cv-{k}/test/{name}.fq"
        if os.path.exists(fq):
            cmds.append((["scan", "--fastq", fq,
                          "--motif-model", f"{tdir}/train.model",
                          "--out1", f"{sdir}/{name}.raw"],
                         f"{sdir}/log"))
    return cmds


def _submit_task_array(elem_out, task_cmds, sge_option_file):
    """Cluster fan-out of pattern x fold tasks (script/elem:326-364):
    write one dispatch script that switches on the scheduler's task-id
    env var and submit it as an N-task array job through the
    grid_engine_opt template (parallel/arrayjob.py)."""
    import shlex
    from ..parallel.arrayjob import GridEngineOptions
    ge = GridEngineOptions.load(sge_option_file)
    script = f"{elem_out}/array_job.sh"
    with open(script, "w") as f:
        f.write("#!/bin/sh\n# generated by elem train --array\n")
        f.write(f'tid="${{{ge.task_id_env}}}"\ncase "$tid" in\n')
        for tid, cmds in enumerate(task_cmds, 1):
            lines = "\n    ".join(
                " ".join(shlex.quote(str(a)) for a in
                         [sys.executable, "-m", "rnaelem_tpu.cli"]
                         + list(argv))
                + f" 2>> {shlex.quote(log)}"
                for argv, log in cmds)
            f.write(f"  {tid})\n    {lines}\n    ;;\n")
        f.write('  *) echo "bad task id: $tid" >&2; exit 1 ;;\nesac\n')
    ge.submit_job(f"sh {script}", len(task_cmds), show=True)


def run_train(elem_out, max_span, max_iter, batch_size, thread, jobs,
              pattern_index, no_shuffle, sge_option_file=None,
              in_process=False, array=False, **_):
    folds = _folds(elem_out)
    pats = _patterns(elem_out)
    indices = [pattern_index] if pattern_index else \
        list(range(1, len(pats) + 1))
    tasks = []
    for pi in indices:
        motif = pats[pi - 1]
        for k in folds:
            tasks.append((pi, k, motif))
    # compile sharing: order tasks so patterns with the same compiled-
    # kernel signature (motif state count S, Lp bucket is shared) run
    # back to back — each signature compiles once into the persistent
    # XLA cache and every later task of that signature hits it
    tasks.sort(key=lambda t: (_pattern_signature(t[2]), t[1]))
    cmds_of = lambda t: _train_task_cmds(
        elem_out, t[0], t[1], t[2], max_span, max_iter, batch_size,
        no_shuffle)

    if array and sge_option_file:
        _submit_task_array(elem_out, [cmds_of(t) for t in tasks],
                           sge_option_file)
        return
    if array and not sge_option_file:
        cry("info: --array without --sge-option-file runs the local "
            "--jobs pool")

    def one(task, env):
        cry("k_fold:", task[1])
        cry("pattern:", task[0])
        for argv, log in cmds_of(task):
            if in_process:
                _run_inproc(argv, log)
            else:
                _run_cli(argv, log, env)

    # in-process tasks share one JAX client; the global stderr redirect
    # (and the device itself) serialize them, so the pool is bypassed
    runtime.fan_out(tasks, one, 1 if in_process else jobs)


def _pattern_signature(pattern: str):
    """Patterns compile to the same DP kernels iff they have the same
    state count; group by (#pair nodes, #loop nodes, no-rss) which
    determines S for the profile grammar (grammar/profile.py)."""
    p = pattern.replace("*", "")
    return (p.count("("), sum(c in "._" for c in p), "_" in p)


def _run_inproc(args, log_path, env=None):
    """Run one CLI command inside THIS process (shared JAX client and
    compiled-kernel cache) instead of a fresh subprocess — the task
    runner for a single shared accelerator, where per-task process
    churn both re-initializes the device and re-compiles every kernel
    (BASELINE.md 'Multi-pattern pipeline').  `env` is unused: the
    task shares this process's device."""
    from .. import cli as CLI
    old_err = sys.stderr
    with open(log_path, "a") as log:
        sys.stderr = log
        try:
            CLI.main([str(a) for a in args])
        finally:
            sys.stderr = old_err
    # drop in-memory jit caches between tasks: 40 in-process tasks
    # accumulated ~130 GB RSS (OOM) when every pattern's compiled
    # programs stayed live; the persistent XLA cache makes later
    # same-signature tasks cheap reloads instead of recompiles
    import gc
    try:
        import jax
        jax.clear_caches()
    except Exception:
        pass
    gc.collect()
    try:
        with open("/proc/self/statm") as f:
            rss_mb = int(f.read().split()[1]) * 4096 // (1 << 20)
        cry("task rss_mb:", rss_mb)
    except Exception:
        pass


def gen_cv_summary(elem_out):
    folds = _folds(elem_out)
    pats = _patterns(elem_out)
    with open(f"{elem_out}/cv", "w") as cv:
        for k in folds:
            for pi in range(1, len(pats) + 1):
                llik, auc = 0.0, 0.5
                # exist prob can saturate to exactly 0/1 (a converged
                # motif); clamp before log so one record cannot abort
                # the fold like the reference's bare log does
                # (script/elem:283-287)
                clamp = lambda p: min(max(p, 1e-300), 1.0 - 1e-16)
                try:
                    base = f"{elem_out}/cv-{k}/test/pattern-{pi}"
                    for r in parse_raw(f"{base}/positive.raw"):
                        llik += math.log(clamp(float(r["exist prob"])))
                    if os.path.exists(f"{base}/negative.raw"):
                        for r in parse_raw(f"{base}/negative.raw"):
                            llik += math.log(
                                1 - clamp(float(r["exist prob"])))
                        auc = calc_auc_raw(f"{base}/positive.raw",
                                           f"{base}/negative.raw")
                except Exception as e:
                    cry("k_fold,pattern:", k, pi)
                    cry("error:", e)
                cv.write(f"{k}\t{pi}\t{llik}\t{auc}\n")
    cry("written:", f"{elem_out}/cv")


def run_select(elem_out, num_motifs, **_):
    gen_cv_summary(elem_out)
    rows, all_rows = [], []
    for line in open(f"{elem_out}/cv"):
        k, pi, llik, auc = line.split("\t")
        llik = float(llik)
        if math.isnan(llik):
            continue
        all_rows.append((k, pi, llik, float(auc)))
        if llik < 0:
            rows.append((k, pi, llik, float(auc)))
    if not rows:
        # every fold degenerate (llik == 0, e.g. saturated exist probs):
        # fall back to ranking all folds by AUC rather than selecting
        # nothing (the reference's awk filter would write an empty
        # select.txt here, script/elem:405)
        rows = all_rows
    by_pat = {}
    for k, pi, llik, auc in rows:
        by_pat.setdefault(pi, []).append((k, llik, auc))
    ranked = sorted(
        by_pat.items(),
        key=lambda kv: -np.mean([a for _, _, a in kv[1]]))
    with open(f"{elem_out}/select.txt", "w") as f:
        for pi, entries in ranked[:num_motifs]:
            best_k = max(entries, key=lambda e: e[2])[0]
            f.write(f"{elem_out}/cv-{best_k}/train/pattern-{pi}"
                    f"/train.model\n")


def run_refine(elem_out, max_iter, batch_size, plot_base_threshold,
               jobs, thread, pattern_index, no_shuffle,
               in_process=False, **_):
    models = [m.strip() for m in open(f"{elem_out}/select.txt")]
    if pattern_index:
        models = [models[pattern_index - 1]]
    tasks = list(enumerate(models, 1))
    run1 = _run_inproc if in_process else _run_cli

    def one(task, env):
        tid, model = task
        mdir = f"{elem_out}/model-{tid}"
        os.makedirs(mdir, exist_ok=True)
        ns = ["--no-shuffle"] if no_shuffle else []
        run1(["--fastq", f"{elem_out}/train.fq",
              "--motif-model", model, "--max-iter", max_iter,
              "--batch-size", batch_size, *ns,
              "--out1", f"{mdir}/train.model",
              "--out2", f"{mdir}/train.raw",
              "--out3", f"{mdir}/train.interim"], f"{mdir}/log", env)
        try:
            from .draw_motif import draw
            draw(mdir, f"{mdir}/rss.svg", f"{mdir}/prf.svg",
                 plot_base_threshold)
            _svg_to_png(f"{mdir}/rss.svg", f"{mdir}/rss.png")
            _svg_to_png(f"{mdir}/prf.svg", f"{mdir}/prf.png")
        except Exception as e:
            cry("draw_motif failed:", e)

    runtime.fan_out(tasks, one, 1 if in_process else jobs)


def run_scan(model, elem_out, sequence, outdir, jobs, thread,
             in_process=False, **_):
    from . import kmer_psp
    os.makedirs(outdir, exist_ok=True)
    run1 = _run_inproc if in_process else _run_cli
    with open(f"{outdir}/scan.fq", "w") as f, \
            open(f"{outdir}/log", "a") as lg:
        _stderr_to(lg, kmer_psp.run, sequence, None, f)
    if model is None:
        models = sorted(str(p) for p in
                        Path(elem_out).glob("model-*/train.model"))
        tasks = list(enumerate(models, 1))

        def one(task, env):
            i, mdl = task
            os.makedirs(f"{outdir}/model-{i}", exist_ok=True)
            run1(["scan", "--fastq", f"{outdir}/scan.fq",
                  "--motif-model", mdl,
                  "--out1", f"{outdir}/model-{i}/scan.raw"],
                 f"{outdir}/model-{i}/log", env)

        runtime.fan_out(tasks, one, 1 if in_process else jobs)
    else:
        run1(["scan", "--fastq", f"{outdir}/scan.fq",
              "--motif-model", model,
              "--out1", f"{outdir}/scan.raw"], f"{outdir}/log")


def build_parser():
    p = argparse.ArgumentParser(
        prog="elem",
        description="Tool to discover RNA structural motif elements")
    sub = p.add_subparsers(dest="subcommand")

    def common_train(q):
        q.add_argument("-w", "--max-span", type=int, default=50)
        q.add_argument("-i", "--max-iter", type=int, default=300)
        q.add_argument("-t", "--thread", type=int, default=1)
        q.add_argument("-j", "--jobs", type=int, default=1,
                       help="local task parallelism (replaces --array); "
                            "on a GPU host at most one task per card")
        q.add_argument("-a", "--array", action="store_true",
                       help="submit pattern x fold tasks as a cluster "
                            "array job (requires --sge-option-file); "
                            "without a template, uses --jobs locally")
        q.add_argument("--sge-option-file", default=None,
                       help="cluster submit template "
                            "(arrayjob_manager.hpp format)")
        q.add_argument("--in-process", dest="in_process",
                       action="store_true",
                       help="run tasks inside this process, sharing "
                            "one JAX client and compiled-kernel cache "
                            "(for a single shared accelerator)")
        q.add_argument("-b", "--batch-size", type=int, default=64)
        q.add_argument("--no-shuffle", action="store_true")

    q = sub.add_parser("init")
    q.add_argument("-p", "--positive", required=True)
    q.add_argument("-n", "--negative", default=None)
    q.add_argument("-m", "--pattern-list", required=True)
    q.add_argument("-o", "--outdir", default="elem_out")
    q.add_argument("-F", "--force-overwrite", action="store_true")
    q.add_argument("-k", "--kfold-cv", type=int, default=2)

    q = sub.add_parser("train")
    q.add_argument("-M", "--elem-out", required=True)
    q.add_argument("--pattern-index", type=int, default=None)
    common_train(q)

    q = sub.add_parser("select")
    q.add_argument("-M", "--elem-out", required=True)
    q.add_argument("-N", "--num-motifs", type=int, default=3)

    q = sub.add_parser("refine")
    q.add_argument("-M", "--elem-out", required=True)
    q.add_argument("--pattern-index", type=int, default=None)
    q.add_argument("-P", "--plot-base-threshold", type=float,
                   default=1.5)
    common_train(q)

    q = sub.add_parser("scan")
    q.add_argument("-s", "--sequence", required=True)
    grp = q.add_mutually_exclusive_group(required=True)
    grp.add_argument("-m", "--model", default=None)
    grp.add_argument("-M", "--elem-out", default=None)
    q.add_argument("-o", "--outdir", default="scan_out")
    q.add_argument("-t", "--thread", type=int, default=1)
    q.add_argument("-j", "--jobs", type=int, default=1)
    q.add_argument("-a", "--array", action="store_true")
    q.add_argument("-F", "--force-overwrite", action="store_true")

    q = sub.add_parser(
        "roc", help="per-position motif-inference ROC rows from "
                    "scan.raw (_run-rnaelem-h3.py)")
    q.add_argument("raw", nargs="+")

    q = sub.add_parser("pipeline")
    q.add_argument("-p", "--positive", required=True)
    q.add_argument("-n", "--negative", default=None)
    q.add_argument("-m", "--pattern-list", required=True)
    q.add_argument("-o", "--outdir", default="elem_out")
    q.add_argument("-F", "--force-overwrite", action="store_true")
    q.add_argument("-k", "--kfold-cv", type=int, default=2)
    q.add_argument("-N", "--num-motifs", type=int, default=3)
    q.add_argument("-P", "--plot-base-threshold", type=float,
                   default=1.5)
    common_train(q)
    return p


def main(argv=None):
    opts = vars(build_parser().parse_args(argv))
    sub = opts.pop("subcommand")
    if "outdir" in opts and sub in ("init", "pipeline"):
        if os.path.exists(opts["outdir"]) and \
                not opts["force_overwrite"]:
            cry("already exists:", opts["outdir"])
            raise SystemExit(1)
    if opts.get("kfold_cv", 2) < 2:
        cry("kfold_cv must be greater than 1")
        raise SystemExit(1)
    if sub == "pipeline":
        run_init(opts["positive"], opts["negative"],
                 opts["pattern_list"], opts["outdir"],
                 opts["kfold_cv"])
        opts["elem_out"] = opts["outdir"]
        opts["pattern_index"] = None
        run_train(**opts)
        run_select(**opts)
        run_refine(**opts)
    elif sub == "init":
        run_init(opts["positive"], opts["negative"],
                 opts["pattern_list"], opts["outdir"], opts["kfold_cv"])
    elif sub == "train":
        run_train(**opts)
    elif sub == "select":
        run_select(**opts)
    elif sub == "refine":
        run_refine(**opts)
    elif sub == "scan":
        run_scan(**opts)
    elif sub == "roc":
        from .positional_roc import run as roc_run
        try:
            roc_run(opts["raw"])
        except BrokenPipeError:
            pass
    else:
        build_parser().print_help()
        raise SystemExit(1)


if __name__ == "__main__":
    main()
