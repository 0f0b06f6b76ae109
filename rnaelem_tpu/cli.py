"""``rnaelem`` command-line app: the reference binary's flag surface
(application.hpp:76-301, main.cpp:20-163) on the JAX engine.

Modes: (default) train+scan, ``train``, ``scan``, ``eval``,
``array-eval`` (distributed gradient slave), ``gen-neg``.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np


def _out_stream(name: str, mode="w"):
    if name == "~COUT~":
        return sys.stdout
    if name == "~CERR~":
        return sys.stderr
    if name == "~NULL~":
        return open(os.devnull, "w")
    return open(name, mode)


def _round_up(n, m=16):
    return ((n + m - 1) // m) * m


def build_parser():
    p = argparse.ArgumentParser(
        prog="rnaelem",
        description="RNA sequence-structure motif learning (JAX)")
    p.add_argument("mode", nargs="?", default="normal",
                   choices=["normal", "train", "scan", "eval",
                            "array-eval", "gen-neg", "develop"])
    p.add_argument("-f", "--fastq", dest="seq_fname", default="~NONE~")
    p.add_argument("-m", "--motif-pattern", dest="pattern",
                   default="~NONE~")
    p.add_argument("-q", "--motif-model", dest="model_fname",
                   default="~NONE~")
    p.add_argument("-i", "--max-iter", type=int, default=100)
    p.add_argument("--out1", default="~COUT~")
    p.add_argument("--out2", default="~COUT~")
    p.add_argument("--out3", default="~COUT~")
    p.add_argument("--energy-param", dest="ene_param", default="~T2004~")
    p.add_argument("-w", "--max-span", type=int, default=50)
    p.add_argument("-c", "--max-internal-loop", type=int, default=30)
    p.add_argument("--epsilon", type=float, default=1e-5)
    p.add_argument("--rho-s", type=float, default=1e-1)
    p.add_argument("--rho-theta", type=float, default=1e-1)
    p.add_argument("--rho-lambda", type=float, default=1e-1)
    p.add_argument("--tau", type=float, default=1e-1)
    p.add_argument("--lambda-init", type=float, default=0.0)
    p.add_argument("--lambda-prior", type=float, default=0.0)
    p.add_argument("-p", "--min-bpp", type=float, default=1e-4)
    p.add_argument("--param-set", default="")
    p.add_argument("-a", "--array", type=int, default=1)
    p.add_argument("--tmp", default="~NULL~")
    p.add_argument("--sge-option-file", default="~DEFAULT~",
                   help="cluster submit template for --array "
                        "(arrayjob_manager.hpp:32-108 format); "
                        "~DEFAULT~ runs slaves as local subprocesses")
    p.add_argument("--font", default="~DEFAULT~")
    p.add_argument("--no-rss", action="store_true")
    p.add_argument("--no-profile", dest="no_prf", action="store_true")
    p.add_argument("--no-energy", dest="no_ene", action="store_true")
    p.add_argument("-t", "--thread", type=int, default=1)
    p.add_argument("--no-shuffle", action="store_true")
    p.add_argument("--theta-softmax", action="store_true")
    p.add_argument("--kmer-shuf", type=int, default=2)
    p.add_argument("--lik-ratio", action="store_true")
    p.add_argument("--batch-size", type=int, default=100)
    p.add_argument("--dtype", default=None,
                   help="float32 (default on a GPU) or float64 (default "
                        "on the CPU)")
    # parsed but unused, matching the reference binary exactly: its
    # --pict is stored and never consumed (application.hpp:98-100, 323;
    # the requirement check is commented out at application.hpp:352)
    p.add_argument("--pict", dest="pic_fname", default="~NONE~",
                   help="accepted for reference CLI compatibility; "
                        "figures are produced by the elem refine step")
    # multi-chip / multi-host (replaces the reference's SGE TR_ARRAY
    # loop, motif_trainer.hpp:608-614, with one SPMD program)
    p.add_argument("--mesh", type=int, default=-1,
                   help="data-parallel mesh size: -1 auto (all local "
                        "devices when >1), 0 off, N first N devices")
    p.add_argument("--coordinator", default="",
                   help="jax.distributed coordinator address "
                        "(host:port) for multi-host meshes")
    p.add_argument("--num-processes", type=int, default=0)
    p.add_argument("--process-id", type=int, default=-1)
    return p


def _fq_maxlen(path):
    from .io.fastq import FastqReader
    qr = FastqReader(path)
    return max((len(r.seq) for r in qr.reads()), default=16)


def _build_cfg(args, Lp):
    from .model import joint as J
    pattern = args.pattern
    no_rss = args.no_rss
    if "_" in pattern:
        if "(" in pattern or ")" in pattern:
            raise SystemExit("pattern cannot mix _ and base pairs")
        no_rss = True
        pattern = pattern.replace("_", ".")
    return J.ModelConfig(
        pattern=pattern, Lp=Lp, max_span=args.max_span,
        max_iloop=args.max_internal_loop, min_bpp=args.min_bpp,
        energy=args.ene_param, theta_softmax=args.theta_softmax,
        no_ene=args.no_ene, no_rss=no_rss, no_prf=args.no_prf,
        tau=args.tau, rho_s=args.rho_s, rho_theta=args.rho_theta,
        rho_lambda=args.rho_lambda, lambda_prior=args.lambda_prior,
        dtype=args.dtype)


def _load_or_build_model(args, Lp):
    from .model import io as MIO
    from .model import joint as J
    if args.model_fname != "~NONE~":
        cfg, params = MIO.read_model(
            args.model_fname, Lp=Lp, dtype=args.dtype)
        return cfg, params
    if args.pattern == "~NONE~":
        raise SystemExit("require motif pattern or model")
    cfg = _build_cfg(args, Lp)
    params = J.init_params(J.kernels(cfg).g, cfg,
                           np.dtype(cfg.dtype))
    return cfg, params


def _parse_param_set(s):
    out = []
    for r in s.split(","):
        if not r:
            continue
        se = r.split("-")
        if len(se) == 1:
            out.append(int(se[0]))
        else:
            out.extend(range(int(se[0]), int(se[1]) + 1))
    return out or None


def _build_mesh(args):
    """Data mesh from --mesh: -1 = all local devices when more than one,
    0 = off, N = first N devices."""
    if args.mesh == 0 or args.array > 1:
        return None
    import jax
    devs = jax.devices()
    n = len(devs) if args.mesh < 0 else args.mesh
    if n <= 1:
        return None
    from .parallel.mesh import data_mesh
    return data_mesh(devs[:n])


def do_train(args, also_scan: bool):
    import dataclasses as dc
    from .model import io as MIO
    from .train.trainer import Trainer
    Lp = _round_up(_fq_maxlen(args.seq_fname))
    cfg, params = _load_or_build_model(args, Lp)
    if cfg.Lp < Lp:
        cfg = dc.replace(cfg, Lp=Lp)
    mesh = _build_mesh(args)
    print("motif pattern:", cfg.pattern, file=sys.stderr)
    print("batch size:", args.batch_size, file=sys.stderr)
    if mesh is not None:
        print("mesh:", mesh.devices.size, "devices (data-parallel)",
              file=sys.stderr)
    # multi-process: every host trains the identical SPMD program; only
    # process 0 writes files (shared-filesystem contract of the
    # reference's array mode, motif_array_trainer.hpp:20-58)
    import jax
    is_writer = jax.process_index() == 0
    interim = _out_stream(args.out3) \
        if (args.out3 != "~COUT~" and is_writer) else None
    array_eval = None
    if args.array > 1:
        # TR_ARRAY: file-based distributed gradient via N slaves (the
        # reference's SGE protocol; parallel/arrayjob.py).  Full-batch
        # semantics, mutually exclusive with --mesh.  With a real
        # --sge-option-file the slaves go through the cluster submit
        # template (arrayjob_manager.hpp:121-141); ~DEFAULT~ runs them
        # as local subprocesses (no scheduler is assumed on this host),
        # one GPU card each where the host has cards.
        from .parallel import arrayjob as AJ
        tmp = args.tmp if args.tmp not in (
            "~NULL~", "~COUT~", "~CERR~") else f"tmp{os.getpid()}"
        submit = AJ.submit_local
        if args.sge_option_file != "~DEFAULT~":
            submit = AJ.GridEngineOptions.load(
                args.sge_option_file).submitter(show=True)
        array_eval = AJ.ArrayEvaluator(
            cfg, args.array, tmp, args.seq_fname, args.lik_ratio,
            submit=submit, sge_option_file=args.sge_option_file)
    tr = Trainer(cfg, params, max_iter=args.max_iter, eps=args.epsilon,
                 lambda_init=args.lambda_init, kmer_shuf=args.kmer_shuf,
                 batch_size=args.batch_size, no_shuffle=args.no_shuffle,
                 lik_ratio=args.lik_ratio, interim_out=interim,
                 mask_indices=_parse_param_set(args.param_set),
                 mesh=mesh, array_eval=array_eval)
    tr.set_fq(args.seq_fname)
    params = tr.train()
    if not is_writer:
        return
    out1 = _out_stream(args.out1)
    MIO.write_model(out1, cfg, params)
    if out1 not in (sys.stdout, sys.stderr):
        out1.close()
    if also_scan:
        from .scan.driver import Scanner
        out2 = _out_stream(args.out2)
        Scanner(cfg, params).scan(args.seq_fname, out2)
        if out2 not in (sys.stdout, sys.stderr):
            out2.close()


def do_scan(args, out_name):
    from .model import io as MIO
    from .scan.driver import Scanner
    Lp = _round_up(_fq_maxlen(args.seq_fname))
    cfg, params = MIO.read_model(
        args.model_fname, Lp=Lp, dtype=args.dtype)
    out = _out_stream(out_name)
    Scanner(cfg, params).scan(args.seq_fname, out)
    if out not in (sys.stdout, sys.stderr):
        out.close()


def do_eval(args):
    from .model import io as MIO
    from .train.objective import eval_file
    Lp = _round_up(_fq_maxlen(args.seq_fname))
    cfg, params = MIO.read_model(
        args.model_fname, Lp=Lp, dtype=args.dtype)
    arrayeval = args.mode == "array-eval"
    if arrayeval:
        tid_env = None
        if args.sge_option_file != "~DEFAULT~":
            # rank comes from the env var the submit template names
            # (arrayjob_manager.hpp:110-119)
            from .parallel.arrayjob import GridEngineOptions
            tid_env = GridEngineOptions.load(
                args.sge_option_file).task_id_env
        tid = int(
            os.environ[tid_env] if tid_env and tid_env in os.environ
            else os.environ.get(
                "SLURM_ARRAY_TASK_ID",
                os.environ.get("SGE_TASK_ID", "1")))
        fn, gr, eff = eval_file(cfg, params, args.seq_fname,
                                args.lik_ratio,
                                shard=(tid - 1, args.array))
        tmp = _out_stream(args.tmp + "-" + str(tid))
        print("index:", tid, "/", args.array, file=tmp)
        print("fn: %.17g" % fn, file=tmp)
        print("gr: [" + ",".join("%.17g" % v for v in gr) + "]",
              file=tmp)
        print("sum eff: %.17g" % eff, file=tmp)
        tmp.close()
    else:
        fn, gr, eff = eval_file(cfg, params, args.seq_fname,
                                args.lik_ratio)
        o1, o2 = _out_stream(args.out1), _out_stream(args.out2)
        print("fn: %.17g" % fn, file=o1)
        print("gr: [" + ",".join("%.17g" % v for v in gr) + "]",
              file=o2)


def do_genneg(args):
    from .io.fastq import FastqReader
    from .alphabet import ints_to_seq
    from .pipeline.ushuffle import negative_for
    out = _out_stream(args.out1)
    qr = FastqReader(args.seq_fname)
    for i in range(args.max_iter):
        qr.clear()
        for cnt, r in enumerate(qr.reads(), 1):
            s = ints_to_seq(r.seq)
            neg = negative_for(s, args.kmer_shuf, i)
            out.write(f">iter:{i};seq:{cnt};orig:\"{r.id}\"\n{neg}\n")


def _local_array_on_gpus(args):
    """--array N with local slaves on a GPU host: the slaves take the
    cards (parallel/arrayjob.py), so this master process must not open
    one."""
    from . import runtime
    return (args.mode in ("normal", "train") and args.array > 1
            and args.sge_option_file == "~DEFAULT~"
            and bool(runtime.local_gpus()))


def main(argv=None):
    from . import runtime
    args = build_parser().parse_args(argv)
    # loudly ignored reference flags (vs --pict, which the reference
    # itself parses and never consumes — that one stays silent parity)
    if args.font != "~DEFAULT~":
        print("warning: --font is ignored; figures are SVG "
              "(pipeline/draw_motif.py), no FreeType font is needed",
              file=sys.stderr)
    if args.thread != 1:
        print("warning: --thread is ignored; sequences are batched "
              "through one device kernel — use --mesh for multi-device "
              "data parallelism or elem --jobs for task parallelism",
              file=sys.stderr)
    if args.coordinator:
        # multi-host entry point: every host runs the same command with
        # its own --process-id; jax.devices() then spans all hosts
        import jax
        jax.distributed.initialize(
            coordinator_address=args.coordinator,
            num_processes=args.num_processes or None,
            process_id=(args.process_id
                        if args.process_id >= 0 else None))
    platform = None
    if _local_array_on_gpus(args):
        if args.mode == "normal":
            raise SystemExit(
                "rnaelem: local --array slaves take every GPU card, and "
                "the scan after training needs one; run `rnaelem train "
                "--array N` and then `rnaelem scan`, or train on all "
                "cards in one process with --mesh")
        import jax
        jax.config.update("jax_platforms", "cpu")
        platform = "gpu"     # the slaves' dtype rule
    args.dtype = runtime.setup(args.dtype, platform)
    if args.mode in ("normal", "train"):
        if args.seq_fname == "~NONE~":
            raise SystemExit("require input filename (sequence)")
        do_train(args, also_scan=(args.mode == "normal"))
    elif args.mode == "scan":
        if "~NONE~" in (args.seq_fname, args.model_fname):
            raise SystemExit("require sequence and model filenames")
        do_scan(args, args.out1)
    elif args.mode in ("eval", "array-eval"):
        do_eval(args)
    elif args.mode == "gen-neg":
        do_genneg(args)
    elif args.mode == "develop":
        pass


if __name__ == "__main__":
    main()
