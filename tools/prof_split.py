"""Split timing: forward-only DP vs full fn/grad vs BPP pass, len-100x64.

Usage: python tools/prof_split.py [--trace DIR] [--nseq N] [--len L]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace", default="")
    ap.add_argument("--nseq", type=int, default=64)
    ap.add_argument("--len", type=int, default=100, dest="L")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import jax
    from rnaelem_tpu import runtime
    from rnaelem_tpu.alphabet import seq_to_ints
    from rnaelem_tpu.model import joint as J
    from rnaelem_tpu.train import objective as OBJ

    dtype = runtime.setup()
    nseq, L = args.nseq, args.L
    cfg = J.ModelConfig(pattern="(.....)", Lp=L, max_span=50,
                        max_iloop=30, min_bpp=1e-4, tau=0.1,
                        rho_theta=0.1, rho_lambda=0.1, dtype=dtype)
    k = J.kernels(cfg)
    params = J.init_params(k.g, cfg, np.dtype(dtype))
    rng = np.random.RandomState(0)
    reads = []
    for i in range(nseq):
        s = "".join("ACGU"[c] for c in rng.randint(0, 4, L))
        q = np.full(L + 1, 10 + (i % 3))
        q[-1] = 0
        reads.append((seq_to_ints(s), q))

    def t(label, fn, reps=args.reps):
        t0 = time.time()
        r = fn()
        jax.block_until_ready(r)
        compile_t = time.time() - t0
        t0 = time.time()
        for _ in range(reps):
            r = fn()
        jax.block_until_ready(r)
        dt = (time.time() - t0) / reps
        print(f"{label:28s} compile+1 {compile_t:7.2f}s   steady {dt*1e3:9.2f} ms", flush=True)
        return r

    # 1. bpp mask pass
    sds = [J.make_seqdata(cfg, s, q) for s, q in reads]
    sd_b = jax.tree.map(lambda *xs: __import__('jax').numpy.stack(xs), *sds)
    bp_ok, eff = t("bpp_mask(null fwd+vjp)",
                   lambda: J._effective_bp_mask_batch_jit(cfg, sd_b))

    batch = OBJ.stack_reads(cfg, reads)

    # 2. forward-only joint parts
    import functools
    import jax.numpy as jnp

    @functools.partial(jax.jit, static_argnums=0)
    def fwd(cfg, params, sd_b, bp_ok_b):
        return J._batch_logZ_parts_jit(cfg, params, sd_b, None, bp_ok_b)

    t("joint forward (parts)", lambda: fwd(cfg, params, batch.sd, batch.bp_ok))

    # 3. full fn/grad
    t("fn+grad (fwd+bwd)", lambda: OBJ.batch_fn_grad(cfg, params, batch))

    if args.trace:
        with jax.profiler.trace(args.trace):
            r = OBJ.batch_fn_grad(cfg, params, batch)
            jax.block_until_ready(r)
        print("trace written to", args.trace)


if __name__ == "__main__":
    main()
