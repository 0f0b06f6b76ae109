"""Profiling harness: break the train-eval hot path into components."""
import functools
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
import jax
import jax.numpy as jnp

from rnaelem_tpu import runtime
from rnaelem_tpu.alphabet import seq_to_ints
from rnaelem_tpu.model import joint as J
from rnaelem_tpu.train import objective as OBJ


def timeit(name, f, reps=3):
    r = f()
    jax.block_until_ready(r)
    t0 = time.time()
    for _ in range(reps):
        r = f()
    jax.block_until_ready(r)
    dt = (time.time() - t0) / reps
    print(f"{name:42s} {dt*1000:9.1f} ms")
    return dt


def main():
    dtype = runtime.setup()
    nseq, L = 64, 100
    cfg = J.ModelConfig(pattern="(.....)", Lp=L, max_span=50,
                        max_iloop=30, min_bpp=1e-4, tau=0.1,
                        rho_theta=0.1, rho_lambda=0.1, dtype=dtype)
    params = J.init_params(J.kernels(cfg).g, cfg, np.dtype(dtype))
    rng = np.random.RandomState(0)
    reads = []
    for i in range(nseq):
        s = "".join("ACGU"[c] for c in rng.randint(0, 4, L))
        q = np.full(L + 1, 10 + (i % 3))
        q[-1] = 0
        reads.append((seq_to_ints(s), q))
    batch = OBJ.stack_reads(cfg, reads)
    k = J.kernels(cfg)

    # 1. bp masks (null DP fwd+vjp)
    timeit("bp_masks (null fwd+vjp, batch)", lambda: OBJ.batch_bp_masks(cfg, batch.sd))

    # 2. forward-only joint parts (vmap over batch)
    @jax.jit
    def fwd_only(params, sd, bp_ok):
        return J._batch_logZ_parts_jit(cfg, params, sd, None, bp_ok)
    timeit("joint forward only (batch)", lambda: fwd_only(params, batch.sd, batch.bp_ok))

    # 3. full fn+grad
    timeit("fn+grad (batch_fn_grad)", lambda: OBJ.batch_fn_grad(cfg, params, batch))

    # 4. factors-only
    @jax.jit
    def factors_only(params, sd, bp_ok):
        return J.batch_factors(cfg, params, sd, bp_ok)
    timeit("factor construction only", lambda: factors_only(params, batch.sd, batch.bp_ok))


if __name__ == "__main__":
    main()
