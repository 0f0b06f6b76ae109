"""Write tests/golden/flagship_fn_gr.npz: fn and gradient of the flagship
configuration (pattern (.....), W=50, C=30, min_bpp=1e-4, Lp=100) on 8
seeded random 100-nt reads, computed on the CPU in float64 — the oracle
chip_smoke.py holds a GPU's float32 evaluation of the same point to.

Usage: JAX_PLATFORMS=cpu python tools/flagship_golden.py
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    import jax
    import bench
    from rnaelem_tpu import runtime

    if jax.default_backend() != "cpu":
        raise SystemExit("run with JAX_PLATFORMS=cpu: the golden is the "
                         "CPU float64 result")
    runtime.setup("float64")
    fn, gr = bench.flagship_fn_gr("float64")
    np.savez(bench.FLAGSHIP_GOLDEN, fn=fn, gr=gr)
    print("wrote", bench.FLAGSHIP_GOLDEN, "fn", fn, "|gr|max",
          np.abs(gr).max())


if __name__ == "__main__":
    main()
