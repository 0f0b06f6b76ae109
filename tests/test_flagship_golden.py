"""The CPU float64 path reproduces tests/golden/flagship_fn_gr.npz — the
oracle chip_smoke.py holds a GPU's float32 evaluation to (regenerate
with `JAX_PLATFORMS=cpu python tools/flagship_golden.py`)."""
import numpy as np

import bench


def test_flagship_fn_gr_matches_cpu_golden():
    fn, gr = bench.flagship_fn_gr("float64")
    ref = np.load(bench.FLAGSHIP_GOLDEN)
    assert gr.shape == ref["gr"].shape
    np.testing.assert_allclose(fn, float(ref["fn"]), rtol=1e-10)
    np.testing.assert_allclose(gr, ref["gr"], rtol=1e-9,
                               atol=1e-9 * np.abs(ref["gr"]).max())
