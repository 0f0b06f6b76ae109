import os

# Tests run on a virtual 8-device CPU mesh with float64 enabled so we can
# check numerics against the f64 C++ reference.  chip_smoke.py runs the
# main path on a GPU.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    flags = (flags + " --xla_force_host_platform_device_count=8")
if "xla_cpu_max_isa" not in flags:
    # this host's cpuinfo advertises AMX but executing AMX code traps:
    # XLA:CPU's own AOT loader warns "machine type ... doesn't match",
    # and late-suite compiles segfaulted inside backend_compile_and_load
    # until codegen was capped at AVX512
    flags = flags + " --xla_cpu_max_isa=AVX512"
os.environ["XLA_FLAGS"] = flags.strip()

import jax  # noqa: E402

from rnaelem_tpu import runtime  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# The entry points' own set-up (float64, matmul precision, the
# persistent compilation cache inside the checkout).  The cache is
# REQUIRED for suite stability on this jaxlib, not just speed —
# compiling a large executable late in a long-lived process segfaulted
# inside backend_compile_and_load (each test passes in isolation); cache
# loads avoid the late live compiles.  Populate a cold cache
# file-by-file (fresh interpreter per file):  for f in tests/test_*.py;
#   do python -m pytest "$f" -q -m "not slow"; done
# The mesh tests additionally re-run themselves in fresh interpreters
# with the cache OFF: serializing a mesh-sharded CPU executable is the
# other reproducible crash (compilation_cache.put_executable_and_time).
runtime.setup("float64")

assert jax.devices()[0].platform == "cpu", jax.devices()

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")
GOLDDIR = os.path.join(os.path.dirname(__file__), "golden")
