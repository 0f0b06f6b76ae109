"""Process-wide JAX set-up and per-card placement of child processes.

Every entry point (``rnaelem``, ``elem``, bench.py, tools/ and
chip_smoke.py) calls :func:`setup` once, so the user's path and the
timed path compile the same program:

* compilation cache: ``$JAX_COMPILATION_CACHE_DIR`` when set, else one
  fixed directory inside the checkout (a cache directory that moves
  between runs never hits);
* default dtype: float32 on a GPU, float64 on the CPU (the reference
  oracle's precision);
* matmul precision: the exp-space DP chains ~100 columns of products,
  so a float32 product must not drop to TF32 (see MATMUL_PRECISION).

A JAX process reserves most of a card's memory when it first uses it,
so a second process on the same card fails.  :func:`fan_out` runs local
child processes with one card each, and never more at once than there
are cards.
"""
from __future__ import annotations

import os
import queue
import subprocess
from concurrent.futures import ThreadPoolExecutor

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache")
# "highest": true float32 products.  "high" lets XLA use TF32 on the
# GPU (~3 decimal digits per product); measured fn/gradient parity of
# both is in CHANGES.md.
MATMUL_PRECISION = "highest"


def cache_dir() -> str:
    return os.environ.get(CACHE_ENV) or CACHE_DIR


def default_dtype(platform: str) -> str:
    return "float32" if platform == "gpu" else "float64"


def setup(dtype: str | None = None, platform: str | None = None) -> str:
    """Apply the compilation cache, matmul precision and dtype; returns
    the dtype name.  `platform` defaults to JAX's default backend; pass
    it to resolve the dtype without opening a device."""
    import jax
    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_default_matmul_precision", MATMUL_PRECISION)
    dtype = dtype or default_dtype(platform or jax.default_backend())
    if dtype == "float64":
        jax.config.update("jax_enable_x64", True)
    return dtype


def local_gpus() -> list:
    """Ids of the GPU cards local children may use, found without
    opening one: none when JAX_PLATFORMS names no GPU platform, else
    CUDA_VISIBLE_DEVICES when set, else the cards nvidia-smi lists."""
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and not {"cuda", "gpu"} & set(plats.split(",")):
        return []
    vis = os.environ.get("CUDA_VISIBLE_DEVICES")
    if vis is not None:
        return [d.strip() for d in vis.split(",") if d.strip()]
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=index", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return []
    return res.stdout.split() if res.returncode == 0 else []


def fan_out(tasks, run, jobs: int, env: dict | None = None) -> list:
    """Return [run(task, env_i) for task in tasks] computed on up to
    `jobs` threads, where env_i is a copy of `env` (default: this
    process's environment).  On a GPU host each running task gets a card
    of its own in env_i["CUDA_VISIBLE_DEVICES"], and at most one task per
    card runs at once."""
    base = dict(os.environ if env is None else env)
    cards = local_gpus()
    free = queue.SimpleQueue()
    for c in cards:
        free.put(c)
    if cards:
        jobs = min(jobs, len(cards))

    def one(task):
        if not cards:
            return run(task, dict(base))
        card = free.get()
        try:
            return run(task, dict(base, CUDA_VISIBLE_DEVICES=card))
        finally:
            free.put(card)

    if jobs > 1:
        with ThreadPoolExecutor(max_workers=jobs) as ex:
            return list(ex.map(one, tasks))
    return [one(t) for t in tasks]
