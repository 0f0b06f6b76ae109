"""The runtime set-up every entry point shares (rnaelem_tpu/runtime.py),
the per-card placement of local child processes, and chip_smoke.py's
refusal to run without a GPU."""
import os
import shutil
import subprocess
import sys
import threading
import time

import jax
import pytest

from rnaelem_tpu import cli, runtime
from rnaelem_tpu.parallel import arrayjob
from rnaelem_tpu.pipeline import elem

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env,want", [
    ("/some/cache", "/some/cache"),
    (None, os.path.join(REPO, ".jax_cache")),
    ("", os.path.join(REPO, ".jax_cache")),
])
def test_cache_dir(monkeypatch, env, want):
    if env is None:
        monkeypatch.delenv(runtime.CACHE_ENV, raising=False)
    else:
        monkeypatch.setenv(runtime.CACHE_ENV, env)
    assert runtime.cache_dir() == want


@pytest.mark.parametrize("platform,want", [
    ("gpu", "float32"), ("cpu", "float64")])
def test_default_dtype(monkeypatch, platform, want):
    assert runtime.default_dtype(platform) == want
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    monkeypatch.setattr(jax.config, "update", lambda *a: None)
    assert runtime.setup() == want
    assert runtime.setup("float64") == "float64"


def test_setup_applies_cache_and_precision():
    assert runtime.setup("float64") == "float64"
    assert jax.config.jax_default_matmul_precision == \
        runtime.MATMUL_PRECISION
    assert jax.config.jax_compilation_cache_dir == runtime.cache_dir()
    assert jax.config.jax_enable_x64


def test_setup_precision_failure_raises(monkeypatch):
    monkeypatch.setattr(runtime, "MATMUL_PRECISION", "no-such-precision")
    with pytest.raises(ValueError):
        runtime.setup("float64")
    assert jax.config.jax_default_matmul_precision != "no-such-precision"


@pytest.mark.parametrize("env,want", [
    ({"JAX_PLATFORMS": "cpu", "CUDA_VISIBLE_DEVICES": "0,1"}, []),
    ({"JAX_PLATFORMS": "", "CUDA_VISIBLE_DEVICES": "2,3"}, ["2", "3"]),
    ({"JAX_PLATFORMS": "cuda", "CUDA_VISIBLE_DEVICES": ""}, []),
])
def test_local_gpus_without_opening_a_card(monkeypatch, env, want):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert runtime.local_gpus() == want


def _record_fan_out(monkeypatch, cards, n_tasks, jobs):
    """Run n_tasks through fan_out with `cards` faked; returns the card
    each task got and the largest set of cards in use at one time."""
    monkeypatch.setattr(runtime, "local_gpus", lambda: list(cards))
    lock = threading.Lock()
    active, got, most = [], {}, [0]

    def run(task, env):
        card = env.get("CUDA_VISIBLE_DEVICES")
        with lock:
            assert not cards or card not in active, (card, active)
            active.append(card)
            most[0] = max(most[0], len(active))
        time.sleep(0.05)
        with lock:
            active.remove(card)
        got[task] = card
        return task

    assert runtime.fan_out(range(n_tasks), run, jobs,
                           env={"CUDA_VISIBLE_DEVICES": "x"}) \
        == list(range(n_tasks))
    return got, most[0]


def test_fan_out_one_card_per_child(monkeypatch):
    got, most = _record_fan_out(monkeypatch, ["0", "1", "2", "3"], 6, 6)
    assert most <= 4
    assert set(got.values()) <= {"0", "1", "2", "3"}


def test_fan_out_without_cards_is_unchanged(monkeypatch):
    got, most = _record_fan_out(monkeypatch, [], 6, 6)
    assert most == 6                      # all jobs at once, as before
    assert set(got.values()) == {"x"}     # the caller's env, untouched


def test_elem_tasks_one_card_each(monkeypatch, tmp_path):
    monkeypatch.setattr(runtime, "local_gpus", lambda: ["5", "6"])
    seen = []
    monkeypatch.setattr(elem, "_run_cli", lambda argv, log, env=None:
                        seen.append(env["CUDA_VISIBLE_DEVICES"]))
    out = tmp_path / "elem"
    for i in (1, 2, 3):
        (out / f"model-{i}").mkdir(parents=True)
        (out / f"model-{i}" / "train.model").write_text("")
    elem.run_scan(model=None, elem_out=str(out),
                  sequence=os.path.join(REPO, "tests", "fixtures",
                                        "material", "positive.fa"),
                  outdir=str(tmp_path / "scan"), jobs=8, thread=1)
    assert len(seen) == 3 and set(seen) <= {"5", "6"}


def test_array_slaves_one_card_each(monkeypatch, tmp_path):
    monkeypatch.setattr(runtime, "local_gpus", lambda: ["0", "1"])
    out = tmp_path / "slave"
    code = ("import os, time; t = os.environ['SGE_TASK_ID']; "
            f"open(r'{out}' + t, 'w').write("
            "os.environ['CUDA_VISIBLE_DEVICES'] + ' %.3f' % time.time());"
            " time.sleep(0.3); "
            f"open(r'{out}' + t, 'a').write(' %.3f' % time.time())")
    arrayjob.submit_local([sys.executable, "-c", code], 4)
    rows = [(tmp_path / f"slave{t}").read_text().split()
            for t in range(1, 5)]
    assert {r[0] for r in rows} == {"0", "1"}
    for t0 in (float(r[1]) for r in rows):   # <= 2 slaves at any time
        assert sum(float(a) <= t0 < float(b) for _, a, b in rows) <= 2


def test_array_master_on_gpu_host(monkeypatch):
    monkeypatch.setattr(runtime, "local_gpus", lambda: ["0"])
    args = cli.build_parser().parse_args(["train", "--array", "2"])
    assert cli._local_array_on_gpus(args)
    args = cli.build_parser().parse_args(
        ["train", "--array", "2", "--sge-option-file", "opts"])
    assert not cli._local_array_on_gpus(args)
    with pytest.raises(SystemExit, match="--mesh"):
        cli.main(["-f", "x.fq", "-m", "(...)", "--array", "2"])
    monkeypatch.setattr(runtime, "local_gpus", lambda: [])
    args = cli.build_parser().parse_args(["train", "--array", "2"])
    assert not cli._local_array_on_gpus(args)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_without_gpu(tmp_path, alone):
    """No GPU under JAX_PLATFORMS=cpu, and no package next to a lone
    copy of the script: either way a non-zero exit and no result."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if alone:
        shutil.copy(script, tmp_path)
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
