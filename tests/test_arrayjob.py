"""File-based distributed objective evaluation (TR_ARRAY): the master
(parallel/arrayjob.py) must spawn slaves, parse their 17-digit
`tmp-<tid>` files with the reference's field/duplicate checks, and sum
to the same fn/gr as one local full-file evaluation
(/root/reference/RNAelem/motif_array_trainer.hpp:20-73,
motif_eval.hpp:23-54)."""
import os
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(__file__)
FIX = os.path.join(HERE, "fixtures")
REPO = os.path.dirname(HERE)


def _env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_array_master_matches_local(tmp_path):
    from rnaelem_tpu.parallel.arrayjob import ArrayEvaluator
    from rnaelem_tpu.model import io as MIO
    from rnaelem_tpu.train.objective import eval_file

    fq = os.path.join(FIX, "0.fq")
    cfg, params = MIO.read_model(os.path.join(FIX, "0.model"),
                                 Lp=48, dtype="float64")
    tmp = str(tmp_path / "tmp")
    env = _env()
    ev = ArrayEvaluator(
        cfg, 2, tmp, fq,
        submit=lambda argv, n: __import__(
            "rnaelem_tpu.parallel.arrayjob",
            fromlist=["submit_local"]).submit_local(argv, n, env))
    # the snapshot writer quantizes to 6 significant digits (the
    # reference's own broadcast precision) — compare against a local
    # eval of the SAME roundtripped parameters
    fn, gr, eff = ev(params)
    assert (tmp_path / "tmp-1").exists() and (tmp_path / "tmp-2").exists()
    cfg_rt, params_rt = MIO.read_model(tmp, Lp=48, dtype="float64")
    fn_ref, gr_ref, eff_ref = eval_file(cfg_rt, params_rt, fq)
    assert fn == pytest.approx(fn_ref, rel=1e-9, abs=1e-9)
    np.testing.assert_allclose(gr, gr_ref, rtol=1e-8, atol=1e-9)
    assert eff == pytest.approx(eff_ref, rel=1e-9)


def test_duplicate_and_missing_field_checks(tmp_path):
    from rnaelem_tpu.parallel.arrayjob import collect_fn_gr_eff
    p1 = tmp_path / "t-1"
    p2 = tmp_path / "t-2"
    p1.write_text("index: 1 / 2\nfn: 1.5\ngr: [1,2]\nsum eff: 0.5\n")
    p2.write_text("index: 1 / 2\nfn: 2.5\ngr: [3,4]\nsum eff: 0.25\n")
    with pytest.raises(ValueError, match="duplicate"):
        collect_fn_gr_eff(str(tmp_path / "t"), 2)
    p2.write_text("index: 2 / 2\nfn: 2.5\ngr: [3,4]\nsum eff: 0.25\n")
    fn, gr, eff = collect_fn_gr_eff(str(tmp_path / "t"), 2)
    assert fn == 4.0 and eff == 0.75
    np.testing.assert_array_equal(gr, [4.0, 6.0])
    p2.write_text("index: 2 / 2\nfn: 2.5\nsum eff: 0.25\n")
    with pytest.raises(ValueError, match="broken"):
        collect_fn_gr_eff(str(tmp_path / "t"), 2)


def _fake_scheduler(tmp_path):
    """A stand-in cluster scheduler: parses `-t 1-N`, logs the full
    submit line, and runs the quoted job N times with FAKE_TASK_ID set
    (sequentially — `-sync y` semantics)."""
    sched = tmp_path / "fake_qsub.py"
    sched.write_text("""\
import os, subprocess, sys
args = sys.argv[1:]
log = os.environ["FAKE_SCHED_LOG"]
open(log, "a").write(" ".join(args) + "\\n")
n = int(args[args.index("-t") + 1].split("-")[1])
job = args[-1]
for tid in range(1, n + 1):
    env = dict(os.environ, FAKE_TASK_ID=str(tid))
    r = subprocess.run(job, shell=True, env=env)
    if r.returncode:
        sys.exit(r.returncode)
""")
    tmpl = tmp_path / "grid_opt"
    tmpl.write_text(f"""\
command
command: {sys.executable} {sched}
task id: FAKE_TASK_ID
array: -t $from-$to
binary:
sync:
cwd:
environment:
other:
""")
    return str(tmpl)


def test_grid_engine_options_parse_and_cmd():
    """Template parsing + submit-line assembly must follow
    arrayjob_manager.hpp:32-141 ($from/$to substitution, all-8-keys
    check, non-key lines skipped)."""
    from rnaelem_tpu.parallel.arrayjob import GridEngineOptions
    ge = GridEngineOptions.load("~DEFAULT~")
    assert ge.task_id_env == "SGE_TASK_ID"
    cmd = ge.submit_cmd("RNAelem train", 7)
    assert cmd.startswith("qsub -t 1-7 -b y -sync y -cwd -V ")
    assert cmd.endswith('"RNAelem train"')
    with pytest.raises(ValueError, match="grid_engine_opt broken"):
        GridEngineOptions.parse("command: qsub\narray: -t $from-$to\n")


def test_template_submission_e2e(tmp_path, monkeypatch):
    """`--sge-option-file` drives a real submission through the fake
    scheduler: slaves get their rank from the template's task-id env
    var and the master sums their files (arrayjob_manager.hpp:121-141
    + motif_array_trainer.hpp:20-58)."""
    from rnaelem_tpu.parallel.arrayjob import (ArrayEvaluator,
                                               GridEngineOptions)
    from rnaelem_tpu.model import io as MIO
    from rnaelem_tpu.train.objective import eval_file

    tmpl = _fake_scheduler(tmp_path)
    fq = os.path.join(FIX, "0.fq")
    cfg, params = MIO.read_model(os.path.join(FIX, "0.model"),
                                 Lp=48, dtype="float64")
    log = tmp_path / "sched.log"
    for k, v in _env().items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("FAKE_SCHED_LOG", str(log))
    tmp = str(tmp_path / "tmp")
    ge = GridEngineOptions.load(tmpl)
    ev = ArrayEvaluator(cfg, 2, tmp, fq, submit=ge.submitter(),
                        sge_option_file=tmpl)
    fn, gr, eff = ev(params)
    # the scheduler was actually used, once, with -t 1-2
    sub_lines = log.read_text().strip().splitlines()
    assert len(sub_lines) == 1 and "-t 1-2" in sub_lines[0]
    cfg_rt, params_rt = MIO.read_model(tmp, Lp=48, dtype="float64")
    fn_ref, gr_ref, eff_ref = eval_file(cfg_rt, params_rt, fq)
    assert fn == pytest.approx(fn_ref, rel=1e-9, abs=1e-9)
    np.testing.assert_allclose(gr, gr_ref, rtol=1e-8, atol=1e-9)


def test_elem_array_submission(tmp_path, monkeypatch):
    """`elem train --array --sge-option-file` must write a dispatch
    script switching on the template's task-id env and submit it as one
    N-task array job (script/elem:326-364)."""
    from rnaelem_tpu.pipeline import elem as E

    tmpl = _fake_scheduler(tmp_path)
    # replace the scheduler with a pure recorder (no execution)
    rec = tmp_path / "rec.py"
    rec.write_text("import os,sys\n"
                   "open(os.environ['FAKE_SCHED_LOG'],'a')"
                   ".write(' '.join(sys.argv[1:])+'\\n')\n")
    tmpl2 = tmp_path / "grid_opt2"
    tmpl2.write_text(open(tmpl).read().replace(
        "fake_qsub.py", "rec.py"))
    out = tmp_path / "elem_out"
    (out / "cv-0" / "train").mkdir(parents=True)
    (out / "cv-1" / "train").mkdir(parents=True)
    (out / "pattern_list").write_text("(...)\n(.....)\n")
    for k in (0, 1):
        (out / f"cv-{k}" / "train" / "train.fq").write_text("")
    log = tmp_path / "sched2.log"
    monkeypatch.setenv("FAKE_SCHED_LOG", str(log))
    E.run_train(str(out), 50, 10, 64, 1, 1, None, False,
                sge_option_file=str(tmpl2), array=True)
    line = log.read_text().strip()
    assert "-t 1-4" in line                      # 2 patterns x 2 folds
    script = (out / "array_job.sh").read_text()
    assert 'tid="${FAKE_TASK_ID}"' in script
    assert script.count("rnaelem_tpu.cli") >= 4
    assert "--motif-pattern '(.....)'" in script


@pytest.mark.slow
def test_array_train_e2e(tmp_path):
    """`rnaelem train --array 2` end-to-end: 3 L-BFGS-B iterations with
    the distributed objective must produce a model close to the local
    `--array 1` run (6-digit snapshot quantization perturbs the
    trajectory slightly, as in the reference)."""
    fq = os.path.join(FIX, "0.fq")

    def run(tag, extra):
        out1 = str(tmp_path / f"train.{tag}.model")
        r = subprocess.run(
            [sys.executable, "-m", "rnaelem_tpu.cli", "train",
             "-f", fq, "-m", "(.*)", "--no-shuffle",
             "-i", "3", "--batch-size", "-1",
             "-w", "20", "-c", "8", "--dtype", "float64",
             "--out1", out1, "--out3", "~NULL~"] + extra,
            env=_env(), capture_output=True, text=True, timeout=1200,
            cwd=str(tmp_path))
        assert r.returncode == 0, r.stderr[-3000:]
        return out1

    local = run("local", [])
    arr = run("arr", ["--array", "2", "--tmp", str(tmp_path / "tmp")])
    from rnaelem_tpu.model import io as MIO
    _, p_l = MIO.read_model(local, Lp=48, dtype="float64")
    _, p_a = MIO.read_model(arr, Lp=48, dtype="float64")
    np.testing.assert_allclose(np.asarray(p_a.lam),
                               np.asarray(p_l.lam), atol=2e-3)
    np.testing.assert_allclose(np.asarray(p_a.singles),
                               np.asarray(p_l.singles), atol=2e-3)
