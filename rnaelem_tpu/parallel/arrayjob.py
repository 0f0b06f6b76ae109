"""File-based distributed objective evaluation — the reference's SGE
array-job backend (arrayjob_manager.hpp:121-151 submit,
motif_array_trainer.hpp:20-58 collect, motif_eval.hpp:23-54 slave) as a
queue-agnostic subprocess fan-out.

This is the no-mesh fallback: when devices ARE connected, the mesh path
(parallel/mesh.py) replaces the whole protocol with one SPMD program.
Here the channel is the shared filesystem, exactly like the reference:
the master writes a model snapshot (through the same 6-significant-
digit model writer the reference broadcasts with), slaves each evaluate
fn/gr over their `assigned_range` slice of the FASTQ and write a
17-digit `tmp-<tid>` text file, and the master parses and sums them.

A custom scheduler (qsub & co.) can be swapped in by passing `submit`;
the default runs the slaves as local subprocesses with `SGE_TASK_ID`
set, which is also how the 2-slave test exercises the protocol.
"""
from __future__ import annotations

import shlex
import subprocess
import sys
from typing import Callable, List, Optional

import numpy as np

F_INDEX, F_FN, F_GR, F_EFF = 1, 2, 4, 8
F_ALL = F_INDEX | F_FN | F_GR | F_EFF

# the reference's built-in template (RNAelem/grid_engine_opt:1-23),
# reproduced as data: key -> Grid Engine qsub fragment
DEFAULT_GRID_OPTIONS = {
    "command": "qsub",
    "task id": "SGE_TASK_ID",
    "array": "-t $from-$to",
    "binary": "-b y",
    "sync": "-sync y",
    "cwd": "-cwd",
    "environment": "-V",
    "other": "-e $HOME/.ugeerr -o $HOME/.ugeout -l s_vmem=1G,mem_req=1G",
}


class GridEngineOptions:
    """The reference's cluster submit-template
    (arrayjob_manager.hpp:32-141): eight `key: value` lines describing
    how to submit an N-task array job to a scheduler.  `submit(job, n)`
    builds `command array binary sync cwd environment other "job"` with
    $from/$to substituted and runs it through the shell; `task_id_env`
    names the env var each task reads its 1-based rank from."""

    KEYS = ("command", "task id", "array", "binary", "sync", "cwd",
            "environment", "other")

    def __init__(self, opts: dict):
        missing = [k for k in self.KEYS if k not in opts]
        if missing:
            raise ValueError(
                "grid_engine_opt broken: missing keys %s" % missing)
        self.opts = {k: opts[k] for k in self.KEYS}

    @classmethod
    def parse(cls, text: str) -> "GridEngineOptions":
        opts = {}
        for line in text.splitlines():
            vs = line.strip().split(":")
            if len(vs) != 2:
                continue
            key, val = vs[0].strip(), vs[1].strip()
            if key in cls.KEYS:
                opts[key] = val
            else:
                print("not used:", key, file=sys.stderr)
        return cls(opts)

    @classmethod
    def load(cls, fname: str) -> "GridEngineOptions":
        if fname == "~DEFAULT~":
            return cls(dict(DEFAULT_GRID_OPTIONS))
        with open(fname) as f:
            return cls.parse(f.read())

    @property
    def task_id_env(self) -> str:
        return self.opts["task id"]

    def submit_cmd(self, job: str, n: int) -> str:
        array = (self.opts["array"]
                 .replace("$from", "1").replace("$to", str(n)))
        parts = [self.opts["command"], array, self.opts["binary"],
                 self.opts["sync"], self.opts["cwd"],
                 self.opts["environment"], self.opts["other"],
                 '"' + job + '"']
        return " ".join(p for p in parts if p)

    def submit_job(self, job: str, n: int, show: bool = False) -> None:
        total = self.submit_cmd(job, n)
        if show:
            print("submit:", total, file=sys.stderr)
        res = subprocess.run(total, shell=True, capture_output=True,
                             text=True)
        if show and (res.stdout or res.stderr):
            print((res.stdout + res.stderr).strip("\n"), file=sys.stderr)
        if res.returncode != 0:
            raise RuntimeError(
                "array-job submission failed (%d): %s\n%s" % (
                    res.returncode, total,
                    (res.stdout + res.stderr)[-2000:]))

    def submitter(self, show: bool = False) -> Callable:
        """An ArrayEvaluator-compatible `submit` callable: joins the
        slave argv into one shell job string and submits it as an
        n-task array job through the scheduler."""
        def submit(slave_argv: List[str], n: int,
                   env: Optional[dict] = None) -> None:
            job = " ".join(shlex.quote(a) for a in slave_argv)
            self.submit_job(job, n, show=show)
        return submit


def collect_fn_gr_eff(tmp_prefix: str, n: int):
    """Parse and sum the n slave files `<tmp_prefix>-<tid>` with the
    reference's field-bitmask and duplicate-index checks
    (motif_array_trainer.hpp:29-56).  Returns (fn, gr, sum_eff)."""
    fn_total, eff_total = 0.0, 0.0
    gr_total: Optional[np.ndarray] = None
    seen = set()
    for tid in range(1, n + 1):
        path = f"{tmp_prefix}-{tid}"
        got = 0
        for line in open(path):
            line = line.strip()
            if line.startswith("index:"):
                idx = int(line.split(":")[1].split("/")[0])
                if idx in seen:
                    raise ValueError(f"duplicate slave index {idx}")
                seen.add(idx)
                got |= F_INDEX
            elif line.startswith("fn:"):
                fn_total += float(line.split(":", 1)[1])
                got |= F_FN
            elif line.startswith("gr:"):
                vec = np.array([
                    float(v) for v in
                    line.split(":", 1)[1].strip().strip("[]").split(",")
                    if v])
                gr_total = vec if gr_total is None else gr_total + vec
                got |= F_GR
            elif line.startswith("sum eff:"):
                eff_total += float(line.split(":", 1)[1])
                got |= F_EFF
        if got != F_ALL:
            raise ValueError(
                f"broken slave file {path}: field mask {got:04b}")
    return fn_total, gr_total, eff_total


def submit_local(slave_argv: List[str], n: int,
                 env: Optional[dict] = None) -> None:
    """Run n slaves as local subprocesses, rank via SGE_TASK_ID
    (the reference's DBG_ARRAY-compatible env contract,
    arrayjob_manager.hpp:110-119), and block until all finish —
    the subprocess equivalent of `qsub -t 1-N -sync y`.  On a GPU host
    each slave gets a card of its own and at most one slave per card
    runs at once (runtime.fan_out); elsewhere all n run at once."""
    from .. import runtime

    def run(tid, e):
        e["SGE_TASK_ID"] = str(tid)
        p = subprocess.run(slave_argv, env=e, stdout=subprocess.DEVNULL,
                           stderr=subprocess.PIPE, text=True)
        return p.returncode, p.stderr

    for rc, err in runtime.fan_out(range(1, n + 1), run, n, env):
        if rc != 0:
            raise RuntimeError(
                f"array-eval slave failed ({rc}):\n{err[-2000:]}")


class ArrayEvaluator:
    """Master side of one distributed objective evaluation per call
    (motif_trainer.hpp:608-614): write the model snapshot to `tmp`,
    fan out `rnaelem array-eval --fastq ... --motif-model <tmp>
    --array n --tmp <tmp>` slaves, collect fn/gr/eff."""

    def __init__(self, cfg, n: int, tmp: str, fq: str,
                 lik_ratio: bool = False,
                 submit: Callable = submit_local,
                 python: Optional[str] = None,
                 sge_option_file: str = "~DEFAULT~"):
        self.cfg = cfg
        self.n = n
        self.tmp = tmp
        self.fq = fq
        self.lik_ratio = lik_ratio
        self.submit = submit
        self.python = python or sys.executable
        self.sge_option_file = sge_option_file

    def slave_argv(self) -> List[str]:
        argv = [self.python, "-m", "rnaelem_tpu.cli", "array-eval",
                "--fastq", self.fq, "--motif-model", self.tmp,
                "--array", str(self.n), "--tmp", self.tmp,
                "--dtype", str(self.cfg.dtype)]
        if self.sge_option_file != "~DEFAULT~":
            # the slave reads its rank from the template's task-id env
            argv += ["--sge-option-file", self.sge_option_file]
        if self.lik_ratio:
            argv.append("--lik-ratio")
        return argv

    def __call__(self, params):
        from ..model import io as MIO
        MIO.write_model(self.tmp, self.cfg, params)
        self.submit(self.slave_argv(), self.n)
        return collect_fn_gr_eff(self.tmp, self.n)
