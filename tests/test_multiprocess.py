"""Multi-PROCESS (multi-host) training: two local CPU processes joined
by jax.distributed must write a train.model BYTE-IDENTICAL to the
single-process run.

This is the real cross-node leg of the reference's TR_ARRAY mode
(/root/reference/RNAelem/arrayjob_manager.hpp:121-151 submit,
motif_array_trainer.hpp:20-58 collect): here the "array job" is one
SPMD program over a global mesh spanning both processes, input staging
goes through jax.make_array_from_process_local_data and per-read
outputs come back through a host allgather (parallel/mesh.py), so the
read-order reduction — and therefore the trained model — is exactly the
single-process bytes (SURVEY §4(e)).
"""
import os
import socket
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_fq(path, n, L, seed=7):
    rng = np.random.RandomState(seed)
    with open(path, "w") as f:
        for i in range(n):
            s = "".join("ACGU"[c] for c in rng.randint(0, 4, L))
            qual = "".join(chr(33 + int(q))
                           for q in rng.randint(5, 25, L))
            sentinel = "!" if i % 2 == 0 else chr(33 + 5)
            f.write(f"@r{i}\n{s}\n+\n{qual}{sentinel}\n")


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _cli_cmd(fq, out1, extra):
    return [sys.executable, "-m", "rnaelem_tpu.cli", "train",
            "-f", fq, "-m", "(...)",
            "-i", "3", "--batch-size", "8",
            "-w", "12", "-c", "8", "-p", "0",
            "--dtype", "float64",
            "--out1", out1, "--out3", "~NULL~"] + extra


def _env(n_local_devices):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=%d"
                        % n_local_devices)
    # cache OFF: serializing mesh-sharded CPU executables to the
    # persistent cache segfaults this jaxlib (tests/test_mesh_parallel)
    env["JAX_ENABLE_COMPILATION_CACHE"] = "false"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_two_process_train_byte_identical(tmp_path):
    fq = str(tmp_path / "train.fq")
    _write_fq(fq, 8, 14)

    # single-process run (any mesh size; the per-read design makes the
    # result shard-invariant — proven by test_mesh_trainer)
    single_out = str(tmp_path / "train.single.model")
    r = subprocess.run(_cli_cmd(fq, single_out, ["--mesh", "0"]),
                       env=_env(2), capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]

    # two processes x 2 local CPU devices = one global 4-device mesh
    port = _free_port()
    multi_out = str(tmp_path / "train.multi.model")
    procs = []
    for pid in range(2):
        cmd = _cli_cmd(fq, multi_out, [
            "--mesh", "-1",
            "--coordinator", f"localhost:{port}",
            "--num-processes", "2", "--process-id", str(pid)])
        procs.append(subprocess.Popen(
            cmd, env=_env(2), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        errs.append(err)
        assert p.returncode == 0, err[-3000:]

    with open(single_out, "rb") as f:
        single = f.read()
    with open(multi_out, "rb") as f:
        multi = f.read()
    assert b"pattern" in single and len(single) > 100
    assert multi == single, (errs[0][-1500:], errs[1][-1500:])
