"""Two-process jax.distributed rendezvous test.

Spawns two REAL OS processes (4 fake CPU devices each), has them
rendezvous through parallel/distributed.initialize with a localhost
coordinator, build one 8-device global mesh spanning both processes, run a
sharded env step, and reduce metrics across hosts with pmean_metrics.
This exercises the only previously untested file in parallel/
(distributed.py) end-to-end; cross-process CPU collectives ride Gloo.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

_WORKER = Path(__file__).with_name("distributed_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_rendezvous_and_sharded_step():
    port = _free_port()
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    repo_root = str(Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")

    procs = [
        subprocess.Popen(
            [sys.executable, str(_WORKER), str(pid), str(port)],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("distributed workers hung:\n" + "\n".join(outs))

    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert f"WORKER{pid} OK" in out, out

    # both processes computed the SAME replicated global mean
    vals = [
        line.split("mean_reward=")[1]
        for out in outs
        for line in out.splitlines()
        if "mean_reward=" in line
    ]
    assert len(vals) == 2 and vals[0] == vals[1], vals
