"""TWO-PROCESS distributed init (VERDICT r2 #7): spawn 2 CPU processes with a
local coordinator, run parallel/distributed.initialize in each, build a mesh
over the GLOBAL device set, and psum across process boundaries — the one seam
--xla_force_host_platform_device_count cannot fake (it is always
single-process). Replaces the deepspeed launcher role at reference
scripts/llama/llama3_8b_sft.sh:9."""
import os
import socket
import subprocess
import sys

import pytest

_WORKER = r"""
import os, sys
sys.path.insert(0, os.environ["SLIME_REPO"])
import jax
jax.config.update("jax_platforms", "cpu")

from slime_jax.parallel import distributed as dist

dist.initialize()  # env fallbacks: COORDINATOR_ADDRESS/NUM_PROCESSES/PROCESS_ID

import numpy as np
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

assert jax.process_count() == 2, jax.process_count()
assert dist.process_count() == 2
pid = dist.process_index()

# 2 processes x 2 local devices = 4 global devices
devs = jax.devices()
assert len(devs) == 4, devs
mesh = Mesh(np.asarray(devs).reshape(4), ("data",))

# each host contributes its slice of a global batch (local_batch_slice), then
# one jitted psum runs across the process boundary
sl = dist.local_batch_slice(8)
assert sl == slice(pid * 4, pid * 4 + 4), sl
local = np.arange(8, dtype=np.float32)[sl].reshape(2, 2)
garr = jax.make_array_from_process_local_data(
    NamedSharding(mesh, P("data")), local, (4, 2))

@jax.jit
def total(x):
    return jnp.sum(x)

got = float(total(garr))
want = float(np.arange(8).sum())
assert got == want, (got, want)

dist.barrier("done")
if dist.is_main_process():
    print("MULTIPROC-OK", got)
"""


@pytest.mark.slow
def test_two_process_psum(tmp_path):
    # free port for the coordinator
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()

    script = tmp_path / "worker.py"
    script.write_text(_WORKER)

    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.pop("JAX_PLATFORMS", None)
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
        env["SLIME_REPO"] = os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))
        env["COORDINATOR_ADDRESS"] = f"localhost:{port}"
        env["NUM_PROCESSES"] = "2"
        env["PROCESS_ID"] = str(pid)
        # each process needs its own compile cache to avoid write races
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / f"cache{pid}")
        procs.append(subprocess.Popen(
            [sys.executable, str(script)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))

    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((p.returncode, out, err))

    for rc, out, err in outs:
        assert rc == 0, f"rc={rc}\nstdout:{out[-1000:]}\nstderr:{err[-3000:]}"
    assert any("MULTIPROC-OK 28.0" in out for _, out, _ in outs), outs
