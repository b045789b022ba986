"""What the program does about the device it finds: the chip smoke refuses to
run without a GPU, the compile cache goes where the rule says, and the peak
table knows its devices and nothing else."""
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(**extra):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env.update(extra)
    return env


def _run(args, cwd=REPO, env=None):
    return subprocess.run([sys.executable] + args, cwd=cwd,
                          env=env or _env(), capture_output=True, text=True,
                          timeout=240)


def test_chip_smoke_fails_on_cpu():
    r = _run(["chip_smoke.py"])
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """Copied out of the repository, the script has nothing to run."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], cwd=str(tmp_path))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


_CACHE_PROBE = """
import sys
sys.path.insert(0, {repo!r})
import jax, jax.numpy as jnp
from slime_jax.utils import enable_compilation_cache
path = enable_compilation_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
jax.jit(lambda x: jnp.sin(x) * {salt})(jnp.ones(3)).block_until_ready()
print("PATH=" + path)
print("CONFIG=" + str(jax.config.jax_compilation_cache_dir))
"""


def _probe(salt, **env):
    r = _run(["-c", _CACHE_PROBE.format(repo=REPO, salt=salt)],
             env=_env(**env))
    assert r.returncode == 0, r.stderr[-2000:]
    lines = dict(line.split("=", 1) for line in r.stdout.splitlines()
                 if "=" in line)
    return lines["PATH"], lines["CONFIG"]


def test_compile_cache_follows_env_var(tmp_path):
    cache = str(tmp_path / "cc")
    path, config = _probe(3.25, JAX_COMPILATION_CACHE_DIR=cache)
    assert path == cache and config == cache
    assert os.listdir(cache), "nothing was written to the cache directory"


def test_compile_cache_default_is_in_checkout():
    path, config = _probe(4.5)
    want = os.path.join(REPO, ".jax_compile_cache")
    assert path == want and config == want
    assert os.path.isdir(want)


_FLAGS_PROBE = ("import os, slime_jax, jax; jax.devices(); "
                "print('FLAGS=' + os.environ['XLA_FLAGS'])")


@pytest.mark.parametrize("given, want", [
    (None, "--xla_gpu_enable_triton_gemm=false"),
    ("--xla_force_host_platform_device_count=2",
     "--xla_force_host_platform_device_count=2 "
     "--xla_gpu_enable_triton_gemm=false"),
    ("--xla_gpu_enable_triton_gemm=true", "--xla_gpu_enable_triton_gemm=true"),
])
def test_import_sends_gemms_to_cublas(given, want):
    """Importing the package turns XLA's Triton GEMM fusions off unless
    XLA_FLAGS already decides; the CPU backend accepts the flag."""
    env = _env(**({"XLA_FLAGS": given} if given else {}))
    r = _run(["-c", _FLAGS_PROBE], env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "FLAGS=" + want


def test_peak_table_knows_h100():
    from slime_jax.utils import bf16_peak_flops
    assert bf16_peak_flops("NVIDIA H100 80GB HBM3") == 989e12


@pytest.mark.parametrize("kind", ["cpu", "AMD Instinct MI300X", "NVIDIA A100-SXM4-80GB"])
def test_peak_table_raises_on_unknown_device(kind):
    from slime_jax.utils import bf16_peak_flops
    with pytest.raises(ValueError, match="no bf16 peak"):
        bf16_peak_flops(kind)
