"""scripts/verify_released_weights.py end-to-end against a locally-exported
tiny checkpoint: record -> verify passes; corrupt a weight -> verify FAILS.
(The real target — released SliME-8B — needs egress; this pins that the one
command works the day weights are reachable. VERDICT r3 #1/#5.)"""
import importlib.util
import os
import sys

import numpy as np
import pytest

import jax

from slime_jax import checkpoint as ckpt
from slime_jax.config import SliMEConfig
from slime_jax.models import slime

_SCRIPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "scripts", "verify_released_weights.py")


def _load_module():
    spec = importlib.util.spec_from_file_location("verify_released_weights",
                                                  _SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    cfg = SliMEConfig.tiny()
    params = slime.init(jax.random.PRNGKey(0), cfg)
    d = str(tmp_path_factory.mktemp("released"))
    ckpt.save_checkpoint(d, params, cfg)
    cfg.save(d)
    # Record the golden here so every test in this module is self-sufficient
    # (they run verify without --record and need slime_jax_golden.npz).
    assert _load_module().main([d, "--record", "--skip-quant"]) == 0
    return d


@pytest.mark.slow  # heavy: compile-bound; runs in the full tier (make test)
def test_record_then_verify_passes(exported, capsys):
    mod = _load_module()
    assert mod.main([exported, "--record", "--skip-quant"]) == 0
    assert os.path.exists(os.path.join(exported, "slime_jax_golden.npz"))
    assert mod.main([exported, "--skip-quant"]) == 0
    out = capsys.readouterr().out
    assert "[PASS] logit_parity" in out
    assert "[PASS] greedy_generation_2" in out


@pytest.mark.slow  # heavy: compile-bound; runs in the full tier (make test)
def test_quant_modes_report(exported, capsys):
    """int8/int4 loads run and report top-1 agreement; at tiny width we only
    require the checks to execute and int8 to clear a loose bar."""
    mod = _load_module()
    rc = mod.main([exported, "--top1-int8", "0.5", "--top1-int4", "0.0"])
    out = capsys.readouterr().out
    assert "load_int8" in out and "load_int4" in out
    assert rc == 0


def test_corrupted_weight_fails(exported, tmp_path, capsys):
    import shutil

    import torch

    d = str(tmp_path / "bad")
    shutil.copytree(exported, d)
    # corrupt: add noise to every q_proj weight in the saved state dict
    fp = next(os.path.join(d, f) for f in os.listdir(d)
              if f in ("model.safetensors", "pytorch_model.bin"))
    if fp.endswith(".safetensors"):
        from safetensors.torch import load_file, save_file
        sd = load_file(fp)
    else:
        sd = torch.load(fp, map_location="cpu", weights_only=True)
    for k in sd:
        if "q_proj.weight" in k:
            sd[k] = sd[k] + 0.05 * torch.randn_like(sd[k].float()).to(sd[k].dtype)
    if fp.endswith(".safetensors"):
        save_file(sd, fp)
    else:
        torch.save(sd, fp)

    mod = _load_module()
    assert mod.main([d, "--skip-quant"]) == 1
    out = capsys.readouterr().out
    assert "[FAIL]" in out
