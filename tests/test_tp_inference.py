"""Tensor-parallel inference/serving on the virtual mesh: generate() and the
continuous-batching engine produce the same greedy tokens sharded as unsharded.

This is the serving-side counterpart of the Megatron TP train sharding — one
engine serving a model wider than a single device (the 70B serving story). The
reference has no equivalent (one whole model per GPU worker,
llava/serve/model_worker.py)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from slime_jax.config import SliMEConfig
from slime_jax.constants import IMAGE_TOKEN_INDEX
from slime_jax.generate import generate
from slime_jax.models import slime
from slime_jax.parallel import mesh as mesh_lib
from slime_jax.serve.batch_engine import BatchDecodeEngine, Request


@pytest.fixture(scope="module")
def setup():
    cfg = SliMEConfig.tiny()
    params = slime.init(jax.random.PRNGKey(0), cfg)
    return cfg, params


@pytest.mark.slow  # heavy: compile-bound; runs in the full tier (make test)
def test_generate_tp_matches_single(setup):
    cfg, params = setup
    rng = np.random.default_rng(0)
    ids = rng.integers(5, cfg.llm.vocab_size, (1, 9)).astype(np.int32)
    mask = np.ones((1, 9), bool)
    ref = np.asarray(generate(params, cfg, ids, mask, max_new_tokens=8,
                              eos_id=-1))
    mesh = mesh_lib.make_mesh(1, 1, 2, devices=jax.devices()[:2])   # pure TP over 2 virtual devices
    got = np.asarray(generate(params, cfg, ids, mask, max_new_tokens=8,
                              eos_id=-1, mesh=mesh))
    np.testing.assert_array_equal(ref, got)


@pytest.mark.slow  # heavy: compile-bound; runs in the full tier (make test)
def test_generate_tp_multimodal(setup):
    cfg, params = setup
    rng = np.random.default_rng(1)
    t = cfg.vision.image_size
    MC = 1 + cfg.max_local_crops
    ids = rng.integers(5, cfg.llm.vocab_size, (1, 10)).astype(np.int32)
    ids[0, 2] = IMAGE_TOKEN_INDEX
    mask = np.ones((1, 10), bool)
    pix = rng.standard_normal((1, MC, 3, t, t)).astype(np.float32)
    cmask = np.ones((1, MC), bool)
    ref = np.asarray(generate(params, cfg, ids, mask, pix, cmask,
                              max_new_tokens=6, eos_id=-1))
    mesh = mesh_lib.make_mesh(1, 1, 2, devices=jax.devices()[:2])
    got = np.asarray(generate(params, cfg, ids, mask, pix, cmask,
                              max_new_tokens=6, eos_id=-1, mesh=mesh))
    np.testing.assert_array_equal(ref, got)


@pytest.mark.slow
def test_engine_tp_matches_plain(setup):
    cfg, params = setup
    rng = np.random.default_rng(2)
    prompts = [rng.integers(5, cfg.llm.vocab_size, (5 + 2 * i,)).astype(np.int32)
               for i in range(3)]

    def run(mesh):
        eng = BatchDecodeEngine(params, cfg, max_slots=4, cache_len=64,
                                mesh=mesh)
        reqs = [Request(input_ids=p, max_new_tokens=5) for p in prompts]
        for r in reqs:
            eng.submit(r)
        for _ in range(40):
            if eng.tick() == 0 and eng.pending.empty():
                break
        out = []
        for r in reqs:
            toks = []
            for chunk in r.stream():
                toks.extend(chunk)
            out.append(toks)
        return out

    plain = run(None)
    tp = run(mesh_lib.make_mesh(1, 1, 2, devices=jax.devices()[:2]))
    assert plain == tp, (plain, tp)
    assert all(len(t) >= 1 for t in plain)


@pytest.mark.slow
def test_engine_tp_cache_actually_sharded(setup):
    cfg, params = setup
    mesh = mesh_lib.make_mesh(1, 1, 2, devices=jax.devices()[:2])
    eng = BatchDecodeEngine(params, cfg, max_slots=2, cache_len=32, mesh=mesh)
    from jax.sharding import PartitionSpec as P
    assert eng.cache["k"].sharding.spec == P(None, None, None, "model", None), \
        eng.cache["k"].sharding
