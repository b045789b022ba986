"""Multi-LoRA serving: one base model, per-request adapters in one batch.

Correctness contract: a slot with adapter a must emit exactly what a model
with that adapter MERGED into the weights emits; base slots batched with
adapter slots must emit exactly the base output (vLLM's multi-LoRA role —
beyond the reference, which loads one merged checkpoint per worker,
llava/model/builder.py:52-91)."""
import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")
import jax  # noqa: E402

from slime_jax.config import SliMEConfig
from slime_jax.generate import generate
from slime_jax.models import slime
from slime_jax.serve.batch_engine import BatchDecodeEngine, Request
from slime_jax.train import lora as lora_lib


@pytest.fixture(scope="module")
def setup():
    cfg = SliMEConfig.tiny()
    params = slime.init(jax.random.PRNGKey(0), cfg)
    return cfg, params


def _mk_adapter(cfg, params, seed, scale=0.1):
    """Random stacked rank-4 adapter over q/k/v/o + MLP, nonzero so outputs
    actually differ from base."""
    rng = np.random.default_rng(seed)
    L = cfg.llm.num_layers
    H = cfg.llm.hidden_size
    I = cfg.llm.intermediate_size
    hd = cfg.llm.head_dim
    r = 4
    adapters = {}
    dims = {"q_proj": cfg.llm.num_heads * hd,
            "k_proj": cfg.llm.num_kv_heads * hd,
            "v_proj": cfg.llm.num_kv_heads * hd,
            "o_proj": H, "gate_proj": I, "up_proj": I}
    ins = {"q_proj": H, "k_proj": H, "v_proj": H,
           "o_proj": cfg.llm.num_heads * hd, "gate_proj": H, "up_proj": H}
    for proj, out_d in dims.items():
        adapters[f"llm/layers/{proj}"] = {
            "A": rng.standard_normal((L, r, ins[proj])).astype(np.float32)
            * scale,
            "B": rng.standard_normal((L, out_d, r)).astype(np.float32)
            * scale}
    return {"rank": r, "alpha": r, "adapters": adapters}   # scale folds to 1


def _merged_params(params, state):
    """Merge reference: the tiny model's layers are a per-layer LIST, so
    unstack the [L, ...] adapters into per-layer paths before merging."""
    adapters = {}
    for spath, ab in state["adapters"].items():
        prefix, proj = spath.rsplit("/", 1)
        L = np.asarray(ab["A"]).shape[0]
        for li in range(L):
            adapters[f"{prefix}/{li}/{proj}"] = {
                "A": np.asarray(ab["A"])[li], "B": np.asarray(ab["B"])[li]}
    merged = lora_lib.apply_to_params(
        params, {**state, "adapters": adapters})
    # guard against the silent-no-match failure mode this helper exists for
    flat = jax.tree_util.tree_leaves(merged)
    base = jax.tree_util.tree_leaves(params)
    assert any(not np.array_equal(a, b) for a, b in zip(flat, base))
    return merged


def _run(eng, req, ticks=80):
    eng.submit(req)
    for _ in range(ticks):
        if eng.tick() == 0 and eng.pending.empty() and eng._admission is None:
            break
    out = []
    while True:
        got = req.out_queue.get(timeout=10)
        if got is None:
            return out
        out.extend(got)


@pytest.mark.slow  # heavy: compile-bound; runs in the full tier (make test)
def test_adapter_slot_matches_merged_model(setup):
    cfg, params = setup
    state = _mk_adapter(cfg, params, seed=1)
    rng = np.random.default_rng(0)
    S = 12
    ids = rng.integers(5, cfg.llm.vocab_size, (S,)).astype(np.int32)

    merged = _merged_params(params, state)
    ref = generate(merged, cfg, jnp.asarray(ids[None]), jnp.ones((1, S), bool),
                   max_new_tokens=6, eos_id=-1)
    ref = np.asarray(ref)[0].tolist()

    eng = BatchDecodeEngine(params, cfg, max_slots=2, cache_len=96)
    aid = eng.register_adapter(state)
    got = _run(eng, Request(input_ids=ids, max_new_tokens=6, adapter_id=aid))
    assert got == ref[:len(got)] and len(got) >= 3


@pytest.mark.slow  # heavy: compile-bound; runs in the full tier (make test)
def test_mixed_batch_base_and_two_adapters(setup):
    """Three slots — base, adapter1, adapter2 — decode in the SAME batched
    steps; each must match its own solo reference exactly."""
    cfg, params = setup
    s1 = _mk_adapter(cfg, params, seed=2)
    s2 = _mk_adapter(cfg, params, seed=3)
    rng = np.random.default_rng(1)
    S = 10
    prompts = [rng.integers(5, cfg.llm.vocab_size, (S,)).astype(np.int32)
               for _ in range(3)]

    refs = []
    for p, st in zip(prompts, (None, s1, s2)):
        mp = params if st is None else _merged_params(params, st)
        r = generate(mp, cfg, jnp.asarray(p[None]), jnp.ones((1, S), bool),
                     max_new_tokens=5, eos_id=-1)
        refs.append(np.asarray(r)[0].tolist())

    eng = BatchDecodeEngine(params, cfg, max_slots=4, cache_len=96)
    a1 = eng.register_adapter(s1)
    a2 = eng.register_adapter(s2)
    reqs = [Request(input_ids=prompts[0], max_new_tokens=5),
            Request(input_ids=prompts[1], max_new_tokens=5, adapter_id=a1),
            Request(input_ids=prompts[2], max_new_tokens=5, adapter_id=a2)]
    for r in reqs:
        eng.submit(r)
    for _ in range(100):
        if eng.tick() == 0 and eng.pending.empty() and eng._admission is None:
            break
    for r, ref in zip(reqs, refs):
        out = []
        while True:
            got = r.out_queue.get(timeout=10)
            if got is None:
                break
            out.extend(got)
        assert out == ref[:len(out)] and len(out) >= 2

    # adapters actually changed behavior vs base on at least one prompt
    assert refs[1] != refs[0] or refs[2] != refs[0]


def test_adapter_freed_slot_returns_to_fused_base_path(setup):
    """After the adapter request retires the engine drops back to the plain
    base path (_use_lora False), and a following base request matches the
    adapter-free engine exactly."""
    cfg, params = setup
    state = _mk_adapter(cfg, params, seed=4)
    rng = np.random.default_rng(2)
    ids = rng.integers(5, cfg.llm.vocab_size, (9,)).astype(np.int32)
    base_ref = _run(BatchDecodeEngine(params, cfg, max_slots=2, cache_len=96),
                    Request(input_ids=ids, max_new_tokens=5))

    eng = BatchDecodeEngine(params, cfg, max_slots=2, cache_len=96)
    aid = eng.register_adapter(state)
    _run(eng, Request(input_ids=ids, max_new_tokens=5, adapter_id=aid))
    assert not eng._use_lora
    got = _run(eng, Request(input_ids=ids, max_new_tokens=5))
    assert got == base_ref


def test_unknown_adapter_fails_request(setup):
    cfg, params = setup
    eng = BatchDecodeEngine(params, cfg, max_slots=2, cache_len=96)
    req = Request(input_ids=np.arange(5, 12).astype(np.int32),
                  max_new_tokens=3, adapter_id=5)
    eng.submit(req)
    for _ in range(10):
        eng.tick()
    assert req.out_queue.get(timeout=10) is None


def test_stack_adapter_state_roundtrip(setup):
    """Per-layer PEFT-style paths stack into [L, ...] arrays at the right
    layer rows."""
    cfg, _ = setup
    L = cfg.llm.num_layers
    st = {"rank": 2, "alpha": 4, "adapters": {
        "llm/layers/1/q_proj": {"A": np.ones((2, 8), np.float32),
                                "B": np.full((8, 2), 2.0, np.float32)}}}
    out = lora_lib.stack_adapter_state(st, L)
    ab = out["adapters"]["llm/layers/q_proj"]
    assert ab["A"].shape == (L, 2, 8) and ab["B"].shape == (L, 8, 2)
    assert np.asarray(ab["A"][1]).sum() == 16
    assert np.asarray(ab["A"][0]).sum() == 0
