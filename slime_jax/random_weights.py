"""Random SliME parameters at full width, generated on the device from a seed.

For smoke runs and benchmarks where no released checkpoint is available: the
shapes, dtypes and layouts are exactly what a loaded checkpoint gives the
engine and the trainer (LLM layers pre-stacked, llama.stack_layers layout), and
the values are random. Generating on the device keeps a 16 GB bf16 decoder
from being built and copied on the host.
"""
from __future__ import annotations

from typing import Dict

import jax
import jax.numpy as jnp

from .config import LLMConfig, SliMEConfig
from .models import projector as proj_mod
from .models import sampler as samp_mod
from .models import vit

STD = 0.02


def _bf16(key, shape):
    return jax.jit(lambda k: jax.random.normal(k, shape, jnp.bfloat16) * STD)(key)


def _int8(key, shape):
    """Per-row int8 weight-only dict ({"q", "scale"}, ops/quantization.py
    layout) whose dequantized values have standard deviation STD."""
    q = jax.jit(lambda k: jax.random.randint(k, shape, -127, 128, jnp.int8))(key)
    # uniform over [-127, 127] has std 127 / sqrt(3)
    scale = jnp.full(shape[:-1] + (1,), STD * 3 ** 0.5 / 127.0, jnp.float32)
    return {"q": q, "scale": scale}


def random_llm(cfg: LLMConfig, key, fmt: str = "bf16") -> Dict:
    """Decoder params with stacked layers; fmt "bf16" or "int8" (weight-only
    int8 on every projection and the LM head; embeddings stay bf16)."""
    if fmt not in ("bf16", "int8"):
        raise ValueError(f"fmt must be bf16 or int8, got {fmt!r}")
    NL, H, HD, I = (cfg.num_layers, cfg.hidden_size, cfg.head_dim,
                    cfg.intermediate_size)
    shapes = {
        "q_proj": (cfg.num_heads * HD, H),
        "k_proj": (cfg.num_kv_heads * HD, H),
        "v_proj": (cfg.num_kv_heads * HD, H),
        "o_proj": (H, cfg.num_heads * HD),
        "gate_proj": (I, H),
        "up_proj": (I, H),
        "down_proj": (H, I),
    }
    make = _bf16 if fmt == "bf16" else _int8
    keys = jax.random.split(key, len(shapes) + 2)
    layers = {name: {"weight": make(k, (NL,) + shp)}
              for k, (name, shp) in zip(keys, shapes.items())}
    layers["input_layernorm"] = {"weight": jnp.ones((NL, H), jnp.float32)}
    layers["post_attention_layernorm"] = {"weight": jnp.ones((NL, H),
                                                             jnp.float32)}
    return {
        "embed_tokens": _bf16(keys[-2], (cfg.vocab_size, H)),
        "norm": {"weight": jnp.ones((H,), jnp.float32)},
        "layers": layers,
        "lm_head": {"weight": make(keys[-1], (cfg.vocab_size, H))},
    }


def random_slime(cfg: SliMEConfig, seed: int, llm_fmt: str = "bf16",
                 adapter_dtype=jnp.bfloat16) -> Dict:
    """Full SliME params: bf16 vision tower, projector and sampler in
    ``adapter_dtype`` (float32 when they are trained), decoder in ``llm_fmt``."""
    key = jax.random.PRNGKey(seed)
    kv, kp, ks, kl = jax.random.split(key, 4)
    cast = lambda tree, dt: jax.tree_util.tree_map(
        lambda x: x.astype(dt) if x.dtype == jnp.float32 else x, tree)
    params = {
        "vision": cast(vit.init(kv, cfg.vision), jnp.bfloat16),
        "projector": cast(proj_mod.init(kp, cfg), adapter_dtype),
        "llm": random_llm(cfg.llm, kl, llm_fmt),
    }
    if cfg.has_sampler:
        params["sampler"] = cast(samp_mod.init(ks, cfg), adapter_dtype)
    return params
