"""Checkpoint conversion and loading.

Maps HF/torch state dicts (safetensors or .bin) onto this framework's param pytrees,
covering the four reference load modes (llava/model/builder.py:26-173): full
checkpoint, base + mm_projector.bin adapter, base + LoRA (+ non_lora_trainables),
and plain LM. Also exports back to the reference key set so checkpoints stay
interchangeable (SURVEY.md §5 checkpoint/resume).
"""
from __future__ import annotations

import json
import os
import re
from typing import Dict, Iterable, Optional

import numpy as np

from .config import LLMConfig, SliMEConfig, VisionConfig


def _np(x) -> np.ndarray:
    """torch tensor / array-like -> float32 numpy (bf16-safe)."""
    if hasattr(x, "detach"):
        x = x.detach()
        if str(x.dtype) in ("torch.bfloat16", "torch.float16"):
            x = x.float()
        x = x.cpu().numpy()
    return np.asarray(x)


def load_state_dict_file(path: str) -> Dict[str, np.ndarray]:
    """Load a .safetensors or torch .bin file into numpy arrays."""
    if path.endswith(".safetensors"):
        from safetensors import safe_open
        out = {}
        with safe_open(path, framework="np") as f:
            for k in f.keys():
                try:
                    out[k] = f.get_tensor(k)
                except Exception:
                    # bf16 tensors can't map to numpy directly; go through torch
                    import torch
                    from safetensors.torch import load_file
                    return {k: _np(v) for k, v in load_file(path).items()}
        return out
    import torch
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: _np(v) for k, v in sd.items()}


def load_sharded_state_dict(model_dir: str) -> Dict[str, np.ndarray]:
    """Load all weight shards in an HF model directory."""
    index_files = [f for f in os.listdir(model_dir)
                   if f.endswith(".index.json")]
    files: Iterable[str]
    if index_files:
        with open(os.path.join(model_dir, index_files[0])) as f:
            files = sorted(set(json.load(f)["weight_map"].values()))
    else:
        files = sorted(f for f in os.listdir(model_dir)
                       if f.endswith((".safetensors", ".bin"))
                       and not f.startswith("training_args"))
    sd: Dict[str, np.ndarray] = {}
    for fn in files:
        sd.update(load_state_dict_file(os.path.join(model_dir, fn)))
    return sd


def _strip(sd: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _normalize_peft_prefixes(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Strip PEFT wrapper prefixes the reference strips at load
    (builder.py:69-75): 'base_model.' first, then one redundant leading 'model.'
    when keys start 'model.model.' (named_parameters of a PEFT-wrapped model)."""
    sd = {(k[len("base_model."):] if k.startswith("base_model.") else k): v
          for k, v in sd.items()}
    if any(k.startswith("model.model.") for k in sd):
        sd = {(k[len("model."):] if k.startswith("model.") else k): v
              for k, v in sd.items()}
    return sd


def _lora_rank_alpha(model_path: str, lora_sd: Dict[str, np.ndarray]):
    """(r, alpha) from adapter_config.json, else inferred from factor shapes
    (alpha defaults to 2r, the reference's r=128/alpha=256 ratio)."""
    cfg_fp = os.path.join(model_path, "adapter_config.json")
    ac = {}
    if os.path.exists(cfg_fp):
        with open(cfg_fp) as f:
            ac = json.load(f)
        if "r" in ac:
            return int(ac["r"]), int(ac.get("lora_alpha", 2 * ac["r"]))
    r = next((v.shape[0] for k, v in lora_sd.items() if ".lora_A." in k), None)
    if r is None:
        raise ValueError(
            f"cannot infer LoRA rank for {model_path}: adapter_config.json has "
            "no 'r' and no '.lora_A.' factors were found in the adapter state "
            "dict — unsupported adapter naming?")
    return int(r), int(ac.get("lora_alpha", 2 * r))


# ----------------------------------------------------------------------------------
# Per-module converters: torch key set -> our pytree layout.
# ----------------------------------------------------------------------------------

def _lin(sd, key, bias=True):
    pre = f"{key}." if key else ""
    p = {"weight": sd[f"{pre}weight"]}
    if bias and f"{pre}bias" in sd:
        p["bias"] = sd[f"{pre}bias"]
    return p


def _ln(sd, key):
    return {"weight": sd[f"{key}.weight"], "bias": sd[f"{key}.bias"]}


def _mha(sd, key):
    return {"in_proj_weight": sd[f"{key}.in_proj_weight"],
            "in_proj_bias": sd[f"{key}.in_proj_bias"],
            "out_proj": _lin(sd, f"{key}.out_proj")}


def convert_resampler(sd: Dict[str, np.ndarray], prefix: str = "") -> Dict:
    """Resampler state dict (sampler.py:91-173) -> resampler.init() layout."""
    sd = _strip(sd, prefix) if prefix else sd
    p = {
        "pos_embed": sd["pos_embed"].astype(np.float32),
        "query": sd["query"],
        "attn": _mha(sd, "attn"),
        "ln_q": _ln(sd, "ln_q"),
        "ln_kv": _ln(sd, "ln_kv"),
        "ln_post": _ln(sd, "ln_post"),
    }
    if "kv_proj.weight" in sd:
        p["kv_proj"] = _lin(sd, "kv_proj", bias=False)
    if "proj.weight" in sd:
        p["proj"] = _lin(sd, "proj")
    if "self_attn.in_proj_weight" in sd:
        p["self_attn"] = _mha(sd, "self_attn")
    return p


def convert_projector(sd: Dict[str, np.ndarray], cfg: SliMEConfig,
                      prefix: str = "") -> Dict:
    """mm_projector state dict -> projector.init() layout.

    Gated keys (builder.py:38-74): projection.{0,2}.{weight,bias}, attn.*, w_gate, w_noise.
    """
    sd = _strip(sd, prefix) if prefix else sd
    t = cfg.mm_projector_type
    if t == "linear":
        return {"proj": _lin(sd, "0") if "0.weight" in sd else _lin(sd, "")}
    m = re.match(r"^mlp(\d+)x_gelu$", t)
    if m:
        depth = int(m.group(1))
        return {"mlp": {"layers": [_lin(sd, str(2 * i)) for i in range(depth)]}}
    if t == "qformer":
        return {"resampler": convert_resampler(sd)}
    assert t == "gated", t
    return {
        "projection": {"layers": [_lin(sd, "projection.0"), _lin(sd, "projection.2")]},
        "attn": convert_resampler(sd, "attn."),
        "w_gate": sd["w_gate"].astype(np.float32),
        "w_noise": sd["w_noise"].astype(np.float32),
    }


def convert_sampler(sd: Dict[str, np.ndarray], cfg: SliMEConfig,
                    prefix: str = "") -> Dict:
    """TextGuidedSampler state dict (builder.py:222-281) -> sampler.init() layout."""
    sd = _strip(sd, prefix) if prefix else sd
    p: Dict = {"post_qformer": convert_resampler(sd, "post_qformer.")}
    if cfg.mm_resampler_type == "qformer":
        sel = _strip(sd, "selector.")
        p["selector"] = {
            "query": sel["query"],
            "self_attn": _mha(sel, "self_attn"),
            "cross_attn": _mha(sel, "cross_attn"),
            "ln_q": _ln(sel, "ln_q"),
            "ln_kv": _ln(sel, "ln_kv"),
            "ln_post": _ln(sel, "ln_post"),
            "prob_proj": {"fc1": _lin(sel, "prob_proj.0"),
                          "fc2": _lin(sel, "prob_proj.2")},
        }
    return p


def convert_clip_vision(sd: Dict[str, np.ndarray], cfg: VisionConfig,
                        prefix: str = "vision_model.") -> Dict:
    """HF CLIPVisionModel state dict -> vit.init() layout.

    The patch-embed conv [E,3,ph,pw] flattens to the matmul weight [E, 3*ph*pw] in
    the order matching vit.embed_patches' (c, ph, pw) patch flattening.
    """
    sd = _strip(sd, prefix) if prefix else sd
    E = cfg.hidden_size
    conv = sd["embeddings.patch_embedding.weight"]  # [E, 3, ph, pw]
    params = {
        "class_embedding": sd["embeddings.class_embedding"].reshape(E),
        "patch_embedding": conv.reshape(E, -1),
        "position_embedding": sd["embeddings.position_embedding.weight"],
        "pre_layernorm": _ln(sd, "pre_layrnorm"),  # HF's historical typo
        "layers": [],
    }
    if "post_layernorm.weight" in sd:  # absent from pre-round-2 saves
        params["post_layernorm"] = _ln(sd, "post_layernorm")
    for i in range(cfg.num_layers):
        b = f"encoder.layers.{i}"
        params["layers"].append({
            "layer_norm1": _ln(sd, f"{b}.layer_norm1"),
            "q_proj": _lin(sd, f"{b}.self_attn.q_proj"),
            "k_proj": _lin(sd, f"{b}.self_attn.k_proj"),
            "v_proj": _lin(sd, f"{b}.self_attn.v_proj"),
            "out_proj": _lin(sd, f"{b}.self_attn.out_proj"),
            "layer_norm2": _ln(sd, f"{b}.layer_norm2"),
            "fc1": _lin(sd, f"{b}.mlp.fc1"),
            "fc2": _lin(sd, f"{b}.mlp.fc2"),
        })
    return params


def convert_llama(sd: Dict[str, np.ndarray], cfg: LLMConfig,
                  prefix: str = "model.") -> Dict:
    """HF LlamaForCausalLM state dict -> llama.init() layout."""
    body = _strip(sd, prefix) if prefix else sd
    params = {
        "embed_tokens": body["embed_tokens.weight"],
        "norm": {"weight": body["norm.weight"]},
        "layers": [],
    }
    for i in range(cfg.num_layers):
        b = f"layers.{i}"
        lp = {
            "input_layernorm": {"weight": body[f"{b}.input_layernorm.weight"]},
            "q_proj": _lin(body, f"{b}.self_attn.q_proj"),
            "k_proj": _lin(body, f"{b}.self_attn.k_proj"),
            "v_proj": _lin(body, f"{b}.self_attn.v_proj"),
            "o_proj": _lin(body, f"{b}.self_attn.o_proj"),
            "post_attention_layernorm": {"weight": body[f"{b}.post_attention_layernorm.weight"]},
        }
        if cfg.num_experts > 0:
            lp["gate"] = _lin(body, f"{b}.block_sparse_moe.gate", bias=False)
            lp["experts"] = {
                "w1": np.stack([body[f"{b}.block_sparse_moe.experts.{e}.w1.weight"]
                                for e in range(cfg.num_experts)]),
                "w2": np.stack([body[f"{b}.block_sparse_moe.experts.{e}.w2.weight"]
                                for e in range(cfg.num_experts)]),
                "w3": np.stack([body[f"{b}.block_sparse_moe.experts.{e}.w3.weight"]
                                for e in range(cfg.num_experts)]),
            }
        else:
            lp["gate_proj"] = _lin(body, f"{b}.mlp.gate_proj")
            lp["up_proj"] = _lin(body, f"{b}.mlp.up_proj")
            lp["down_proj"] = _lin(body, f"{b}.mlp.down_proj")
        params["layers"].append(lp)
    if "lm_head.weight" in sd:
        params["lm_head"] = {"weight": sd["lm_head.weight"]}
    else:  # tied embeddings
        params["lm_head"] = {"weight": params["embed_tokens"]}
    return params


# ----------------------------------------------------------------------------------
# Top-level loader: the four reference load modes.
# ----------------------------------------------------------------------------------

def load_pretrained(model_path: str, *, model_base: Optional[str] = None,
                    cfg: Optional[SliMEConfig] = None,
                    vision_path: Optional[str] = None,
                    load_bits: Optional[int] = None,
                    quantize_lm_head: bool = False,
                    quantize_vision: bool = False,
                    int4_scheme: str = "default") -> Dict:
    """Load a SliME checkpoint directory into a full param pytree
    {vision, projector, sampler, llm}. Mirrors load_pretrained_model
    (llava/model/builder.py:26-173) minus the GPU-quantization paths.

    int4_scheme (load_bits=4 only): "default" = NF4 group-64 (the data type
    the reference's bnb path loads; accuracy-safe), "absmax" = per-row
    uniform int4 (quality budget in docs/Serving.md), "group" = group-128
    absmax in the "q4g" packing (group accuracy at packed-int4 bytes).
    """
    if cfg is None:
        cfg = SliMEConfig.load(model_path)

    sd = load_sharded_state_dict(model_path)

    # adapter-only checkpoints (mm_projector.bin / sampler.bin /
    # non_lora_trainables.bin) next to a base model. Each file is gated on its
    # OWN key prefixes — a dir with a weight index plus adapter bins must still
    # pick up sampler.bin after mm_projector keys are already present.
    for extra, prefixes in (
            ("mm_projector.bin", ("model.mm_projector.",)),
            ("sampler.bin", ("model.sampler.",)),
            ("non_lora_trainables.bin", ("model.mm_projector.", "model.sampler."))):
        fp = os.path.join(model_path, extra)
        if not os.path.exists(fp):
            continue
        if all(any(k.startswith(p) for k in sd) for p in prefixes):
            continue  # index-less dirs slurp the .bin files via the shard loader
        sd.update(_normalize_peft_prefixes(load_state_dict_file(fp)))

    # LoRA load mode (builder.py:52-91): low-rank factors live in
    # adapter_model.{safetensors,bin} (or inline lora_* keys) relative to
    # model_base; collected here, merged into the weights below.
    adapter_fp = next(
        (os.path.join(model_path, f)
         for f in ("adapter_model.safetensors", "adapter_model.bin")
         if os.path.exists(os.path.join(model_path, f))), None)
    lora_sd = (load_state_dict_file(adapter_fp) if adapter_fp
               else {k: v for k, v in sd.items()
                     if ".lora_A." in k or ".lora_B." in k})
    if lora_sd and model_base is None:
        raise ValueError(
            f"{model_path} is a LoRA checkpoint (low-rank adapter factors "
            "found) — pass model_base so the adapters can be merged into the "
            "base weights (reference builder.py:52-91), or pre-merge with "
            "scripts/merge_lora_weights.py")

    if model_base is not None:
        base = load_sharded_state_dict(model_base)
        base.update(sd)
        sd = base

    params: Dict = {}
    params["llm"] = convert_llama(
        {k: v for k, v in sd.items()
         if not k.startswith(("model.vision_tower", "model.mm_projector", "model.sampler"))},
        cfg.llm)
    params["projector"] = convert_projector(
        _strip(sd, "model.mm_projector."), cfg)
    if cfg.has_sampler:
        params["sampler"] = convert_sampler(_strip(sd, "model.sampler."), cfg)
    vt = _strip(sd, "model.vision_tower.vision_tower.")
    if vt:
        params["vision"] = convert_clip_vision(vt, cfg.vision)
    elif vision_path:
        params["vision"] = convert_clip_vision(
            load_sharded_state_dict(vision_path), cfg.vision)

    if lora_sd:
        # merge W <- W + (alpha/r) B @ A in place on the numpy tree (the
        # reference's PEFT merge_and_unload)
        from .train import lora as lora_lib
        r, alpha = _lora_rank_alpha(model_path, lora_sd)
        state = lora_lib.import_peft(lora_sd, r=r, alpha=alpha)
        scale = alpha / r
        merged = 0
        for path, ab in state["adapters"].items():
            node = params
            for part in path.split("/"):
                node = node[int(part)] if isinstance(node, list) else node[part]
            w = np.asarray(node["weight"], np.float32)
            delta = scale * (np.asarray(ab["B"], np.float32)
                             @ np.asarray(ab["A"], np.float32))
            node["weight"] = (w + delta).astype(np.asarray(node["weight"]).dtype)
            merged += 1
        if not merged:
            raise ValueError(
                f"LoRA adapter keys in {model_path} did not map onto any "
                "loaded weights — key-name mismatch, refusing to return an "
                "unmerged model")

    if load_bits in (4, 8):
        # bitsandbytes-equivalent quantized load (model/builder.py:32-41): layer
        # matmul weights are quantized (dequant fuses into the matmul epilogue,
        # see models/layers.linear); embeddings/lm_head/norms stay fp so gathers
        # and the final projection keep full precision — matching bitsandbytes'
        # default llm_int8_skip_modules=[lm_head].
        from .ops.quantization import quantize_params
        params["llm"]["layers"] = quantize_params(params["llm"]["layers"],
                                                  bits=load_bits, min_size=1024,
                                                  scheme=int4_scheme)
    if quantize_lm_head:
        # opt-in beyond the reference (works with or without load_bits): int8
        # lm_head cuts ~12% of the per-step weight stream at 128k vocab
        # (llama._lm_head is quant-aware); logits shift <2% relative on
        # tiny-model parity
        from .ops.quantization import quantize_params
        params["llm"]["lm_head"] = quantize_params(
            params["llm"]["lm_head"], bits=8, min_size=1024)
    if quantize_vision and "vision" in params:
        # opt-in W8A8 vision tower (beyond the reference, which keeps CLIP
        # in fp16): per-row int8 weights + per-token int8 activations
        # (ops/w8a8_matmul.py). Halves vision weight memory; ~2% relative
        # feature error, bounded in tests/test_w8a8.py.
        from .models import vit as vit_mod
        params["vision"] = vit_mod.quantize_tower(params["vision"], cfg.vision)
    return params


# ----------------------------------------------------------------------------------
# Export: our pytrees -> reference-compatible state dicts / files.
# ----------------------------------------------------------------------------------

def _flat(prefix: str, p: Dict, out: Dict[str, np.ndarray]) -> None:
    for k, v in p.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            _flat(key, v, out)
        elif isinstance(v, (list, tuple)):
            for i, vi in enumerate(v):
                if isinstance(vi, dict):
                    _flat(f"{key}.{i}", vi, out)
                else:
                    out[f"{key}.{i}"] = np.asarray(vi)
        else:
            out[key] = np.asarray(v)


def export_resampler(p: Dict, prefix: str) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    out[f"{prefix}pos_embed"] = np.asarray(p["pos_embed"])
    out[f"{prefix}query"] = np.asarray(p["query"])
    for name in ("attn", "self_attn"):
        if name in p:
            out[f"{prefix}{name}.in_proj_weight"] = np.asarray(p[name]["in_proj_weight"])
            out[f"{prefix}{name}.in_proj_bias"] = np.asarray(p[name]["in_proj_bias"])
            out[f"{prefix}{name}.out_proj.weight"] = np.asarray(p[name]["out_proj"]["weight"])
            out[f"{prefix}{name}.out_proj.bias"] = np.asarray(p[name]["out_proj"]["bias"])
    for ln in ("ln_q", "ln_kv", "ln_post"):
        out[f"{prefix}{ln}.weight"] = np.asarray(p[ln]["weight"])
        out[f"{prefix}{ln}.bias"] = np.asarray(p[ln]["bias"])
    if "kv_proj" in p:
        out[f"{prefix}kv_proj.weight"] = np.asarray(p["kv_proj"]["weight"])
    if "proj" in p:
        out[f"{prefix}proj.weight"] = np.asarray(p["proj"]["weight"])
        out[f"{prefix}proj.bias"] = np.asarray(p["proj"]["bias"])
    return out


def export_projector(p: Dict, cfg: SliMEConfig,
                     prefix: str = "model.mm_projector.") -> Dict[str, np.ndarray]:
    t = cfg.mm_projector_type
    out: Dict[str, np.ndarray] = {}
    if t == "linear":
        out[f"{prefix}weight"] = np.asarray(p["proj"]["weight"])
        out[f"{prefix}bias"] = np.asarray(p["proj"]["bias"])
        return out
    m = re.match(r"^mlp(\d+)x_gelu$", t)
    if m:
        for i, lp in enumerate(p["mlp"]["layers"]):
            out[f"{prefix}{2 * i}.weight"] = np.asarray(lp["weight"])
            out[f"{prefix}{2 * i}.bias"] = np.asarray(lp["bias"])
        return out
    if t == "qformer":
        return export_resampler(p["resampler"], prefix)
    assert t == "gated"
    for i, lp in enumerate(p["projection"]["layers"]):
        out[f"{prefix}projection.{2 * i}.weight"] = np.asarray(lp["weight"])
        out[f"{prefix}projection.{2 * i}.bias"] = np.asarray(lp["bias"])
    out.update(export_resampler(p["attn"], f"{prefix}attn."))
    out[f"{prefix}w_gate"] = np.asarray(p["w_gate"])
    out[f"{prefix}w_noise"] = np.asarray(p["w_noise"])
    # constant registered buffers the reference GatedBlock persists
    # (multimodal_projector/builder.py:69-70); loaders ignore them, but the
    # reference's strict state-dict load expects the keys to exist
    out[f"{prefix}mean"] = np.zeros((1,), np.float32)
    out[f"{prefix}std"] = np.ones((1,), np.float32)
    return out


def export_sampler(p: Dict, cfg: SliMEConfig,
                   prefix: str = "model.sampler.") -> Dict[str, np.ndarray]:
    out = export_resampler(p["post_qformer"], f"{prefix}post_qformer.")
    if "selector" in p:
        sel = p["selector"]
        sp = f"{prefix}selector."
        out[f"{sp}query"] = np.asarray(sel["query"])
        for name in ("self_attn", "cross_attn"):
            out[f"{sp}{name}.in_proj_weight"] = np.asarray(sel[name]["in_proj_weight"])
            out[f"{sp}{name}.in_proj_bias"] = np.asarray(sel[name]["in_proj_bias"])
            out[f"{sp}{name}.out_proj.weight"] = np.asarray(sel[name]["out_proj"]["weight"])
            out[f"{sp}{name}.out_proj.bias"] = np.asarray(sel[name]["out_proj"]["bias"])
        for ln in ("ln_q", "ln_kv", "ln_post"):
            out[f"{sp}{ln}.weight"] = np.asarray(sel[ln]["weight"])
            out[f"{sp}{ln}.bias"] = np.asarray(sel[ln]["bias"])
        out[f"{sp}prob_proj.0.weight"] = np.asarray(sel["prob_proj"]["fc1"]["weight"])
        out[f"{sp}prob_proj.0.bias"] = np.asarray(sel["prob_proj"]["fc1"]["bias"])
        out[f"{sp}prob_proj.2.weight"] = np.asarray(sel["prob_proj"]["fc2"]["weight"])
        out[f"{sp}prob_proj.2.bias"] = np.asarray(sel["prob_proj"]["fc2"]["bias"])
    return out


def export_llama(p: Dict, cfg: LLMConfig, prefix: str = "model.") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    out[f"{prefix}embed_tokens.weight"] = np.asarray(p["embed_tokens"])
    out[f"{prefix}norm.weight"] = np.asarray(p["norm"]["weight"])
    layers = p["layers"]
    if isinstance(layers, dict):   # stacked [L, ...] storage (scan path)
        from .models import llama as _llama
        layers = _llama.unstack_layers(layers, cfg.num_layers)
    for i, lp in enumerate(layers):
        b = f"{prefix}layers.{i}"
        out[f"{b}.input_layernorm.weight"] = np.asarray(lp["input_layernorm"]["weight"])
        out[f"{b}.post_attention_layernorm.weight"] = np.asarray(
            lp["post_attention_layernorm"]["weight"])
        for nm in ("q_proj", "k_proj", "v_proj", "o_proj"):
            out[f"{b}.self_attn.{nm}.weight"] = np.asarray(lp[nm]["weight"])
            if "bias" in lp[nm]:
                out[f"{b}.self_attn.{nm}.bias"] = np.asarray(lp[nm]["bias"])
        if cfg.num_experts > 0:
            out[f"{b}.block_sparse_moe.gate.weight"] = np.asarray(lp["gate"]["weight"])
            for e in range(cfg.num_experts):
                for wn in ("w1", "w2", "w3"):
                    out[f"{b}.block_sparse_moe.experts.{e}.{wn}.weight"] = \
                        np.asarray(lp["experts"][wn][e])
        else:
            for nm in ("gate_proj", "up_proj", "down_proj"):
                out[f"{b}.mlp.{nm}.weight"] = np.asarray(lp[nm]["weight"])
    out["lm_head.weight"] = np.asarray(p["lm_head"]["weight"])
    return out


def export_state_dict(params: Dict, cfg: SliMEConfig) -> Dict[str, np.ndarray]:
    """Full model -> reference-compatible flat state dict (llava key names)."""
    sd = export_llama(params["llm"], cfg.llm)
    sd.update(export_projector(params["projector"], cfg))
    if "sampler" in params and cfg.has_sampler:
        sd.update(export_sampler(params["sampler"], cfg))
    if "vision" in params:
        v = params["vision"]
        vp = "model.vision_tower.vision_tower.vision_model."
        sd[f"{vp}embeddings.class_embedding"] = np.asarray(v["class_embedding"])
        E = cfg.vision.hidden_size
        ps = cfg.vision.patch_size
        sd[f"{vp}embeddings.patch_embedding.weight"] = \
            np.asarray(v["patch_embedding"]).reshape(E, 3, ps, ps)
        sd[f"{vp}embeddings.position_embedding.weight"] = \
            np.asarray(v["position_embedding"])
        sd[f"{vp}pre_layrnorm.weight"] = np.asarray(v["pre_layernorm"]["weight"])
        sd[f"{vp}pre_layrnorm.bias"] = np.asarray(v["pre_layernorm"]["bias"])
        if "post_layernorm" in v:
            sd[f"{vp}post_layernorm.weight"] = np.asarray(v["post_layernorm"]["weight"])
            sd[f"{vp}post_layernorm.bias"] = np.asarray(v["post_layernorm"]["bias"])
        for i, lp in enumerate(v["layers"]):
            b = f"{vp}encoder.layers.{i}"
            for nm, ours in (("layer_norm1", "layer_norm1"),
                             ("layer_norm2", "layer_norm2")):
                sd[f"{b}.{nm}.weight"] = np.asarray(lp[ours]["weight"])
                sd[f"{b}.{nm}.bias"] = np.asarray(lp[ours]["bias"])
            for nm in ("q_proj", "k_proj", "v_proj", "out_proj"):
                sd[f"{b}.self_attn.{nm}.weight"] = np.asarray(lp[nm]["weight"])
                sd[f"{b}.self_attn.{nm}.bias"] = np.asarray(lp[nm]["bias"])
            for nm in ("fc1", "fc2"):
                sd[f"{b}.mlp.{nm}.weight"] = np.asarray(lp[nm]["weight"])
                sd[f"{b}.mlp.{nm}.bias"] = np.asarray(lp[nm]["bias"])
    return sd


def save_checkpoint(path: str, params: Dict, cfg: SliMEConfig,
                    *, adapters_only: bool = False) -> None:
    """Write a checkpoint directory: config.json + weights.

    adapters_only reproduces the reference's staged-pretrain saves
    (mm_projector.bin + sampler.bin, llava_trainer.py:248-276) in torch format so
    the reference can load them unchanged.
    """
    os.makedirs(path, exist_ok=True)
    cfg.save(path)
    import torch

    def to_torch(sd):
        return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}

    if adapters_only:
        torch.save(to_torch(export_projector(params["projector"], cfg)),
                   os.path.join(path, "mm_projector.bin"))
        if "sampler" in params and cfg.has_sampler:
            torch.save(to_torch(export_sampler(params["sampler"], cfg)),
                       os.path.join(path, "sampler.bin"))
        return
    sd = export_state_dict(params, cfg)
    try:
        from safetensors.torch import save_file
        save_file(to_torch(sd), os.path.join(path, "model.safetensors"))
    except ImportError:
        torch.save(to_torch(sd), os.path.join(path, "pytorch_model.bin"))


def save_lora_checkpoint(path: str, params: Dict, lora_state: Dict,
                         cfg: SliMEConfig) -> None:
    """Write a reference-layout LoRA checkpoint directory: config.json +
    adapter_config.json + adapter_model.bin (PEFT key names) +
    non_lora_trainables.bin (projector/sampler trained outside PEFT).

    This is the save side of the reference's LoRA split
    (llava/train/train.py:1185-1196); load_pretrained(path, model_base=...)
    merges it back (builder.py:52-91 semantics), and reference PEFT tooling
    can consume the adapter files unchanged."""
    from .train.lora import export_peft

    os.makedirs(path, exist_ok=True)
    cfg.save(path)
    import torch

    def to_torch(sd):
        return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}

    targets = sorted({p.rsplit("/", 1)[-1] for p in lora_state["adapters"]})
    with open(os.path.join(path, "adapter_config.json"), "w") as f:
        json.dump({"peft_type": "LORA", "r": int(lora_state["rank"]),
                   "lora_alpha": int(lora_state["alpha"]),
                   "lora_dropout": 0.0, "bias": "none",
                   "target_modules": targets,
                   "task_type": "CAUSAL_LM"}, f, indent=2)
    torch.save(to_torch(export_peft(lora_state)),
               os.path.join(path, "adapter_model.bin"))
    non_lora: Dict[str, np.ndarray] = {}
    if "projector" in params:
        non_lora.update(export_projector(params["projector"], cfg))
    if "sampler" in params and cfg.has_sampler:
        non_lora.update(export_sampler(params["sampler"], cfg))
    if non_lora:
        torch.save(to_torch(non_lora),
                   os.path.join(path, "non_lora_trainables.bin"))


def to_jax(params, dtype=None):
    """numpy pytree -> jnp arrays (optionally casting floats).

    Quantized leaves ({"q"/"q4", "scale"} dicts from ops.quantization) are kept
    intact: casting their fp32 'scale' to bf16 would add ~0.2-0.4% avoidable
    dequant error on every int8/int4 weight.
    """
    import jax
    import jax.numpy as jnp

    from .ops.quantization import is_quantized

    import numpy as np

    def conv(x, *, keep_fp32=False):
        # cast on HOST, then upload: an eager device-side astype compiles a
        # tiny kernel per distinct leaf shape (~250 for an unstacked
        # checkpoint). numpy handles bf16 via ml_dtypes.
        x = np.asarray(x)
        if (dtype is not None and not keep_fp32
                and x.dtype in (np.float32, np.float64, np.float16)):
            x = x.astype(jnp.dtype(dtype))
        return jnp.asarray(x)

    def walk(node):
        if is_quantized(node):
            return {k: conv(v, keep_fp32=(k == "scale")) for k, v in node.items()}
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return conv(node)

    return walk(params)
