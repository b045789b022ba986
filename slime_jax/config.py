"""Configuration dataclasses for SliME-JAX.

The reference stores all multimodal knobs on the HF model config so checkpoints are
self-describing (reference: llava/model/llava_arch.py:80-93, llava/train/train.py:1108-1143).
We keep the same `config.json` key set for checkpoint compatibility, but expose them as
typed, hashable dataclasses so they can be closed over by jitted functions as static
arguments.
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class VisionConfig:
    """CLIP ViT encoder config (CLIP-L/336 defaults).

    Reference wraps HF CLIPVisionModel (llava/model/multimodal_encoder/clip_encoder.py:8-89)
    and selects hidden layer -2, dropping CLS ("patch" feature select).
    """
    image_size: int = 336
    patch_size: int = 14
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 24
    num_heads: int = 16
    layer_norm_eps: float = 1e-5
    # Which hidden state to tap: -2 == penultimate layer (mm_vision_select_layer)
    select_layer: int = -2
    select_feature: str = "patch"  # drop CLS token

    @property
    def num_patches_per_side(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.num_patches_per_side ** 2


@dataclass(frozen=True)
class LLMConfig:
    """Decoder-only LLM config covering Llama-3-8B / Vicuna-7B/13B / Mistral / Mixtral.

    Replaces the reference's per-family HF subclasses (llava/model/language_model/*)
    with one parameterized functional decoder.
    """
    vocab_size: int = 128256
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    rope_theta: float = 500000.0
    rms_norm_eps: float = 1e-5
    max_position_embeddings: int = 8192
    tie_word_embeddings: bool = False
    # Mixtral-style MoE (0 experts == dense)
    num_experts: int = 0
    num_experts_per_tok: int = 2
    # HF MixtralConfig.router_aux_loss_coef semantics; 0 disables (reference
    # training never enables output_router_logits, so 0 is the parity default)
    router_aux_loss_coef: float = 0.0
    attention_bias: bool = False

    @classmethod
    def llama3_8b(cls) -> "LLMConfig":
        return cls()

    @classmethod
    def vicuna_7b(cls) -> "LLMConfig":
        return cls(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
                   num_layers=32, num_heads=32, num_kv_heads=32, rope_theta=10000.0,
                   rms_norm_eps=1e-5, max_position_embeddings=4096)

    @classmethod
    def vicuna_13b(cls) -> "LLMConfig":
        return cls(vocab_size=32000, hidden_size=5120, intermediate_size=13824,
                   num_layers=40, num_heads=40, num_kv_heads=40, rope_theta=10000.0,
                   max_position_embeddings=4096)

    @classmethod
    def llama3_70b(cls) -> "LLMConfig":
        return cls(hidden_size=8192, intermediate_size=28672, num_layers=80,
                   num_heads=64, num_kv_heads=8)

    @classmethod
    def mistral_7b(cls) -> "LLMConfig":
        return cls(vocab_size=32000, hidden_size=4096, intermediate_size=14336,
                   num_layers=32, num_heads=32, num_kv_heads=8, rope_theta=10000.0)

    @classmethod
    def mixtral_8x7b(cls) -> "LLMConfig":
        return cls(vocab_size=32000, hidden_size=4096, intermediate_size=14336,
                   num_layers=32, num_heads=32, num_kv_heads=8, rope_theta=1000000.0,
                   num_experts=8, num_experts_per_tok=2)

    @classmethod
    def tiny(cls, vocab_size: int = 512) -> "LLMConfig":
        """Tiny config for tests and dry runs."""
        return cls(vocab_size=vocab_size, hidden_size=128, intermediate_size=256,
                   num_layers=2, num_heads=4, num_kv_heads=2, head_dim=32,
                   max_position_embeddings=512)


@dataclass(frozen=True)
class SliMEConfig:
    """Top-level multimodal config.

    Key names mirror the reference `config.json` keys written at
    llava/model/llava_arch.py:80-93 so released checkpoints remain self-describing.
    """
    llm: LLMConfig = field(default_factory=LLMConfig)
    vision: VisionConfig = field(default_factory=VisionConfig)

    mm_projector_type: str = "gated"        # linear | mlpNx_gelu | qformer | gated | identity
    mm_resampler_type: str = "cosine"        # cosine | qformer | identity | spatial
    mm_resampler_dim: int = 144              # queries of local compression layer
    mm_resampler_topp: float = 0.9           # text-guided crop top-p
    mm_resampler_temp: float = 1.0
    mm_patch_merge_type: str = "flat"
    mm_learnable_gated: int = -1             # pin a single gated expert during staged pretrain
    use_local_only: bool = False
    use_global_only: bool = False
    image_aspect_ratio: str = "anyres"
    image_grid_pinpoints: Tuple[Tuple[int, int], ...] = (
        (336, 672), (672, 336), (672, 672), (1008, 336), (336, 1008), (672, 1008), (1008, 672),
    )  # reference hard-codes a 7-resolution list (train.py:1109)
    seperator: int = 1919                    # token id spliced between global and local features
                                             # (reference spelling preserved: llava_arch.py:92)
    tokenizer_model_max_length: int = 2048
    tokenizer_padding_side: str = "right"
    pad_token_id: int = 0
    bos_token_id: int = 128000
    eos_token_id: int = 128009

    # Static-shape crop budget (reference pads to max_of_x=10 at train.py:903-926)
    max_local_crops: int = 7

    @property
    def mm_hidden_size(self) -> int:
        return self.vision.hidden_size

    @property
    def hidden_size(self) -> int:
        return self.llm.hidden_size

    @property
    def mm_num_heads(self) -> int:
        # reference derives heads as mm_hidden_size // 128 (builder.py:46); floor at 1
        # so tiny test configs stay valid
        return max(1, self.mm_hidden_size // 128)

    @property
    def llm_num_heads_128(self) -> int:
        return max(1, self.hidden_size // 128)

    @property
    def has_sampler(self) -> bool:
        # reference: llava_arch.py:38-39
        return self.mm_resampler_type not in (None, "identity", "spatial")

    # ------------------------------------------------------------------
    # config.json (de)serialization — key set compatible with the reference
    # ------------------------------------------------------------------
    def to_json_dict(self) -> dict:
        d = {
            "model_type": "llava_llama",
            "mm_projector_type": self.mm_projector_type,
            "mm_resampler_type": self.mm_resampler_type,
            "mm_resampler_dim": self.mm_resampler_dim,
            "mm_resampler_topp": self.mm_resampler_topp,
            "mm_resampler_temp": self.mm_resampler_temp,
            "mm_patch_merge_type": self.mm_patch_merge_type,
            "mm_learnable_gated": self.mm_learnable_gated,
            "mm_hidden_size": self.mm_hidden_size,
            "mm_vision_select_layer": self.vision.select_layer,
            "mm_vision_select_feature": self.vision.select_feature,
            "mm_vision_tower": "openai/clip-vit-large-patch14-336",
            # extra keys (ignored by the reference) so configs are self-contained
            "mm_vision_image_size": self.vision.image_size,
            "mm_vision_patch_size": self.vision.patch_size,
            "mm_vision_num_layers": self.vision.num_layers,
            "mm_vision_intermediate_size": self.vision.intermediate_size,
            "mm_vision_num_heads": self.vision.num_heads,
            "use_local_only": self.use_local_only,
            "use_global_only": self.use_global_only,
            "image_aspect_ratio": self.image_aspect_ratio,
            "image_grid_pinpoints": [list(p) for p in self.image_grid_pinpoints],
            "seperator": self.seperator,
            "tokenizer_model_max_length": self.tokenizer_model_max_length,
            "tokenizer_padding_side": self.tokenizer_padding_side,
            "pad_token_id": self.pad_token_id,
            "bos_token_id": self.bos_token_id,
            "eos_token_id": self.eos_token_id,
            # LLM keys (HF-compatible)
            "vocab_size": self.llm.vocab_size,
            "hidden_size": self.llm.hidden_size,
            "intermediate_size": self.llm.intermediate_size,
            "num_hidden_layers": self.llm.num_layers,
            "num_attention_heads": self.llm.num_heads,
            "num_key_value_heads": self.llm.num_kv_heads,
            "rope_theta": self.llm.rope_theta,
            "rms_norm_eps": self.llm.rms_norm_eps,
            "max_position_embeddings": self.llm.max_position_embeddings,
            "head_dim": self.llm.head_dim,
        }
        if self.llm.num_experts > 0:  # Mixtral-family keys (HF names)
            d["num_local_experts"] = self.llm.num_experts
            d["num_experts_per_tok"] = self.llm.num_experts_per_tok
            d["router_aux_loss_coef"] = self.llm.router_aux_loss_coef
        return d

    @classmethod
    def from_json_dict(cls, d: dict) -> "SliMEConfig":
        llm = LLMConfig(
            vocab_size=d.get("vocab_size", 128256),
            hidden_size=d.get("hidden_size", 4096),
            intermediate_size=d.get("intermediate_size", 14336),
            num_layers=d.get("num_hidden_layers", 32),
            num_heads=d.get("num_attention_heads", 32),
            num_kv_heads=d.get("num_key_value_heads", d.get("num_attention_heads", 32)),
            head_dim=d.get("head_dim", d.get("hidden_size", 4096) // d.get("num_attention_heads", 32)),
            rope_theta=d.get("rope_theta", 10000.0),
            rms_norm_eps=d.get("rms_norm_eps", 1e-5),
            max_position_embeddings=d.get("max_position_embeddings", 4096),
            num_experts=d.get("num_local_experts", 0),
            num_experts_per_tok=d.get("num_experts_per_tok", 2),
            router_aux_loss_coef=d.get("router_aux_loss_coef", 0.0),
        )
        vision = VisionConfig(
            image_size=d.get("mm_vision_image_size", 336),
            patch_size=d.get("mm_vision_patch_size", 14),
            hidden_size=d.get("mm_hidden_size", 1024),
            intermediate_size=d.get("mm_vision_intermediate_size", 4096),
            num_layers=d.get("mm_vision_num_layers", 24),
            num_heads=d.get("mm_vision_num_heads", 16),
            select_layer=d.get("mm_vision_select_layer", -2),
            select_feature=d.get("mm_vision_select_feature", "patch"),
        )
        pinpoints = d.get("image_grid_pinpoints") or []
        return cls(
            llm=llm, vision=vision,
            mm_projector_type=d.get("mm_projector_type", "linear"),
            mm_resampler_type=d.get("mm_resampler_type", "identity") or "identity",
            mm_resampler_dim=d.get("mm_resampler_dim", 144),
            mm_resampler_topp=d.get("mm_resampler_topp", 0.9),
            mm_resampler_temp=d.get("mm_resampler_temp", 1.0),
            mm_patch_merge_type=d.get("mm_patch_merge_type", "flat"),
            mm_learnable_gated=d.get("mm_learnable_gated", -1),
            use_local_only=d.get("use_local_only", False),
            use_global_only=d.get("use_global_only", False),
            image_aspect_ratio=d.get("image_aspect_ratio", "anyres"),
            image_grid_pinpoints=tuple(tuple(p) for p in pinpoints) or SliMEConfig.image_grid_pinpoints,
            seperator=d.get("seperator", 1919),
            tokenizer_model_max_length=d.get("tokenizer_model_max_length", 2048),
            tokenizer_padding_side=d.get("tokenizer_padding_side", "right"),
            pad_token_id=d.get("pad_token_id") or 0,
            bos_token_id=d.get("bos_token_id", 1),
            eos_token_id=d.get("eos_token_id", 2),
        )

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(self.to_json_dict(), f, indent=2)

    @classmethod
    def load(cls, path: str) -> "SliMEConfig":
        cfg_file = path if path.endswith(".json") else os.path.join(path, "config.json")
        with open(cfg_file) as f:
            return cls.from_json_dict(json.load(f))

    @classmethod
    def slime_8b(cls) -> "SliMEConfig":
        return cls(llm=LLMConfig.llama3_8b())

    @classmethod
    def slime_7b(cls) -> "SliMEConfig":
        return cls(llm=LLMConfig.vicuna_7b(), bos_token_id=1, eos_token_id=2)

    @classmethod
    def slime_13b(cls) -> "SliMEConfig":
        return cls(llm=LLMConfig.vicuna_13b(), bos_token_id=1, eos_token_id=2)

    @classmethod
    def slime_70b(cls) -> "SliMEConfig":
        return cls(llm=LLMConfig.llama3_70b())

    @classmethod
    def tiny(cls) -> "SliMEConfig":
        """Tiny end-to-end config for tests: small LLM + small ViT."""
        return cls(
            llm=LLMConfig.tiny(),
            vision=VisionConfig(image_size=56, patch_size=14, hidden_size=64,
                                intermediate_size=128, num_layers=2, num_heads=4),
            mm_resampler_dim=4,
            seperator=7,
            tokenizer_model_max_length=512,
            bos_token_id=1, eos_token_id=2,
        )
