"""SliME-JAX: a high-resolution multimodal framework in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of yfzhang114/SliME
("Beyond LLaVA-HD", arXiv 2406.08487): anyres image slicing, global/local feature
split with a gated MoE projector and text-guided crop selection, Llama/Vicuna
backbones, three-stage training, evaluation harness, and distributed serving.
"""

__version__ = "0.1.0"

import os as _os

# XLA's Triton GEMM fusions gave NaN logits, at random from one compile or
# run to the next, for the bf16 Llama-3-8B prefill at 64 and 128 tokens on an
# H100 (jax 0.9.0); the same program with every GEMM on cuBLAS is finite and
# agrees across lengths. Read when the GPU backend starts, so it is set here,
# before any entry point touches a device. An explicit setting in XLA_FLAGS
# wins.
if "xla_gpu_enable_triton_gemm" not in _os.environ.get("XLA_FLAGS", ""):
    _os.environ["XLA_FLAGS"] = " ".join(filter(None, (
        _os.environ.get("XLA_FLAGS"), "--xla_gpu_enable_triton_gemm=false")))

from .config import LLMConfig, SliMEConfig, VisionConfig  # noqa: F401
from .constants import (DEFAULT_IMAGE_TOKEN, IGNORE_INDEX,  # noqa: F401
                        IMAGE_TOKEN_INDEX)
