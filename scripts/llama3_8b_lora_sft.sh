#!/bin/bash
# SliME-8B LoRA SFT (mirrors scripts/llama-lora/llama_8b_lora_sft.sh:
# r=128 alpha=256, LoRA lr 2e-4, separate projector lr 2e-5; projector +
# sampler train outside the adapters and save as non_lora_trainables.bin).
#
# QLoRA: BITS=4 (NF4, the reference's bitsandbytes type) or BITS=8 quantizes
# the frozen LLM base and shrinks its weight memory 4x / 2x (the reference
# needs an A100-80G; see docs/Training.md).
set -e

MODEL_PATH=${MODEL_PATH:-./checkpoints/llama3-8b-base}
PT=${PT:-./checkpoints/slime-8b-pt/stage3}
DATA=${DATA:-"./playground/data/sharegpt4v_mix665k.json ./playground/data/smr.json"}
IMAGES=${IMAGES:-./playground/data/images}
OUT=${OUT:-./checkpoints/slime-8b-lora}
BITS=${BITS:-16}
MESH_FSDP=${MESH_FSDP:-}

python scripts/train_slime.py \
  --model-path $MODEL_PATH --data-path $DATA --image-folder $IMAGES \
  --version llama3 --per-device-batch-size 16 --model-max-length 2048 \
  --lora-enable --lora-r 128 --lora-alpha 256 --bits $BITS \
  --learning-rate 2e-4 --mm-projector-lr 2e-5 --warmup-ratio 0.03 \
  --save-steps 10000 --logging-steps 10 --group-by-modality-length \
  --pretrain-mm-mlp-adapter $PT/mm_projector.bin \
  --pretrain-mm-re-sampler $PT/sampler.bin \
  --output-dir $OUT ${MESH_FSDP:+--mesh-fsdp $MESH_FSDP}
