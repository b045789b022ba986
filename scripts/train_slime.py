#!/usr/bin/env python
"""Training entrypoint CLI.

Rebuilds the argument surface of the reference's ModelArguments / DataArguments /
TrainingArguments (llava/train/train.py:56-166) + train() orchestration
(train.py:943-1199). One process drives the whole mesh (SPMD);
there is no per-GPU launcher — the deepspeed CLI's role is played by
jax.distributed + the (data, fsdp, model) mesh.

Example (stage 1, global-only MLP expert):
  python scripts/train_slime.py \
    --model-path ./init_ckpt --data-path pretrain.json --image-folder ./images \
    --output-dir ./out/stage1 --tune-mm-mlp-adapter --use-global-only \
    --mm-learnable-gated 0 --learning-rate 1e-3 --version plain
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def parse_args():
    ap = argparse.ArgumentParser()
    # model args (reference ModelArguments)
    ap.add_argument("--model-path", required=True,
                    help="checkpoint dir (config.json + weights) or config-only dir")
    ap.add_argument("--model-base", default=None)
    ap.add_argument("--version", default="v1",
                    help="conversation template: plain|v1|llama3|mpt")
    ap.add_argument("--tune-mm-mlp-adapter", action="store_true")
    ap.add_argument("--freeze-mm-mlp-adapter", action="store_true")
    ap.add_argument("--freeze-backbone", action="store_true")
    ap.add_argument("--mm-learnable-gated", type=int, default=-1)
    ap.add_argument("--use-global-only", action="store_true")
    ap.add_argument("--use-local-only", action="store_true")
    ap.add_argument("--pretrain-mm-mlp-adapter", default=None)
    ap.add_argument("--pretrain-mm-re-sampler", default=None)
    # data args
    ap.add_argument("--data-path", nargs="+", required=True)
    ap.add_argument("--image-folder", default="")
    ap.add_argument("--image-aspect-ratio", default="anyres")
    ap.add_argument("--pixel-dtype", default="uint8",
                    choices=["uint8", "float32"],
                    help="pixel transport: uint8 ships raw crops and "
                         "CLIP-normalizes on device (1/4 the host->device "
                         "bytes; identical math); float32 ships normalized "
                         "crops (the reference layout)")
    ap.add_argument("--group-by-modality-length", action="store_true")
    ap.add_argument("--seq-packing", action="store_true",
                    help="pack text-only examples into full sequences "
                         "(block-diagonal attention, exact loss; "
                         "data/packing.py) — rejects multimodal datasets")
    # training args
    ap.add_argument("--output-dir", required=True)
    ap.add_argument("--per-device-batch-size", type=int, default=8)
    ap.add_argument("--gradient-accumulation-steps", type=int, default=1)
    ap.add_argument("--num-train-epochs", type=int, default=1)
    ap.add_argument("--max-steps", type=int, default=None)
    ap.add_argument("--learning-rate", type=float, default=2e-5)
    ap.add_argument("--mm-projector-lr", type=float, default=None)
    ap.add_argument("--weight-decay", type=float, default=0.0)
    ap.add_argument("--warmup-ratio", type=float, default=0.03)
    ap.add_argument("--lr-scheduler-type", default="cosine")
    ap.add_argument("--optim", default="adamw",
                    choices=["adamw", "adamw8bit"],
                    help="adamw8bit stores Adam moments as blockwise int8 "
                         "(~2.06 B/param vs 8 — train/opt8.py)")
    ap.add_argument("--model-max-length", type=int, default=2048)
    ap.add_argument("--save-steps", type=int, default=1000)
    ap.add_argument("--async-save", action="store_true",
                    help="non-blocking Orbax train-state saves")
    ap.add_argument("--logging-steps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=3407)
    # DPO (the reference's vestigial --task DPO surface, train.py:133-166,
    # implemented: train/dpo.py + data/dpo.py)
    ap.add_argument("--task", default="SFT", choices=["SFT", "DPO"],
                    help="SFT, or DPO over preference pairs "
                         "(records with chosen/rejected or "
                         "output_1/output_2 + preference)")
    ap.add_argument("--dpo-beta", type=float, default=0.1)
    ap.add_argument("--dpo-loss-type", default="sigmoid",
                    choices=["sigmoid", "ipo", "kto_pair"])
    ap.add_argument("--dpo-use-average", action="store_true",
                    help="average per-token log-probs instead of sums")
    ap.add_argument("--dpo-token-weighted", action="store_true",
                    help="up-weight tokens where chosen/rejected differ "
                         "(RLHF-V recipe)")
    ap.add_argument("--dpo-token-weight", type=float, default=1.1)
    ap.add_argument("--sft-weight", type=float, default=0.0,
                    help="mix in plain NLL on the chosen rows")
    ap.add_argument("--dpo-weight", type=float, default=1.0)
    ap.add_argument("--ref-model-path", default=None,
                    help="reference-policy checkpoint for full-parameter DPO "
                         "(default: the starting weights); LoRA-DPO ignores "
                         "this — the frozen base is the reference")
    # LoRA / QLoRA (reference scripts/llama-lora/*.sh r=128 alpha=256; --bits
    # 8/4 quantizes the frozen LLM base = the bitsandbytes kbit path,
    # train.py:956-972)
    ap.add_argument("--lora-enable", action="store_true")
    ap.add_argument("--lora-r", type=int, default=128)
    ap.add_argument("--lora-alpha", type=int, default=256)
    ap.add_argument("--bits", type=int, default=16, choices=[16, 8, 4],
                    help="quantize the (frozen) LLM base for QLoRA; "
                         "requires --lora-enable")
    # mesh
    ap.add_argument("--mesh-data", type=int, default=1)
    ap.add_argument("--mesh-fsdp", type=int, default=None)
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--bf16", action="store_true", default=True)
    ap.add_argument("--remat", action="store_true",
                    help="rematerialize decoder blocks on backward (gradient "
                         "checkpointing equivalent)")
    return ap.parse_args()


def main():
    from slime_jax.utils import enable_compilation_cache
    enable_compilation_cache()
    args = parse_args()
    import jax
    import jax.numpy as jnp

    from slime_jax import checkpoint as ckpt
    from slime_jax.config import SliMEConfig
    from slime_jax.data.dataset import SupervisedDataset, data_loader
    from slime_jax.models import slime
    from slime_jax.parallel import mesh as mesh_lib
    from slime_jax.train.optim import TrainConfig
    from slime_jax.train.trainer import RunConfig, Trainer

    cfg = SliMEConfig.load(args.model_path)
    cfg = SliMEConfig(**{**cfg.__dict__,
                         "use_global_only": args.use_global_only,
                         "use_local_only": args.use_local_only,
                         "mm_learnable_gated": args.mm_learnable_gated,
                         "image_aspect_ratio": args.image_aspect_ratio,
                         "tokenizer_model_max_length": args.model_max_length})

    # weights: full checkpoint, or random-init fresh modules around a base LLM
    if args.bits != 16 and not args.lora_enable:
        raise SystemExit("--bits 8/4 trains a quantized base — only valid "
                         "with --lora-enable (QLoRA); full finetuning of "
                         "quantized weights is not a thing")
    has_weights = any(f.endswith((".safetensors", ".bin"))
                      for f in os.listdir(args.model_path))
    if has_weights:
        params = ckpt.to_jax(ckpt.load_pretrained(
            args.model_path, model_base=args.model_base, cfg=cfg,
            load_bits=args.bits if args.bits != 16 else None))
    else:
        params = slime.init(jax.random.PRNGKey(args.seed), cfg)
        if args.bits != 16:
            from slime_jax.ops.quantization import quantize_params
            params["llm"]["layers"] = quantize_params(
                params["llm"]["layers"], args.bits)
    # stack the LLM layer list: llama.forward lax.scans over stacked
    # storage, so the train step compiles ONE layer body instead of
    # unrolling every decoder block into the fwd+bwd graph (unrolled, the
    # compile of a 190M 3-stage run took >25 min per stage). MoE layers keep the
    # list layout (per-expert subtrees are not uniformly stackable).
    if (not args.lora_enable and cfg.llm.num_experts == 0
            and isinstance(params["llm"].get("layers"), list)):
        from slime_jax.models import llama as llama_mod
        params["llm"]["layers"] = llama_mod.stack_layers(
            params["llm"]["layers"])

    # staged adapter warm-starts (reference initialize_vision_modules,
    # llava_arch.py:107-119)
    for pre, key, conv in (
            (args.pretrain_mm_mlp_adapter, "projector",
             lambda sd: ckpt.convert_projector(
                 ckpt._strip(sd, "model.mm_projector."), cfg)),
            (args.pretrain_mm_re_sampler, "sampler",
             lambda sd: ckpt.convert_sampler(
                 ckpt._strip(sd, "model.sampler."), cfg))):
        if pre:
            sd = ckpt.load_state_dict_file(pre)
            params[key] = ckpt.to_jax(conv(sd))

    from transformers import AutoTokenizer
    tokenizer = AutoTokenizer.from_pretrained(args.model_base or args.model_path)
    tokenizer.model_max_length = args.model_max_length

    if args.task == "DPO":
        from slime_jax.data.dpo import PreferenceDataset
        ds = PreferenceDataset(args.data_path, tokenizer,
                               image_folder=args.image_folder,
                               image_aspect_ratio=args.image_aspect_ratio,
                               conv_version=args.version,
                               max_crops=1 + cfg.max_local_crops,
                               tile=cfg.vision.image_size,
                               pixel_dtype=args.pixel_dtype,
                               token_weighted=args.dpo_token_weighted,
                               token_weight=args.dpo_token_weight)
    else:
        ds = SupervisedDataset(args.data_path, tokenizer,
                               image_folder=args.image_folder,
                               image_aspect_ratio=args.image_aspect_ratio,
                               conv_version=args.version,
                               max_crops=1 + cfg.max_local_crops,
                               tile=cfg.vision.image_size,
                               pixel_dtype=args.pixel_dtype)

    n_batches = max(len(ds) // args.per_device_batch_size, 1) * args.num_train_epochs
    total_steps = args.max_steps or n_batches
    tc = TrainConfig(
        learning_rate=args.learning_rate, mm_projector_lr=args.mm_projector_lr,
        weight_decay=args.weight_decay, warmup_ratio=args.warmup_ratio,
        total_steps=total_steps, lr_schedule=args.lr_scheduler_type,
        tune_mm_mlp_adapter=args.tune_mm_mlp_adapter,
        freeze_mm_mlp_adapter=args.freeze_mm_mlp_adapter,
        freeze_backbone=args.freeze_backbone,
        mm_learnable_gated=args.mm_learnable_gated,
        gradient_accumulation_steps=args.gradient_accumulation_steps,
        optim=args.optim)
    rc = RunConfig(output_dir=args.output_dir, save_steps=args.save_steps,
                   log_steps=args.logging_steps, max_steps=total_steps,
                   seed=args.seed,
                   adapters_only_save=args.tune_mm_mlp_adapter,
                   async_save=args.async_save)

    mesh = mesh_lib.make_mesh(args.mesh_data, args.mesh_fsdp, args.mesh_model) \
        if len(jax.devices()) > 1 else None
    # --per-device-batch-size semantics: the loader yields the GLOBAL batch
    # (per-device x batch-sharded mesh extent), like the reference's
    # per_device_train_batch_size x world_size
    batch_mult = 1
    if mesh is not None:
        batch_mult = mesh.shape["data"] * mesh.shape["fsdp"]
    global_batch = args.per_device_batch_size * batch_mult

    lora_state = None
    if args.lora_enable:
        from slime_jax.train import lora as lora_lib
        lora_state = lora_lib.init_lora(jax.random.PRNGKey(args.seed + 1),
                                        params, r=args.lora_r,
                                        alpha=args.lora_alpha)
    dpo_cfg, ref_params = None, None
    if args.task == "DPO":
        from slime_jax.train.dpo import DPOConfig
        dpo_cfg = DPOConfig(beta=args.dpo_beta, loss_type=args.dpo_loss_type,
                            use_average=args.dpo_use_average,
                            token_weighted=args.dpo_token_weighted,
                            token_weight=args.dpo_token_weight,
                            sft_weight=args.sft_weight,
                            dpo_weight=args.dpo_weight)
        if args.ref_model_path and args.lora_enable:
            # LoRA-DPO's reference policy is the frozen base by construction
            # (adapters off == base); honoring a DIFFERENT ref checkpoint would
            # need a second resident model — refuse instead of silently
            # changing the objective
            raise SystemExit("--ref-model-path is incompatible with "
                             "--lora-enable: LoRA-DPO uses the frozen base as "
                             "the reference policy (drop --ref-model-path, or "
                             "run full-parameter DPO)")
        if args.ref_model_path:
            ref_params = ckpt.to_jax(ckpt.load_pretrained(
                args.ref_model_path, cfg=cfg))
    trainer = Trainer(params, cfg, tc, rc, mesh=mesh,
                      compute_dtype=jnp.bfloat16 if args.bf16 else jnp.float32,
                      remat=args.remat, lora=lora_state, dpo=dpo_cfg,
                      ref_params=ref_params)

    if args.seq_packing and args.task == "DPO":
        raise SystemExit("--seq-packing does not compose with --task DPO "
                         "(pair rows must stay aligned)")
    if args.seq_packing and any(l > 0 for l in ds.modality_lengths):
        raise SystemExit("--seq-packing is text-only (image features splice "
                         "into the embedding sequence; token-aligned "
                         "segments can't describe them)")

    def batches():
        import random as _random

        from slime_jax.data.packing import packed_loader
        for epoch in range(args.num_train_epochs):
            if args.task == "DPO":
                from slime_jax.data.dpo import dpo_loader
                yield from dpo_loader(
                    ds, batch_size=global_batch,
                    seq_len=args.model_max_length,
                    pad_token_id=tokenizer.pad_token_id or 0,
                    seed=args.seed + epoch, num_workers=8)
                continue
            if args.seq_packing:
                order = list(range(len(ds)))
                _random.Random(args.seed + epoch).shuffle(order)
                yield from packed_loader(
                    (ds[i] for i in order), batch_size=global_batch,
                    seq_len=args.model_max_length,
                    pad_token_id=tokenizer.pad_token_id or 0)
                continue
            yield from data_loader(
                ds, batch_size=global_batch,
                seq_len=args.model_max_length,
                pad_token_id=tokenizer.pad_token_id or 0,
                seed=args.seed + epoch,
                group_by_modality_length=args.group_by_modality_length,
                num_workers=8)

    from slime_jax.data.dataset import prefetch
    trainer.train(prefetch(batches(), depth=2))
    trainer.save(args.output_dir)
    print(f"done -> {args.output_dir}")


if __name__ == "__main__":
    main()
