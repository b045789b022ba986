"""Direct Preference Optimization: the reference's absent `--task DPO` path.

The reference carries a full DPO *surface* with no implementation behind it:
`TrainingArguments` defines `task` ("Preference for direct preference
optimization"), `dpo_beta`, `loss_type` ("choose from [sigmoid, ipo,
kto_pair]"), `dpo_use_average`, `dpo_token_weighted`, `dpo_token_weight`,
`sft_weight`, `dpo_weight` (reference llava/train/train.py:133-166), and
ships a launch script that passes `--task DPO` with an RLHF-V preference
dataset (reference scripts/llama-lora/eval/log_p_inference.sh) — but
`train()` never reads any of those fields. This module is a working
implementation of that intended surface.

Design:

- One forward per model evaluation over ``[2B, S]`` rows — chosen rows
  stacked on rejected rows — so the pair shares one compiled program and
  the matmuls see one large batch instead of two half-batches.
- Per-sequence log-probabilities come from ``ops.loss.chunked_sequence_logp``:
  the vocab projection runs chunk-by-chunk inside a checkpointed scan, so
  DPO (which needs TWO model evaluations per step) never materializes
  [2B, S, V] logits for either of them.
- Reference-model log-probs are computed OUTSIDE the gradient closure
  (they carry no gradient), so the backward pass only spans the policy
  forward.
- LoRA-DPO gets the reference model for free: the frozen base (optionally
  int8/NF4-quantized — QLoRA-DPO) *is* the reference policy, so no second
  parameter tree exists in memory. This is the configuration the
  reference's own script implies (a LoRA run over llava-v1.5-13b).
- Crop selection runs deterministically (``training=False``: no gumbel
  noise in the text-guided sampler) — the implicit reward
  ``beta * (logp_policy - logp_ref)`` must not absorb selection noise.

Loss types follow the field's documented menu (train.py:143-148), with the
community-standard semantics for each name:

- ``sigmoid``  -log sigmoid(beta * [(pi_c - pi_r) - (ref_c - ref_r)])
- ``ipo``      ([(pi_c - pi_r) - (ref_c - ref_r)] - 1/(2 beta))^2
- ``kto_pair`` paired Kahneman-Tversky: 1 - sigmoid(beta * (chosen
  logratio - mean rejected KL)) and the mirror term for rejected.

``dpo_use_average`` divides each sequence log-prob by its target-token
mass before the loss; ``dpo_token_weighted``/``dpo_token_weight`` up-weight
the tokens where the chosen and rejected answers differ (weights computed
host-side in data/dpo.py and redistributed onto the fused rows in-graph);
``sft_weight``/``dpo_weight`` mix in a plain NLL term on the chosen rows.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import optax

from ..config import SliMEConfig
from ..constants import IGNORE_INDEX
from ..models import slime
from ..ops.loss import DEFAULT_LOSS_CHUNK, chunked_sequence_logp
from ..parallel import mesh as mesh_lib
from .optim import TrainConfig

LOSS_TYPES = ("sigmoid", "ipo", "kto_pair")


@dataclasses.dataclass
class DPOConfig:
    """Mirror of the reference's vestigial DPO fields (train.py:133-166)."""
    beta: float = 0.1                 # dpo_beta
    loss_type: str = "sigmoid"        # [sigmoid, ipo, kto_pair]
    use_average: bool = False         # dpo_use_average
    token_weighted: bool = False      # dpo_token_weighted
    token_weight: float = 1.1         # dpo_token_weight
    sft_weight: float = 0.0           # sft_weight
    dpo_weight: float = 1.0           # dpo_weight

    def __post_init__(self):
        if self.loss_type not in LOSS_TYPES:
            raise ValueError(f"loss_type {self.loss_type!r} not in {LOSS_TYPES}")


def dpo_losses(policy_chosen: jnp.ndarray, policy_rejected: jnp.ndarray,
               ref_chosen: jnp.ndarray, ref_rejected: jnp.ndarray, *,
               beta: float, loss_type: str = "sigmoid"
               ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Per-pair losses + implicit rewards from [B] sequence log-probs.

    Returns (losses, chosen_rewards, rejected_rewards); ``losses`` is [B]
    for sigmoid/ipo and [2B] for kto_pair (each pair contributes both a
    chosen-side and a rejected-side term)."""
    pi_ratio = policy_chosen - policy_rejected
    ref_ratio = ref_chosen - ref_rejected
    h = pi_ratio - ref_ratio
    if loss_type == "sigmoid":
        losses = -jax.nn.log_sigmoid(beta * h)
    elif loss_type == "ipo":
        losses = (h - 1.0 / (2.0 * beta)) ** 2
    elif loss_type == "kto_pair":
        chosen_kl = jnp.clip(jnp.mean(policy_chosen - ref_chosen), 0.0, None)
        rejected_kl = jnp.clip(jnp.mean(policy_rejected - ref_rejected),
                               0.0, None)
        losses = jnp.concatenate([
            1.0 - jax.nn.sigmoid(
                beta * ((policy_chosen - ref_chosen) - rejected_kl)),
            1.0 - jax.nn.sigmoid(
                beta * (chosen_kl - (policy_rejected - ref_rejected))),
        ])
    else:  # pragma: no cover - guarded by DPOConfig
        raise ValueError(loss_type)
    chosen_rewards = beta * (policy_chosen - ref_chosen)
    rejected_rewards = beta * (policy_rejected - ref_rejected)
    return losses, chosen_rewards, rejected_rewards


def _fused_weights(fused_labels: jnp.ndarray,
                   target_weights: jnp.ndarray) -> jnp.ndarray:
    """Distribute host-side per-TARGET-token weights onto the fused rows.

    Fusion (models/slime._splice_one) moves text tokens around image spans
    but preserves their order, so the k-th non-IGNORE label in the fused
    row is exactly the k-th answer token the host saw.  ``target_weights``
    [B, T] lists weights in that order; positions beyond a row's target
    count are irrelevant (masked by IGNORE)."""
    valid = fused_labels != IGNORE_INDEX
    k = jnp.cumsum(valid.astype(jnp.int32), axis=1) - 1
    k = jnp.clip(k, 0, target_weights.shape[1] - 1)
    w = jnp.take_along_axis(target_weights.astype(jnp.float32), k, axis=1)
    return jnp.where(valid, w, 0.0)


def pair_logps(params, cfg: SliMEConfig, batch: Dict, *,
               compute_dtype=jnp.bfloat16, remat: bool = False,
               scan_layers: bool = False,
               loss_chunk="auto", token_weights: Optional[jnp.ndarray] = None
               ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """One forward over the stacked [2B, S] pair batch -> ([2B] logp, [2B] mass).

    ``batch['input_ids']`` is [2B, S] (chosen block then rejected block);
    ``pixel_values``/``crop_mask`` are per-PAIR [B, ...] and are tiled to both
    rows (the pair shares its image)."""
    if loss_chunk == "auto":
        loss_chunk = (DEFAULT_LOSS_CHUNK
                      if cfg.llm.vocab_size >= 16384 else None)
    pv, cm = batch["pixel_values"], batch["crop_mask"]
    if pv.shape[0] * 2 == batch["input_ids"].shape[0]:
        pv = jnp.concatenate([pv, pv], axis=0)
        cm = jnp.concatenate([cm, cm], axis=0)
    hidden, fused = slime.forward(
        params, cfg, batch["input_ids"], batch["attention_mask"], pv, cm,
        batch["labels"], training=False, compute_dtype=compute_dtype,
        remat=remat, scan_layers=scan_layers,
        return_hidden=True)
    weights = None
    if token_weights is not None:
        weights = _fused_weights(fused.labels, token_weights)
    return chunked_sequence_logp(hidden, params["llm"]["lm_head"],
                                 fused.labels, chunk=loss_chunk,
                                 weights=weights)


def _dpo_metrics(losses, chosen_rewards, rejected_rewards, pc, pr, n_chosen,
                 weighted: bool = False):
    margin = chosen_rewards - rejected_rewards
    m = {
        "reward_margin": jnp.mean(margin),
        "reward_accuracy": jnp.mean((margin > 0).astype(jnp.float32)),
        "chosen_reward": jnp.mean(chosen_rewards),
        "rejected_reward": jnp.mean(rejected_rewards),
        "policy_chosen_logp": jnp.mean(pc),
        "policy_rejected_logp": jnp.mean(pr),
    }
    if weighted:
        # with dpo_token_weighted the mass is the sum of difflib weights, not a
        # token count — name it what it is so tokens accounting stays honest
        m["target_weight_mass"] = n_chosen
    else:
        m["n_target_tokens"] = n_chosen.astype(jnp.int32)
    return m


def _dpo_objective(logp, mass, ref_logp, ref_mass, dc: DPOConfig):
    """[2B] policy/ref logps -> (scalar loss, metrics)."""
    B = logp.shape[0] // 2
    safe_mass = jnp.maximum(mass, 1e-9)
    safe_ref_mass = jnp.maximum(ref_mass, 1e-9)
    if dc.use_average:
        p = logp / safe_mass
        r = ref_logp / safe_ref_mass
    else:
        p, r = logp, ref_logp
    pc, pr = p[:B], p[B:]
    rc, rr = r[:B], r[B:]
    losses, chosen_rewards, rejected_rewards = dpo_losses(
        pc, pr, rc, rr, beta=dc.beta, loss_type=dc.loss_type)
    loss = dc.dpo_weight * jnp.mean(losses)
    if dc.sft_weight > 0.0:
        # plain NLL on the chosen rows (always per-token mean, the SFT scale)
        sft = -jnp.sum(logp[:B]) / jnp.maximum(jnp.sum(mass[:B]), 1e-9)
        loss = loss + dc.sft_weight * sft
    n_chosen = jnp.sum(mass[:B])
    return loss, _dpo_metrics(losses, chosen_rewards, rejected_rewards,
                              pc, pr, n_chosen, weighted=dc.token_weighted)


def make_dpo_train_step(cfg: SliMEConfig, tc: TrainConfig, tx, dc: DPOConfig,
                        *, compute_dtype=jnp.bfloat16, remat: bool = False,
                        scan_layers: bool = False, loss_chunk="auto"):
    """Full-parameter DPO: step(state, ref_params, batch, rng) -> (state, metrics).

    ``ref_params`` is the frozen reference policy (by default the SFT
    checkpoint the run started from); it is evaluated outside the gradient
    closure — backward spans only the policy forward."""

    kw = dict(compute_dtype=compute_dtype, remat=remat,
              scan_layers=scan_layers, loss_chunk=loss_chunk)

    def loss(params, batch, ref_logp, ref_mass, token_weights):
        logp, mass = pair_logps(params, cfg, batch,
                                token_weights=token_weights, **kw)
        return _dpo_objective(logp, mass, ref_logp, ref_mass, dc)

    @functools.partial(jax.jit, donate_argnums=(0,))
    def step(state, ref_params, batch, rng):
        del rng  # selection runs deterministically (see module docstring)
        token_weights = batch.get("target_weights") if dc.token_weighted \
            else None
        ref_logp, ref_mass = pair_logps(ref_params, cfg, batch,
                                        token_weights=token_weights, **kw)
        (l, aux), grads = jax.value_and_grad(loss, has_aux=True)(
            state["params"], batch, ref_logp, ref_mass, token_weights)
        updates, new_opt = tx.update(grads, state["opt_state"], state["params"])
        new_params = optax.apply_updates(state["params"], updates)
        gnorm = optax.global_norm(grads)
        new_state = {"params": new_params, "opt_state": new_opt,
                     "step": state["step"] + 1}
        return new_state, {"loss": l, "grad_norm": gnorm, **aux}

    return step


def make_lora_dpo_train_step(cfg: SliMEConfig, tc: TrainConfig, tx,
                             dc: DPOConfig, *, rank: int, alpha: int,
                             compute_dtype=jnp.bfloat16, remat: bool = False,
                             scan_layers: bool = False, loss_chunk="auto"):
    """LoRA/QLoRA DPO: the frozen base IS the reference policy.

    step(state, base_params, batch, rng) -> (state, metrics). No second
    parameter tree: reference log-probs come from ``base_params`` with the
    adapters off (and the ORIGINAL projector/sampler — the trainable
    "extras" only exist on the policy side), which is exact because the
    policy at adapter-init (B=0) equals the base."""
    from . import lora as lora_lib

    kw = dict(compute_dtype=compute_dtype, remat=remat,
              scan_layers=scan_layers, loss_chunk=loss_chunk)

    def policy_params(trainable, base_params):
        params = dict(base_params)
        params.update(trainable["extras"])
        return lora_lib.attach(
            params, {"rank": rank, "alpha": alpha,
                     "adapters": trainable["adapters"]})

    def loss(trainable, base_params, batch, ref_logp, ref_mass, token_weights):
        logp, mass = pair_logps(policy_params(trainable, base_params), cfg,
                                batch, token_weights=token_weights, **kw)
        return _dpo_objective(logp, mass, ref_logp, ref_mass, dc)

    @functools.partial(jax.jit, donate_argnums=(0,))
    def step(state, base_params, batch, rng):
        del rng
        token_weights = batch.get("target_weights") if dc.token_weighted \
            else None
        ref_logp, ref_mass = pair_logps(base_params, cfg, batch,
                                        token_weights=token_weights, **kw)
        (l, aux), grads = jax.value_and_grad(loss, has_aux=True)(
            state["params"], base_params, batch, ref_logp, ref_mass,
            token_weights)
        updates, new_opt = tx.update(grads, state["opt_state"], state["params"])
        new_params = optax.apply_updates(state["params"], updates)
        gnorm = optax.global_norm(grads)
        new_state = {"params": new_params, "opt_state": new_opt,
                     "step": state["step"] + 1}
        return new_state, {"loss": l, "grad_norm": gnorm, **aux}

    return step


def shard_ref_params(ref_params, mesh=None):
    """Place the frozen reference tree (sharded under a mesh, else devices)."""
    if mesh is not None:
        return mesh_lib.shard_params(mesh, ref_params)
    return jax.tree_util.tree_map(jnp.asarray, ref_params)
