"""Sharded training step: loss + grad + optimizer update under one jit.

The ZeRO equivalence (SURVEY.md §2.10): parameters and Adam moments are sharded
along the ``fsdp`` mesh axis by the rules in parallel/mesh.py; XLA all-gathers
weights on use and reduce-scatters gradients — the same communication volume as
DeepSpeed ZeRO-3, compiled instead of hand-scheduled. The batch is sharded over
``(data, fsdp)``; adding ``model`` gives Megatron TP for 70B. Optimizer state is
created from the already-sharded params (zeros_like preserves sharding), so Adam
moments land sharded without extra plumbing.
"""
from __future__ import annotations

import functools
import jax
import jax.numpy as jnp
import optax

from ..config import SliMEConfig
from ..models import slime
from ..parallel import mesh as mesh_lib
from .optim import TrainConfig, label_tree, make_optimizer


def make_train_step(cfg: SliMEConfig, tc: TrainConfig, tx,
                    compute_dtype=jnp.bfloat16, remat: bool = False,
                    scan_layers: bool = False, loss_chunk="auto", mesh=None):
    """Returns step(state, batch, rng) -> (state, metrics); jitted, state donated.

    Parameters the staged-freezing flags freeze (optim.trainable_label) enter
    the loss through stop_gradient: the backward pass computes no weight
    gradients for them, no gradient buffer the size of a frozen 8B LLM is
    allocated, and they leave the step unchanged. ``grad_norm`` is the norm
    of the trained parameters' gradients.

    The loss is chunked over the sequence (ops.loss) so the step never
    materializes [B, S, V] logits; loss_chunk="auto" chunks only at real vocab
    widths (see slime.loss_fn). Pass ``mesh`` when training sharded: fusion
    activations get canonical batch shardings (constrain_batch_act) so the SPMD
    partitioner never falls back to replicate-and-repartition."""

    def loss(params, batch, rng):
        return slime.loss_fn(params, cfg, batch, training=True, rng=rng,
                             compute_dtype=compute_dtype,
                             remat=remat, scan_layers=scan_layers,
                             loss_chunk=loss_chunk, mesh=mesh)

    @functools.partial(jax.jit, donate_argnums=(0,))
    def step(state, batch, rng):
        params = state["params"]
        labels = label_tree(params, tc)

        def frozen_loss(params, batch, rng):
            params = jax.tree_util.tree_map(
                lambda lab, p: jax.lax.stop_gradient(p) if lab == "frozen"
                else p, labels, params)
            return loss(params, batch, rng)

        (l, aux), grads = jax.value_and_grad(frozen_loss, has_aux=True)(
            params, batch, rng)
        updates, new_opt = tx.update(grads, state["opt_state"], params)
        new_params = jax.tree_util.tree_map(
            lambda lab, p, n: p if lab == "frozen" else n,
            labels, params, optax.apply_updates(params, updates))
        gnorm = optax.global_norm([
            g for lab, g in zip(jax.tree_util.tree_leaves(labels),
                                jax.tree_util.tree_leaves(grads))
            if lab != "frozen"])
        new_state = {"params": new_params, "opt_state": new_opt,
                     "step": state["step"] + 1}
        return new_state, {"loss": l, "grad_norm": gnorm, **aux}

    return step


def make_lora_train_step(cfg: SliMEConfig, tc: TrainConfig, tx, *,
                         rank: int, alpha: int,
                         compute_dtype=jnp.bfloat16, remat: bool = False,
                         scan_layers: bool = False, loss_chunk="auto",
                         mesh=None):
    """LoRA/QLoRA step: only the adapter factors (+ projector/sampler extras)
    are trained; the base — bf16 or QUANTIZED int8/int4 — is a frozen input.

    step(state, base_params, batch, rng) -> (state, metrics). ``state`` holds
    the small trainable tree {"adapters", "extras"} and its optimizer state;
    ``base_params`` is passed (not donated, never updated) so the same buffers
    serve every step. The forward applies adapters in factored form
    (train.lora.attach -> layers.linear), so a quantized base keeps its
    fused-kernel path — the QLoRA layout the reference gets from
    bitsandbytes + PEFT (train.py:956-972, 1036-1052)."""
    from . import lora as lora_lib

    def loss(trainable, base_params, batch, rng):
        params = dict(base_params)
        params.update(trainable["extras"])
        params = lora_lib.attach(
            params, {"rank": rank, "alpha": alpha,
                     "adapters": trainable["adapters"]})
        return slime.loss_fn(params, cfg, batch, training=True, rng=rng,
                             compute_dtype=compute_dtype,
                             remat=remat, scan_layers=scan_layers,
                             loss_chunk=loss_chunk, mesh=mesh)

    @functools.partial(jax.jit, donate_argnums=(0,))
    def step(state, base_params, batch, rng):
        (l, aux), grads = jax.value_and_grad(loss, has_aux=True)(
            state["params"], base_params, batch, rng)
        updates, new_opt = tx.update(grads, state["opt_state"], state["params"])
        new_params = optax.apply_updates(state["params"], updates)
        gnorm = optax.global_norm(grads)
        new_state = {"params": new_params, "opt_state": new_opt,
                     "step": state["step"] + 1}
        return new_state, {"loss": l, "grad_norm": gnorm, **aux}

    return step


def init_lora_train_state(base_params, lora_state, tc: TrainConfig, mesh=None,
                          train_extras=("projector", "sampler")):
    """Build (sharded_base, state, tx) for the LoRA step.

    The trainable tree is {"adapters": <lora factors>, "extras": <projector/
    sampler subtrees>}; optimizer moments exist only for it. With a mesh, the
    base shards by the usual rules (quantized dicts included) and the
    trainable tree by the adapter/extras rules."""
    from .optim import make_lora_optimizer

    trainable = {"adapters": lora_state["adapters"],
                 "extras": {k: base_params[k] for k in train_extras
                            if k in base_params}}
    base = {k: v for k, v in base_params.items()}
    if mesh is not None:
        base = mesh_lib.shard_params(mesh, base)
        trainable = mesh_lib.shard_params(mesh, trainable)
    else:
        base = jax.tree_util.tree_map(jnp.asarray, base)
        trainable = jax.tree_util.tree_map(jnp.array, trainable)
    tx, _ = make_lora_optimizer(trainable, tc)
    # ONE jitted graph for the whole optimizer init: eagerly, tx.init issues
    # a zeros/copy op and a compile per unique leaf shape
    opt_state = jax.jit(tx.init)(trainable)
    state = {"params": trainable, "opt_state": opt_state,
             "step": jnp.zeros((), jnp.int32)}
    return base, state, tx


def init_train_state(params, tc: TrainConfig, mesh=None):
    """Build (state, tx, step_fn closure inputs). With a mesh, params are sharded
    first so optimizer moments inherit the sharded layout."""
    if mesh is not None:
        params = mesh_lib.shard_params(mesh, params)
        tx, _ = make_optimizer(params, tc)
        # one compile instead of an eager zeros op per leaf (see the LoRA
        # variant above); jit output follows the inputs' shardings
        opt_state = jax.jit(tx.init)(params)
    else:
        tx, _ = make_optimizer(params, tc)

        @jax.jit
        def _mk(p):
            # the copy keeps the caller's buffers alive across the train
            # step's donation; inside jit the whole init is ONE compile
            p = jax.tree_util.tree_map(jnp.array, p)
            return p, tx.init(p)

        params, opt_state = _mk(params)
    state = {"params": params, "opt_state": opt_state,
             "step": jnp.zeros((), jnp.int32)}
    return state, tx
