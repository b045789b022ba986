"""Multi-host initialization and cross-host utilities.

Replaces the deepspeed launcher + NCCL process-group setup (SURVEY.md §2.11:
`jax.distributed.initialize` for multi-host process groups). Each host runs the
same SPMD program and XLA places the collectives (NCCL on GPUs) — no rank
plumbing in model code.
"""
from __future__ import annotations

import os
from typing import Optional


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Idempotent jax.distributed.initialize with env fallbacks
    (COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID); a no-op single-host."""
    import jax

    if num_processes is None:
        num_processes = int(os.environ.get("NUM_PROCESSES", "1"))
    if num_processes <= 1 and coordinator_address is None:
        return
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address
            or os.environ.get("COORDINATOR_ADDRESS"),
            num_processes=num_processes,
            process_id=process_id if process_id is not None
            else int(os.environ.get("PROCESS_ID", "0")))
    except RuntimeError as e:
        if "already initialized" not in str(e):
            raise


def process_count() -> int:
    import jax
    return jax.process_count()


def process_index() -> int:
    import jax
    return jax.process_index()


def is_main_process() -> bool:
    return process_index() == 0


def local_batch_slice(global_batch: int) -> slice:
    """The rows of a global batch this host should feed (for per-host data loading
    with jax.make_array_from_process_local_data-style assembly)."""
    n = process_count()
    per = global_batch // n
    i = process_index()
    return slice(i * per, (i + 1) * per)


def barrier(name: str = "barrier") -> None:
    """Cross-host sync point (debug/checkpoint coordination)."""
    import jax
    import jax.numpy as jnp
    if jax.process_count() == 1:
        return
    x = jnp.ones(())
    jax.block_until_ready(
        jax.pmap(lambda v: jax.lax.psum(v, "i"), axis_name="i")(
            x[None].repeat(jax.local_device_count(), 0)))
