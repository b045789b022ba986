"""Logging, profiling, and misc utilities.

Rebuilds llava/utils.py (build_logger with rotating file redirection,
rank0 printing, semaphore pretty-printing) and adds the profiling layer the
reference lacks (SURVEY.md §5: "Tracing/profiling: none"): jax.profiler trace
capture, step timing, and the device description and peak rates that every
benchmark line carries.
"""
from __future__ import annotations

import contextlib
import json
import logging
import logging.handlers
import os
import sys
import time
from typing import Dict, Optional

from .constants import LOGDIR

server_error_msg = ("**NETWORK ERROR DUE TO HIGH TRAFFIC. PLEASE REGENERATE OR "
                    "REFRESH THIS PAGE.**")

_handler = None


def build_logger(logger_name: str, logger_filename: str) -> logging.Logger:
    """Console + daily-rotated file logging; stdout/stderr redirected into the log
    (reference llava/utils.py:17-57 behavior)."""
    global _handler
    formatter = logging.Formatter(
        fmt="%(asctime)s | %(levelname)s | %(name)s | %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S")

    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO)
    logging.getLogger().handlers[0].setFormatter(formatter)

    stdout_logger = logging.getLogger("stdout")
    stdout_logger.setLevel(logging.INFO)
    sys.stdout = StreamToLogger(stdout_logger, logging.INFO)
    stderr_logger = logging.getLogger("stderr")
    stderr_logger.setLevel(logging.ERROR)
    sys.stderr = StreamToLogger(stderr_logger, logging.ERROR)

    logger = logging.getLogger(logger_name)
    logger.setLevel(logging.INFO)

    if _handler is None:
        os.makedirs(LOGDIR, exist_ok=True)
        filename = os.path.join(LOGDIR, logger_filename)
        _handler = logging.handlers.TimedRotatingFileHandler(
            filename, when="D", utc=True)
        _handler.setFormatter(formatter)
        for name, item in logging.root.manager.loggerDict.items():
            if isinstance(item, logging.Logger):
                item.addHandler(_handler)
    return logger


class StreamToLogger:
    """File-like object redirecting writes into a logger (llava/utils.py:60-90)."""

    def __init__(self, logger: logging.Logger, log_level=logging.INFO):
        self.terminal = sys.stdout
        self.logger = logger
        self.log_level = log_level
        self.linebuf = ""

    def __getattr__(self, attr):
        return getattr(self.terminal, attr)

    def write(self, buf):
        temp = self.linebuf + buf
        self.linebuf = ""
        for line in temp.splitlines(True):
            if line.endswith("\n"):
                self.logger.log(self.log_level, line.rstrip())
            else:
                self.linebuf += line

    def flush(self):
        if self.linebuf:
            self.logger.log(self.log_level, self.linebuf.rstrip())
        self.linebuf = ""


def rank0_print(*args, **kw):
    """Print only on process 0 (reference train.py:49-51)."""
    try:
        import jax
        if jax.process_index() != 0:
            return
    except Exception:
        pass
    print(*args, **kw)


def pretty_print_semaphore(sem) -> str:
    if sem is None:
        return "None"
    return f"Semaphore(value={sem._value})"


def disable_caching_allocator():  # parity shim for disable_torch_init callers
    pass


# ----------------------------------------------------------------------------------
# Profiling (superset over the reference)
# ----------------------------------------------------------------------------------

@contextlib.contextmanager
def profile_trace(logdir: str = "/tmp/slime_trace", enabled: bool = True):
    """Capture a jax.profiler trace (viewable in TensorBoard / Perfetto)."""
    if not enabled:
        yield
        return
    import jax
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class StepTimer:
    """Lightweight per-step wall-clock metrics accumulator."""

    def __init__(self):
        self.t0: Optional[float] = None
        self.records: list = []

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.records.append(time.perf_counter() - self.t0)

    def summary(self) -> Dict[str, float]:
        if not self.records:
            return {}
        import numpy as np
        arr = np.asarray(self.records)
        return {"mean_s": float(arr.mean()), "p50_s": float(np.percentile(arr, 50)),
                "p90_s": float(np.percentile(arr, 90)), "n": len(arr)}


class MetricsLogger:
    """Append-only jsonl metrics with optional wandb mirroring
    (reference --report_to wandb)."""

    def __init__(self, path: str, use_wandb: bool = False, **wandb_kw):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.wandb = None
        if use_wandb:
            try:
                import wandb
                self.wandb = wandb.init(**wandb_kw)
            except ImportError:
                pass

    def log(self, metrics: Dict, step: Optional[int] = None) -> None:
        rec = dict(metrics)
        if step is not None:
            rec["step"] = step
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self.wandb is not None:
            self.wandb.log(metrics, step=step)


def enable_compilation_cache() -> str:
    """Persistent XLA compilation cache: restarts reuse compiled executables
    from disk instead of paying the first compile again. Called by every
    entry point. With $JAX_COMPILATION_CACHE_DIR set, JAX reads it itself and
    nothing is changed here; otherwise the cache is the fixed
    ``<checkout>/.jax_compile_cache`` (listed in .gitignore). Returns the
    directory in use."""
    import os

    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), ".jax_compile_cache")
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path


# Dense (no sparsity) bf16 tensor-core peaks, keyed by jax device_kind.
# Source: NVIDIA H100 data sheet, SXM part, at its full 700 W power limit.
BF16_PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989e12,
}


def bf16_peak_flops(device_kind: str) -> float:
    """Published dense bf16 peak of one device; raises for a device the table
    does not know rather than assuming a peak."""
    try:
        return BF16_PEAK_FLOPS[device_kind]
    except KeyError:
        raise ValueError(f"no bf16 peak recorded for device_kind "
                         f"{device_kind!r}; add it to utils.BF16_PEAK_FLOPS "
                         f"with its source") from None


def device_description() -> Dict:
    """{"platform", "kind", "count"} of the devices JAX runs on — printed
    beside every measurement so no number is read without its device."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
