"""Profiling and timing (PyTorch port of the JAX package's
`utils/profiling.py`): a `torch.profiler` trace, a step timer that waits
for the card, and a small autotuner over configurations."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Iterable

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace (CPU, and the card's kernels when
    there is one) into log_dir: `with trace('/tmp/prof'): step(...)`."""
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def _on_card(out) -> bool:
    if isinstance(out, torch.Tensor):
        return out.is_cuda
    if isinstance(out, dict):
        return any(_on_card(v) for v in out.values())
    if isinstance(out, (list, tuple)):
        return any(_on_card(v) for v in out)
    return False


class StepTimer:
    """Wall-clock step times that end on a finished device: a synchronize
    when the result lies on the card. `time_fn` times with CUDA events
    there."""

    def __init__(self):
        self.times: list[float] = []

    @contextlib.contextmanager
    def step(self, result_holder: list | None = None):
        t0 = time.time()
        yield
        if result_holder and _on_card(result_holder[-1]):
            torch.cuda.synchronize()
        self.times.append(time.time() - t0)

    def time_fn(self, fn, *args, warmup: int = 2, iters: int = 10) -> float:
        """Mean seconds a call, the device's work included."""
        out = None
        for _ in range(warmup):
            out = fn(*args)
        if _on_card(out):
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn(*args)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3 / iters
        t0 = time.time()
        for _ in range(iters):
            fn(*args)
        return (time.time() - t0) / iters

    @property
    def mean_ms(self) -> float:
        return 1e3 * sum(self.times) / max(len(self.times), 1)


def autotune(fn_builder: Callable, configs: Iterable, *args, **timer_kw):
    """The fastest config: fn_builder(config) -> callable(*args). A config
    that fails to build or run is skipped. Returns (best, {repr: s})."""
    timer = StepTimer()
    best, best_t = None, float("inf")
    results = {}
    for config in configs:
        try:
            fn = fn_builder(config)
            t = timer.time_fn(fn, *args, **timer_kw)
        except Exception:
            continue
        results[repr(config)] = t
        if t < best_t:
            best, best_t = config, t
    return best, results
