"""Profiling / tracing utilities.

The reference only measures (and then discards) one wall-clock interval
(FCCF.cpp:1681-1685). Observability (SURVEY.md §5):

  - ``stage_timer``: per-stage wall timing with device synchronization
    (block_until_ready), for quick breakdowns without a profiler;
  - ``trace``: context manager around ``jax.profiler`` producing a
    TensorBoard-loadable trace of the compiled pipeline;
  - ``annotate``: named traces inside jit via jax.profiler.TraceAnnotation
    equivalents (jax.named_scope).
"""

from __future__ import annotations

import contextlib
import time
from collections import OrderedDict

import jax


class StageTimer:
    """Accumulates named wall-clock stage timings (device-synchronized)."""

    def __init__(self):
        self.times = OrderedDict()

    @contextlib.contextmanager
    def stage(self, name, *sync):
        """Times the block, device-synchronized. JAX dispatch is async, so
        outputs created INSIDE the block must be registered for the exit
        barrier — append them to the yielded list::

            with timer.stage("register") as live:
                live.append(fn(x))

        (``*sync`` args are evaluated at entry and only help for values
        that already exist; without registration the recorded time is
        just dispatch.) Recording happens even if the body raises."""
        live: list = list(sync)
        t0 = time.perf_counter()
        try:
            yield live
        finally:
            for x in live:
                jax.block_until_ready(x)
            self.times[name] = (
                self.times.get(name, 0.0) + time.perf_counter() - t0
            )

    def report(self):
        total = sum(self.times.values())
        lines = [f"{'stage':<28}{'time (ms)':>12}{'share':>9}"]
        for k, v in self.times.items():
            lines.append(f"{k:<28}{v * 1e3:>12.2f}{v / max(total, 1e-12):>8.1%}")
        lines.append(f"{'total':<28}{total * 1e3:>12.2f}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a jax.profiler trace (view with TensorBoard)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


annotate = jax.named_scope
