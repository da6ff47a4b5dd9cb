"""Tracing / profiling helpers.

JAX replacement for the reference's observability affordances
(SURVEY.md §5): the fps/MRays title stats live in utils/stats.py; this module
adds device-level tracing (the PIX-capture analogue) via jax.profiler, plus
named-scope annotation so render phases show up in trace viewers the way
NAME_D3D12_OBJECT labels show in PIX
(/root/reference/libs/DXRFramework/Helpers/DirectXHelper.h:130-155).
"""

from __future__ import annotations

import contextlib
import time

import jax


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a jax.profiler device trace around a block:

        with device_trace("/tmp/rt-trace"):
            pipeline.render()

    View with TensorBoard or Perfetto (trace files under log_dir).
    """
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


# Named annotation scope: frames/phases appear in the trace timeline.
annotate = jax.profiler.TraceAnnotation


class FrameTimer:
    """Host-side phase timing. A phase given a `fence` (arrays, or a
    callable returning them) waits for them with ``block_until_ready``, so
    it times the device work and not just the enqueue."""

    def __init__(self):
        self.phases: dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str, fence=None):
        t0 = time.perf_counter()
        yield
        if fence is not None:
            jax.block_until_ready(fence() if callable(fence) else fence)
        self.phases[name] = self.phases.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> str:
        total = sum(self.phases.values())
        parts = [f"{k}: {v * 1000:.2f}ms" for k, v in self.phases.items()]
        return f"total {total * 1000:.2f}ms | " + " | ".join(parts)
