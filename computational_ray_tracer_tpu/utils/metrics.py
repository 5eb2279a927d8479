"""Metrics, structured logging, timers, and profiler hooks.

Capability parity with the reference's observability (SURVEY §5): the chrono
``Timer`` (Util/Timer.h:3-56), the per-sample-pass wall-time prints
(RayTracerTestApp.h:399-409), and the global triangle-intersect counter
(Shapes.h:909-911) — array-first: counters are *array outputs* of the kernels
(octree_traverse returns per-ray test counts), timers block on device
results, metrics are structured JSON lines, and ``trace`` wraps
``jax.profiler`` for Perfetto dumps."""

from __future__ import annotations

import contextlib
import json
import sys
import time


class Timer:
    """Wall-clock timer (Timer capability): ms/us/ns reads + lap."""

    def __init__(self):
        self.start()

    def start(self):
        self._t0 = time.perf_counter()

    def seconds(self):
        return time.perf_counter() - self._t0

    def ms(self):
        return self.seconds() * 1e3

    def us(self):
        return self.seconds() * 1e6

    def ns(self):
        return self.seconds() * 1e9

    def lap(self):
        t = self.seconds()
        self.start()
        return t


class MetricsLogger:
    """Structured JSONL metrics (rays/s, spp/s, scaling efficiency...)."""

    def __init__(self, stream=None, path=None):
        self._stream = stream or sys.stderr
        self._file = open(path, "a") if path else None

    def log(self, event, **fields):
        rec = {"event": event, "t": time.time(), **fields}
        line = json.dumps(rec)
        if self._file:
            self._file.write(line + "\n")
            self._file.flush()
        else:
            print(line, file=self._stream)

    def close(self):
        if self._file:
            self._file.close()


class RenderMeter:
    """Throughput accounting for progressive renders: rays/s, pass time."""

    def __init__(self, n_pixels, rays_per_sample, logger=None):
        self.n_pixels = n_pixels
        self.rays_per_sample = rays_per_sample
        self.logger = logger or MetricsLogger()
        self.timer = Timer()
        self.passes = 0

    def pass_done(self, block_on=None):
        if block_on is not None:
            block_on.block_until_ready()
        dt = self.timer.lap()
        self.passes += 1
        rays = self.n_pixels * self.rays_per_sample
        self.logger.log("pass", index=self.passes, seconds=dt,
                        rays_per_sec=rays / max(dt, 1e-9))
        return dt


@contextlib.contextmanager
def trace(name, log_dir=None):
    """jax.profiler trace context (Perfetto): the device-side answer to the
    reference's ad hoc timer prints."""
    import jax
    if log_dir is None:
        yield
        return
    with jax.profiler.trace(log_dir):
        with jax.profiler.TraceAnnotation(name):
            yield
