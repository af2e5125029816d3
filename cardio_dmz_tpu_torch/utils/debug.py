"""Debug logging, tracing, and wall timers (dmz_debug.h equivalents).

Counterpart of the JAX package's utils/debug.py:

* dmz_debug_log / dmz_error_log -> python logging (dmz_debug.h:18-42)
* DMZ_TRACE verbose tracing       -> trace_log, gated by CARDIO_TRACE
* 10-slot microsecond timers      -> Timers (dmz_debug.h:51-105)
* device-side profiling           -> a torch.profiler trace context and
                                     named regions (record_function), in
                                     place of jax.profiler's
"""

import contextlib
import logging
import os
import tempfile
import time

logger = logging.getLogger("cardio_dmz_tpu_torch")

_TRACE = os.environ.get("CARDIO_TRACE", "0").lower() in ("1", "true")


def debug_log(fmt, *args):
    logger.debug(fmt, *args)


def error_log(fmt, *args):
    logger.error(fmt, *args)


def trace_log(fmt, *args):
    if _TRACE:
        logger.info("TRACE: " + fmt, *args)


class Timers:
    """10-slot wall timers mirroring dmz_debug_timer_* (dmz_debug.h:51-105):
    start/lap/stop/print per slot, microsecond resolution."""

    N_SLOTS = 10

    def __init__(self):
        self._start = [0.0] * self.N_SLOTS
        self._lap = [0.0] * self.N_SLOTS

    def start(self, slot=0):
        now = time.perf_counter()
        self._start[slot] = now
        self._lap[slot] = now

    def lap(self, slot=0):
        """Microseconds since the last lap (or start)."""
        now = time.perf_counter()
        elapsed = (now - self._lap[slot]) * 1e6
        self._lap[slot] = now
        return elapsed

    def stop(self, slot=0):
        """Microseconds since start."""
        return (time.perf_counter() - self._start[slot]) * 1e6

    def print_lap(self, message, slot=0):
        us = self.lap(slot)
        debug_log("%10.3f ms to %s", us / 1000.0, message)
        return us


TIMERS = Timers()


@contextlib.contextmanager
def profile_trace(log_dir=None):
    """A torch.profiler trace of the block, host and (when there is a
    card) device activity, written as a Chrome trace to
    <log_dir>/trace.json on exit; log_dir defaults to cardio_trace in the
    temporary directory. Yields the trace's path. View it in Perfetto or
    chrome://tracing."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "cardio_trace")
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)


def annotate(name):
    """Named region of a profile (torch.profiler.record_function)."""
    import torch
    return torch.profiler.record_function(name)
