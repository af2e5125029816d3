"""Serving-loop metrics: counters/gauges with a text exposition format.

The port's own copy of the JAX package's runtime/metrics.py (pure Python,
no backend).

The reference's observability is the scan_analytics ring plus debug-log
macros (SURVEY.md §5) — per-session, never exported. A production serving
deployment needs loop-level counters; this is the host-side surface
(device-side per-session telemetry stays in session/analytics.py).

Prometheus-style text exposition so any scraper can consume it; zero
dependencies; threads-safe enough for the serving loop's single writer +
occasional reader.
"""

import threading
import time


class Metrics:
    def __init__(self, namespace="cardio"):
        self.namespace = namespace
        self._lock = threading.Lock()
        self._counters = {}
        self._gauges = {}
        self._timers = {}   # name -> (count, total_s, max_s)
        self.started_at = time.time()

    # ------------------------------------------------------------- write
    def inc(self, name, value=1):
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + value

    def set(self, name, value):
        with self._lock:
            self._gauges[name] = value

    def observe(self, name, seconds):
        with self._lock:
            c, t, m = self._timers.get(name, (0, 0.0, 0.0))
            self._timers[name] = (c + 1, t + seconds, max(m, seconds))

    class _Timer:
        def __init__(self, metrics, name):
            self.metrics, self.name = metrics, name

        def __enter__(self):
            self.t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            self.metrics.observe(self.name, time.perf_counter() - self.t0)

    def time(self, name):
        """with metrics.time("step"): ..."""
        return self._Timer(self, name)

    # -------------------------------------------------------------- read
    def snapshot(self):
        """Namespaced flat view: counters/gauges/timer-derived keys cannot
        collide (each kind carries its own prefix)."""
        with self._lock:
            out = {f"counter_{k}": v for k, v in self._counters.items()}
            out.update({f"gauge_{k}": v for k, v in self._gauges.items()})
            for name, (c, t, m) in self._timers.items():
                out[f"timer_{name}_count"] = c
                out[f"timer_{name}_seconds_total"] = round(t, 6)
                out[f"timer_{name}_seconds_max"] = round(m, 6)
                if c:
                    out[f"timer_{name}_seconds_avg"] = round(t / c, 6)
            out["gauge_uptime_seconds"] = round(
                time.time() - self.started_at, 3)
        return out

    @staticmethod
    def _format_value(v):
        """Prometheus sample values are floats; bools map to 0/1 and
        non-numeric values (None, strings) are dropped by the caller."""
        if isinstance(v, bool):
            return "1" if v else "0"
        if isinstance(v, (int, float)):
            return repr(v)
        return None

    def render_text(self):
        """Prometheus text exposition (with # TYPE lines; numeric-only)."""
        lines = []
        for k, v in sorted(self.snapshot().items()):
            kind, _, rest = k.partition("_")
            val = self._format_value(v)
            if val is None:
                continue
            name = f"{self.namespace}_{rest}"
            ptype = ("counter" if kind == "counter"
                     or rest.endswith(("_count", "_seconds_total"))
                     else "gauge")
            lines.append(f"# TYPE {name} {ptype}")
            lines.append(f"{name} {val}")
        return "\n".join(lines) + "\n"
