"""Typed metrics registry and run provenance.

`sched.metrics.summarize` is built on these: a :class:`Counter` for
monotonically increasing totals, a :class:`Gauge` for point-in-time
values and a :class:`Histogram` whose ``summary()`` is the mean/p50/p99
shape every serving record reports.  No labels, no time series: the
stack's clock is the scheduler tick and the per-tick stream lives in
``obs.trace``; this layer only aggregates.

:func:`provenance` stamps the run context (config, mode, seed, backend,
torch and CUDA versions, the card and its power limit, git sha,
timestamp) into ``--json`` dumps, so a number can be traced to the run
that made it.
"""
from __future__ import annotations

import datetime
import os
import subprocess
from typing import Dict, List, Optional


def percentile(values: List[float], q: float) -> Optional[float]:
    """Nearest-rank percentile; None on empty input."""
    if not values:
        return None
    xs = sorted(values)
    idx = max(0, min(len(xs) - 1, int(round(q / 100.0 * (len(xs) - 1)))))
    return xs[idx]


class Counter:
    """Monotonically increasing total."""

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Point-in-time value (last write wins)."""

    def __init__(self, name: str):
        self.name = name
        self.value: Optional[float] = None

    def set(self, v: Optional[float]) -> None:
        self.value = v


class Histogram:
    """Value distribution; ``summary()`` is ``{"mean", "p50", "p99"}``
    (rounded, None when empty)."""

    def __init__(self, name: str):
        self.name = name
        self.values: List[float] = []

    def observe(self, v: float) -> None:
        self.values.append(float(v))

    def observe_many(self, vs) -> None:
        self.values.extend(float(v) for v in vs)

    def summary(self, scale: float = 1.0, digits: int = 4) -> Optional[dict]:
        if not self.values:
            return None
        xs = [v * scale for v in self.values]
        return {
            "mean": round(sum(xs) / len(xs), digits),
            "p50": round(percentile(xs, 50), digits),
            "p99": round(percentile(xs, 99), digits),
        }


class Registry:
    """Get-or-create namespace of typed metrics; ``snapshot()`` returns
    plain dicts ready for ``json.dump``."""

    def __init__(self):
        self.counters: Dict[str, Counter] = {}
        self.gauges: Dict[str, Gauge] = {}
        self.histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        if name not in self.counters:
            self.counters[name] = Counter(name)
        return self.counters[name]

    def gauge(self, name: str) -> Gauge:
        if name not in self.gauges:
            self.gauges[name] = Gauge(name)
        return self.gauges[name]

    def histogram(self, name: str) -> Histogram:
        if name not in self.histograms:
            self.histograms[name] = Histogram(name)
        return self.histograms[name]

    def snapshot(self) -> dict:
        return {
            "counters": {k: c.value for k, c in sorted(self.counters.items())},
            "gauges": {k: g.value for k, g in sorted(self.gauges.items())},
            "histograms": {k: h.summary() for k, h
                           in sorted(self.histograms.items())},
        }


def _run(cmd: List[str]) -> Optional[str]:
    """A command's stripped standard output, or None if it cannot run."""
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=10,
                             cwd=os.path.dirname(os.path.abspath(__file__)))
    except (OSError, subprocess.SubprocessError):
        return None
    if out.returncode != 0:
        return None
    return out.stdout.strip() or None


def card(device=None) -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them (the device's line),
    or None when ``device`` is not a CUDA device."""
    import torch
    device = torch.device(device) if device is not None else None
    if device is None or device.type != "cuda":
        return None
    out = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"])
    if out is None:
        return None
    lines = out.splitlines()
    return lines[min(device.index or 0, len(lines) - 1)]


def provenance(config: Optional[str] = None, mode: Optional[str] = None,
               seed: Optional[int] = None, backend: Optional[str] = None,
               device=None, **extra) -> dict:
    """Run-context header stamped into ``--json`` dumps: enough to
    attribute a number to the run that made it.  ``device`` (a torch
    device) adds the card and its power limit when it is a CUDA one."""
    import torch
    info = {
        "config": config,
        "mode": mode,
        "seed": seed,
        "backend": backend,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "card": card(device),
        "git_sha": _run(["git", "rev-parse", "--short", "HEAD"]),
        "timestamp": datetime.datetime.now(
            datetime.timezone.utc).isoformat(timespec="seconds"),
    }
    info.update(extra)
    return info
