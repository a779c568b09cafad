"""Host-side metrics registry with Prometheus text exposition.

A copy of the JAX package's ``obs/registry.py`` (framework-neutral): one
registry serves the training loop (per-step wall time, samples, bad-step
counters) with Prometheus text format 0.0.4, the lowest common
denominator every metrics stack ingests.

Design constraints:

* **Lock-light hot path.** A counter ``inc()`` is one short critical
  section on the child's own lock (never a registry-wide lock); the
  per-child lock exists because ``+=`` on a float is NOT atomic across
  bytecode boundaries and torn counters are worse than none.
* **Fixed histogram bounds.** Buckets are chosen at metric creation and
  never re-bucketed — cumulative bucket counts are monotone, which is
  what makes rate()/histogram_quantile() correct on the scraper side.
* **Stable names are an API** (the reference's
  ``docs/observability.md`` holds the inventory): dashboards and fleet
  pollers key on them.
"""

from __future__ import annotations

import re
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# Default histogram bounds: latency-shaped, 1 ms .. 60 s. Wide enough
# for a train step (ms..s) and a generation TTFT under load.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

# A sample is (name, labels-dict, value) — the unit the renderer groups.
Sample = Tuple[str, Dict[str, str], float]
# Metadata: name -> (type, help).
Meta = Dict[str, Tuple[str, str]]


def escape_label_value(v: str) -> str:
    """Prometheus label-value escaping: backslash, double-quote, newline
    (text format 0.0.4 — the three characters that would corrupt the
    line grammar)."""
    return (str(v).replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _fmt_value(v: float) -> str:
    f = float(v)
    if f == float("inf"):
        return "+Inf"
    if f == float("-inf"):
        return "-Inf"
    if f != f:
        return "NaN"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _fmt_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{escape_label_value(v)}"'
                     for k, v in labels.items())
    return "{" + inner + "}"


def render(meta: Meta, samples: Iterable[Sample]) -> str:
    """Render samples as exposition text, GROUPED by metric name (the
    format requires all lines of one metric to form a single block, with
    at most one ``# TYPE`` — the reason merging two engines' metrics
    cannot be plain string concatenation)."""
    by_name: Dict[str, List[Sample]] = {}
    order: List[str] = []
    for s in samples:
        base = s[0]
        # Histogram series group under the base metric name.
        for suffix in ("_bucket", "_sum", "_count"):
            if base.endswith(suffix) and base[:-len(suffix)] in meta:
                base = base[:-len(suffix)]
                break
        if base not in by_name:
            by_name[base] = []
            order.append(base)
        by_name[base].append(s)
    out: List[str] = []
    for base in order:
        typ, help_ = meta.get(base, ("untyped", ""))
        if help_:
            out.append(f"# HELP {base} {help_}")
        out.append(f"# TYPE {base} {typ}")
        for name, labels, value in by_name[base]:
            out.append(f"{name}{_fmt_labels(labels)} {_fmt_value(value)}")
    return "\n".join(out) + ("\n" if out else "")


def parse_exposition(text: str) -> Dict[Tuple[str, Tuple[Tuple[str, str],
                                                         ...]], float]:
    """Parse exposition text back into ``{(name, sorted-label-items):
    value}`` — the scraper half used by :mod:`.summary` (the fleet
    poller) and by tests asserting golden lines survive a round trip.
    Tolerant: unknown/comment lines are skipped, not errors."""
    out: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = re.match(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"
                     r"(?:\{(.*)\})?\s+(\S+)$", line)
        if not m:
            continue
        name, labelstr, value = m.groups()
        labels: Dict[str, str] = {}
        if labelstr:
            for lm in re.finditer(
                    r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"',
                    labelstr):
                # Single-pass unescape: sequential str.replace would
                # consume the 'n' of an escaped backslash followed by n
                # ("\\n" must parse as backslash+n, not newline).
                labels[lm.group(1)] = re.sub(
                    r"\\(.)",
                    lambda m: "\n" if m.group(1) == "n" else m.group(1),
                    lm.group(2))
        try:
            if value == "+Inf":
                v = float("inf")
            elif value == "-Inf":
                v = float("-inf")
            else:
                v = float(value)
        except ValueError:
            continue
        out[(name, tuple(sorted(labels.items())))] = v
    return out


class _Child:
    """One concrete series (a metric bound to one label-value set)."""

    def __init__(self):
        self._lock = threading.Lock()


class Counter(_Child):
    """Monotone counter. ``inc(n)`` with n >= 0 only — a counter that
    goes down lies to every rate() on the scraper side."""

    def __init__(self):
        super().__init__()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter increment must be >= 0, got {n}")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge(_Child):
    """Settable instantaneous value."""

    def __init__(self):
        super().__init__()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        with self._lock:
            self._value -= n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram(_Child):
    """Fixed-bound cumulative histogram (the Prometheus shape:
    ``_bucket{le=}`` counts are cumulative, plus ``_sum``/``_count``)."""

    def __init__(self, buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__()
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        if any(b != b or b == float("inf") for b in bounds):
            raise ValueError(f"bucket bounds must be finite, got {bounds}")
        self.bounds = bounds
        self._counts = [0] * len(bounds)
        self._inf = 0
        self._sum = 0.0

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._sum += v
            self._inf += 1
            # Linear scan: bucket lists here are ~15 long and observe()
            # sits on host paths measured in ms, not ns.
            # _counts are per-bucket (non-cumulative) internally;
            # snapshot() cumulates, so one observation lands in exactly
            # one slot here.
            for i, b in enumerate(self.bounds):
                if v <= b:
                    self._counts[i] += 1
                    break

    def snapshot(self) -> Tuple[Tuple[Tuple[float, int], ...], float, int]:
        """(cumulative (bound, count) pairs, sum, total count)."""
        with self._lock:
            counts = list(self._counts)
            total, s = self._inf, self._sum
        cum = 0
        out = []
        for b, c in zip(self.bounds, counts):
            cum += c
            out.append((b, cum))
        return tuple(out), s, total

    @property
    def count(self) -> int:
        with self._lock:
            return self._inf

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class _Metric:
    """A named metric family: the child itself when unlabeled, or a
    lazily-populated ``labels()`` map of children."""

    def __init__(self, name: str, help_: str, kind: str,
                 label_names: Tuple[str, ...], **kw):
        self.name = name
        self.help = help_
        self.kind = kind
        self.label_names = label_names
        self._kw = kw
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], _Child] = {}
        if not label_names:
            self._children[()] = _KINDS[kind](**kw)

    def labels(self, **labels) -> _Child:
        if tuple(sorted(labels)) != tuple(sorted(self.label_names)):
            raise ValueError(
                f"metric {self.name} takes labels {self.label_names}, "
                f"got {tuple(labels)}")
        key = tuple(str(labels[k]) for k in self.label_names)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(key,
                                                  _KINDS[self.kind](
                                                      **self._kw))
        return child

    def remove(self, **labels) -> None:
        """Drop one child series (idempotent). For label sets that churn
        over a process lifetime — e.g. a serving fleet's retired replica
        names — unbounded children are a slow leak in memory AND in the
        exposition; scrapers treat the disappearance as a normal series
        termination."""
        if tuple(sorted(labels)) != tuple(sorted(self.label_names)):
            raise ValueError(
                f"metric {self.name} takes labels {self.label_names}, "
                f"got {tuple(labels)}")
        key = tuple(str(labels[k]) for k in self.label_names)
        with self._lock:
            self._children.pop(key, None)

    # Unlabeled convenience: the family IS its single child.
    def _only(self) -> _Child:
        if self.label_names:
            raise ValueError(
                f"metric {self.name} is labeled {self.label_names}; "
                f"use .labels(...)")
        return self._children[()]

    def inc(self, n: float = 1.0) -> None:
        self._only().inc(n)          # type: ignore[attr-defined]

    def set(self, v: float) -> None:
        self._only().set(v)          # type: ignore[attr-defined]

    def dec(self, n: float = 1.0) -> None:
        self._only().dec(n)          # type: ignore[attr-defined]

    def observe(self, v: float) -> None:
        self._only().observe(v)      # type: ignore[attr-defined]

    @property
    def value(self) -> float:
        return self._only().value    # type: ignore[attr-defined]

    @property
    def count(self) -> int:
        return self._only().count    # type: ignore[attr-defined]

    @property
    def sum(self) -> float:
        return self._only().sum      # type: ignore[attr-defined]

    def snapshot(self):
        return self._only().snapshot()  # type: ignore[attr-defined]

    def collect(self, const_labels: Optional[Dict[str, str]] = None
                ) -> List[Sample]:
        const = dict(const_labels or {})
        with self._lock:
            children = list(self._children.items())
        out: List[Sample] = []
        for key, child in children:
            labels = dict(const)
            labels.update(zip(self.label_names, key))
            if self.kind == "histogram":
                cum, s, total = child.snapshot()  # type: ignore
                for bound, c in cum:
                    bl = dict(labels)
                    bl["le"] = _fmt_value(bound)
                    out.append((self.name + "_bucket", bl, c))
                il = dict(labels)
                il["le"] = "+Inf"
                out.append((self.name + "_bucket", il, total))
                out.append((self.name + "_sum", labels, s))
                out.append((self.name + "_count", dict(labels), total))
            else:
                out.append((self.name, labels,
                            child.value))  # type: ignore[attr-defined]
        return out


class MetricsRegistry:
    """A set of named metrics with one exposition renderer.

    Creation is idempotent (``counter(name)`` returns the existing
    family) so call sites register at first use without an init-order
    protocol; re-registering under a DIFFERENT kind raises — two
    subsystems fighting over one name is a bug, not a merge.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get(self, name: str, help_: str, kind: str,
             labels: Sequence[str] = (), **kw) -> _Metric:
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labels:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r} on {name}")
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if m.kind != kind:
                    raise ValueError(
                        f"metric {name} already registered as {m.kind}, "
                        f"cannot re-register as {kind}")
                if kind == "histogram" and m._kw != kw:
                    # Same discipline as the kind conflict: silently
                    # keeping the first registration's bounds would hand
                    # the caller buckets they never asked for.
                    raise ValueError(
                        f"histogram {name} already registered with "
                        f"buckets {m._kw.get('buckets')}, cannot "
                        f"re-register with {kw.get('buckets')}")
                return m
            m = _Metric(name, help_, kind, tuple(labels), **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help_: str = "",
                labels: Sequence[str] = ()) -> _Metric:
        return self._get(name, help_, "counter", labels)

    def gauge(self, name: str, help_: str = "",
              labels: Sequence[str] = ()) -> _Metric:
        return self._get(name, help_, "gauge", labels)

    def histogram(self, name: str, help_: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> _Metric:
        # Normalized bounds so list-vs-tuple spellings of the same
        # buckets compare equal in the re-registration check.
        return self._get(name, help_, "histogram", labels,
                         buckets=tuple(sorted(float(b) for b in buckets)))

    def collect(self, const_labels: Optional[Dict[str, str]] = None
                ) -> Tuple[Meta, List[Sample]]:
        with self._lock:
            metrics = list(self._metrics.values())
        meta: Meta = {}
        samples: List[Sample] = []
        for m in metrics:
            meta[m.name] = (m.kind, m.help)
            samples.extend(m.collect(const_labels))
        return meta, samples

    def render(self, const_labels: Optional[Dict[str, str]] = None) -> str:
        meta, samples = self.collect(const_labels)
        return render(meta, samples)


# ---------------------------------------------------------------------------
# The process-default registry: the training plane's shared surface
# (the trainer and the runtime register here; the per-rank HTTP listener
# renders it).
# ---------------------------------------------------------------------------

_default = MetricsRegistry()


def registry() -> MetricsRegistry:
    return _default
