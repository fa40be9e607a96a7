"""Mergeable streaming quantile sketch for latency histograms (a copy of
``repro/telemetry/sketch.py``; pure Python, the port imports nothing from
``repro``, and ``to_dict`` is the same dict in both packages).

The serving engine observes one latency sample per emitted token; a run
can emit millions, and per-request / per-engine sketches must combine
into one fleet view, so the estimator has to be *mergeable* with a
deterministic result.  The sketch is a two-phase hybrid:

  * **exact phase** — up to ``max_exact`` samples are kept verbatim, so
    small runs (every test, every smoke bench) report exact quantiles;
  * **bucketed phase** — past that, samples collapse into DDSketch-style
    logarithmic buckets: magnitude index ``ceil(log_gamma |x|)`` with
    ``gamma = (1 + alpha) / (1 - alpha)``, held in separate stores per
    sign (the magnitude index is itself negative for ``|x| < 1``, so
    sign must be carried by the store, not the index).  This bounds the
    *relative* error of any quantile estimate by ``alpha`` (the bucket
    midpoint is within ``alpha`` of every value the bucket holds).

Merging is associative and commutative by construction: bucket
assignment is a pure per-value function (independent of arrival or merge
order) and bucket counts add; two exact-phase sketches whose union still
fits stay exact.  ``tests/test_telemetry.py`` seals all three contracts in the reference
(associativity, rank/relative-error bound, small-n exactness) with
hypothesis properties.

No numpy/torch imports: the sketch is pure python so the scheduler-side
hot path (one ``add`` per token) stays allocation-light and the module
is importable anywhere (report CLIs, tests) without pulling in torch.
"""

from __future__ import annotations

import math
from typing import Iterable, Optional

__all__ = ["QuantileSketch"]

#: Default exact-phase capacity: plenty for tests/smokes, tiny in memory.
DEFAULT_MAX_EXACT = 128
#: Default relative-error bound for the bucketed phase (1%).
DEFAULT_ALPHA = 0.01


class QuantileSketch:
    """Mergeable quantile sketch: exact under small n, ``alpha``-relative
    error beyond.  Tracks count/sum/min/max exactly in both phases."""

    __slots__ = ("alpha", "max_exact", "_gamma", "_log_gamma", "_exact",
                 "_pos", "_neg", "_zero", "count", "sum", "min", "max")

    def __init__(self, alpha: float = DEFAULT_ALPHA,
                 max_exact: int = DEFAULT_MAX_EXACT):
        if not 0.0 < alpha < 1.0:
            raise ValueError(f"alpha must be in (0, 1), got {alpha}")
        if max_exact < 0:
            raise ValueError(f"max_exact must be >= 0, got {max_exact}")
        self.alpha = float(alpha)
        self.max_exact = int(max_exact)
        self._gamma = (1.0 + alpha) / (1.0 - alpha)
        self._log_gamma = math.log(self._gamma)
        self._exact: Optional[list] = []  # None once bucketed
        #: Separate per-sign stores keyed by the *magnitude* index
        #: ``ceil(log_gamma |x|)`` (standard DDSketch layout).  A single
        #: sign-mirrored dict would collide: ``|x| < 1`` has a negative
        #: magnitude index, which a mirror scheme confuses with the
        #: opposite sign.
        self._pos: dict[int, int] = {}
        self._neg: dict[int, int] = {}
        self._zero = 0  # exact zeros (log-bucket index is undefined at 0)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    # -- ingestion -----------------------------------------------------------

    def add(self, x: float) -> None:
        x = float(x)
        if math.isnan(x):
            raise ValueError("QuantileSketch cannot ingest NaN")
        self.count += 1
        self.sum += x
        if x < self.min:
            self.min = x
        if x > self.max:
            self.max = x
        if self._exact is not None:
            self._exact.append(x)
            if self.count > self.max_exact:
                self._collapse()
        else:
            self._bucket_add(x, 1)

    def _index(self, mag: float) -> int:
        """Deterministic bucket index for a *magnitude* ``mag > 0``.
        Negative for ``mag < 1`` — which is why the two signs live in
        separate stores rather than a mirrored index space."""
        return math.ceil(math.log(mag) / self._log_gamma)

    def _bucket_add(self, x: float, n: int) -> None:
        if x == 0.0:
            self._zero += n
        elif x > 0.0:
            i = self._index(x)
            self._pos[i] = self._pos.get(i, 0) + n
        else:
            i = self._index(-x)
            self._neg[i] = self._neg.get(i, 0) + n

    def _collapse(self) -> None:
        """Exact -> bucketed; per-value and order-independent, so any
        merge order that ends past ``max_exact`` lands on the same state."""
        assert self._exact is not None
        for v in self._exact:
            self._bucket_add(v, 1)
        self._exact = None

    # -- merge ---------------------------------------------------------------

    def merge(self, other: "QuantileSketch") -> "QuantileSketch":
        """Pure merged copy (``self`` and ``other`` are untouched).

        Associative/commutative: the result depends only on the multiset
        of ingested values, never on merge order (the seal property).
        """
        if (self.alpha, self.max_exact) != (other.alpha, other.max_exact):
            raise ValueError(
                f"cannot merge sketches with different parameters: "
                f"(alpha={self.alpha}, max_exact={self.max_exact}) vs "
                f"(alpha={other.alpha}, max_exact={other.max_exact})")
        out = QuantileSketch(self.alpha, self.max_exact)
        out.count = self.count + other.count
        out.sum = self.sum + other.sum
        out.min = min(self.min, other.min)
        out.max = max(self.max, other.max)
        if (self._exact is not None and other._exact is not None
                and out.count <= out.max_exact):
            out._exact = self._exact + other._exact
            return out
        out._exact = None
        for src in (self, other):
            if src._exact is not None:
                for v in src._exact:
                    out._bucket_add(v, 1)
            else:
                out._zero += src._zero
                for store, src_store in ((out._pos, src._pos),
                                         (out._neg, src._neg)):
                    for i, n in src_store.items():
                        store[i] = store.get(i, 0) + n
        return out

    def update(self, values: Iterable[float]) -> "QuantileSketch":
        for v in values:
            self.add(v)
        return self

    # -- queries -------------------------------------------------------------

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    @property
    def is_exact(self) -> bool:
        return self._exact is not None

    def _representative(self, i: int) -> float:
        """Positive bucket midpoint for magnitude index ``i``: within
        ``alpha`` relative error of every magnitude the bucket holds
        (2*g^i/(g+1) for the (g^(i-1), g^i] bucket).  Callers apply the
        sign of the store the bucket came from."""
        return 2.0 * self._gamma ** i / (self._gamma + 1.0)

    def quantile(self, q: float) -> float:
        """Value at quantile ``q`` in [0, 1] (nearest-rank definition:
        the smallest ingested value whose rank >= ceil(q * n))."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        if self.count == 0:
            return 0.0
        rank = max(1, math.ceil(q * self.count))  # 1-based target rank
        if self._exact is not None:
            return sorted(self._exact)[rank - 1]
        # ordered sweep: negative buckets (largest magnitude = most
        # negative first), zeros, then positive buckets (smallest first)
        seen = 0
        for i in sorted(self._neg, reverse=True):
            seen += self._neg[i]
            if seen >= rank:
                return self._clamp(-self._representative(i))
        seen += self._zero
        if seen >= rank:
            return 0.0
        for i in sorted(self._pos):
            seen += self._pos[i]
            if seen >= rank:
                return self._clamp(self._representative(i))
        return self.max  # numeric-edge fallback; unreachable in practice

    def _clamp(self, v: float) -> float:
        """Keep representatives inside the observed range, so q=0/q=1
        degrade gracefully to the exact extrema."""
        return min(max(v, self.min), self.max)

    def percentiles(self, ps=(50, 95, 99)) -> dict[str, float]:
        return {f"p{p:g}": self.quantile(p / 100.0) for p in ps}

    # -- (de)serialization ---------------------------------------------------

    def to_dict(self) -> dict:
        """JSON-safe state; ``from_dict`` round-trips it bit-exactly."""
        d = {
            "alpha": self.alpha,
            "max_exact": self.max_exact,
            "count": self.count,
            "sum": self.sum,
            "min": self.min if self.count else None,
            "max": self.max if self.count else None,
        }
        if self._exact is not None:
            d["exact"] = list(self._exact)
        else:
            d["zero"] = self._zero
            d["pos"] = {str(i): n for i, n in sorted(self._pos.items())}
            d["neg"] = {str(i): n for i, n in sorted(self._neg.items())}
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "QuantileSketch":
        out = cls(alpha=d["alpha"], max_exact=d["max_exact"])
        out.count = int(d["count"])
        out.sum = float(d["sum"])
        out.min = math.inf if d["min"] is None else float(d["min"])
        out.max = -math.inf if d["max"] is None else float(d["max"])
        if "exact" in d:
            out._exact = [float(v) for v in d["exact"]]
        else:
            out._exact = None
            out._zero = int(d.get("zero", 0))
            out._pos = {int(i): int(n) for i, n in d.get("pos", {}).items()}
            out._neg = {int(i): int(n) for i, n in d.get("neg", {}).items()}
        return out

    # -- canonical equality (the associativity seal compares these) ---------

    def _canonical(self) -> tuple:
        if self._exact is not None:
            return ("exact", tuple(sorted(self._exact)))
        return ("buckets", self._zero, tuple(sorted(self._pos.items())),
                tuple(sorted(self._neg.items())))

    def __eq__(self, other) -> bool:
        if not isinstance(other, QuantileSketch):
            return NotImplemented
        return ((self.alpha, self.max_exact, self.count)
                == (other.alpha, other.max_exact, other.count)
                and self._canonical() == other._canonical())

    __hash__ = None  # mutable

    def __repr__(self) -> str:
        phase = "exact" if self._exact is not None else "buckets"
        return (f"QuantileSketch(n={self.count}, {phase}, "
                f"alpha={self.alpha})")
