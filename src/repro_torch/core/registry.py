"""The estimator registry: every (p, projection, estimator) scenario as data.

The port's own copy of ``repro.core.registry`` (the JAX package is never
imported here).  An :class:`EstimatorSpec` declares the p-domain and the
projection families an estimator serves and how its strips are computed;
:func:`resolve` validates a request against it once, at the API boundary.

The built-in specs are the even-p estimators, ``plain`` (packed-factor
strips) and ``mle`` (margin-MLE Newton strips).  The fractional-p ``gm``
spec is not ported yet: it needs the α-stable projections.

Each spec declares its :class:`RouteCapabilities`, the serving routes its
strips may ride; the index's query planner reads them instead of
estimator names.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, Optional, Tuple

__all__ = [
    "PDomain",
    "RouteCapabilities",
    "EstimatorSpec",
    "get",
    "resolve",
    "names",
    "EVEN_P",
    "SKETCH_EVEN_P",
    "PLAIN",
    "MARGIN_MLE",
    "DEFAULT_ESTIMATOR",
    "STACKED_PACKED",
    "STACKED_SKETCH",
]

# canonical estimator names — the only quoted estimator literals in the port
PLAIN = "plain"
MARGIN_MLE = "mle"
DEFAULT_ESTIMATOR = PLAIN

# the stacked top-k programs a spec may name (``RouteCapabilities``)
STACKED_PACKED = "packed"      # packed-factor matmul strips (plain)
STACKED_SKETCH = "sketch_mle"  # raw-sketch Newton strips (margin-MLE)


@dataclasses.dataclass(frozen=True)
class PDomain:
    """Valid p values for one consumer: even integers p >= ``even_min``, or
    the half-open interval ``lo < p <= hi``."""

    even_min: Optional[int] = None
    lo: Optional[float] = None
    hi: Optional[float] = None

    def __post_init__(self):
        if (self.even_min is None) == (self.lo is None or self.hi is None):
            raise ValueError(
                "PDomain needs either even_min or a (lo, hi] interval")

    @property
    def describe(self) -> str:
        if self.even_min is not None:
            return f"even p >= {self.even_min}"
        return f"{self.lo} < p <= {self.hi}"

    def contains(self, p) -> bool:
        if self.even_min is not None:
            return (float(p).is_integer() and int(p) >= self.even_min
                    and int(p) % 2 == 0)
        return self.lo < float(p) <= self.hi

    def check(self, p, *, what: str) -> None:
        """Raise the single, well-worded p-domain error."""
        if not self.contains(p):
            raise ValueError(f"{what} requires {self.describe}, got p={p}")


EVEN_P = PDomain(even_min=2)          # the exact decomposition identities
SKETCH_EVEN_P = PDomain(even_min=4)   # the paper's sketch (p-1 >= 3 orders)


@dataclasses.dataclass(frozen=True)
class RouteCapabilities:
    """What serving routes an estimator's strips can ride.

    Attributes:
      stacked_topk: which stacked top-k program serves this estimator
        (:data:`STACKED_PACKED` / :data:`STACKED_SKETCH`), or ``None`` when
        none exists.
      stacked_threshold: a stacked threshold program exists.
      fused_bitwise_stable: the strips are bitwise invariant under the
        stacked fan's re-tiling.  When False the planner keeps the
        estimator on the exact per-segment fan unless the caller opts into
        an ``ApproxContract``.
    """

    stacked_topk: Optional[str] = None
    stacked_threshold: bool = False
    fused_bitwise_stable: bool = False


@dataclasses.dataclass(frozen=True)
class EstimatorSpec:
    """One estimator scenario, declared as data.

    Attributes:
      name: the public estimator name (the ``estimator=`` string).
      description: one line for docs.
      p_domain: valid p values.
      projections: projection families the estimator's sketches use.
      uses_packed: strips are one packed product (``pairwise_lp``); False
        means strips call ``pairwise`` on the raw sketches.
      pairwise: ``(sa, sb, cfg, *, clip=True) -> (n, m)`` strip estimates.
      capabilities: :class:`RouteCapabilities` the planner reads.
    """

    name: str
    description: str
    p_domain: PDomain
    projections: Tuple[str, ...]
    uses_packed: bool
    pairwise: Callable
    capabilities: RouteCapabilities = RouteCapabilities()


_LOCK = threading.Lock()
_SPECS: Dict[str, EstimatorSpec] = {}
_BUILTINS_REGISTERED = False

_SUBGAUSSIAN = ("normal", "uniform", "threepoint")


def get(name: str) -> EstimatorSpec:
    _ensure_builtins()
    with _LOCK:
        spec = _SPECS.get(name)
    if spec is None:
        known = ", ".join(repr(n) for n in names())
        raise ValueError(f"unknown estimator {name!r} (registered: {known})")
    return spec


def resolve(name: str, p=None, projection: Optional[str] = None) -> EstimatorSpec:
    """name -> spec, with (p, projection) checked against its domain."""
    spec = get(name)
    if p is not None:
        spec.p_domain.check(p, what=f"estimator {spec.name!r}")
    if projection is not None and projection not in spec.projections:
        fams = ", ".join(repr(f) for f in spec.projections)
        raise ValueError(
            f"estimator {spec.name!r} requires a projection family in "
            f"({fams}), got {projection!r}")
    return spec


def names() -> Tuple[str, ...]:
    """Registered estimator names, built-ins first."""
    _ensure_builtins()
    with _LOCK:
        return tuple(_SPECS)


def _ensure_builtins() -> None:
    """Register the built-in specs on first lookup, so this module stays a
    leaf that any layer may import."""
    global _BUILTINS_REGISTERED
    if _BUILTINS_REGISTERED:
        return
    with _LOCK:
        if _BUILTINS_REGISTERED:
            return
        from .pairwise import pairwise_distances, pairwise_margin_mle

        _SPECS[PLAIN] = EstimatorSpec(
            name=PLAIN,
            description="unbiased packed-matmul estimator (paper §2.1)",
            p_domain=SKETCH_EVEN_P,
            projections=_SUBGAUSSIAN,
            uses_packed=True,
            pairwise=pairwise_distances,
            capabilities=RouteCapabilities(
                stacked_topk=STACKED_PACKED,
                stacked_threshold=True,
                fused_bitwise_stable=True,
            ),
        )
        _SPECS[MARGIN_MLE] = EstimatorSpec(
            name=MARGIN_MLE,
            description="margin-regularized MLE, Newton per strip (Lemma 4)",
            p_domain=SKETCH_EVEN_P,
            projections=_SUBGAUSSIAN,
            uses_packed=False,
            pairwise=pairwise_margin_mle,
            capabilities=RouteCapabilities(
                stacked_topk=STACKED_SKETCH,
                stacked_threshold=False,
                # Newton strips are not bitwise stable under re-tiling
                fused_bitwise_stable=False,
            ),
        )
        _BUILTINS_REGISTERED = True
