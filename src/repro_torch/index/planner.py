"""``repro_torch.index.planner`` — one place that picks a serving route.

The port's own copy of ``repro.index.planner``: host-only Python, with the
same plans, cost model, counters and reasons.  The routes:

  dense     the single-host fan (``index.query.fan_topk`` /
            ``threshold_scan``) — the only route when the index is not
            sharded, and the only one the port executes so far;
  dispatch  the per-segment fan of a sharded index;
  stacked   one fused fan over equal-shape per-shard blocks.

The ``dispatch`` and ``stacked`` routes are kept as data until the sharded
index is ported.  A :class:`QueryPlan` is the chosen route plus a fallback
chain.  Eligibility is read from the estimator's declared
:class:`repro_torch.core.registry.RouteCapabilities`, never from its name.
Three contracts are encoded here and nowhere else:

  * **Bit-exactness is the default.**  A plan without an
    :class:`ApproxContract` only uses routes that are bit-identical to the
    single-host answer.
  * **``approx_ok`` is an opt-in, asserted bound.**  It lets an estimator
    whose strips are not bitwise stable under re-tiling
    (``fused_bitwise_stable=False``, the margin-MLE) ride a stacked
    program, behind a conformance gate per operand snapshot.
  * **Measured cost breaks ties.**  An EWMA of observed per-route latency
    (fed by :meth:`QueryPlanner.observe`, seeded from the ``repro_torch.obs``
    histograms) orders the chain, with hysteresis.

Every plan increments a ``planner.planned_<route>`` counter, every served
query a ``planner.actual_<route>`` counter, and a served route other than
the planned one counts into ``planner.fallbacks``.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from typing import Dict, Hashable, Optional, Tuple

from ..core import registry
from ..obs.metrics import REGISTRY

__all__ = ["ApproxContract", "QueryPlan", "QueryPlanner"]

REDUCES = ("topk", "threshold")
ROUTES = ("stacked", "dispatch", "dense")

# per-route stage-1 latency histograms (filled by the executors' spans while
# tracing is enabled) — the cold-start seed for the cost model
_ROUTE_METRIC = {
    "stacked": "index.stage1_parallel_ms",
    "dispatch": "index.stage1_dispatch_ms",
    "dense": "index.stage1_dense_ms",
}

_PLANNED = {r: REGISTRY.counter(f"planner.planned_{r}",
                                f"query plans that chose the {r} route")
            for r in ROUTES}
_ACTUAL = {r: REGISTRY.counter(f"planner.actual_{r}",
                               f"queries actually served by the {r} route")
           for r in ROUTES}
_FALLBACKS = REGISTRY.counter(
    "planner.fallbacks",
    "queries served by a route other than the planned one")
_GATE_PASS = REGISTRY.counter(
    "planner.approx_gate_pass",
    "approx_ok conformance gates that admitted a stacked mle snapshot")
_GATE_FAIL = REGISTRY.counter(
    "planner.approx_gate_fail",
    "approx_ok conformance gates that rejected a stacked mle snapshot")


@dataclasses.dataclass(frozen=True)
class ApproxContract:
    """Opt-in tolerance contract for approximate routing.

    ``|got - ref| <= atol + rtol * |ref|`` elementwise against the exact
    (dispatch) answer — checked once per operand snapshot by the planner's
    conformance gate, not assumed.  The defaults leave ~5x headroom over
    the ~2e-5 relative drift measured for the stacked margin-MLE fold, with
    ``atol`` absorbing clipped near-zero distances (0.0 vs tiny-positive
    flips under re-tiling).

    Example (opt an mle top-k onto the stacked fan)::

        >>> from repro_torch.index.planner import ApproxContract
        >>> contract = ApproxContract(rtol=1e-4, atol=1e-5)
        >>> # index.query(X, estimator=registry.MARGIN_MLE, approx_ok=contract)
        >>> contract.rtol
        0.0001
    """

    rtol: float = 1e-4
    atol: float = 1e-5

    def __post_init__(self):
        for name in ("rtol", "atol"):
            v = getattr(self, name)
            if not (isinstance(v, (int, float)) and math.isfinite(v)
                    and v >= 0):
                raise ValueError(
                    f"ApproxContract.{name} must be a finite float >= 0, "
                    f"got {v!r}")


@dataclasses.dataclass(frozen=True)
class QueryPlan:
    """An explicit routing decision: what to run, what to fall back to,
    what it is expected to cost, and why.

    ``deadline_ms`` carries the caller's remaining latency budget when the
    request arrived through the SLO front door (``repro.serve``); routes are
    allowed to consult it (see the deadline flip in :meth:`QueryPlanner.plan`)
    but never to drop work — load shedding happens in the front door with a
    typed rejection, not here.  ``replica`` records which serving replica the
    front door routed this query to (None outside a replicated deployment).

    Example::

        >>> from repro_torch.index.planner import QueryPlanner
        >>> from repro_torch.core import registry
        >>> plan = QueryPlanner().plan(reduce="topk",
        ...                            estimator=registry.DEFAULT_ESTIMATOR,
        ...                            sharded=False)
        >>> plan.route
        'dense'
        >>> plan.chain
        ('dense',)
    """

    reduce: str
    estimator: str
    route: str
    fallbacks: Tuple[str, ...] = ()
    expected_cost_ms: Optional[float] = None
    reason: str = ""
    approx: Optional[ApproxContract] = None
    deadline_ms: Optional[float] = None
    replica: Optional[int] = None

    @property
    def chain(self) -> Tuple[str, ...]:
        """Routes in execution order: the pick, then its fallbacks."""
        return (self.route,) + self.fallbacks

    def describe(self) -> str:
        cost = (f"{self.expected_cost_ms:.2f}ms"
                if self.expected_cost_ms is not None else "unknown")
        fb = ",".join(self.fallbacks) or "-"
        out = (f"route={self.route} fallbacks={fb} expected_cost={cost} "
               f"reason={self.reason}")
        if self.deadline_ms is not None:
            out += f" deadline={self.deadline_ms:g}ms"
        if self.replica is not None:
            out += f" replica={self.replica}"
        return out


class QueryPlanner:
    """Route selection + the cost/conformance state behind it.

    One instance per index (created by ``SketchIndex.__init__``), so cost
    samples never leak between corpora.  All methods are thread-safe — the
    batcher's flusher threads plan and observe concurrently.

    Example (plan → execute → feed the cost model)::

        >>> from repro_torch.core import registry
        >>> from repro_torch.index.planner import QueryPlanner
        >>> p = QueryPlanner()
        >>> plan = p.plan(reduce="topk", estimator=registry.DEFAULT_ESTIMATOR,
        ...               sharded=True, mesh_available=True)
        >>> plan.chain                     # executors walk this in order
        ('stacked', 'dispatch')
        >>> p.observe(plan, "stacked", 4.2)   # served by stacked in 4.2ms
        >>> p.stats()["actual"]
        {'stacked': 1}
    """

    # a measured route displaces the static preference only when it is
    # decisively cheaper on enough samples: eligible routes return the same
    # answer (identical under the default contract, within the asserted
    # tolerance under approx_ok), so routing stability is worth more than a
    # few percent of stage-1 latency
    hysteresis = 1.5
    min_samples = 3

    def __init__(self, *, alpha: float = 0.25):
        if not 0 < alpha <= 1:
            raise ValueError("alpha must be in (0, 1]")
        self.alpha = alpha
        self._lock = threading.Lock()
        self._cost: Dict[Tuple[str, str, str], float] = {}
        self._count: Dict[Tuple[str, str, str], int] = {}
        self._planned: Dict[str, int] = {}
        self._actual: Dict[str, int] = {}
        self._fallbacks = 0
        self._gates: Dict[Hashable, Tuple[bool, float]] = {}
        self.last_plan: Optional[QueryPlan] = None

    # ------------------------------------------------------------- planning

    def plan(self, *, reduce: str, estimator: str, sharded: bool,
             mesh_available: bool = False,
             sealed_segments: Optional[int] = None,
             approx_ok: Optional[ApproxContract] = None,
             deadline_ms: Optional[float] = None,
             replica: Optional[int] = None,
             record: bool = True) -> QueryPlan:
        """Pick a route for one query.

        ``sealed_segments`` is advisory shape information: the stacked fan
        stays the plan whenever the mesh makes it *possible* (capability),
        because the sealed count can change between planning and execution
        — the executor declines an empty stack and the fallback chain
        serves.  ``record=False`` is the read-only form (``stats()``
        predicting the route an unobserved estimator would take) — it must
        not count as a planned query.

        ``deadline_ms`` is the caller's remaining budget (from the serving
        front door).  It can flip the static stacked preference to dispatch
        when the cost model has measured both routes and only dispatch fits
        the budget — a deterministic, explainable flip (the reason names the
        deadline), never a silent drop.  ``replica`` is stamped onto the
        plan for observability; it does not change the route.
        """
        if reduce not in REDUCES:
            raise ValueError(f"unknown reduce {reduce!r} (want {REDUCES})")
        spec = registry.get(estimator)
        if approx_ok is not None and not isinstance(approx_ok, ApproxContract):
            raise TypeError(
                "approx_ok must be an ApproxContract (or None for the "
                f"bit-exact default), got {type(approx_ok).__name__}")

        if deadline_ms is not None and not (
                isinstance(deadline_ms, (int, float))
                and math.isfinite(deadline_ms) and deadline_ms > 0):
            raise ValueError(
                f"deadline_ms must be a finite float > 0, got {deadline_ms!r}"
                " (expired budgets are rejected by the front door, never "
                "planned)")

        caps = spec.capabilities
        has_program = (caps.stacked_topk is not None if reduce == "topk"
                       else caps.stacked_threshold)
        if not sharded:
            plan = self._mk(reduce, estimator, "dense", (), approx_ok,
                            "single-host index: the dense fan is the route",
                            deadline_ms, replica)
        elif not mesh_available:
            plan = self._mk(reduce, estimator, "dispatch", (), approx_ok,
                            "no usable serving mesh: the stacked fan needs "
                            "one distinct device per shard",
                            deadline_ms, replica)
        elif not caps.fused_bitwise_stable and approx_ok is None:
            plan = self._mk(reduce, estimator, "dispatch", (), approx_ok,
                            f"estimator {spec.name!r} is pinned to the exact "
                            "dispatch strips — its strips are not bitwise "
                            "stable under the stacked re-tiling "
                            "(fused_bitwise_stable=False; pass approx_ok to "
                            "opt into a stacked program where one exists)",
                            deadline_ms, replica)
        elif not has_program:
            plan = self._mk(reduce, estimator, "dispatch", (), approx_ok,
                            f"no stacked {reduce} program is registered for "
                            f"estimator {spec.name!r}; dispatch serves it "
                            "regardless of approx_ok",
                            deadline_ms, replica)
        else:
            # a stacked program exists and is admissible (bitwise-stable
            # estimators always; others' top-k under approx_ok,
            # tolerance-gated downstream).  Dispatch stays in the chain: the
            # stacked executor declines when nothing is sealed on a shard
            # yet, or when this operand snapshot failed its approx gate.
            route, fallbacks = "stacked", ("dispatch",)
            reason = ("one shard_map fold over every shard beats "
                      "per-segment dispatch" if caps.fused_bitwise_stable else
                      f"approx_ok(rtol={approx_ok.rtol:g}, "
                      f"atol={approx_ok.atol:g}): {spec.name} rides the "
                      "stacked fan, conformance-gated per snapshot")
            if sealed_segments == 0:
                reason += " (nothing sealed yet: expect the dispatch "\
                          "fallback to serve)"
            flipped = self._cost_prefers_dispatch(reduce, estimator)
            if flipped:
                cs, cd = flipped
                route, fallbacks = "dispatch", ("stacked",)
                reason = (f"cost model: dispatch EWMA {cd:.2f}ms beats "
                          f"stacked {cs:.2f}ms by >= {self.hysteresis:g}x")
            elif deadline_ms is not None:
                # the deadline flip skips the hysteresis band on purpose:
                # an explicit budget outranks routing stability, but both
                # routes must be measured — a guess is not a reason to leave
                # the statically-preferred (and usually faster) stacked fan
                fits = self._deadline_prefers_dispatch(reduce, estimator,
                                                       deadline_ms)
                if fits:
                    cs, cd = fits
                    route, fallbacks = "dispatch", ("stacked",)
                    reason = (f"deadline {deadline_ms:g}ms: stacked EWMA "
                              f"{cs:.2f}ms exceeds the budget, dispatch "
                              f"{cd:.2f}ms fits")
            plan = self._mk(reduce, estimator, route, fallbacks, approx_ok,
                            reason, deadline_ms, replica)
        if record:
            with self._lock:
                self._planned[plan.route] = (
                    self._planned.get(plan.route, 0) + 1)
                self.last_plan = plan
            _PLANNED[plan.route].inc()
        return plan

    def _mk(self, reduce, estimator, route, fallbacks, approx, reason,
            deadline_ms=None, replica=None):
        return QueryPlan(reduce=reduce, estimator=estimator, route=route,
                         fallbacks=tuple(fallbacks),
                         expected_cost_ms=self.expected_cost_ms(
                             reduce, estimator, route),
                         reason=reason, approx=approx,
                         deadline_ms=deadline_ms, replica=replica)

    def _cost_prefers_dispatch(self, reduce, estimator):
        """(stacked_ms, dispatch_ms) when measured cost decisively favors
        dispatch; None otherwise (insufficient samples, or within the
        hysteresis band — the static preference stands)."""
        with self._lock:
            ks = (reduce, estimator, "stacked")
            kd = (reduce, estimator, "dispatch")
            if (self._count.get(ks, 0) < self.min_samples
                    or self._count.get(kd, 0) < self.min_samples):
                return None
            cs, cd = self._cost[ks], self._cost[kd]
        if cs > self.hysteresis * cd:
            return cs, cd
        return None

    def _deadline_prefers_dispatch(self, reduce, estimator, deadline_ms):
        """(stacked_ms, dispatch_ms) when only dispatch's measured cost fits
        the caller's budget; None otherwise (insufficient samples on either
        route, both fit, or neither fits — in which case the static
        preference stands and the front door accounts the overrun)."""
        with self._lock:
            ks = (reduce, estimator, "stacked")
            kd = (reduce, estimator, "dispatch")
            if (self._count.get(ks, 0) < self.min_samples
                    or self._count.get(kd, 0) < self.min_samples):
                return None
            cs, cd = self._cost[ks], self._cost[kd]
        if cs > deadline_ms >= cd:
            return cs, cd
        return None

    # ----------------------------------------------------------- cost model

    def expected_cost_ms(self, reduce: str, estimator: str,
                         route: str) -> Optional[float]:
        """EWMA of observed stage-1 latency for (reduce, estimator, route);
        seeded from the per-route obs histogram p50 when this planner has
        no samples yet (histograms fill only while tracing is enabled, so
        they are a seed, never the primary feed)."""
        with self._lock:
            v = self._cost.get((reduce, estimator, route))
        if v is not None:
            return v
        hist = REGISTRY.get(_ROUTE_METRIC.get(route, ""))
        if hist is not None and getattr(hist, "count", 0) >= self.min_samples:
            return float(hist.percentile(50))
        return None

    def observe(self, plan: QueryPlan, route: str, elapsed_ms: float) -> None:
        """Record which route actually served a planned query, and at what
        cost.  Keyed per (reduce, estimator, route): an mle dispatch sample
        must never poison plain's dispatch estimate."""
        key = (plan.reduce, plan.estimator, route)
        with self._lock:
            prev = self._cost.get(key)
            self._cost[key] = (float(elapsed_ms) if prev is None else
                               (1.0 - self.alpha) * prev
                               + self.alpha * float(elapsed_ms))
            self._count[key] = self._count.get(key, 0) + 1
            self._actual[route] = self._actual.get(route, 0) + 1
            fell_back = route != plan.route
            if fell_back:
                self._fallbacks += 1
        _ACTUAL[route].inc()
        if fell_back:
            _FALLBACKS.inc()

    # ----------------------------------------------------- conformance gate

    def gate_status(self, key: Hashable) -> Optional[bool]:
        """True/False once the snapshot under ``key`` has been gated; None
        while unchecked (the executor must calibrate)."""
        with self._lock:
            entry = self._gates.get(key)
        return None if entry is None else entry[0]

    def record_gate(self, key: Hashable, ok: bool, max_rel_drift: float
                    ) -> bool:
        """Memoize one conformance-gate verdict per operand snapshot — the
        dual (stacked + exact) computation runs once, not per query."""
        with self._lock:
            self._gates[key] = (bool(ok), float(max_rel_drift))
        (_GATE_PASS if ok else _GATE_FAIL).inc()
        return bool(ok)

    # -------------------------------------------------------------- readout

    def stats(self) -> dict:
        with self._lock:
            return {
                "planned": dict(self._planned),
                "actual": dict(self._actual),
                "fallbacks": self._fallbacks,
                "cost_ewma_ms": {"/".join(k): round(v, 4)
                                 for k, v in sorted(self._cost.items())},
                "approx_gates": [
                    {"ok": ok, "max_rel_drift": drift}
                    for ok, drift in self._gates.values()
                ],
            }
