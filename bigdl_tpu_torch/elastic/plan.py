"""Mesh re-planning: fit a named-axis topology onto surviving capacity
(≙ ``bigdl_tpu/elastic/plan.py``; pure functions, the same plans).

The supervisor keeps one *template* mesh ({axis: size} at full
capacity) and asks :func:`plan_mesh` what to run on whatever devices
are still alive.  Axis names and order never change — every parameter
sharding spec stays valid — and each axis size must be a **divisor of
its template size**, so the model-divisibility constraints that held
at full capacity (head counts, d_model multiples, global-batch
splits) survive every shrink.

Within those constraints the planner returns the **largest feasible
mesh**: it searches the (small) divisor lattice exhaustively instead
of walking one prime-factor chain — {dp: 6, tp: 4} on 8 surviving
devices yields {dp: 2, tp: 4} (all 8 used), not the {dp: 1, tp: 4} a
divide-by-smallest-prime greedy would strand itself at.  Ties on
device count break by **per-axis shrink cost** (``AXIS_SHRINK_COST``,
overridable per call): shrinking ``dp``/``fsdp`` is pure same-math
re-batching of replicated state (a cheap re-layout at resume), while
``pp``/``tp``/``ep`` shrinks re-partition tensors/stages/experts —
expensive restores and, for tp, dimensions entangled with the model.
A preempted 4-axis job therefore shrinks the **cheapest viable axis**:
dp4×tp2 on 4 surviving devices resumes as dp2×tp2, never dp4×tp1.

Regrow is the same call with more devices: the plan monotonically
approaches the template as capacity returns, and never exceeds it.
"""
from __future__ import annotations

import itertools
import math
from typing import Dict, Optional, Sequence

import numpy as np

# shrink order: batch-ish axes first, model-entangled axes last
# (kept as the deterministic last-resort tie-break under custom costs)
SHRINK_PRIORITY: Sequence[str] = ("dp", "fsdp", "sp", "pp", "tp", "ep")

# relative cost of HALVING an axis (per log2 shrink step).  dp/fsdp
# re-layouts are cheap (replicated/1-D-resharded state, bit-exact or
# documented-ulp resumes — docs/checkpointing.md taxonomy); pp/ep move
# whole stages/experts; tp re-partitions every sharded tensor AND its
# size is entangled with model dims (head counts, d_ff multiples).
AXIS_SHRINK_COST: Dict[str, float] = {
    "dp": 1.0, "fsdp": 2.0, "sp": 4.0, "pp": 8.0, "ep": 8.0, "tp": 16.0}


def shrink_cost(template: Dict[str, int], plan: Dict[str, int],
                axis_costs: Optional[Dict[str, float]] = None) -> float:
    """Total cost of shrinking ``template`` to ``plan``:
    ``sum(cost[axis] * log2(template/plan))`` — log2 because each
    halving is one re-layout of the axis's state, and costs compose
    multiplicatively along the divisor chain."""
    costs = dict(AXIS_SHRINK_COST)
    costs.update(axis_costs or {})
    total = 0.0
    for k, v in template.items():
        s = plan.get(k, 1)
        if s < v:
            total += costs.get(k, max(costs.values())) \
                * math.log2(v / s)
    return total


def _prod(axes: Dict[str, int]) -> int:
    return int(np.prod(list(axes.values()), dtype=np.int64)) if axes else 1


def _divisors(n: int):
    return [d for d in range(1, n + 1) if n % d == 0]


def _axis_candidates(axes: Dict[str, int],
                     floors: Dict[str, int]) -> Dict[str, list]:
    """Per-axis legal sizes: divisors of the template size that meet the
    axis's floor.  ONE definition of what a legal axis size is — the
    planner's search space and fleet admission's floor reservation must
    never disagree.  Raises ``ValueError`` when an axis has none."""
    out = {}
    for k, v in axes.items():
        floor = max(1, floors.get(k, 1))
        cands = [d for d in _divisors(v) if d >= floor]
        if not cands:
            raise ValueError(
                f"axis {k!r}: no divisor of {v} meets its floor {floor}")
        out[k] = cands
    return out


def plan_mesh(n_devices: int, template: Dict[str, int],
              min_axes: Optional[Dict[str, int]] = None,
              axis_costs: Optional[Dict[str, float]] = None
              ) -> Dict[str, int]:
    """Largest mesh ≤ ``template`` (axis-wise, divisor-constrained)
    fitting ``n_devices``; device-count ties break by MINIMUM total
    shrink cost (:func:`shrink_cost`), so the plan shrinks the
    cheapest viable axis — dp before fsdp before sp/pp/ep before tp
    under the default ``AXIS_SHRINK_COST``, or whatever ``axis_costs``
    overrides say (a job whose tp re-layout is cheap on its model can
    invert the preference without forking the planner).

    ``min_axes`` pins lower bounds (e.g. ``{"tp": 2}`` when a layer's
    sharded dimension cannot be replicated); a shrink that would land
    below a pin is illegal, never silently applied.  Raises
    ``ValueError`` when no divisor combination fits — the caller
    decides whether that is fatal or worth waiting out.
    """
    if n_devices < 1:
        raise ValueError(f"no surviving capacity (n_devices={n_devices})")
    axes = {str(k): int(v) for k, v in template.items()}
    for k, v in axes.items():
        if v < 1:
            raise ValueError(f"template axis {k!r} has size {v}")
    floors = {str(k): int(v) for k, v in (min_axes or {}).items()}
    names = list(axes)
    cand_map = _axis_candidates(axes, floors)
    cand_lists = [cand_map[k] for k in names]
    # deterministic last-resort tie-break (equal device count AND equal
    # cost, e.g. under a flat custom cost map): keep LATE-priority axes
    # at full size — compare sizes in reverse priority order
    rank = {a: i for i, a in enumerate(SHRINK_PRIORITY)}
    order = sorted(range(len(names)),
                   key=lambda i: -rank.get(names[i], len(SHRINK_PRIORITY)))
    best = None
    for combo in itertools.product(*cand_lists):
        p = int(np.prod(combo, dtype=np.int64))
        if p > n_devices:
            continue
        plan = dict(zip(names, combo))
        key = (p, -shrink_cost(axes, plan, axis_costs),
               tuple(combo[i] for i in order))
        if best is None or key > best[0]:
            best = (key, combo)
    if best is None:
        raise ValueError(
            f"cannot shrink mesh {dict(template)} onto {n_devices} "
            f"device(s) with floors {floors}")
    return dict(zip(names, best[1]))


def plan_devices(axes: Dict[str, int], devices) -> list:
    """The device (or rank) prefix a plan actually uses (stable ordering
    keeps reshard layouts deterministic across replans)."""
    need = _prod(axes)
    devices = list(devices)
    if need > len(devices):
        raise ValueError(f"plan {axes} needs {need} devices, "
                         f"have {len(devices)}")
    return devices[:need]
