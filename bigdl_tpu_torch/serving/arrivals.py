"""Seeded open-loop arrival processes in VIRTUAL time
(≙ ``bigdl_tpu/serving/arrivals.py``, plain Python: the port imports
nothing of the reference).

The offered sequence — arrival times and how many there are — is exactly
(seed, shape, rate, duration)-determined, because the phase/diurnal
multiplier and termination read *virtual* time only and each yielded
arrival consumes exactly ONE ``rng.exponential`` draw (``rng`` a
``numpy.random.RandomState`` or ``Generator``).  Wall clock only paces the
replay, so two runs with the same seed offer bit-identical traces
regardless of host speed, and the same seed gives the reference's
timestamps bit for bit.

Shapes:

  * ``TRACES`` — the step-function phase shapes (``steady`` / ``burst`` /
    ``overload``) as ``(start_fraction, rate_multiplier)`` tuples, applied
    via :func:`mult_at`;
  * :func:`diurnal_mult` — one smooth day-cycle over the run: a raised
    cosine from ``trough`` at the run's edges to ``peak`` mid-run.

:func:`trace_record` captures the generating tuple plus the realised
arrival timestamps into a JSON-ready dict; :func:`replay_arrivals`
iterates the recorded timestamps verbatim, so a run can be reproduced
without the generating code.
"""
from __future__ import annotations

import math
from typing import (Any, Callable, Dict, Iterable, Iterator, List,
                    Optional, Sequence, Tuple)

#: --trace shapes as (start_fraction_of_run, rate_multiplier) phases
TRACES = {
    "steady": ((0.0, 1.0),),
    "burst": ((0.0, 1.0), (0.4, 6.0), (0.6, 1.0)),
    "overload": ((0.0, 1.0), (0.3, 4.0)),
}

Phases = Sequence[Tuple[float, float]]


def mult_at(phases: Phases, frac: float) -> float:
    """The step-function rate multiplier at ``frac`` of the run."""
    m = phases[0][1]
    for start, mult in phases:
        if frac >= start:
            m = mult
    return m


def diurnal_mult(frac: float, peak: float = 3.0,
                 trough: float = 0.25) -> float:
    """Raised-cosine day cycle mapped onto the run: ``trough`` at
    ``frac`` 0 and 1, ``peak`` at 0.5 — pure arithmetic on the virtual
    fraction, so it is deterministic by construction."""
    return trough + (peak - trough) * 0.5 * (1.0 - math.cos(
        2.0 * math.pi * frac))


def virtual_arrivals(rng, rate: float, phases: Phases, duration: float,
                     rate_fn: Optional[Callable[[float], float]] = None
                     ) -> Iterator[float]:
    """Seeded Poisson arrival times in VIRTUAL time — the phase
    multiplier and termination read virtual time only, so the offered
    sequence (arrival times + however many there are) is exactly
    (seed, trace, rate, duration)-determined; wall clock only paces
    the replay.  Exactly ONE rng.exponential per yielded arrival, so
    callers interleave their own size/payload draws off the same rng
    without perturbing the arrival sequence.  ``rate_fn`` (e.g.
    :func:`diurnal_mult`) multiplies on top of the phase shape,
    making the instantaneous rate ``rate * mult_at(...) *
    rate_fn(frac)``."""
    t_virtual = 0.0
    while True:
        frac = t_virtual / duration
        r = rate * mult_at(phases, frac)
        if rate_fn is not None:
            r *= rate_fn(frac)
        t_virtual += rng.exponential(1.0 / r)
        if t_virtual >= duration:
            return
        yield t_virtual


def rate_at(frac: float, rate: float, phases: Phases,
            rate_fn: Optional[Callable[[float], float]] = None
            ) -> float:
    """The instantaneous offered rate at ``frac`` of the run — the
    same ``rate * mult_at(...) * rate_fn(frac)`` product
    :func:`virtual_arrivals` samples from, exposed so trace artifacts
    can annotate load without re-deriving the composition rule."""
    r = rate * mult_at(phases, frac)
    if rate_fn is not None:
        r *= rate_fn(frac)
    return r


def trace_record(seed: int, rate: float, phases: Phases,
                 duration: float, arrivals: Iterable[float], *,
                 shape: str = "steady", rate_ticks: int = 32,
                 rate_fn: Optional[Callable[[float], float]] = None
                 ) -> Dict[str, Any]:
    """The JSON-ready replay artifact for one offered trace: the
    generating tuple (seed / rate / phases / duration / shape), a
    ``rate_ticks``-point sample of the instantaneous rate curve (for
    plotting — NOT needed for replay), and the realised arrival
    timestamps in virtual seconds.  ``arrivals`` is materialised, so
    pass the same list the run consumed."""
    ts: List[float] = [float(t) for t in arrivals]
    ticks = [{"frac": i / max(rate_ticks - 1, 1),
              "rate": rate_at(i / max(rate_ticks - 1, 1), rate, phases,
                              rate_fn)}
             for i in range(rate_ticks)]
    return {
        "version": 1,
        "seed": int(seed),
        "rate": float(rate),
        "shape": str(shape),
        "phases": [[float(s), float(m)] for s, m in phases],
        "duration": float(duration),
        "n_arrivals": len(ts),
        "rate_curve": ticks,
        "arrivals_s": ts,
    }


def replay_arrivals(record: Dict[str, Any]) -> Iterator[float]:
    """Iterate a :func:`trace_record` artifact's arrival timestamps
    verbatim — the replay half of the determinism contract.  Raises
    ``ValueError`` on an artifact this version cannot replay."""
    if record.get("version") != 1:
        raise ValueError(
            f"unsupported arrival-trace version {record.get('version')!r}")
    for t in record["arrivals_s"]:
        yield float(t)
