"""Proxy-regression sentinel over goodput and bench trajectories (≙
``bigdl_tpu/observability/regress.py``).

A proxy metric may regress past its committed bound only when the
baseline entry carries a **justification** string: an undocumented
regression fails, a justified one is reported as *waived*, and a stale
bound (the metric is now far better than the baseline demands) is
surfaced so that the bound gets ratcheted.

Two input shapes, one trajectory schema (``{"source", "metrics"}``
rows):

  * normalized bench rounds (:func:`bench_rows`), flattened to dotted
    metric keys;
  * goodput-ledger snapshots (:meth:`~.goodput.GoodputLedger.snapshot`,
    or a :func:`~.goodput.rollup`), folded by :func:`ledger_row` into
    **fractions of owned time** so that the bounds are load-independent.

The baseline is the reference's JSON format (``load_baseline`` reads the
reference's ``artifacts/goodput_baseline.json`` as it is)::

    {
      "metrics": {
        "ledger:train/goodput_fraction": {"min": 0.45},
        "ledger:train/buckets.checkpoint_blocking": {"max": 0.30},
        "bench:r09/decode_throughput.speedup": {
            "min": 1.2, "justification": null}
      },
      "buckets": {"input_stall": {"max_fraction": 0.5}}
    }

``metrics`` bounds name one trajectory point; ``buckets`` bounds apply to
EVERY ledger row.  A metric named under ``watch`` with at least 3 points
is also flagged (as advisory) when its newest point jumps more than
``change_factor`` × the prior spread away from the prior mean.
:func:`gate` is True when no finding has severity ``fail``.  Host
arithmetic only: the same rows and baseline give the reference's
findings.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from .goodput import BUCKETS


def ledger_row(name: str, snapshot: Dict[str, Any]) -> Dict[str, Any]:
    """One trajectory row from a ledger snapshot: buckets as fractions
    of owned time (load-independent), plus the goodput fraction and
    the conservation error itself — a wiring bug that breaks the
    conservation law should trip the sentinel too."""
    owned = float(snapshot.get("owned_s", 0.0)) or 1.0
    metrics = {"goodput_fraction":
               float(snapshot.get("goodput_fraction", 0.0)),
               "conservation_error":
               float(snapshot.get("conservation_error", 0.0)),
               "owned_s": float(snapshot.get("owned_s", 0.0))}
    for b in BUCKETS:
        metrics[f"buckets.{b}"] = \
            float(snapshot.get("buckets", {}).get(b, 0.0)) / owned
    return {"source": f"ledger:{name}", "metrics": metrics}


def bench_rows(normalized: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Trajectory rows from ``bench_trend.normalize_rounds`` output.
    FAILED rounds keep an empty row — the gap is part of the record."""
    return [{"source": f"bench:r{row['round']:02d}",
             "mode": row.get("mode"),
             "metrics": dict(row.get("metrics") or {})}
            for row in normalized]


def _series(rows: List[Dict[str, Any]], key: str) -> List[float]:
    """Chronological values of one dotted metric across every row whose
    source family matches the key's prefix (``bench:*/x`` collects x
    from every bench row; an exact source only from that row)."""
    fam, _, metric = key.partition("/")
    out = []
    for row in rows:
        src = row.get("source", "")
        if src == fam or (fam.endswith("*") and
                          src.startswith(fam[:-1])):
            v = row.get("metrics", {}).get(metric)
            if isinstance(v, (int, float)):
                out.append(float(v))
    return out


class Finding:
    """One sentinel verdict.  ``severity`` is ``fail`` (undocumented
    regression — CI red), ``waived`` (regressed, but the baseline
    entry carries a justification), or ``info`` (stale bound /
    change-point advisory)."""

    def __init__(self, severity: str, key: str, message: str,
                 value: Optional[float] = None,
                 bound: Optional[float] = None):
        self.severity = severity
        self.key = key
        self.message = message
        self.value = value
        self.bound = bound

    def as_dict(self) -> Dict[str, Any]:
        return {"severity": self.severity, "key": self.key,
                "message": self.message, "value": self.value,
                "bound": self.bound}

    def render(self) -> str:
        return f"[{self.severity}] {self.key}: {self.message}"


def check(rows: List[Dict[str, Any]], baseline: Dict[str, Any],
          change_factor: float = 4.0,
          stale_margin: float = 0.5) -> List[Finding]:
    """Apply the committed baseline to a trajectory.  Returns every
    finding; CI fails iff any has severity ``fail`` (see
    :func:`gate`)."""
    findings: List[Finding] = []
    by_source = {row.get("source"): row for row in rows}

    # -- explicit per-metric bounds ------------------------------------ #
    for key, spec in (baseline.get("metrics") or {}).items():
        fam, _, metric = key.partition("/")
        row = by_source.get(fam)
        if row is None:
            findings.append(Finding(
                "info", key, "no trajectory row for this source — "
                "bound not evaluated"))
            continue
        v = row.get("metrics", {}).get(metric)
        if not isinstance(v, (int, float)):
            findings.append(Finding(
                "info", key, f"metric absent from {fam} — bound not "
                "evaluated (schema drift?)"))
            continue
        just = spec.get("justification")
        lo, hi = spec.get("min"), spec.get("max")
        if lo is not None and v < float(lo):
            findings.append(Finding(
                "waived" if just else "fail", key,
                f"regressed below committed floor ({v:g} < {lo:g})"
                + (f"; justified: {just}" if just else
                   " with no committed justification"),
                value=float(v), bound=float(lo)))
        elif hi is not None and v > float(hi):
            findings.append(Finding(
                "waived" if just else "fail", key,
                f"grew past committed ceiling ({v:g} > {hi:g})"
                + (f"; justified: {just}" if just else
                   " with no committed justification"),
                value=float(v), bound=float(hi)))
        else:
            # stale-bound ratchet: the graftlint discipline in the
            # other direction — a bound the reality has left far
            # behind stops meaning anything
            if lo is not None and float(lo) > 0 \
                    and v > float(lo) * (1.0 + stale_margin):
                findings.append(Finding(
                    "info", key,
                    f"bound is stale: {v:g} beats floor {lo:g} by "
                    f">{stale_margin:.0%}; ratchet it",
                    value=float(v), bound=float(lo)))
            if hi is not None and float(hi) > 0 \
                    and v < float(hi) * (1.0 - stale_margin):
                findings.append(Finding(
                    "info", key,
                    f"bound is stale: {v:g} is under ceiling {hi:g} "
                    f"by >{stale_margin:.0%}; ratchet it",
                    value=float(v), bound=float(hi)))

    # -- bucket ceilings over every ledger row ------------------------- #
    for bucket, spec in (baseline.get("buckets") or {}).items():
        cap = spec.get("max_fraction")
        if cap is None:
            continue
        just = spec.get("justification")
        for row in rows:
            src = row.get("source", "")
            if not src.startswith("ledger:"):
                continue
            v = row.get("metrics", {}).get(f"buckets.{bucket}")
            if isinstance(v, (int, float)) and v > float(cap):
                findings.append(Finding(
                    "waived" if just else "fail",
                    f"{src}/buckets.{bucket}",
                    f"badput bucket grew past its recorded baseline "
                    f"({v:.3f} > {cap:g} of owned time)"
                    + (f"; justified: {just}" if just else ""),
                    value=float(v), bound=float(cap)))

    # -- change-point advisory over multi-point series ------------------ #
    for key in (baseline.get("watch") or []):
        pts = _series(rows, key)
        if len(pts) < 3:
            continue
        prior, latest = pts[:-1], pts[-1]
        mean = sum(prior) / len(prior)
        spread = max(prior) - min(prior)
        if spread <= 0:
            spread = abs(mean) * 0.01 or 1e-9
        if abs(latest - mean) > change_factor * spread:
            findings.append(Finding(
                "info", key,
                f"change-point: latest {latest:g} departs the prior "
                f"mean {mean:g} by >{change_factor:g}x the prior "
                f"spread {spread:g}",
                value=latest, bound=mean))
    return findings


def gate(findings: List[Finding]) -> bool:
    """True when the trajectory passes (no undocumented regression)."""
    return not any(f.severity == "fail" for f in findings)


def load_baseline(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)
