"""Signal collection for the autoscale control loop (≙
``bigdl_tpu/autoscale/signals.py``).

One :func:`read_signals` call folds the telemetry surfaces the policy
consumes into a single :class:`Signals` snapshot:

  * **SLO burn**: the worst ``burn_fast`` / ``burn_slow`` and the
    breached objectives, read from
    :attr:`~bigdl_tpu_torch.observability.slo.SLOEngine.last_results`
    (the engine's cached verdicts), never re-running the window math;
  * **backlog**: summed queue depth across live replicas
    (``*queue_depth*`` / ``*queue_rows*`` gauges in the series store);
  * **utilisation**: mean decode slot occupancy and KV-pool fill.

The port's own: a set of batching ``ServingEngine`` replicas has no
decode slots, so no occupancy series.  When none is fresh and every live
replica of ``replica_set`` is a ``ServingEngine``, the occupancy is the
backlog over one full batch of every live replica,
``min(1, queue_depth / sum(max_batch))``: the fill of the set's next
batches.  Without it the policy, which never scales down while
occupancy is ``None``, could not shrink such a set.  With it, pressure
reads at ``occupancy_high * max_batch`` queued rows a replica when that
is under ``queue_high``.

All reads are gauge ``last()`` values with a freshness window: a sample
older than ``fresh`` seconds (against the STORE's clock) is treated as
absent, so a scraper that died never feeds the policy a flattering stale
zero.  Every field is ``None``-safe: "no data" is a state of its own
that the policy treats as "hold", never as "idle".
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

#: series-key patterns matched against BOTH naming planes — a raw
#: recorder store (``decode/queue_depth``) and an aggregator store
#: (``serve.replica0/bigdl_decode_queue_depth``)
QUEUE_SERIES = ("*decode*queue_depth*", "*replica*queue_rows*")
OCCUPANCY_SERIES = ("*decode*occupancy*",)
KV_SERIES = ("*kv*fill*", "*pool*fill*")


class Signals:
    """One immutable-ish snapshot of everything the policy looks at."""

    __slots__ = ("at", "burn_fast", "burn_slow", "breached", "no_data",
                 "queue_depth", "occupancy", "kv_fill", "replicas",
                 "evidence")

    def __init__(self, *, at: float, burn_fast: Optional[float] = None,
                 burn_slow: Optional[float] = None,
                 breached: Tuple[str, ...] = (), no_data: bool = True,
                 queue_depth: Optional[float] = None,
                 occupancy: Optional[float] = None,
                 kv_fill: Optional[float] = None, replicas: int = 0,
                 evidence: Tuple[Dict[str, Any], ...] = ()):
        self.at = float(at)
        self.burn_fast = burn_fast
        self.burn_slow = burn_slow
        self.breached = tuple(breached)
        self.no_data = bool(no_data)
        self.queue_depth = queue_depth
        self.occupancy = occupancy
        self.kv_fill = kv_fill
        self.replicas = int(replicas)
        # provenance: the EXACT samples/verdicts this snapshot folded —
        # ``{"kind", "series", "t", "value"}`` per item — so a scale
        # decision's trace can link to what actually triggered it
        self.evidence = tuple(evidence)

    def as_dict(self) -> Dict[str, Any]:
        d = {k: getattr(self, k) for k in self.__slots__}
        d["evidence"] = [dict(e) for e in self.evidence]
        return d

    def __repr__(self):
        return (f"Signals(breached={list(self.breached)}, "
                f"burn_fast={self.burn_fast}, "
                f"queue_depth={self.queue_depth}, "
                f"occupancy={self.occupancy}, replicas={self.replicas})")


def _fresh_last(store, patterns: Sequence[str], now: float,
                fresh: float):
    """``[(key, t, value), ...]`` latest point per matching series, only
    when the point is newer than ``now - fresh``.  The timestamp rides
    along as provenance — it identifies the exact sample a scale
    decision later cites as evidence."""
    out = []
    for key in store.match(patterns):
        last = store.get(key).last()
        if last is not None and last[0] >= now - fresh:
            out.append((key, last[0], last[1]))
    return out


def read_signals(slo_engine=None, store=None, replica_set=None, *,
                 now: Optional[float] = None, fresh: float = 30.0,
                 queue_series: Sequence[str] = QUEUE_SERIES,
                 occupancy_series: Sequence[str] = OCCUPANCY_SERIES,
                 kv_series: Sequence[str] = KV_SERIES) -> Signals:
    """Fold the SLO engine's cached verdicts + the series store's
    freshest gauges + the replica set's live membership into one
    :class:`Signals`.  Any surface may be absent (``None``); missing
    surfaces yield ``None`` fields, never fabricated zeros."""
    if store is None and slo_engine is not None:
        store = slo_engine.store
    if now is None:
        now = float(store.now()) if store is not None \
            else float(slo_engine.clock()) if slo_engine is not None \
            else 0.0

    burn_fast = burn_slow = None
    breached = []
    no_data = True
    evidence = []
    if slo_engine is not None and slo_engine.last_results:
        for name, r in slo_engine.last_results.items():
            if r.get("no_data"):
                continue
            no_data = False
            bf, bs = r.get("burn_fast"), r.get("burn_slow")
            if bf is not None and (burn_fast is None or bf > burn_fast):
                burn_fast = bf
            if bs is not None and (burn_slow is None or bs > burn_slow):
                burn_slow = bs
            if r.get("breach"):
                breached.append(name)
            evidence.append({"kind": "slo", "series": name, "t": now,
                             "value": bf, "burn_slow": bs,
                             "breach": bool(r.get("breach"))})

    queue_depth = occupancy = kv_fill = None
    if store is not None:
        qs = _fresh_last(store, queue_series, now, fresh)
        if qs:
            queue_depth = sum(v for _, _, v in qs)
            no_data = False
        occ = _fresh_last(store, occupancy_series, now, fresh)
        if occ:
            occupancy = sum(v for _, _, v in occ) / len(occ)
            no_data = False
        kv = _fresh_last(store, kv_series, now, fresh)
        if kv:
            kv_fill = sum(v for _, _, v in kv) / len(kv)
        for kind, rows in (("queue", qs), ("occupancy", occ),
                           ("kv", kv)):
            for key, t, v in rows:
                evidence.append({"kind": kind, "series": key,
                                 "t": t, "value": v})

    replicas = 0
    if replica_set is not None:
        from ..serving.engine import ServingEngine
        from ..serving.replicas import TERMINAL_REASONS
        live = [replica_set.replicas[i].engine
                for i, h in replica_set.health().items()
                if not (h["state"] == "ejected"
                        and h["reason"] in TERMINAL_REASONS)]
        replicas = len(live)
        if occupancy is None and queue_depth is not None and live \
                and all(isinstance(e, ServingEngine) for e in live):
            full = sum(e.ladder.max_batch for e in live)
            occupancy = min(1.0, queue_depth / full)
            evidence.append({"kind": "occupancy",
                             "series": "queue_rows/max_batch", "t": now,
                             "value": occupancy})

    return Signals(at=now, burn_fast=burn_fast, burn_slow=burn_slow,
                   breached=sorted(breached), no_data=no_data,
                   queue_depth=queue_depth, occupancy=occupancy,
                   kv_fill=kv_fill, replicas=replicas,
                   evidence=tuple(evidence))
