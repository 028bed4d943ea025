"""Transient-fault injection plane (≙ ``bigdl_tpu/faults``): named
injection *sites*, armed from one environment variable or :func:`arm`, so
that every retry, failover and rollback claim is proven by a test that
(a) asserts the fault fired (``fault/injected_total``) and (b) asserts the
system survived it.

The port has the reference's control-flow sites on its serving path::

    serving.swap        registry weight hot-swap (validate + publish)
    serving.compute     one ServingEngine batch (delay = a wedged replica,
                        err = a failing one)
    serving.decode_step one DecodeEngine step (delay = a wedged step,
                        err = live requests fail and a ReplicaSet fails
                        them over)
    serving.publish     the canary publisher's staging step

and the reference's two write sites, which every byte the checkpoint
writer puts on disk passes through (:func:`filter_write`, called by
``checkpoint.faults.guarded_write``)::

    ckpt.shard_write    one shard file of a checkpoint
    ckpt.manifest       one manifest (or part-manifest) write

The other names of :data:`SITES` (data, HTTP, step dispatch, fleet)
parse, so that one ``BIGDL_FAULT`` value means the same to both
packages, but no code of the port reaches them yet.

Grammar (``BIGDL_FAULT`` env var or :func:`arm`)::

    "<site>:<mode>:<arg>[@<nth>[+]]"   one spec; join several with ";"

    modes:   err:<errno>      raise OSError(errno) — number or name
             delay:<ms>       block for <ms> milliseconds (in chunks of
                              at most 50 ms)
             corrupt:<n>      write sites only: flip the last <n> bytes;
                              never fires at a control site
             kill:<n>         at a control site, immediate
                              ``os._exit(KILL_EXIT_CODE)``; at a write
                              site, after the first <n> bytes are durable

    @<nth>:  ``@2`` fires ONLY on the 3rd match of that site (0-based),
             ``@2+`` on every match from the 3rd onward; omitted = every
             match.  Match counting is thread-safe.

Every fired fault increments ``fault/injected_total`` and
``fault/injected.<site>`` on the recorder the site passes (a site without
one counts only process-locally), and the process-local count that
:func:`injected_total` reads.
"""
from __future__ import annotations

import errno as _errno
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

ENV_VAR = "BIGDL_FAULT"
#: the reference's kill exit code — parents of kill tests match it
KILL_EXIT_CODE = 42

SITES = ("ckpt.shard_write", "ckpt.manifest", "data.shard_open",
         "data.record_read", "serving.swap", "serving.compute",
         "serving.decode_step", "serving.publish", "http.bind",
         "step.dispatch", "fleet.place", "fleet.preempt")

_MODES = ("err", "delay", "corrupt", "kill")


class FaultSpec:
    """One armed fault: site, mode, numeric argument, match selector."""

    __slots__ = ("site", "mode", "arg", "nth", "onward", "hits", "fired")

    def __init__(self, site: str, mode: str, arg: int,
                 nth: Optional[int] = None, onward: bool = False):
        if site not in SITES:
            raise ValueError(f"unknown fault site {site!r}; "
                             f"sites: {', '.join(SITES)}")
        if mode not in _MODES:
            raise ValueError(f"unknown fault mode {mode!r}; "
                             f"modes: {', '.join(_MODES)}")
        self.site = site
        self.mode = mode
        self.arg = int(arg)
        self.nth = nth              # None = every match
        self.onward = onward        # "@n+": from the nth match onward
        self.hits = 0               # site matches observed
        self.fired = 0              # faults actually injected

    def __repr__(self):
        sel = "" if self.nth is None else \
            f"@{self.nth}{'+' if self.onward else ''}"
        return f"{self.site}:{self.mode}:{self.arg}{sel}"


def _parse_errno(text: str) -> int:
    try:
        return int(text)
    except ValueError:
        num = getattr(_errno, text.strip().upper(), None)
        if isinstance(num, int):
            return num
        raise ValueError(f"unknown errno {text!r} in {ENV_VAR} spec")


def parse(spec: str) -> List[FaultSpec]:
    """Parse one ``BIGDL_FAULT`` value (possibly ``;``-joined) into specs;
    raises ValueError with the offending fragment on bad input."""
    out: List[FaultSpec] = []
    for frag in spec.split(";"):
        frag = frag.strip()
        if not frag:
            continue
        nth, onward = None, False
        body = frag
        if "@" in frag:
            body, sel = frag.rsplit("@", 1)
            if sel.endswith("+"):
                onward, sel = True, sel[:-1]
            try:
                nth = int(sel)
            except ValueError:
                raise ValueError(
                    f"bad match selector {sel!r} in {ENV_VAR} spec "
                    f"{frag!r} (want @<nth> or @<nth>+)") from None
        parts = body.split(":")
        if len(parts) != 3:
            raise ValueError(
                f"bad {ENV_VAR} spec {frag!r}: want "
                "<site>:<mode>:<arg>[@<nth>[+]]")
        site, mode, arg = parts
        if mode == "err":
            out.append(FaultSpec(site, mode, _parse_errno(arg), nth,
                                 onward))
        else:
            try:
                out.append(FaultSpec(site, mode, int(arg), nth, onward))
            except ValueError:
                raise ValueError(
                    f"bad numeric argument {arg!r} in {ENV_VAR} spec "
                    f"{frag!r}") from None
    return out


_lock = threading.Lock()
_specs: Optional[List[FaultSpec]] = None
_env_checked = False
_counts: Dict[str, int] = {}


def arm(spec) -> None:
    """Arm programmatically: a spec string, a list of FaultSpecs, or None
    to disarm.  Overrides the environment."""
    global _specs, _env_checked
    with _lock:
        if spec is None:
            _specs = None
        elif isinstance(spec, str):
            _specs = parse(spec)
        else:
            _specs = list(spec)
        _env_checked = True     # explicit arm/disarm beats the env


def disarm() -> None:
    arm(None)


def reset() -> None:
    """Test seam: drop the plan, the counts and the env-read latch, so that
    the next site check re-reads ``BIGDL_FAULT``."""
    global _specs, _env_checked
    with _lock:
        _specs = None
        _env_checked = False
        _counts.clear()


def injected_total(site: Optional[str] = None) -> int:
    """Process-local fired-fault count (per site, or all sites)."""
    with _lock:
        if site is not None:
            return _counts.get(site, 0)
        return sum(_counts.values())


def _active() -> List[FaultSpec]:
    global _env_checked, _specs
    with _lock:
        if not _env_checked:
            _env_checked = True
            env = os.environ.get(ENV_VAR)
            if env:
                _specs = parse(env)
        return _specs or []


def _match(site: str, exclude_modes=()) -> Optional[FaultSpec]:
    """Thread-safe match counting; returns the spec that fires for this
    occurrence of ``site``, or None.

    Every armed spec for the site observes every occurrence (its ``hits``
    advance even when another spec fires first), so
    ``"s:err:EIO@0;s:err:EIO@1"`` fires on occurrences 0 AND 1.  When
    several specs select the same occurrence the first armed one fires.
    ``exclude_modes`` makes a spec ineligible to fire at this call site
    (its hits still advance)."""
    if _specs is None and _env_checked:
        return None             # fast path: disarmed (benign race)
    _active()
    with _lock:
        if not _specs:
            return None
        fired: Optional[FaultSpec] = None
        for s in _specs:
            if s.site != site:
                continue
            n = s.hits
            s.hits += 1
            if fired is None and s.mode not in exclude_modes and (
                    s.nth is None
                    or (n >= s.nth if s.onward else n == s.nth)):
                s.fired += 1
                fired = s
        if fired is not None:
            _counts[site] = _counts.get(site, 0) + 1
        return fired


def _record(site: str, mode: str, recorder=None) -> None:
    if recorder is None:
        return
    try:
        recorder.inc("fault/injected_total")
        recorder.inc(f"fault/injected.{site}")
        recorder.emit_record("fault_event", site=site, mode=mode)
    except Exception:
        pass                    # telemetry must never mask the fault


def _sleep_chunked(seconds: float) -> None:
    deadline = time.monotonic() + seconds
    while True:
        left = deadline - time.monotonic()
        if left <= 0:
            return
        time.sleep(left if left < 0.05 else 0.05)


def _raise_err(spec: FaultSpec, site: str):
    raise OSError(spec.arg, f"injected fault at {site} "
                            f"[{_errno.errorcode.get(spec.arg, spec.arg)}]")


def inject(site: str, recorder=None) -> bool:
    """Control-flow sites: raise ``err``, block ``delay``, die ``kill`` per
    the armed plan.  ``corrupt`` has no payload here: the spec never fires
    (a counted no-op would let a chaos assertion pass without any fault
    happening).  Returns True when a non-raising fault fired."""
    spec = _match(site, exclude_modes=("corrupt",))
    if spec is None:
        return False
    _record(site, spec.mode, recorder)
    if spec.mode == "err":
        _raise_err(spec, site)
    if spec.mode == "delay":
        _sleep_chunked(spec.arg / 1e3)
    elif spec.mode == "kill":
        os._exit(KILL_EXIT_CODE)
    return True


def filter_write(site: str, data: bytes, recorder=None
                 ) -> Tuple[bytes, Optional[int]]:
    """Write sites: returns ``(payload, kill_offset)``.  ``err`` raises
    before any byte lands, ``delay`` blocks, ``corrupt`` flips the last
    ``n`` bytes (a torn tail that CRC verification must catch), and
    ``kill`` hands the caller the offset for its flush-the-prefix-then-die
    protocol (``checkpoint.faults.guarded_write``)."""
    spec = _match(site)
    if spec is None:
        return data, None
    _record(site, spec.mode, recorder)
    if spec.mode == "err":
        _raise_err(spec, site)
    if spec.mode == "delay":
        _sleep_chunked(spec.arg / 1e3)
        return data, None
    if spec.mode == "corrupt":
        n = max(1, min(spec.arg, len(data))) if data else 0
        if n:
            data = data[:-n] + bytes(b ^ 0xFF for b in data[-n:])
        return data, None
    return data, min(max(spec.arg, 0), len(data))       # kill


__all__ = ["ENV_VAR", "KILL_EXIT_CODE", "SITES", "FaultSpec", "parse",
           "arm", "disarm", "reset", "injected_total", "inject",
           "filter_write"]
