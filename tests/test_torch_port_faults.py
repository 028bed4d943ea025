"""The port's fault plane and retry policy held against the reference's:
the same ``BIGDL_FAULT`` specs parse to the same plans, fire on the same
occurrences with the same counts, and the same retry schedule sleeps the
same delays and counts the same ``retry/*`` counters."""
import errno
import random

import pytest

from bigdl_tpu import faults as J
from bigdl_tpu.observability import Recorder as JRecorder
from bigdl_tpu.utils.retry import RetryPolicy as JRetryPolicy
from bigdl_tpu_torch import faults as T
from bigdl_tpu_torch.observability import Recorder as TRecorder
from bigdl_tpu_torch.utils import retry as retry_mod
from bigdl_tpu_torch.utils.retry import RetryPolicy as TRetryPolicy

SPECS = ["serving.swap:err:EIO", "serving.compute:delay:1500@0",
         "serving.decode_step:err:28@2+",
         "serving.publish:err:EAGAIN@0;serving.publish:err:5@1",
         " serving.swap:corrupt:3 ; ckpt.manifest:kill:10@4 ",
         "fleet.place:delay:0"]
BAD = ["nowhere:err:EIO", "serving.swap:explode:1", "serving.swap:err:ENOPE",
       "serving.swap:err", "serving.swap:delay:x", "serving.swap:err:EIO@x"]


@pytest.fixture(autouse=True)
def _clean():
    J.reset()
    T.reset()
    yield
    J.reset()
    T.reset()


def _plan(specs):
    return [(s.site, s.mode, s.arg, s.nth, s.onward, repr(s)) for s in specs]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_equal(spec):
    assert _plan(T.parse(spec)) == _plan(J.parse(spec))
    assert T.SITES == J.SITES and T.KILL_EXIT_CODE == J.KILL_EXIT_CODE


@pytest.mark.parametrize("spec", BAD)
def test_bad_specs_raise_in_both(spec):
    with pytest.raises(ValueError) as jt:
        J.parse(spec)
    with pytest.raises(ValueError) as tt:
        T.parse(spec)
    assert str(tt.value) == str(jt.value)


def _drive(mod, rec, site, n):
    """Call ``inject`` n times; each call's outcome."""
    out = []
    for _ in range(n):
        try:
            out.append(("fired" if mod.inject(site, rec) else "quiet"))
        except OSError as e:
            out.append(("err", e.errno))
    return out


@pytest.mark.parametrize("spec,site", [
    ("serving.publish:err:EAGAIN@0;serving.publish:err:5@1",
     "serving.publish"),
    ("serving.decode_step:err:EIO@2+", "serving.decode_step"),
    ("serving.compute:delay:1@1;serving.compute:err:EIO@1",
     "serving.compute"),
    ("serving.swap:corrupt:3", "serving.swap"),
    ("serving.swap:err:EBUSY", "serving.compute"),
])
def test_inject_fires_on_the_same_occurrences(spec, site):
    jr, tr = JRecorder(), TRecorder()
    J.arm(spec)
    T.arm(spec)
    want = _drive(J, jr, site, 5)
    got = _drive(T, tr, site, 5)
    assert got == want
    assert T.injected_total(site) == J.injected_total(site)
    assert T.injected_total() == J.injected_total()
    for k in ("fault/injected_total", f"fault/injected.{site}"):
        assert tr.counter_value(k) == jr.counter_value(k)


def test_env_arming_disarm_and_reset(monkeypatch):
    monkeypatch.setenv("BIGDL_FAULT", "serving.swap:err:EIO@1")
    T.reset()
    assert not T.inject("serving.swap")
    with pytest.raises(OSError) as ei:
        T.inject("serving.swap")
    assert ei.value.errno == errno.EIO
    assert T.injected_total("serving.swap") == 1
    T.disarm()                      # beats the env
    assert not T.inject("serving.swap")
    T.reset()                       # drops the counts, re-reads the env
    assert T.injected_total() == 0
    assert not T.inject("serving.swap")


# --------------------------------------------------------------------- #
# retry                                                                 #
# --------------------------------------------------------------------- #
def _flaky(n_fail, exc):
    calls = []

    def fn():
        calls.append(1)
        if len(calls) <= n_fail:
            raise exc
        return len(calls)
    return fn, calls


def _port_run(pol, fn, slept, monkeypatch):
    monkeypatch.setattr(retry_mod.time, "sleep", slept.append)
    try:
        return pol.run(fn)
    except OSError:
        return "gave up"
    finally:
        monkeypatch.undo()


@pytest.mark.parametrize("seeded", [True, False])
@pytest.mark.parametrize("n_fail", [0, 2, 5])
def test_retry_schedule_and_counters_equal(seeded, n_fail, monkeypatch):
    """The port's constant budget (3 attempts, base 0.01, ceiling 0.2)
    run against the reference's policy built with the same values: the
    same calls, counters and, from one seed, the same jittered sleeps."""
    outcomes = []
    for cls, rcls in ((JRetryPolicy, JRecorder), (TRetryPolicy, TRecorder)):
        rec, slept = rcls(), []
        fn, calls = _flaky(n_fail, OSError(errno.EIO, "blip"))
        random.seed(7)
        if cls is JRetryPolicy:
            pol = cls(max_attempts=3, base=0.01, max_delay=0.2,
                      rng=random.Random(7), name="serving.publish",
                      recorder_fn=lambda r=rec: r, sleep=slept.append)
            try:
                res = pol.run(fn)
            except OSError:
                res = "gave up"
            delays = [cls(base=0.01, max_delay=0.2, rng=random.Random(3))
                      .delay_for(a) for a in range(1, 8)]
        else:
            pol = cls(name="serving.publish", recorder_fn=lambda r=rec: r)
            res = _port_run(pol, fn, slept, monkeypatch)
            delays = []
            for a in range(1, 8):       # one fresh seed per policy, as above
                random.seed(3)
                delays.append(cls().delay_for(a))
        counters = {k: rec.counter_value(k) for k in (
            "retry/attempts", "retry/attempts.serving.publish",
            "retry/giveups", "retry/giveups.serving.publish")}
        outcomes.append((res, len(calls), counters,
                         slept if seeded else len(slept),
                         delays if seeded else len(delays)))
    assert outcomes[1] == outcomes[0]
    if not seeded:
        # unseeded draws stay under the same ceilings
        caps = [min(0.01 * 2 ** (a - 1), 0.2) for a in range(1, 8)]
        assert all(0.0 <= TRetryPolicy().delay_for(a) <= c
                   for a, c in zip(range(1, 8), caps))


def test_retry_fatal_and_deadline_equal(monkeypatch):
    """Fatal errors raise at once on both; a transient one exhausts the
    same three attempts (the port has no deadline: its callers set
    none)."""
    for exc in (ValueError("drift"), OSError(errno.EROFS, "ro"),
                TimeoutError("slow")):
        got = []
        for cls, rcls in ((JRetryPolicy, JRecorder),
                          (TRetryPolicy, TRecorder)):
            rec, slept = rcls(), []
            fn, calls = _flaky(10, exc)
            if cls is JRetryPolicy:
                pol = cls(max_attempts=3, base=0.01, max_delay=0.2,
                          recorder_fn=lambda r=rec: r, sleep=slept.append)
                with pytest.raises(type(exc)):
                    pol.run(fn)
            else:
                pol = cls(recorder_fn=lambda r=rec: r)
                monkeypatch.setattr(retry_mod.time, "sleep", slept.append)
                with pytest.raises(type(exc)):
                    pol.run(fn)
                monkeypatch.undo()
            got.append((len(calls), len(slept),
                        rec.counter_value("retry/giveups")))
        assert got[1] == got[0]
    # without a recorder the port's counters go nowhere, and nothing raises
    fn, calls = _flaky(1, ConnectionError("reset"))
    monkeypatch.setattr(retry_mod.time, "sleep", lambda d: None)
    assert TRetryPolicy().run(fn) == 2
