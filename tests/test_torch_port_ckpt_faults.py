"""Crash consistency of the port's checkpoints, with real kills
(``os._exit`` mid-write through ``bigdl_tpu_torch.checkpoint.faults``)
and a real SIGTERM: the port's counterpart of
``tests/test_checkpoint_faults.py``'s local-mode tests.

Each case runs ``_torch_port_ckpt_worker.py`` (9 iterations, a
checkpoint every 2: saves 0–3 at iterations 2, 4, 6, 8), kills it at one
point of one save, reruns it on the same directory, and holds the final
weights and Adam moments bitwise to one uninterrupted run's.  A kill at
every fault site is a case: in a shard, between the shards and the
manifest, in the manifest, in the first save, and through the
``BIGDL_FAULT`` write site (``ckpt.shard_write:kill``).
"""
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from bigdl_tpu_torch.checkpoint import scan
from bigdl_tpu_torch.checkpoint.faults import ENV_VAR, KILL_EXIT_CODE

_WORKER = os.path.join(os.path.dirname(__file__),
                       "_torch_port_ckpt_worker.py")
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(fault=None, plane=None):
    env = os.environ.copy()
    env.pop(ENV_VAR, None)
    env.pop("BIGDL_FAULT", None)
    env["PYTHONPATH"] = _REPO
    if fault is not None:
        env[ENV_VAR] = fault
    if plane is not None:
        env["BIGDL_FAULT"] = plane
    return env


def _run(ck, out, *args, fault=None, plane=None, check_rc=None):
    p = subprocess.run([sys.executable, _WORKER, str(ck), str(out), *args],
                       env=_env(fault, plane), stdout=subprocess.PIPE,
                       stderr=subprocess.STDOUT, text=True, timeout=300)
    if check_rc is not None:
        assert p.returncode == check_rc, \
            f"rc={p.returncode}, wanted {check_rc}\n{p.stdout}"
    return p


def _state(out):
    with np.load(str(out)) as z:
        return [z[k] for k in z.files]


def _bitwise(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def baseline(tmp_path_factory):
    """The uninterrupted 9-iteration run's final state."""
    d = tmp_path_factory.mktemp("baseline")
    _run(d / "ck", d / "out.npz", check_rc=0)
    return _state(d / "out.npz")


@pytest.mark.parametrize("fault,plane,intact,resume", [
    # 64 bytes into a shard of the second save (iteration 4)
    ("1:bytes:64", None, [2], "RESUME iteration=2"),
    # every shard of the second save durable, its manifest not
    ("1:pre_manifest", None, [2], "RESUME iteration=2"),
    # 10 bytes into the manifest's tmp write of the third save
    ("2:manifest:10", None, [2, 4], "RESUME iteration=4"),
    # the very first save torn: the rerun starts from scratch
    ("0:bytes:0", None, [], None),
    # the fault plane's write site: the 7th shard write (second save)
    (None, "ckpt.shard_write:kill:100@6", [2], "RESUME iteration=2"),
], ids=["mid_shard", "pre_manifest", "mid_manifest", "first_save",
        "plane_shard_write"])
def test_kill_resumes_to_the_uninterrupted_state(tmp_path, baseline, fault,
                                                 plane, intact, resume):
    ck, out = tmp_path / "ck", tmp_path / "out.npz"
    _run(ck, out, fault=fault, plane=plane, check_rc=KILL_EXIT_CODE)
    assert not out.exists()              # it died mid-run
    assert [m.meta["iteration"] for _, m in scan(str(ck))] == intact
    if fault and "bytes" in fault and intact:
        torn = [d for d in os.listdir(ck) if d.startswith("ckpt_")
                and not os.path.exists(os.path.join(ck, d,
                                                    "MANIFEST.json"))]
        assert torn, "expected a torn manifest-less directory"
    r = _run(ck, out, check_rc=0)
    if resume is None:
        assert "RESUME" not in r.stdout
    else:
        assert resume in r.stdout, r.stdout
    _bitwise(_state(out), baseline)


def test_sigterm_preemption_commits_final_checkpoint(tmp_path):
    """A real SIGTERM mid-run: the worker commits ``preempt_iter_<k>``
    and exits 0; a resumed run reaches the uninterrupted run's state,
    bitwise."""
    ck, out = tmp_path / "ck", tmp_path / "out.npz"
    p = subprocess.Popen(
        [sys.executable, _WORKER, str(ck), str(out), "iters=14", "preempt",
         "step_sleep=25"], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.time() + 120
        for line in p.stdout:
            if line.startswith("iter 6") or time.time() > deadline:
                break
        p.send_signal(signal.SIGTERM)
        rest = p.communicate(timeout=120)[0]
    finally:
        if p.poll() is None:
            p.kill()
    assert p.returncode == 0, f"the preempted worker must exit 0:\n{rest}"
    assert "final checkpoint" in rest
    newest = scan(str(ck))[-1][1]
    assert newest.tag.startswith("preempt_iter_"), newest.tag
    k = newest.meta["iteration"]
    assert 6 <= k < 14
    r = _run(ck, out, "iters=14", check_rc=0)
    assert f"RESUME iteration={k}" in r.stdout, r.stdout
    ref = tmp_path / "ref.npz"
    _run(tmp_path / "ck_ref", ref, "iters=14", check_rc=0)
    _bitwise(_state(out), _state(ref))
