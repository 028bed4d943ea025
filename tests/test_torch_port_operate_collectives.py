"""The port's measured collective accounting on two gloo ranks
(``tests/_torch_port_collectives_rank.py``, spawned once for the module).

The reference reads the collectives GSPMD put into a compiled step's HLO
(``tests/test_collective_volume.py``); the port records the ones its own
``parallel/`` code issues during one step
(``SpmdTrainer.account_collectives``).  The data-parallel volume is held
to ring theory as the reference's is; where the port chooses other ops
than GSPMD (Megatron's f/g all-reduces, fsdp's gathers and the
backward's re-gather), the tests name the port's own ops and do not
compare them with the reference's numbers."""
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
RANK = REPO / "tests" / "_torch_port_collectives_rank.py"
WORLD = 2


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    import os
    import pickle
    d = tmp_path_factory.mktemp("collectives")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen(
        [sys.executable, str(RANK), str(r), str(WORLD), str(d / "store"),
         str(d / "out.pkl")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    codes = [p.returncode for p in procs]
    assert not any(codes), f"ranks exited {codes}:\n" + "\n".join(
        log[-3000:] for log in logs)
    return pickle.loads((d / "out.pkl").read_bytes())


def test_dp2_volume_matches_ring_theory(ranks):
    dp = ranks["dp"]
    ops = dp["acct"]["ops"]
    assert set(ops) == {"all-reduce"}
    theory = 2 * dp["grad_bytes"] * (WORLD - 1) / WORLD
    wire = dp["acct"]["wire_bytes_per_step"]
    # one flat all-reduce of the gradients, plus the loss's and the token
    # count's scalars: the reference's band
    assert theory * 0.95 <= wire <= theory * 1.25, (wire, theory)
    assert set(dp["acct"]["groups"]) == {"dp"}


def test_fsdp_step_has_gather_and_scatter(ranks):
    fs = ranks["fsdp"]
    kinds = set(fs["acct"]["ops"])
    assert {"all-gather", "reduce-scatter"} <= kinds, kinds
    theory = 2 * fs["grad_bytes"] * (WORLD - 1) / WORLD
    wire = fs["acct"]["wire_bytes_per_step"]
    assert wire <= theory * 2.2, (wire, theory)
    # the port's own choice: each sharded leaf gathered in the forward and
    # again in the backward (saved-tensor hooks), its gradient
    # reduce-scattered, so the gathers move twice the scatter's bytes
    ops = fs["acct"]["ops"]
    assert ops["all-gather"] == pytest.approx(2 * ops["reduce-scatter"],
                                              rel=0.01)


def test_tp_issues_megatron_all_reduces(ranks):
    """Megatron's f/g: an all-reduce after each block's ``wo`` and ``w2``
    in the forward and before its projections in the backward, all on the
    tp group.  GSPMD picks its own set for the same layout (the
    reference's budget test counts all-reduces and a collective-permute on
    its composed mesh); the port's is named here, not equated with it."""
    tp = ranks["tp"]
    assert set(tp["acct"]["ops"]) == {"all-reduce"}
    assert set(tp["acct"]["groups"]) == {"tp"}
    assert tp["acct"]["wire_bytes_per_step"] > 0


@pytest.mark.parametrize("axes", ["dp", "fsdp", "tp"])
def test_account_collectives_changes_nothing(ranks, axes):
    r = ranks[axes]
    assert r["unchanged"] and r["records_before"] == 0
    g = r["gauges"]
    assert g["collective/wire_bytes_per_step"] == pytest.approx(
        r["acct"]["wire_bytes_per_step"])
    for label, d in r["acct"]["groups"].items():
        assert g[f"comm/group.{label}.wire_bytes_per_step"] == \
            pytest.approx(d["wire_bytes"])


def test_ragged_last_batch_does_not_double_count_collectives(ranks):
    """A smaller last batch must not add its volume to the previous
    step's: the per-step gauges reset each step, and the totals are the
    sum of the steps (the reference's C3 case, on the port's
    ``DistriOptimizer`` at dp = 2)."""
    steps = ranks["ragged"]
    assert len(steps) == 2
    per_step = steps[0]["gauges"]["collective/bytes_per_step"]
    assert per_step > 0
    # gradients are parameter-shaped: both steps move the same volume
    assert steps[1]["gauges"]["collective/bytes_per_step"] == per_step
    assert steps[1]["counters"]["collective/bytes_total"] == 2 * per_step


def test_backward_on_another_thread_is_recorded(ranks):
    """On CUDA the autograd engine runs a backward on a thread of its
    own: a tap opened on the caller's thread must still see the
    backward's collectives.  Megatron's *f* is the identity forward and
    one all-reduce of its (4, 8) fp32 cotangent backward."""
    e = ranks["elsewhere"]
    assert e["forward"] == []
    nbytes = 4 * 8 * 4
    assert e["backward"] == [("all-reduce", nbytes,
                              2.0 * nbytes * (WORLD - 1) / WORLD, "tp")]


def test_a_step_on_another_thread_is_recorded_whole(ranks):
    """An fsdp step run on a thread other than the tap's records the same
    ops and bytes as ``account_collectives`` on one thread."""
    e = ranks["elsewhere"]
    same, other = e["step_same_thread"], e["step_other_thread"]
    assert {"all-gather", "reduce-scatter"} <= set(other["ops"])
    assert other["ops"] == pytest.approx(same["ops"])
    assert other["wire_bytes_per_step"] == pytest.approx(
        same["wire_bytes_per_step"])


def test_ranks_import_neither_jax_nor_the_reference(ranks):
    assert ranks["jax_free"]
