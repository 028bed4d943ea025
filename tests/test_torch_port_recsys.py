"""The recommendation slice of the port (MovieLens, the two-tower model,
the sharded bag over gloo ranks) held against the reference on the same
seeded numpy inputs.

  * ``data/movielens.py``: the same synthetic table, split, ragged
    samples, record bytes, shard files and collated batches, bitwise;
  * ``models/two_tower.py`` on the reference's weights: the same
    probabilities (rtol 1e-6: XLA and ATen round the sigmoid apart), a
    reference module file of a ``TwoTower`` loading in the port and
    scoring the same;
  * the two-tower from rating shards through ``Optimizer`` against the
    reference's at batch 64 (per-step losses within ``LOSS_TOL``), and the
    port's checkpoint-and-cursor resume bitwise a straight run;
  * one spawned world of 4 gloo ranks (``_torch_port_recsys_rank.py``):
    ``ShardedEmbeddingBag`` at 4 shards and at 2 (the ``tp`` subgroups of
    a ``{"dp": 2, "tp": 2}`` mesh) against the reference's bag on a mesh
    of as many virtual devices: the plain path's forward and backward
    bitwise the reference's, two runs bitwise equal, the dedup forward
    bitwise and its backward within the reference's float32 envelope, the
    exchange's two legs and their bytes; and a dp=2 ``DistriOptimizer``
    of the two-tower over ``sharded_rating_dataset`` on a subgroup of 2
    ranks, against the reference's on 2 virtual devices, whose
    checkpoint resumes exactly once (the same losses, weights and data
    cursor as a straight run);
  * ``chip_smoke.phase_recsys`` rehearsed on the CPU at its small size."""
import importlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu.data import movielens as jml
from bigdl_tpu.embedding import ShardedEmbeddingBag as JBag
from bigdl_tpu.embedding import dedup_for_mesh as jdedup
from bigdl_tpu.embedding import pad_table as jpad
from bigdl_tpu.models import two_tower as jtt
from bigdl_tpu.nn.criterion import BCECriterion as JBCE
from bigdl_tpu.optim.distri_optimizer import DistriOptimizer as JDistri
from bigdl_tpu.optim.optim_method import SGD as JSGD
from bigdl_tpu.optim.optimizer import Optimizer as JOptimizer
from bigdl_tpu.optim.trigger import Trigger as JTrigger
from bigdl_tpu.parallel import mesh as jmesh
from bigdl_tpu.utils import serializer as JS
from bigdl_tpu_torch.data import movielens as tml
from bigdl_tpu_torch.models import two_tower as ttt
from bigdl_tpu_torch.models.convert import from_jax_params
from bigdl_tpu_torch.nn import BCECriterion
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger
from bigdl_tpu_torch.utils import serializer as TS

import _torch_port_recsys_rank as R

REPO = Path(__file__).resolve().parents[1]
N_USERS, N_ITEMS, N_RATINGS, DIM = 200, 120, 1000, 8
# per-step losses, port against reference, over a run of SGD steps: the
# sigmoid and the log round apart in the last bits and the steps carry it
LOSS_TOL = dict(rtol=2e-6, atol=0)
PROB_TOL = dict(rtol=1e-6, atol=0)
WEIGHT_TOL = dict(rtol=1e-5, atol=1e-7)
DEDUP_TOL = dict(rtol=3e-6, atol=1e-6)


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


@pytest.fixture(scope="module")
def ratings():
    return jml._synthetic(N_USERS, N_ITEMS, N_RATINGS, seed=0)


@pytest.fixture(scope="module")
def shards(ratings, tmp_path_factory):
    train, _ = tml.leave_one_out(ratings)
    d = tmp_path_factory.mktemp("ml_shards")
    return tml.write_rating_shards(str(d / "port"), train, n_files=4)


def _ref_model(dim=DIM, seed=3):
    jm = jtt.build(N_USERS, N_ITEMS, dim)
    jm.reset(seed)
    return jm


def _port_model(jm):
    tm = ttt.build(N_USERS, N_ITEMS, jm.n_output, device="cpu")
    from_jax_params(jm._params, tm)
    return tm


# --------------------------------------------------------------------- #
# the spawned world: started first, the reference computed meanwhile    #
# --------------------------------------------------------------------- #
def _ref_exchange(n):
    """The reference's bag over ``n`` virtual devices: per case, the
    output and the padded table's gradient."""
    table, ids, wts, gout = R.inputs()
    saved = jmesh._current_mesh
    try:
        mesh = jmesh.create_mesh({"tp": n}, devices=jax.devices()[:n])
        out = {}
        for case in R.CASES:
            combiner = case if case in ("mean", "sqrtn") else "sum"
            bag = JBag(R.V, R.D, mesh=mesh, axis="tp", combiner=combiner)
            params = {bag.name: {"weight": jpad(jnp.asarray(table), n)}}
            if case == "dedup":
                uniq, inv = jdedup(ids, n)
                x = (jnp.asarray(uniq), jnp.asarray(inv))
            elif case == "weighted":
                x = (jnp.asarray(ids), jnp.asarray(wts))
            else:
                x = jnp.asarray(ids)

            def fwd_bwd(p, x):
                y, vjp = jax.vjp(lambda q: bag.run(q, x)[0], p)
                return y, vjp(jnp.asarray(gout))[0][bag.name]["weight"]
            y, g = jax.jit(fwd_bwd)(params, x)
            out[case] = {"y": np.asarray(y), "g": np.asarray(g)}
        return out
    finally:
        jmesh.set_mesh(saved)


def _ref_distri(cfg, w0):
    """The reference's dp=2 DistriOptimizer of the two-tower over the
    same shards: per-step losses and final weights."""
    saved = jmesh._current_mesh
    try:
        mesh = jmesh.create_mesh({"dp": 2}, devices=jax.devices()[:2])
        jm = _ref_model(cfg["dim"])
        jm._params = {"TwoTower": {k: jnp.asarray(v) for k, v in w0.items()}}
        ds = jml.sharded_rating_dataset(cfg["shards"],
                                        batch_size=cfg["batch"],
                                        n_workers=2, seed=7)
        opt = (JDistri(jm, ds, JBCE(), mesh=mesh)
               .set_optim_method(JSGD(learning_rate=cfg["lr"]))
               .set_end_when(JTrigger.max_epoch(2)))
        losses = []
        fire = opt._fire_mid_epoch

        def hook(*a):
            losses.append(float(opt.state.loss))
            return fire(*a)
        opt._fire_mid_epoch = hook
        trained = opt.optimize()
        return losses, {k: np.asarray(v) for k, v in
                        trained._params["TwoTower"].items()}
    finally:
        jmesh.set_mesh(saved)


@pytest.fixture(scope="module")
def world(shards, tmp_path_factory):
    d = tmp_path_factory.mktemp("recsys_world")
    w0 = {k: np.asarray(v) for k, v in
          _ref_model()._params["TwoTower"].items()}
    np.savez(d / "w0.npz", **w0)
    cfg = dict(weights=str(d / "w0.npz"), shards=shards, n_users=N_USERS,
               n_items=N_ITEMS, dim=DIM, batch=32, lr=0.5, dir=str(d))
    started = R.spawn(4, cfg, d)
    ref = {"tp4": _ref_exchange(4), "tp2": _ref_exchange(2),
           "distri": _ref_distri(cfg, w0)}
    return R.collect(started), ref


def _blocks(ranks, key, case):
    """The port's output and padded-table gradient for ``case``, put
    together from the ranks' blocks (the tp2 mesh's dp replicas are
    checked equal)."""
    parts = {}
    for r in ranks:
        got = r[key][case]
        if got["k"] in parts:
            np.testing.assert_array_equal(parts[got["k"]]["y"], got["y"])
            np.testing.assert_array_equal(parts[got["k"]]["g"], got["g"])
        parts[got["k"]] = got
    order = [parts[k] for k in sorted(parts)]
    assert len(order) == order[0]["n"]
    return (np.concatenate([p["y"] for p in order]),
            np.concatenate([p["g"] for p in order]))


def test_the_ranks_import_no_jax(world):
    ranks, _ = world
    assert all(r["jax_free"] for r in ranks)


@pytest.mark.parametrize("key", ["tp4", "tp2"])
@pytest.mark.parametrize("case", ["sum", "mean", "sqrtn", "weighted"])
def test_sharded_bag_on_ranks_is_bitwise_the_references(world, key, case):
    ranks, ref = world
    y, g = _blocks(ranks, key, case)
    np.testing.assert_array_equal(y, ref[key][case]["y"])
    np.testing.assert_array_equal(g, ref[key][case]["g"])


@pytest.mark.parametrize("key", ["tp4", "tp2"])
def test_dedup_on_ranks_forward_bitwise_backward_in_the_envelope(world,
                                                                   key):
    ranks, ref = world
    y, g = _blocks(ranks, key, "dedup")
    np.testing.assert_array_equal(y, ref[key]["dedup"]["y"])
    np.testing.assert_array_equal(y, ref[key]["sum"]["y"])
    np.testing.assert_allclose(g, ref[key]["dedup"]["g"], **DEDUP_TOL)
    np.testing.assert_allclose(g, ref[key]["sum"]["g"], **DEDUP_TOL)


@pytest.mark.parametrize("key", ["tp4", "tp2"])
def test_exchange_repeats_bitwise_and_is_accounted(world, key):
    """Two legs forward and the reply leg again backward, their bytes the
    recorder's ``_account_exchange`` gauges."""
    ranks, _ = world
    n = 4 if key == "tp4" else 2
    cap = (R.B // n) * R.L
    for r in ranks:
        assert r[key]["repeat"]
        acct = r[key]["accounting"]
        assert acct["ops"] == [("all-to-all", n * cap * 4),
                               ("all-to-all", n * cap * R.D * 4),
                               ("all-to-all", n * cap * R.D * 4)]
        assert acct["labels"] == ["tp"]
        want = float(n * cap * 4 + n * cap * R.D * 4)
        gauges = acct["gauges"]
        assert gauges["embedding/lookup_exchange_bytes"] == want
        assert gauges["comm/group.tp.all-to-all_bytes"] == want
        assert gauges["embedding/exchange_ids"] == float(n * cap)


def test_distri_two_tower_on_a_subgroup_is_the_references(world):
    ranks, ref = world
    lj, wj = ref["distri"]
    for r in ranks[:2]:
        got = r["distri"]["straight"]
        assert len(got["losses"]) == len(lj) == got["iteration"]
        np.testing.assert_allclose(got["losses"], lj, **LOSS_TOL)
        for k, v in wj.items():
            np.testing.assert_allclose(got["weights"][k], v, **WEIGHT_TOL)
    a, b = (ranks[0]["distri"]["straight"], ranks[1]["distri"]["straight"])
    assert a["losses"] == b["losses"]
    for k in a["weights"]:
        np.testing.assert_array_equal(a["weights"][k], b["weights"][k])


def test_distri_checkpoint_resumes_exactly_once(world):
    ranks, _ = world
    straight = ranks[0]["distri"]["straight"]
    for r in ranks[2:]:
        first, resumed = r["distri"]["first"], r["distri"]["resumed"]
        n1 = len(first["losses"])
        assert n1 + len(resumed["losses"]) == len(straight["losses"])
        assert resumed["iteration"] == straight["iteration"]
        assert first["losses"] + resumed["losses"] == straight["losses"]
        assert resumed["cursor"] == straight["cursor"]
        for k, v in straight["weights"].items():
            np.testing.assert_array_equal(resumed["weights"][k], v)


# --------------------------------------------------------------------- #
# MovieLens                                                              #
# --------------------------------------------------------------------- #
def test_synthetic_split_and_samples_are_the_references(ratings):
    np.testing.assert_array_equal(
        tml._synthetic(N_USERS, N_ITEMS, N_RATINGS, seed=0), ratings)
    for a, b in zip(tml.leave_one_out(ratings), jml.leave_one_out(ratings)):
        np.testing.assert_array_equal(a, b)
    assert tml.rating_samples(ratings, max_hist=5, threshold=3) == \
        jml.rating_samples(ratings, max_hist=5, threshold=3)


def test_read_data_sets_falls_back_and_reads_ratings_dat(tmp_path):
    np.testing.assert_array_equal(tml.read_data_sets(str(tmp_path)),
                                  jml.read_data_sets(str(tmp_path)))
    (tmp_path / "ml-1m").mkdir()
    (tmp_path / "ml-1m" / "ratings.dat").write_text(
        "1::1193::5::978300760\n2::661::3::978302109\n")
    for fn in ("read_data_sets", "get_id_pairs", "get_id_ratings"):
        np.testing.assert_array_equal(getattr(tml, fn)(str(tmp_path)),
                                      getattr(jml, fn)(str(tmp_path)))


def test_records_and_shard_files_are_byte_identical(ratings, tmp_path):
    for s in tml.rating_samples(ratings)[:50]:
        rec = tml.encode_sample(*s)
        assert rec == jml.encode_sample(*s)
        (tu, tm_), tl = tml.decode_sample(rec)
        (ju, jm_), jl = jml.decode_sample(rec)
        np.testing.assert_array_equal(tu, ju)
        np.testing.assert_array_equal(tm_, jm_)
        assert tl == jl
    tp = tml.write_rating_shards(str(tmp_path / "t"), ratings, n_files=3)
    jp = jml.write_rating_shards(str(tmp_path / "j"), ratings, n_files=3)
    assert [Path(p).read_bytes() for p in tp] == \
        [Path(p).read_bytes() for p in jp]


def test_collated_batches_are_the_references(shards):
    samples = [tml.decode_sample(tml.encode_sample(*s)) for s in
               tml.rating_samples(jml._synthetic(20, 10, 40, seed=1))]
    (tu, tm_), ty = tml.padded_collate(min_mid_len=4)(samples)
    (ju, jm_), jy = jml.padded_collate(min_mid_len=4)(samples)
    for a, b in ((tu, ju), (tm_, jm_), (ty, jy)):
        np.testing.assert_array_equal(a, b)
    tb = list(tml.sharded_rating_dataset(shards, batch_size=32, seed=7)
              .data(train=True, epoch=1))
    jb = list(jml.sharded_rating_dataset(shards, batch_size=32, seed=7)
              .data(train=True, epoch=1))
    assert len(tb) == len(jb) > 0
    for (xa, ya), (xb, yb) in zip(tb, jb):
        np.testing.assert_array_equal(xa[0], xb[0])
        np.testing.assert_array_equal(xa[1], xb[1])
        np.testing.assert_array_equal(ya, yb)


# --------------------------------------------------------------------- #
# the two-tower                                                          #
# --------------------------------------------------------------------- #
def _batch(seed=0, b=16):
    r = np.random.RandomState(seed)
    uids = r.randint(1, N_USERS + 1, (b, 1)).astype(np.int32)
    mids = r.randint(0, N_ITEMS + 1, (b, 9)).astype(np.int32)
    mids[:, 0] = r.randint(1, N_ITEMS + 1, b)
    return uids, mids


def test_two_tower_on_the_references_weights_scores_the_same():
    jm = _ref_model()
    tm = _port_model(jm)
    assert tm.weight_user.shape == (N_USERS + 1, DIM)
    assert tm.weight_item.shape == (N_ITEMS + 1, DIM)
    u, m = _batch()
    yj = np.asarray(jm.run(jm._params, (jnp.asarray(u), jnp.asarray(m)))[0])
    yt = tm.run(tm.param_dict(), (torch.from_numpy(u),
                                  torch.from_numpy(m)))[0]
    assert tuple(yt.shape) == (16, 1)
    np.testing.assert_allclose(_np(yt), yj, **PROB_TOL)


def test_a_reference_two_tower_module_file_loads_and_scores(tmp_path):
    jm = _ref_model()
    JS.save_module(jm, str(tmp_path / "tt"))
    tm = TS.load_module(str(tmp_path / "tt"), device="cpu")
    assert type(tm) is ttt.TwoTower and isinstance(tm, Module)
    assert (tm.n_users, tm.n_items, tm.n_output, tm.combiner) == \
        (N_USERS + 1, N_ITEMS + 1, DIM, "mean")
    u, m = _batch(1)
    yj = np.asarray(jm.forward((jnp.array(u), jnp.array(m))))
    yt = tm.forward((torch.from_numpy(u), torch.from_numpy(m)))
    np.testing.assert_allclose(_np(yt), yj, **PROB_TOL)


def test_two_tower_build_draws_from_its_seed_on_the_device_asked():
    a = ttt.build(N_USERS, N_ITEMS, DIM, device="cpu", seed=4)
    b = ttt.build(N_USERS, N_ITEMS, DIM, device="cpu", seed=4)
    c = ttt.build(N_USERS, N_ITEMS, DIM, device="cpu", seed=5)
    assert torch.equal(a.weight_user, b.weight_user)
    assert not torch.equal(a.weight_item, c.weight_item)
    bound = float(np.sqrt(6.0 / (N_USERS + 1 + DIM)))
    assert float(a.weight_user.detach().abs().max()) <= bound
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            ttt.build(N_USERS, N_ITEMS, DIM)


def test_two_tower_trains_from_shards_as_the_reference(shards):
    """Two epochs of SGD(0.5) at batch 64 through both Optimizers from
    the same weights: the same per-step losses, and the eval loss
    falls."""
    jm = _ref_model()
    tm = _port_model(jm)
    losses = {"ref": [], "port": []}
    jo = (JOptimizer(jm, jml.sharded_rating_dataset(
        shards, batch_size=64, n_workers=2, seed=7), JBCE(), seed=3)
          .set_optim_method(JSGD(learning_rate=0.5))
          .set_end_when(JTrigger.max_epoch(2)))
    fire = jo._fire_mid_epoch

    def ref_hook(*a):
        losses["ref"].append(float(jo.state.loss))
        return fire(*a)
    jo._fire_mid_epoch = ref_hook
    trained = jo.optimize()
    to = (Optimizer(tm, tml.sharded_rating_dataset(
        shards, batch_size=64, n_workers=2, seed=7), BCECriterion(), seed=3,
        device="cpu")
          .set_optim_method(SGD(learning_rate=0.5))
          .set_end_when(Trigger.max_epoch(2)))
    fire_t = to._fire_mid_epoch

    def port_hook():
        losses["port"].append(float(to.state.loss))
        return fire_t()
    to._fire_mid_epoch = port_hook
    assert to.optimize() is tm
    assert len(losses["port"]) == len(losses["ref"]) > 10
    np.testing.assert_allclose(losses["port"], losses["ref"], **LOSS_TOL)
    for k, v in trained._params["TwoTower"].items():
        np.testing.assert_allclose(_np(getattr(tm, k)), np.asarray(v),
                                   **WEIGHT_TOL)


def test_checkpoint_cursor_resume_is_bitwise(shards, tmp_path):
    """A straight 2-epoch run against 1 epoch, a checkpoint and a fresh
    optimizer resuming through the data cursor: the weights bitwise."""
    jm = _ref_model(dim=4)

    def run(epochs, ck=None):
        tm = _port_model(jm)
        opt = (Optimizer(tm, tml.sharded_rating_dataset(
            shards, batch_size=64, n_workers=2, seed=7), BCECriterion(),
            seed=3, device="cpu")
               .set_optim_method(SGD(learning_rate=0.1))
               .set_end_when(Trigger.max_epoch(epochs)))
        if ck is not None:
            opt.set_checkpoint(str(ck))
        opt.optimize()
        return tm
    straight = run(2)
    run(1, ck=tmp_path / "ck")
    resumed = run(2, ck=tmp_path / "ck")
    assert torch.equal(straight.weight_user, resumed.weight_user)
    assert torch.equal(straight.weight_item, resumed.weight_item)
    assert not torch.equal(straight.weight_user,
                           _port_model(jm).weight_user)


# --------------------------------------------------------------------- #
# the chip phase, rehearsed                                              #
# --------------------------------------------------------------------- #
def test_phase_recsys_rehearses_on_the_cpu():
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    cs = importlib.import_module("chip_smoke")
    out = cs.phase_recsys("cpu", device="cpu", small=True)
    assert all(out["checks"].values()), out["checks"]
    assert {"eval_loss_falls", "cursor_replays_bitwise", "bag_fwd",
            "bag_bwd", "bag_repeat", "bag_dedup_fwd", "bag_dedup_bwd",
            "bag_tap", "int8_within_bound", "int8_bytes_ratio",
            "sparse_sgd_bitwise_dense"} <= set(out["checks"])
    train = out["readings"]["train"]
    assert train["eval_loss_after"] < train["eval_loss_before"]
    assert not torch.distributed.is_initialized()
