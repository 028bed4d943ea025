"""Checkpoints of the port's SpmdTrainer across meshes and packages.

Four gloo ranks (``_torch_port_spmd_rank.py``) train TransformerLM
``tiny`` from the reference's weights with SGD and momentum at
``{"dp": 2, "tp": 2}``: once four steps straight, once two steps and a
checkpoint, in which each rank writes its own fragments (the blocks it
holds, with their global index ranges).  That checkpoint restores at
``{"fsdp": 2, "tp": 2}``, on one device, and in the reference (on 4 of the
virtual devices of ``tests/conftest.py``), and each goes on for the last
two steps of the straight run.  The reference's own checkpoint of the
same run restores onto the port's ranks.  The bands: a mesh against
another mesh or one device within rtol 2e-3 (the reference's band for a
mesh against one device); parameters also within atol 2e-4.
"""
import jax
import numpy as np
import pytest

from bigdl_tpu.models import transformer as JT
from bigdl_tpu.optim import SGD as JSGD
from bigdl_tpu.parallel import mesh as jmesh
from bigdl_tpu.parallel.spmd import SpmdTrainer as JSpmd
from bigdl_tpu_torch.checkpoint.manifest import read_manifest, scan
from bigdl_tpu_torch.models import transformer as TT
from bigdl_tpu_torch.optim import SGD
from bigdl_tpu_torch.parallel import SpmdTrainer

from _torch_port_spmd_rank import collect, load_npz, save_npz, spawn

TOL = dict(rtol=2e-3, atol=2e-4)
MESH = {"dp": 2, "tp": 2}
SGD_KW = {"learning_rate": 0.1, "momentum": 0.9}


def _batches(n=4, b=4, s=32, vocab=256, seed=3):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        tok = rng.randint(0, vocab, (b, s + 1))
        out.append((tok[:, :-1], tok[:, 1:]))
    return out


def _ref_trainer(mesh):
    return JSpmd(JT.build("tiny"), JSGD(**SGD_KW), mesh=mesh, fsdp=False,
                 seed=0)


def _host(a):
    return a.detach().numpy() if hasattr(a, "detach") else np.asarray(a)


def _suffix(tree):
    return {mod.split(".", 1)[1]: {k: _host(a) for k, a in sub.items()}
            for mod, sub in tree.items()}


def _close(got, want):
    got, want = _suffix(got), _suffix(want)
    assert sorted(got) == sorted(want)
    for mod, sub in want.items():
        for k, a in sub.items():
            np.testing.assert_allclose(got[mod][k], a, err_msg=f"{mod}.{k}",
                                       **TOL)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("spmd_ckpt")
    batches = _batches()
    paths = []
    for i, (x, y) in enumerate(batches):
        np.savez(d / f"b{i}.npz", x=x, y=y)
        paths.append(str(d / f"b{i}.npz"))
    saved = jmesh._current_mesh
    try:
        # the reference: two steps at dp2×tp2 and its checkpoint (elastic
        # fragments), then the port's ranks start while it goes on
        mesh = jmesh.create_mesh(MESH, devices=jax.devices()[:4])
        jt = _ref_trainer(mesh).init()
        w0 = jax.tree_util.tree_map(np.asarray, jt.params)
        save_npz(d / "w.npz", w0)
        for b in batches[:2]:
            jt.step(*b)
        ck_ref = str(d / "ck_ref")
        jt.set_checkpoint(ck_ref, layout="manifest", shard_arrays=True)
        jt.save_checkpoint(ck_ref, sync=True)
        ck_port = str(d / "ck_port")

        def job(name, mesh_axes, steps, batch, **kw):
            return {"name": name, "mesh": mesh_axes, "batch": batch,
                    "weights": str(d / "w.npz"), "steps": steps,
                    "model": {"preset": "tiny"}, "optim": ["SGD", SGD_KW],
                    "trainer": {"fsdp": "fsdp" in mesh_axes,
                                "min_fsdp_size": 1}, **kw}
        started = spawn(4, [
            job("full", MESH, 4, paths),
            job("first", MESH, 2, paths[:2], save=ck_port),
            job("resume", {"fsdp": 2, "tp": 2}, 2, paths[2:], load=ck_port),
            job("from_ref", {"fsdp": 2, "tp": 2}, 2, paths[2:],
                load=ck_ref)], d)
        ref_after = [float(jt.step(*b)) for b in batches[2:]]
        ref_params = jax.tree_util.tree_map(np.asarray, jt.params)
        ranks = collect(started)
        # the reference restores the port's four-rank checkpoint
        other = _ref_trainer(jmesh.create_mesh(MESH,
                                               devices=jax.devices()[:4]))
        other.init()
        other.load_checkpoint(ck_port)
        ref_restored = {"step": other._step_count,
                        "losses": [float(other.step(*b))
                                   for b in batches[2:]],
                        "params": jax.tree_util.tree_map(np.asarray,
                                                         other.params)}
    finally:
        jmesh.set_mesh(saved)
    return {"ranks": ranks, "ref_after": ref_after, "ref_params": ref_params,
            "ref_restored": ref_restored, "ck_port": ck_port,
            "batches": batches, "w": load_npz(d / "w.npz")}


def test_ranks_stay_jax_free(runs):
    assert all(r["jax_free"] for r in runs["ranks"])


def test_the_checkpoint_holds_every_ranks_fragments(runs):
    mf = read_manifest(scan(runs["ck_port"])[-1][0])
    assert mf.mesh == {"axes": [["dp", 2], ["tp", 2]], "devices": 4,
                       "processes": 4}
    names = sorted(s.name for s in mf.shards)
    assert names == sorted(f"{n}@p{r:03d}" for r in range(4)
                           for n in {s.name.split("@")[0]
                                     for s in mf.shards})
    assert all(s.kind == "slices" for s in mf.shards)


def test_a_checkpoint_restores_onto_another_mesh(runs):
    """Saved at dp2×tp2, restored at fsdp2×tp2 (a layout the saver never
    held), the run goes on as the uninterrupted one."""
    full, resume = runs["ranks"][0]["full"], runs["ranks"][0]["resume"]
    assert resume["step"] == 4
    np.testing.assert_allclose(resume["losses"], full["losses"][2:], **TOL)
    _close(resume["params"], full["params"])


def test_a_mesh_checkpoint_restores_on_one_device(runs):
    tm = TT.build("tiny", device="cpu")
    tr = SpmdTrainer(tm, SGD(**SGD_KW), device="cpu")
    tr.load_checkpoint(runs["ck_port"])
    assert tr._step_count == 2
    got = [float(tr.step(*b)) for b in runs["batches"][2:]]
    full = runs["ranks"][0]["full"]
    np.testing.assert_allclose(got, full["losses"][2:], **TOL)
    _close(tr.params, full["params"])


def test_the_reference_restores_the_ports_mesh_checkpoint(runs):
    got = runs["ref_restored"]
    assert got["step"] == 2
    np.testing.assert_allclose(got["losses"], runs["ref_after"], **TOL)
    _close(got["params"], runs["ref_params"])


def test_the_port_mesh_restores_the_references_checkpoint(runs):
    got = runs["ranks"][0]["from_ref"]
    assert got["step"] == 4
    np.testing.assert_allclose(got["losses"], runs["ref_after"], **TOL)
    _close(got["params"], runs["ref_params"])
