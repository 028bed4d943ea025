"""Module files and weights files (``bigdl_tpu_torch/utils/serializer.py``'s
module half) against the reference's (``bigdl_tpu/utils/serializer.py``).

A module file written by the reference loads in the port (classes mapped
by name, constructors replayed without the port's generator argument)
and computes the reference's forward within 1e-5 (fp32: XLA-CPU and
ATen-CPU round convolutions and matmuls differently); the port's own
round trip is bitwise; weights files cross both ways exactly; the
structural summaries (``topology_dict``) are equal; a broken or foreign
file raises ``SerializationError``."""
import io
import json
import os
import struct
import zipfile

import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.models import lenet as JL
from bigdl_tpu.models import resnet as JR
from bigdl_tpu.models import transformer as JT
from bigdl_tpu.optim.regularizer import L2Regularizer as JL2
from bigdl_tpu.quantized import quantize as jquantize
from bigdl_tpu.utils import serializer as JS
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.models import lenet as TL
from bigdl_tpu_torch.models import transformer as TT
from bigdl_tpu_torch.nn.module import Module, migrate_legacy_names
from bigdl_tpu_torch.utils import serializer as TS
from bigdl_tpu_torch.utils.serializer import SerializationError

REL = 1e-5


def _img(*shape, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _lenet():
    return JL.build(10), _img(2, 28, 28)


def _lenet_graph():
    return JL.build_graph(10), _img(2, 28, 28)


def _resnet20():
    m = JR.build(10, 20, dataset="cifar10")
    m.reset(0)
    x = _img(2, 3, 32, 32)
    m.training()
    m.forward(x)            # moves the running statistics off their init
    m.evaluate()
    return m, x


def _shared():
    lin = jnn.Linear(6, 6)
    return jnn.Sequential(lin, jnn.Tanh(), lin), _img(3, 6)


def _post_hoc_add():
    m = jnn.Sequential(jnn.Linear(5, 7))
    m.add(jnn.ReLU()).add(jnn.Linear(7, 3))
    return m, _img(3, 5)


def _concat():
    m = jnn.Concat(2, jnn.Linear(4, 3), jnn.Linear(4, 5))
    return m, _img(2, 4)


def _ceil_mode():
    m = jnn.Sequential(jnn.SpatialConvolution(2, 3, 3, 3),
                       jnn.SpatialMaxPooling(2, 2, 2, 2).ceil())
    return m, _img(2, 2, 9, 9)


def _attrs():
    lin = jnn.Linear(4, 3, w_regularizer=JL2(0.01),
                     b_regularizer=JL2(0.02))
    lin.set_init_method(jnn.Xavier(), jnn.Zeros())
    return jnn.Sequential(lin, jnn.Dropout(0.3)), _img(2, 4)


def _tiny():
    m = JT.build("tiny", dropout=0.0)
    x = np.random.RandomState(0).randint(0, 256, (2, 16))
    return m, x


def _int8():
    m = jnn.Sequential(jnn.SpatialConvolution(3, 4, 3, 3, 1, 1, 1, 1),
                       jnn.ReLU(), jnn.Reshape((4 * 8 * 8,)),
                       jnn.Linear(4 * 8 * 8, 5))
    m.reset(0)
    calib = [np.random.RandomState(4).rand(2, 3, 8, 8).astype(np.float32)]
    return jquantize(m, calibration_data=calib), _img(2, 3, 8, 8, seed=5)


MODELS = {"lenet5": _lenet, "lenet5_graph": _lenet_graph,
          "resnet20_bn_state": _resnet20, "shared_submodule": _shared,
          "post_hoc_add": _post_hoc_add, "concat_dimension": _concat,
          "ceil_mode": _ceil_mode, "regularizer_and_init": _attrs,
          "transformer_tiny": _tiny, "int8_calibrated": _int8}


def _ref(name):
    m, x = MODELS[name]()
    if m._params is None:
        m.reset(0)
    return m, x


def _fwd(m, x):
    with torch.no_grad():
        return m.forward(torch.as_tensor(x)).numpy()


def _rel(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-6)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_a_reference_module_file_loads_and_computes_its_forward(tmp_path,
                                                                name):
    jm, x = _ref(name)
    path = str(tmp_path / "m.bigdl")
    JS.save_module(jm, path)
    tm = TS.load_module(path, device="cpu")
    assert isinstance(tm, Module) and not tm.training
    assert _rel(_fwd(tm, x), np.asarray(jm.forward(x))) < REL
    assert TS.topology_dict(tm) == JS.topology_dict(jm)
    # the port's own round trip is bitwise
    path2 = str(tmp_path / "m2.bigdl")
    tm.save(path2)
    tm2 = Module.load(path2, device="cpu")
    np.testing.assert_array_equal(_fwd(tm2, x), _fwd(tm, x))
    assert TS.topology_dict(tm2) == TS.topology_dict(tm)
    # and the reference reads the port's file back
    jm2 = JS.load_module(path2)
    assert _rel(np.asarray(jm2.forward(x)), np.asarray(jm.forward(x))) < REL


def test_structure_survives_the_round_trip(tmp_path):
    """The attributes a constructor replay alone would lose."""
    for name, check in [
            ("shared_submodule", lambda m: m[0] is m[2]),
            ("post_hoc_add", lambda m: len(m) == 3),
            ("concat_dimension", lambda m: m.dimension == 2),
            ("ceil_mode", lambda m: m[1].ceil_mode is True),
            ("regularizer_and_init", lambda m: (
                m[0].w_regularizer.l2 == 0.01
                and m[0].b_regularizer.l2 == 0.02
                and type(m[0].weight_init).__name__ == "Xavier"
                and type(m[0].bias_init).__name__ == "Zeros"
                and m[1].p == 0.3)),
            ("int8_calibrated", lambda m: [
                c.act_absmax is not None for c in m.modules()
                if type(c).__name__ == "QuantizedLinear"] == [True])]:
        jm, _ = _ref(name)
        JS.save_module(jm, str(tmp_path / name))
        tm = TS.load_module(str(tmp_path / name), device="cpu")
        assert check(tm), name
        tm.save(str(tmp_path / (name + ".port")))
        assert check(TS.load_module(str(tmp_path / (name + ".port")),
                                    device="cpu")), name


def test_a_port_model_saves_and_loads_bitwise(tmp_path):
    tm = TT.build("tiny", device="cpu", seed=3)
    x = torch.as_tensor(np.random.RandomState(1).randint(0, 256, (2, 12)))
    tm.save(str(tmp_path / "lm"))
    back = Module.load(str(tmp_path / "lm"), device="cpu")
    assert back.name == tm.name and back.cfg == tm.cfg
    for (k, a), (k2, b) in zip(sorted(tm.state_dict().items()),
                               sorted(back.state_dict().items())):
        assert k == k2 and torch.equal(a, b)
    np.testing.assert_array_equal(_fwd(back, x), _fwd(tm, x))
    with pytest.raises(FileExistsError):
        tm.save(str(tmp_path / "lm"), overwrite=False)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_weights_files_cross_both_ways(tmp_path, writer):
    jm, x = _ref("resnet20_bn_state")
    path = str(tmp_path / "w")
    JS.save_module(jm, str(tmp_path / "m"))
    tm = TS.load_module(str(tmp_path / "m"), device="cpu")
    if writer == "reference":
        jm.save_weights(path)
        params, state = TS.load_weights_file(path)
        tm2 = TS.load_module(str(tmp_path / "m"), device="cpu")
        with torch.no_grad():
            for p in tm2.parameters():
                p.zero_()
        tm2.load_weights(path)
        np.testing.assert_array_equal(_fwd(tm2, x), _fwd(tm, x))
    else:
        tm.save_weights(path)
        params, state = JS.load_weights_file(path)
    for mod, sub in jm._params.items():
        for k, v in sub.items():
            np.testing.assert_array_equal(np.asarray(params[mod][k]),
                                          np.asarray(v))
    for mod, sub in jm._state.items():
        for k, v in sub.items():
            np.testing.assert_array_equal(np.asarray(state[mod][k]),
                                          np.asarray(v))


def test_legacy_unpadded_names_migrate():
    tm = TL.build(10, device="cpu")
    lin = tnn.Linear(3, 2, name="Linear_00000012")
    tree = {"Linear_12": {"weight": 1}, "conv1_5x5": {"bias": 2}}
    out = migrate_legacy_names(tree, tnn.Sequential(lin, tm))
    assert set(out) == {"Linear_00000012", "conv1_5x5"}


def _corrupt(path, tmp_path, how):
    data = bytearray(open(path, "rb").read())
    bad = str(tmp_path / f"bad_{how}")
    if how == "truncated":
        data = data[:len(data) // 2]
    elif how == "flipped":
        # a byte inside an array entry: the zip CRC catches it
        with zipfile.ZipFile(path) as z:
            info = next(i for i in z.infolist()
                        if i.filename.startswith("arrays/"))
        at = info.header_offset + 30 + len(info.filename) + 8
        data[at] ^= 0xFF
    elif how == "not_a_zip":
        data = b"hello world, not a module file"
    open(bad, "wb").write(bytes(data))
    return bad


@pytest.mark.parametrize("how", ["truncated", "flipped", "not_a_zip"])
def test_a_broken_file_raises(tmp_path, how):
    jm, _ = _ref("lenet5")
    path = str(tmp_path / "m")
    JS.save_module(jm, path)
    with pytest.raises(SerializationError):
        TS.load_module(_corrupt(path, tmp_path, how), device="cpu")


def _rewrite_topology(path, out, edit):
    with zipfile.ZipFile(path) as z:
        entries = {n: z.read(n) for n in z.namelist()}
    topo = json.loads(entries["topology.json"])
    edit(topo)
    entries["topology.json"] = json.dumps(topo).encode()
    with zipfile.ZipFile(out, "w") as z:
        for n, b in entries.items():
            z.writestr(n, b)
    return out


def test_a_v1_pickle_container_is_refused(tmp_path):
    path = str(tmp_path / "v1")
    with open(path, "wb") as f:
        f.write(JS.MAGIC + struct.pack("<H", 1) + b"\x80\x04N.")
    with pytest.raises(SerializationError, match="legacy v1"):
        TS.load_module(path, device="cpu")
    with open(str(tmp_path / "w1"), "wb") as f:
        f.write(b"\x80\x04N.")
    with pytest.raises(SerializationError, match="pickle"):
        TS.load_weights_file(str(tmp_path / "w1"))


def test_a_foreign_class_is_refused(tmp_path):
    jm, _ = _ref("lenet5")
    JS.save_module(jm, str(tmp_path / "m"))

    def foreign(topo):
        topo["nodes"][0]["module"] = "os"
        topo["nodes"][0]["class"] = "system"
    bad = _rewrite_topology(str(tmp_path / "m"), str(tmp_path / "f"),
                            foreign)
    with pytest.raises(SerializationError, match="refusing to import"):
        TS.load_module(bad, device="cpu")


def test_a_class_that_is_not_ported_names_its_roadmap_item(tmp_path):
    jm = jnn.Sequential(jnn.Linear(4, 4), jnn.Sigmoid())
    jm.reset(0)
    JS.save_module(jm, str(tmp_path / "m"))
    with pytest.raises(SerializationError,
                       match=r"Sigmoid.*ROADMAP queue A, item 9"):
        TS.load_module(str(tmp_path / "m"), device="cpu")


def test_a_state_tree_refuses_a_module():
    with pytest.raises(SerializationError, match="save_module"):
        TS.state_file_bytes({"m": tnn.Linear(2, 2)})
