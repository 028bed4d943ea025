"""The port's prefetch on the CPU: ``DeviceLoader`` (order, how far its
producer runs ahead, an exception re-raised at the consumer, early exit
without a deadlock, the ``dataloader/*`` counters), ``PrefetchedDataSet``,
``HostToDevice`` on the CPU, and ``set_prefetch`` against the same
training without it: the losses and weights must be bitwise equal
(prefetch moves when a batch is copied, not what is computed).  The
CUDA half (pinned ring, side stream, the copy event the step waits on)
runs in ``chip_smoke.py``'s ``phase_distri``.
"""
import threading
import time

import numpy as np
import pytest
import torch

from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.data import (DataSet, DeviceLoader, HostToDevice,
                                  PrefetchedDataSet)
from bigdl_tpu_torch.models import lenet as TL
from bigdl_tpu_torch.models import resnet as TR
from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger


def _wait_for(cond, timeout=5.0):
    t0 = time.monotonic()
    while not cond():
        if time.monotonic() - t0 > timeout:
            return False
        time.sleep(0.005)
    return True


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_device_loader_order_and_depth(depth):
    produced = []

    def source():
        for i in range(20):
            produced.append(i)
            yield i

    it = iter(DeviceLoader(source(), depth))
    assert next(it) == 0
    # the producer fills the queue and holds one more item: never further
    assert _wait_for(lambda: len(produced) >= depth + 1)
    time.sleep(0.05)
    assert len(produced) <= depth + 2
    assert [0] + list(it) == list(range(20))


def test_device_loader_reraises_at_the_consumer():
    def source():
        yield 1
        yield 2
        raise KeyError("bad record")

    got = []
    with pytest.raises(KeyError, match="bad record"):
        for item in DeviceLoader(source(), 2):
            got.append(item)
    assert got == [1, 2]


def test_device_loader_early_exit_stops_the_producer():
    before = {t.ident for t in threading.enumerate()}
    loader = DeviceLoader(iter(range(10 ** 6)), 2)
    it = iter(loader)
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    it.close()          # break / GC
    assert _wait_for(lambda: not [
        t for t in threading.enumerate()
        if t.ident not in before and t.name == "bigdl-torch-device-loader"])
    rec = loader.recorder
    assert rec.counter_value("dataloader/batches") == 3
    assert rec.counter_value("dataloader/stall_seconds") >= 0.0


def test_device_loader_rejects_depth_0():
    with pytest.raises(ValueError, match="depth"):
        DeviceLoader([], 0)


def test_prefetched_dataset_keeps_the_order_and_stops_early():
    x = np.arange(40, dtype=np.float32).reshape(20, 2)
    y = np.arange(20, dtype=np.float32)
    base = DataSet.minibatch_arrays(x, y, 4)
    pre = PrefetchedDataSet(base, depth=2)
    want = [mb.get_target().tolist() for mb in base.data(True, epoch=3)]
    assert [mb.get_target().tolist() for mb in pre.data(True, epoch=3)] \
        == want
    before = {t.ident for t in threading.enumerate()}
    gen = pre.data(True, epoch=3)
    next(gen)
    gen.close()         # stops the loader's thread
    assert _wait_for(lambda: not [
        t for t in threading.enumerate()
        if t.ident not in before and t.name == "bigdl-torch-device-loader"])
    assert pre.size() == 20


def test_host_to_device_on_the_cpu_places_inline():
    stage = HostToDevice("cpu", depth=2)
    x = np.arange(6, dtype=np.float32).reshape(3, 2)
    staged = stage((x, None))
    assert staged.event is None
    tx, ty = staged.take()
    assert ty is None and tx.device.type == "cpu"
    assert torch.equal(tx, torch.from_numpy(x))


def _train(model, x, y, batch, sgd, epochs, depth):
    opt = (LocalOptimizer(model, (x, y), tnn.ClassNLLCriterion(),
                          batch_size=batch, device="cpu")
           .set_optim_method(SGD(**sgd))
           .set_end_when(Trigger.max_epoch(epochs)))
    if depth:
        opt.set_prefetch(depth)
    losses = []
    fire = opt._fire_mid_epoch

    def hook():
        losses.append(float(opt.state.loss))
        return fire()
    opt._fire_mid_epoch = hook
    opt.optimize()
    return (losses, [w.detach().clone() for w in model.get_weights()],
            opt.recorder)


@pytest.mark.parametrize("depth", [1, 2])
def test_set_prefetch_leaves_lenet_bitwise(depth):
    rs = np.random.RandomState(0)
    x = rs.randn(40, 784).astype(np.float32)
    y = (rs.randint(0, 10, 40) + 1).astype(np.float32)
    runs = [_train(TL.build(10, device="cpu", seed=0), x, y, 8,
                   dict(learning_rate=0.05), 2, d) for d in (0, depth)]
    (l0, w0, _), (l1, w1, rec) = runs
    assert len(l0) == 10 and l0 == l1
    assert all(torch.equal(a, b) for a, b in zip(w0, w1))
    assert rec.counter_value("dataloader/batches") == 10


def test_set_prefetch_leaves_resnet8_bitwise():
    """BN state and momentum too: NHWC ResNet-8, 3 steps."""
    rs = np.random.RandomState(1)
    x = rs.randn(12, 32, 32, 3).astype(np.float32)
    y = (rs.randint(0, 10, 12) + 1).astype(np.float32)
    sgd = dict(learning_rate=0.1, momentum=0.9, weight_decay=1e-4)
    models = [TR.build(class_num=10, depth=8, dataset="cifar10",
                       format="NHWC", device="cpu", seed=2) for _ in range(2)]
    (l0, w0, _), (l1, w1, _) = [_train(m, x, y, 4, sgd, 1, d)
                                for m, d in zip(models, (0, 2))]
    assert l0 == l1 and len(l0) == 3
    assert all(torch.equal(a, b) for a, b in zip(w0, w1))
    assert all(torch.equal(a, b) for a, b in zip(models[0].state_list(),
                                                 models[1].state_list()))
