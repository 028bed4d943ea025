"""The port's image pipeline, samples, datasets, sequence files and device
augmentation against the reference's, on the same numpy inputs.

Tolerances: the host transformers are numpy on both sides with the same
``RandomState`` draws, so every image, sample and batch is compared
bitwise; so are the sequence files (byte for byte) and the record
datasets.  The device augmentation is held bitwise against the
reference's ``lax.dynamic_slice`` crops, ``center_crop``, ``normalize``
and ``to_nchw`` at the same offsets and flips: the crop and flip move
bytes, and the normalization is one fp32 subtract and one fp32 divide on
each side.
"""
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from bigdl_tpu.data import cifar as jcifar
from bigdl_tpu.data import dataset as jds
from bigdl_tpu.data import device_augment as jaug
from bigdl_tpu.data import image as jimg
from bigdl_tpu.data import minibatch as jmb
from bigdl_tpu.data import mnist as jmnist
from bigdl_tpu.data.prefetch import FileRecordDataSet as JFileRecordDataSet
from bigdl_tpu.utils import seqfile as jseq
from bigdl_tpu_torch.data import cifar as tcifar
from bigdl_tpu_torch.data import dataset as tds
from bigdl_tpu_torch.data import device_augment as taug
from bigdl_tpu_torch.data import image as timg
from bigdl_tpu_torch.data import minibatch as tmb
from bigdl_tpu_torch.data import mnist as tmnist
from bigdl_tpu_torch.data.prefetch import FileRecordDataSet
from bigdl_tpu_torch.utils import seqfile as tseq


def _images(seed, n=5, h=14, w=11, grey=False):
    rs = np.random.RandomState(seed)
    shape = (n, h, w) if grey else (n, h, w, 3)
    return rs.randint(0, 256, shape).astype(np.uint8), \
        rs.randint(1, 11, n).astype(np.float64)


def _run(mod, make, items):
    """``make(mod)`` applied to ``items`` (built fresh per package)."""
    return list(make(mod)(iter(items)))


def _same(a, b):
    assert len(a) == len(b)
    for u, v in zip(a, b):
        if isinstance(u, (timg.LabeledBGRImage, timg.LabeledGreyImage)):
            assert u.label == v.label
            np.testing.assert_array_equal(u.data, v.data)
            assert u.data.dtype == v.data.dtype
        elif isinstance(u, tmb.Sample):
            for fu, fv in zip(u.features + u.labels, v.features + v.labels):
                np.testing.assert_array_equal(fu, fv)
                assert fu.dtype == fv.dtype
        elif isinstance(u, tmb.MiniBatch):
            np.testing.assert_array_equal(u.get_input(), v.get_input())
            np.testing.assert_array_equal(u.get_target(), v.get_target())
        else:
            assert u == v


BGR_CHAINS = {
    "decode": lambda m: m.BytesToBGRImg(),
    "decode_norm": lambda m: m.BytesToBGRImg(normalize=255.0),
    "crop_random": lambda m: m.BytesToBGRImg() >> m.BGRImgCropper(
        7, 9, seed=3),
    "crop_center": lambda m: m.BytesToBGRImg() >> m.BGRImgCropper(
        7, 9, crop_method="center"),
    "rdm_crop": lambda m: m.BytesToBGRImg() >> m.BGRImgRdmCropper(
        11, 14, padding=4, seed=5),
    "hflip": lambda m: m.BytesToBGRImg() >> m.HFlip(0.5, seed=2),
    "normalize": lambda m: m.BytesToBGRImg() >> m.BGRImgNormalizer(
        (103.9, 116.8, 123.7), (57.4, 57.1, 58.4)),
    "pixel_norm": lambda m: m.BytesToBGRImg() >> m.BGRImgPixelNormalizer(
        np.random.RandomState(9).rand(14, 11, 3).astype(np.float32) * 100),
    "color_jitter": lambda m: m.BytesToBGRImg() >> m.ColorJitter(seed=4),
    "lighting": lambda m: m.BytesToBGRImg() >> m.Lighting(seed=6),
    "chain": lambda m: (m.BytesToBGRImg() >> m.BGRImgCropper(8, 8, seed=1)
                        >> m.HFlip(seed=1) >> m.ColorJitter(seed=1)
                        >> m.Lighting(seed=1)
                        >> m.BGRImgNormalizer((1, 2, 3), (4, 5, 6))),
    "to_sample_rgb": lambda m: m.BytesToBGRImg() >> m.BGRImgToSample(),
    "to_sample_bgr": lambda m: m.BytesToBGRImg() >> m.BGRImgToSample(
        to_rgb=False),
    "to_batch": lambda m: m.BytesToBGRImg() >> m.BGRImgToBatch(2),
    "to_batch_drop": lambda m: m.BytesToBGRImg() >> m.BGRImgToBatch(
        2, to_rgb=False, drop_last=True),
}


@pytest.mark.parametrize("name", sorted(BGR_CHAINS))
def test_bgr_transformers_bitwise(name):
    imgs, labels = _images(7)
    items = list(zip(imgs, labels))
    got = _run(timg, BGR_CHAINS[name], items)
    want = _run(jimg, BGR_CHAINS[name], items)
    _same(got, want)


GREY_CHAINS = {
    "decode": lambda m: m.BytesToGreyImg(),
    "crop": lambda m: m.BytesToGreyImg() >> m.GreyImgCropper(6, 6, seed=2),
    "normalize": lambda m: m.BytesToGreyImg() >> m.GreyImgNormalizer(
        33.3, 78.5),
    "to_sample": lambda m: m.BytesToGreyImg() >> m.GreyImgToSample(),
    "to_batch": lambda m: m.BytesToGreyImg(normalize=255.0)
    >> m.GreyImgToBatch(3),
}


@pytest.mark.parametrize("name", sorted(GREY_CHAINS))
def test_grey_transformers_bitwise(name):
    imgs, labels = _images(8, grey=True)
    items = list(zip(imgs, labels))
    _same(_run(timg, GREY_CHAINS[name], items),
          _run(jimg, GREY_CHAINS[name], items))


def test_normalizers_from_dataset():
    imgs, labels = _images(9)
    bgr = [timg.LabeledBGRImage(i.astype(np.float32), l)
           for i, l in zip(imgs, labels)]
    jbgr = [jimg.LabeledBGRImage(i.astype(np.float32), l)
            for i, l in zip(imgs, labels)]
    t = timg.BGRImgNormalizer.from_dataset(bgr, samples=4)
    j = jimg.BGRImgNormalizer.from_dataset(jbgr, samples=4)
    np.testing.assert_array_equal(t.mean, j.mean)
    np.testing.assert_array_equal(t.std, j.std)
    grey, _ = _images(9, grey=True)
    tg = timg.GreyImgNormalizer.from_dataset(
        [timg.LabeledGreyImage(g) for g in grey])
    jg = jimg.GreyImgNormalizer.from_dataset(
        [jimg.LabeledGreyImage(g) for g in grey])
    assert (tg.mean, tg.std) == (jg.mean, jg.std)


def test_encoded_bytes_and_local_image_folder(tmp_path):
    """The PIL paths: encoded PNG bytes decode to BGR, and a class-per-
    folder tree reads with its short edge scaled."""
    from PIL import Image
    imgs, labels = _images(10, n=4, h=20, w=30)
    pngs = []
    for k, img in enumerate(imgs):
        buf = io.BytesIO()
        Image.fromarray(img[..., ::-1].copy()).save(buf, format="PNG")
        pngs.append(buf.getvalue())
        d = tmp_path / f"class{k % 2}"
        d.mkdir(exist_ok=True)
        Image.fromarray(img).save(d / f"img{k}.png")
    items = list(zip(pngs, labels))
    got = _run(timg, lambda m: m.BytesToBGRImg(), items)
    _same(got, _run(jimg, lambda m: m.BytesToBGRImg(), items))
    np.testing.assert_array_equal(got[0].data, imgs[0].astype(np.float32))
    grey = _run(timg, lambda m: m.BytesToGreyImg(), items)
    _same(grey, _run(jimg, lambda m: m.BytesToGreyImg(), items))
    paths = timg.local_image_paths(str(tmp_path))
    assert paths == jimg.local_image_paths(str(tmp_path))
    assert [p[1] for p in paths] == [1.0, 1.0, 2.0, 2.0]
    _same(_run(timg, lambda m: m.LocalImgReader(12), paths),
          _run(jimg, lambda m: m.LocalImgReader(12), paths))


def test_seqfile_bytes_equal_and_each_side_reads_the_other(tmp_path):
    """For the same path and ``sync_seed`` the port writes the reference's
    bytes (the sync marker hashes both); each side reads the other's
    file."""
    records = [(f"{k}".encode(), np.random.RandomState(k).bytes(3000 + k))
               for k in range(9)]                # crosses SYNC_INTERVAL
    for cls in (tseq.TEXT_CLASS, tseq.BYTES_CLASS):
        path = str(tmp_path / f"{cls[-4:]}.seq")
        files = {}
        for name, mod in (("port", tseq), ("ref", jseq)):
            with mod.SequenceFileWriter(path, value_class=cls,
                                        sync_seed=3) as w:
                for k, v in records:
                    w.append(k, v)
            files[name] = path + f".{name}"
            os.replace(path, files[name])
        assert open(files["port"], "rb").read() == \
            open(files["ref"], "rb").read()
        assert list(tseq.SequenceFileReader(files["ref"])) == records
        assert list(jseq.SequenceFileReader(files["port"])) == records
        assert tseq.read_seq_pairs(files["port"]) == \
            jseq.read_seq_pairs(files["port"])
    for v in (0, 1, -1, 127, -112, -113, 128, 300, -300, 2 ** 40, -2 ** 40):
        enc = tseq.write_vint(v)
        assert enc == jseq.write_vint(v)
        assert tseq.read_vint(enc, 0) == (v, len(enc))


def test_image_seqfile_round_trip_against_the_reference(tmp_path):
    imgs, labels = _images(11, n=5)
    base = [timg.LabeledBGRImage(i.astype(np.float32), l)
            for i, l in zip(imgs, labels)]
    names = list(timg.BGRImgToLocalSeqFile(2, str(tmp_path / "t"))(base))
    jbase = [jimg.LabeledBGRImage(i.astype(np.float32), l)
             for i, l in zip(imgs, labels)]
    jnames = list(jimg.BGRImgToLocalSeqFile(2, str(tmp_path / "j"))(jbase))
    assert [os.path.basename(n)[1:] for n in names] == \
        [os.path.basename(n)[1:] for n in jnames]
    got = list(timg.LocalSeqFileToBytes()(jnames))
    want = list(jimg.LocalSeqFileToBytes()(names))
    assert len(got) == len(want) == 5
    for (a, la), (b, lb), img, lab in zip(got, want, imgs, labels):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, img)
        assert la == lb == lab


def test_samples_and_padding_as_the_reference():
    rs = np.random.RandomState(12)
    feats = [rs.rand(rs.randint(2, 6), 3).astype(np.float32)
             for _ in range(4)]
    labs = [rs.randint(1, 5, rs.randint(1, 4)).astype(np.float32)
            for _ in range(4)]
    for fp, lp in ((None, None),
                   ((-1.0, 8), (0.0, [5])),
                   ((2.5, [None, 4]), None)):
        args = []
        for mod in (tmb, jmb):
            samples = [mod.Sample(f, l) for f, l in zip(feats, labs)]
            pad = [None if p is None else mod.PaddingParam(*p)
                   for p in (fp, lp)]
            args.append(mod.samples_to_minibatch(samples, *pad))
        _same([args[0]], [args[1]])
    s = tmb.Sample([feats[0], feats[1]], 3.0)
    assert len(s.features) == 2 and s.label() == 3.0 and s.feature(1) is \
        s.features[1]
    multi = tmb.samples_to_minibatch([s, s])
    assert isinstance(multi.get_input(), list)
    mb = tmb.MiniBatch(np.arange(10).reshape(5, 2), np.arange(5))
    np.testing.assert_array_equal(mb.slice(2, 3).get_input(),
                                  np.arange(2, 8).reshape(3, 2))


def test_datasets_and_transformers_as_the_reference():
    rs = np.random.RandomState(13)
    xs = rs.rand(23, 4).astype(np.float32)
    ys = rs.randint(1, 4, 23).astype(np.float32)

    def run(mod, epoch):
        samples = [mod.Sample(x, y) for x, y in zip(xs, ys)]
        ds = mod.DataSet.array(samples) >> mod.SampleToMiniBatch(5)
        fn = mod.FunctionTransformer(
            lambda mb: mod.MiniBatch(mb.get_input() * 2, mb.get_target()))
        dist = mod.DistributedDataSet(ds.transform(fn), num_shards=2)
        return list(dist.data(train=True, epoch=epoch)), \
            list(mod.LocalArrayDataSet(samples, shuffle=False).data(False))

    for epoch in (1, 2):
        (got, plain_t), (want, plain_j) = run(tds, epoch), run(jds, epoch)
        _same(got, want)
        _same(plain_t, plain_j)
        # every batch divides by the shard count; 23 samples in batches
        # of 5 leave one of 3, cut to 2
        assert [mb.size() for mb in got] == [4, 4, 4, 4, 2]
    # a different epoch gives another order
    assert not np.array_equal(run(tds, 1)[0][0].get_input(),
                              run(tds, 2)[0][0].get_input())
    chained = tds.FunctionTransformer(lambda v: v + 1).then(
        tds.FunctionTransformer(lambda v: v * 3))
    assert list(chained([1, 2])) == [6, 9]
    with pytest.raises(TypeError):
        tds.FunctionTransformer(abs) > tds.FunctionTransformer(abs)


def _records(tmp_path, n_files, per_file, h=10, w=12):
    rs = np.random.RandomState(14)
    paths, recs = [], []
    for fi in range(n_files):
        p = tmp_path / f"rec{fi}.bin"
        with open(p, "wb") as f:
            for _ in range(per_file):
                lab = int(rs.randint(1, 11))
                px = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
                rec = np.int32(lab).tobytes() + px.tobytes()
                f.write(rec)
                recs.append(rec)
        paths.append(str(p))
    return paths, recs, 4 + h * w * 3


def _decode(mod, h=10, w=12):
    def decode(rec):
        label = np.frombuffer(rec, "<i4", 1)[0]
        px = np.frombuffer(rec, np.uint8, offset=4).reshape(h, w, 3)
        return mod.Sample(px, np.float32(label))
    return decode


@pytest.mark.parametrize("workers", [1, 3])
def test_file_record_dataset_as_the_reference(tmp_path, workers):
    paths, recs, size = _records(tmp_path, 3, 7)
    got = list((FileRecordDataSet(paths, size, _decode(tmb),
                                  n_workers=workers, capacity=4)
                >> tds.SampleToMiniBatch(4)).data(train=True, epoch=1))
    ds = JFileRecordDataSet(paths, size, _decode(jmb), n_workers=workers,
                            capacity=4)
    want = list(ds.transform(jds.SampleToMiniBatch(4)).data(train=True))
    assert FileRecordDataSet(paths, size, None).size() == ds.size() == 21
    assert [mb.size() for mb in got] == [4, 4, 4, 4, 4, 1]
    if workers == 1:
        _same(got, want)
    key = lambda mb: [(float(t), x.tobytes()) for x, t in
                      zip(mb.get_input(), mb.get_target())]
    assert sorted(sum((key(mb) for mb in got), [])) == \
        sorted(sum((key(mb) for mb in want), []))
    assert got[0].get_input().dtype == np.uint8


def test_mnist_and_cifar_synthetic_as_the_reference():
    for t, j in ((tmnist, jmnist), (tcifar, jcifar)):
        (xt, yt), (xe, ye) = t.load_data()
        for a, b in zip((xt, yt, xe, ye), (*j._synthetic(2048, 0),
                                           *j._synthetic(512, 1))):
            np.testing.assert_array_equal(a, b)
    assert tcifar.TRAIN_MEAN == jcifar.TRAIN_MEAN
    assert tmnist.TRAIN_STD == jmnist.TRAIN_STD


AUG_MEAN, AUG_STD = (103.53, 116.28, 123.675), (57.375, 57.12, 58.395)


def _aug_batch(seed=15, n=6, h=20, w=18, crop=(16, 12)):
    rs = np.random.RandomState(seed)
    x = rs.randint(0, 256, (n, h, w, 3)).astype(np.uint8)
    oy = rs.randint(0, h - crop[0] + 1, n)
    ox = rs.randint(0, w - crop[1] + 1, n)
    flips = rs.rand(n) < 0.5
    return x, oy, ox, flips


def _ref_at(x, oy, ox, flips, crop, fmt="NCHW"):
    """The reference's ops at given offsets and flips: the
    ``lax.dynamic_slice`` crop of ``random_crop``, the ``jnp.where`` flip
    of ``random_hflip``, then ``normalize`` and ``to_nchw``."""
    xj = jnp.asarray(x)
    ch, cw = crop
    out = jax.vmap(lambda img, y0, x0: lax.dynamic_slice(
        img, (y0, x0, 0), (ch, cw, 3)))(xj, jnp.asarray(oy), jnp.asarray(ox))
    out = jnp.where(jnp.asarray(flips)[:, None, None, None],
                    out[:, :, ::-1], out)
    out = jaug.normalize(out, AUG_MEAN, AUG_STD)
    return np.asarray(jaug.to_nchw(out) if fmt == "NCHW" else out)


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_device_augment_at_given_draws_bitwise(fmt):
    x, oy, ox, flips = _aug_batch()
    aug = taug.DeviceAugment(crop=(16, 12), flip=True, mean=AUG_MEAN,
                             std=AUG_STD, out_format=fmt)
    got = aug.apply(torch.from_numpy(x), torch.from_numpy(oy),
                    torch.from_numpy(ox), torch.from_numpy(flips))
    np.testing.assert_array_equal(got.numpy(),
                                  _ref_at(x, oy, ox, flips, (16, 12), fmt))
    # the functions one by one
    xt = torch.from_numpy(x)
    crop = taug.crop_at(xt, torch.from_numpy(oy), torch.from_numpy(ox),
                        16, 12)
    flipped = taug.hflip_at(crop, torch.from_numpy(flips))
    np.testing.assert_array_equal(
        taug.to_nchw(taug.normalize(flipped, AUG_MEAN, AUG_STD)).numpy(),
        _ref_at(x, oy, ox, flips, (16, 12)))
    # eval: the center crop
    want = jaug.to_nchw(jaug.normalize(jaug.center_crop(jnp.asarray(x), 16,
                                                        12),
                                       AUG_MEAN, AUG_STD))
    ev = aug(xt, training=False)
    np.testing.assert_array_equal(
        (ev if fmt == "NCHW" else taug.to_nchw(ev)).numpy(), np.asarray(want))
    np.testing.assert_array_equal(taug.center_crop(xt, 16, 12).numpy(),
                                  np.asarray(jaug.center_crop(
                                      jnp.asarray(x), 16, 12)))


def test_device_augment_matches_the_host_transformers():
    """The device path at the draws the host transformers made (their
    ``RandomState`` replayed) equals ``BGRImgCropper`` → ``HFlip`` →
    ``BGRImgNormalizer`` → ``BGRImgToBatch(to_rgb=False)``, bitwise."""
    x, _, _, _ = _aug_batch(16)
    labels = np.arange(1, 7, dtype=np.float64)
    host = (timg.BytesToBGRImg() >> timg.BGRImgCropper(12, 16, seed=21)
            >> timg.HFlip(0.5, seed=22)
            >> timg.BGRImgNormalizer(AUG_MEAN, AUG_STD)
            >> timg.BGRImgToBatch(6, to_rgb=False))
    (mb,) = list(host(zip(x, labels)))
    crop_rng, flip_rng = np.random.RandomState(21), np.random.RandomState(22)
    oy, ox, flips = [], [], []
    for _ in range(6):
        oy.append(crop_rng.randint(0, 20 - 16 + 1))
        ox.append(crop_rng.randint(0, 18 - 12 + 1))
        flips.append(flip_rng.uniform() < 0.5)
    aug = taug.DeviceAugment(crop=(16, 12), flip=True, mean=AUG_MEAN,
                             std=AUG_STD)
    got = aug.apply(torch.from_numpy(x), torch.tensor(oy), torch.tensor(ox),
                    torch.tensor(flips))
    assert any(flips) and not all(flips)
    np.testing.assert_array_equal(got.numpy(), mb.get_input())


def test_device_augment_draws_from_its_generator():
    x, _, _, _ = _aug_batch(17, n=64)
    xt = torch.from_numpy(x)
    aug = taug.DeviceAugment(crop=(16, 12), flip=True, dtype=torch.bfloat16)
    a = aug(xt, torch.Generator().manual_seed(5))
    b = aug(xt, torch.Generator().manual_seed(5))
    c = aug(xt, torch.Generator().manual_seed(6))
    assert a.dtype == torch.bfloat16 and a.shape == (64, 3, 16, 12)
    assert torch.equal(a, b) and not torch.equal(a, c)
    oy, ox, flips = aug.draw(xt, torch.Generator().manual_seed(5))
    assert int(oy.max()) <= 4 and int(ox.max()) <= 6
    assert 0 < int(flips.sum()) < 64
    assert torch.equal(aug.apply(xt, oy, ox, flips), a)
    with pytest.raises(ValueError, match="gen="):
        aug(xt)
