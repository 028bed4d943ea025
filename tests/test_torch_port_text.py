"""The text slice of the port held against the reference on the CPU: the
layers of the text classifiers (``LookupTable``, ``TemporalConvolution``,
``TemporalMaxPooling``, ``Squeeze``) and ``SpatialDilatedConvolution``,
the text pipeline (``data.text``) and the 20-Newsgroups loader
(``data.news20``), and the two example text classifiers layer by layer.

Each layer is built in ``bigdl_tpu`` and in ``bigdl_tpu_torch``, the
reference's weights are loaded into the port by position, and both run on
the same seeded numpy inputs.  Tolerances: outputs and input gradients
within rtol = atol = 2e-5; weight gradients per leaf within
max |Δg| ≤ 1e-4 · max |g|.  Index handling (clamping, masks) and the text
pipeline are compared exactly.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.data import news20 as jnews
from bigdl_tpu.data import text as jtext
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.data import news20 as tnews
from bigdl_tpu_torch.data import text as ttext

from _torch_port_parity import (assert_close, assert_grads, cross,
                                layer_walk, port_run, rand, ref_run)

TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_REL = 1e-4


def _pair(jm, tm, x, seed=0):
    """Forward, input gradient and weight gradients of both; returns the
    port's output."""
    params, state = cross(jm, tm, seed)
    y = jm.run(params, jnp.asarray(x), state=state)[0]
    dy = rand(seed + 1, np.shape(y))
    yj, gj, gxj, _ = ref_run(jm, params, x, dy, state)
    yt, gt, gxt, _ = port_run(tm, x, dy, tm.initial_state())
    assert yt.shape == yj.shape
    assert_close(yt, yj, "output", **TOL)
    assert_close(gxt, gxj, "input gradient", **TOL)
    assert_grads(gt, gj, GRAD_REL)
    return yt


# --------------------------------------------------------------------- #
# layers                                                                #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("kw", [dict(), dict(dim=2), dict(dim=(2, 4)),
                                dict(dim=1, batch_mode=True),
                                dict(dim=-1), dict(dim=(1, 3),
                                                   batch_mode=True)])
def test_squeeze(kw):
    x = rand(0, (3, 1, 5, 1))
    y = _pair(jnn.Squeeze(**kw), tnn.Squeeze(**kw), x)
    assert y.shape == np.asarray(jnn.Squeeze(**kw).forward(x)).shape


def test_squeeze_of_a_wide_dim_raises_as_the_reference():
    x = rand(0, (3, 2, 5))
    with pytest.raises(ValueError):
        jnn.Squeeze(2).forward(x)
    with pytest.raises(ValueError):
        tnn.Squeeze(2).forward(torch.from_numpy(x))


@pytest.mark.parametrize("k_w,d_w", [(3, None), (4, 2), (11, 1), (2, 3)])
def test_temporal_max_pooling(k_w, d_w):
    _pair(jnn.TemporalMaxPooling(k_w, d_w), tnn.TemporalMaxPooling(k_w, d_w),
          rand(1, (2, 11, 4)))


@pytest.mark.parametrize("stride", [1, 2])
def test_temporal_convolution(stride):
    jm = jnn.TemporalConvolution(5, 7, 3, stride)
    tm = tnn.TemporalConvolution(5, 7, 3, stride)
    assert tuple(tm.weight.shape) == (7, 5, 3)
    _pair(jm, tm, rand(2, (2, 12, 5)))


@pytest.mark.parametrize("kw", [
    dict(dw=1, dh=1, pad_w=2, pad_h=2, dilation_w=2, dilation_h=2),
    dict(dw=1, dh=2, pad_w=-1, pad_h=-1, dilation_w=2, dilation_h=1),
    dict(dw=2, dh=1, pad_w=0, pad_h=-1, dilation_w=3, dilation_h=2,
         with_bias=False)])
def test_spatial_dilated_convolution(kw):
    _pair(jnn.SpatialDilatedConvolution(3, 4, 3, 3, **kw),
          tnn.SpatialDilatedConvolution(3, 4, 3, 3, **kw),
          rand(3, (2, 3, 9, 10)))


# 1-based ids with 0, past the end and negative ones (clamped)
IDS = np.array([[1, 3, 0, 10, 11], [-3, 5, 5, 2, 7]], np.float32)


@pytest.mark.parametrize("kw", [
    dict(), dict(max_norm=1.0), dict(max_norm=2.5, norm_type=1.0),
    dict(mask_zero=True), dict(mask_zero=True, padding_value=5),
    dict(max_norm=1.0, mask_zero=True, padding_value=3)])
def test_lookup_table(kw):
    jm, tm = jnn.LookupTable(10, 4, **kw), tnn.LookupTable(10, 4, **kw)
    y = _pair(jm, tm, IDS)
    # the table itself is never renormalised
    np.testing.assert_array_equal(tm.weight.detach().numpy(),
                                  np.asarray(jm.get_weights()[0]))
    if kw.get("mask_zero"):
        pv = int(kw.get("padding_value", 0.0))
        assert not y[IDS == pv].any()


def test_lookup_table_clamps_ids():
    jm, tm = jnn.LookupTable(10, 4), tnn.LookupTable(10, 4)
    cross(jm, tm)
    y = tm.forward(torch.from_numpy(IDS)).detach().numpy()
    w = tm.weight.detach().numpy()
    np.testing.assert_array_equal(y[0, 2], w[0])      # id 0 -> row 1
    np.testing.assert_array_equal(y[0, 4], w[9])      # id 11 -> row 10
    np.testing.assert_array_equal(y[1, 0], w[0])      # id -3 -> row 1


def test_lookup_table_keeps_an_integer_input():
    jm, tm = jnn.LookupTable(10, 4), tnn.LookupTable(10, 4)
    cross(jm, tm)
    ids = IDS.astype(np.int64)
    np.testing.assert_array_equal(
        tm.forward(torch.from_numpy(ids)).detach().numpy(),
        np.asarray(jm.forward(ids.astype(np.int32))))


# --------------------------------------------------------------------- #
# the text pipeline and 20-Newsgroups                                   #
# --------------------------------------------------------------------- #
TEXT = ("Hello world! It's a sample, with punctuation; and numbers 42. "
        "Another sentence? Yes.  The END")


def test_tokenizer_splitter_and_bipadding():
    for lower in (True, False):
        assert ttext.SentenceTokenizer(lower).tokenize(TEXT) \
            == jtext.SentenceTokenizer(lower).tokenize(TEXT)
    assert list(ttext.SentenceSplitter()([TEXT, " x. y "])) \
        == list(jtext.SentenceSplitter()([TEXT, " x. y "]))
    toks = [["a", "b"], "c d"]
    assert list(ttext.SentenceBiPadding()(toks)) \
        == list(jtext.SentenceBiPadding()(toks))
    assert list(ttext.SentenceBiPadding("<s>", "</s>")(toks)) \
        == list(jtext.SentenceBiPadding("<s>", "</s>")(toks))
    assert ttext.sentences_split(TEXT) == jtext.sentences_split(TEXT)
    assert ttext.sentences_bipadding("x") == jtext.sentences_bipadding("x")
    sents = jtext.sentences_split(TEXT)
    assert ttext.sentence_tokenizer(sents) == jtext.sentence_tokenizer(sents)


def _corpus():
    docs = [t for t, _ in jnews.get_news20("/nonexistent")]
    return [jtext.SentenceTokenizer().tokenize(d) for d in docs]


@pytest.mark.parametrize("vocab_size", [None, 7, 1000])
def test_dictionary(vocab_size, tmp_path):
    corpus = _corpus()
    jd = jtext.Dictionary(corpus, vocab_size)
    td = ttext.Dictionary(corpus, vocab_size)
    assert td.vocabulary() == jd.vocabulary()
    assert td.discard_vocab() == jd.discard_vocab()
    assert td.get_vocab_size() == jd.get_vocab_size()
    assert td.get_discard_size() == jd.get_discard_size()
    assert td.word2index() == jd.word2index()
    assert td.index2word() == jd.index2word()
    for w in ("the", "topic3", "never-seen"):
        assert td.get_index(w) == jd.get_index(w)
    td.save(str(tmp_path))
    back = jtext.Dictionary.load(str(tmp_path))
    assert back.word2index() == jd.word2index()
    assert back.discard_vocab() == jd.discard_vocab()


@pytest.mark.parametrize("kw", [dict(), dict(vocab_length=12),
                                dict(fixed_data_length=6,
                                     fixed_label_length=4),
                                dict(vocab_length=12, fixed_data_length=9,
                                     fixed_label_length=9)])
def test_labeled_sentences_to_samples(kw):
    corpus = _corpus()[:10] + [["one"]]
    jd = jtext.Dictionary(corpus, 11)
    td = ttext.Dictionary(corpus, 11)
    js = list((jtext.TextToLabeledSentence(jd)
               >> jtext.LabeledSentenceToSample(**kw))(corpus))
    ts = list((ttext.TextToLabeledSentence(td)
               >> ttext.LabeledSentenceToSample(**kw))(corpus))
    assert len(ts) == len(js) == 10            # the 1-token one is dropped
    for a, b in zip(ts, js):
        np.testing.assert_array_equal(a.feature(), b.feature())
        np.testing.assert_array_equal(a.labels[0], b.labels[0])


def test_news20_synthetic_and_glove_fallback():
    assert tnews.get_news20("/nonexistent") == jnews.get_news20(
        "/nonexistent")
    assert tnews.CLASS_NUM == jnews.CLASS_NUM
    for dim in (50, 100):
        tw = tnews.get_glove_w2v("/nonexistent", dim=dim)
        jw = jnews.get_glove_w2v("/nonexistent", dim=dim)
        assert sorted(tw) == sorted(jw)
        for w in jw:
            np.testing.assert_array_equal(tw[w], jw[w])


def test_news20_and_glove_read_local_files(tmp_path):
    news = tmp_path / "20news-18828"
    for c, cls in enumerate(["alt.atheism", "comp.graphics"]):
        (news / cls).mkdir(parents=True)
        for i in range(2):
            (news / cls / f"{i}").write_text(f"doc {c} {i} caf\xe9",
                                             encoding="latin-1")
    glove = tmp_path / "glove.6B"
    glove.mkdir()
    (glove / "glove.6B.50d.txt").write_text(
        "the " + " ".join(["0.5"] * 50) + "\ncat " + " ".join(["-1"] * 50)
        + "\n", encoding="latin-1")
    assert tnews.get_news20(str(tmp_path)) == jnews.get_news20(str(tmp_path))
    tw = tnews.get_glove_w2v(str(tmp_path), dim=50)
    jw = jnews.get_glove_w2v(str(tmp_path), dim=50)
    assert sorted(tw) == sorted(jw) == ["cat", "the"]
    for w in jw:
        np.testing.assert_array_equal(tw[w], jw[w])


# --------------------------------------------------------------------- #
# the examples' text classifiers, layer by layer                        #
# --------------------------------------------------------------------- #
def _textclassifier_cnn(nn, emb=50, seq=64, filters=128, classes=20):
    """``examples/textclassifier.py``'s ``build_cnn``."""
    return nn.Sequential(
        nn.TemporalConvolution(emb, filters, 5), nn.ReLU(),
        nn.TemporalMaxPooling(seq - 5 + 1), nn.Reshape((filters,)),
        nn.Linear(filters, 100), nn.ReLU(),
        nn.Linear(100, classes), nn.LogSoftMax())


def _serving_predictor_model(nn, vocab=40, seq=12, emb=16, classes=3):
    """``examples/serving_predictor.py``'s ``build_model``."""
    return nn.Sequential(
        nn.LookupTable(vocab + 1, emb), nn.TemporalConvolution(emb, 32, 3),
        nn.ReLU(), nn.TemporalMaxPooling(seq - 2, 1), nn.Squeeze(2),
        nn.Linear(32, classes), nn.LogSoftMax())


def test_textclassifier_cnn_layer_by_layer():
    jm, tm = _textclassifier_cnn(jnn), _textclassifier_cnn(tnn)
    params, state = cross(jm, tm, seed=4)
    layer_walk(jm, tm, params, state, rand(5, (4, 64, 50)), training=False)


def test_serving_predictor_model_layer_by_layer():
    jm, tm = _serving_predictor_model(jnn), _serving_predictor_model(tnn)
    params, state = cross(jm, tm, seed=6)
    ids = np.random.RandomState(7).randint(0, 42, (8, 12)).astype(np.float32)
    layer_walk(jm, tm, params, state, ids, training=False)
