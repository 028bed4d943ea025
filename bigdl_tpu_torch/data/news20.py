"""20-Newsgroups + GloVe loaders (≙ ``bigdl_tpu/data/news20.py``,
pyspark/bigdl/dataset/news20.py).

get_news20 reads the extracted `20news-18828` folder (class-per-subdir of
text files) from a local dir; with no data present returns a synthetic
corpus of class-templated sentences.  get_glove_w2v reads a local GloVe
txt; the fallback returns deterministic random vectors.  Nothing is
downloaded.
"""
from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

CLASS_NUM = 20


def _synthetic_news(n_per_class=8, classes=CLASS_NUM, seed=0):
    rng = np.random.RandomState(seed)
    topics = [f"topic{c} subject{c} theme{c} matter{c}"
              for c in range(classes)]
    filler = ["the quick brown fox", "jumps over", "a lazy dog",
              "hello world example", "sample sentence text"]
    out = []
    for c in range(classes):
        for _ in range(n_per_class):
            words = [topics[c]] + [filler[rng.randint(len(filler))]
                                   for _ in range(rng.randint(3, 8))]
            rng.shuffle(words)
            out.append((" ".join(words), c + 1))  # 1-based labels
    return out


def get_news20(source_dir="./data/news20/") -> List[Tuple[str, int]]:
    """Returns [(text, 1-based label)] (≙ news20.py get_news20)."""
    news_dir = os.path.join(source_dir, "20news-18828")
    if not os.path.isdir(news_dir):
        return _synthetic_news()
    texts = []
    classes = sorted(os.listdir(news_dir))
    for label_id, cname in enumerate(classes, start=1):
        cdir = os.path.join(news_dir, cname)
        if not os.path.isdir(cdir):
            continue
        for fname in sorted(os.listdir(cdir)):
            fpath = os.path.join(cdir, fname)
            try:
                with open(fpath, encoding="latin-1") as f:
                    content = f.read()
                texts.append((content, label_id))
            except OSError:
                continue
    return texts


def get_glove_w2v(source_dir="./data/news20/", dim=100) -> Dict[str, np.ndarray]:
    """Returns {word: vector} (≙ news20.py get_glove_w2v)."""
    glove_path = os.path.join(source_dir, "glove.6B",
                              f"glove.6B.{dim}d.txt")
    if not os.path.exists(glove_path):
        rng = np.random.RandomState(0)
        vocab = ([f"topic{c}" for c in range(CLASS_NUM)]
                 + "the quick brown fox jumps over a lazy dog hello world "
                   "example sample sentence text subject theme matter".split())
        return {w: rng.randn(dim).astype(np.float32) for w in vocab}
    w2v = {}
    with open(glove_path, encoding="latin-1") as f:
        for line in f:
            parts = line.rstrip().split(" ")
            w2v[parts[0]] = np.asarray(parts[1:], np.float32)
    return w2v
