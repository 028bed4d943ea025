"""Text pipeline (≙ ``bigdl_tpu/data/text.py``; dataset/text/:
SentenceSplitter, SentenceTokenizer, SentenceBiPadding, Dictionary,
TextToLabeledSentence, LabeledSentenceToSample).

Host-side preprocessing in plain Python and numpy; sequences end up as
padded index arrays.  A regex tokenizer and sentence splitter stand in
for the reference's Apache OpenNLP models, with the same pipeline
semantics.  The vocabulary keeps ``Counter.most_common`` order (ties in
first-seen order) and maps an out-of-vocabulary word to ``vocab_size``.
"""
from __future__ import annotations

import json
import os
import re
from collections import Counter
from typing import Iterable, List, Optional, Sequence

import numpy as np

from .dataset import Transformer
from .minibatch import Sample

SENTENCE_START = "SENTENCESTART"
SENTENCE_END = "SENTENCEEND"


class LabeledSentence:
    """Token-index sequence + per-step or scalar label
    (≙ text/Types.scala LabeledSentence)."""

    def __init__(self, data: Sequence[float], label: Sequence[float]):
        self.data = np.asarray(data, np.float32)
        self.label = np.asarray(label, np.float32)

    def data_length(self):
        return len(self.data)

    def label_length(self):
        return len(self.label)


class SentenceSplitter(Transformer):
    """Text blob -> sentences (≙ text/SentenceSplitter.scala; regex instead
    of the reference's OpenNLP model download)."""

    _pat = re.compile(r"(?<=[.!?])\s+")

    def apply_iter(self, it):
        for text in it:
            for s in self._pat.split(text.strip()):
                if s:
                    yield s


class SentenceTokenizer(Transformer):
    """Sentence -> token list (≙ text/SentenceTokenizer.scala)."""

    _pat = re.compile(r"[A-Za-z0-9']+|[.,!?;:]")

    def __init__(self, lower: bool = True):
        self.lower = lower

    def tokenize(self, sentence: str) -> List[str]:
        toks = self._pat.findall(sentence)
        return [t.lower() for t in toks] if self.lower else toks

    def apply_iter(self, it):
        for s in it:
            yield self.tokenize(s)


class SentenceBiPadding(Transformer):
    """tokens -> [start] + tokens + [end]
    (≙ text/SentenceBiPadding.scala)."""

    def __init__(self, start: Optional[str] = None, end: Optional[str] = None):
        self.start = start or SENTENCE_START
        self.end = end or SENTENCE_END

    def apply_iter(self, it):
        for toks in it:
            if isinstance(toks, str):
                yield f"{self.start} {toks} {self.end}"
            else:
                yield [self.start] + list(toks) + [self.end]


class Dictionary:
    """Top-k vocabulary with discard list (≙ text/Dictionary.scala).
    Out-of-vocab words map to index `vocab_size` (the reference's
    getOrElse(word, _vocabSize))."""

    def __init__(self, sentences: Optional[Iterable[Sequence[str]]] = None,
                 vocab_size: Optional[int] = None):
        self._word2index = {}
        self._index2word = {}
        self._discard_vocab: List[str] = []
        if sentences is not None:
            freq = Counter()
            for toks in sentences:
                freq.update(toks)
            ordered = [w for w, _ in freq.most_common()]
            keep = ordered if vocab_size is None else ordered[:vocab_size]
            self._discard_vocab = [] if vocab_size is None \
                else ordered[vocab_size:]
            for i, w in enumerate(keep):
                self._word2index[w] = i
                self._index2word[i] = w

    # ≙ Dictionary.scala API
    def get_vocab_size(self) -> int:
        return len(self._word2index)

    def get_discard_size(self) -> int:
        return len(self._discard_vocab)

    def vocabulary(self) -> List[str]:
        return [self._index2word[i] for i in range(len(self._index2word))]

    def discard_vocab(self) -> List[str]:
        return list(self._discard_vocab)

    def get_index(self, word: str) -> int:
        return self._word2index.get(word, len(self._word2index))

    def get_word(self, index: int) -> str:
        if index in self._index2word:
            return self._index2word[index]
        if self._discard_vocab:
            return self._discard_vocab[
                np.random.randint(len(self._discard_vocab))]
        return self._index2word[np.random.randint(len(self._index2word))]

    def word2index(self):
        return dict(self._word2index)

    def index2word(self):
        return dict(self._index2word)

    def save(self, folder: str):
        os.makedirs(folder, exist_ok=True)
        with open(os.path.join(folder, "dictionary.json"), "w") as f:
            json.dump({"word2index": self._word2index,
                       "discard": self._discard_vocab}, f)

    @staticmethod
    def load(folder: str) -> "Dictionary":
        d = Dictionary()
        with open(os.path.join(folder, "dictionary.json")) as f:
            blob = json.load(f)
        d._word2index = {k: int(v) for k, v in blob["word2index"].items()}
        d._index2word = {v: k for k, v in d._word2index.items()}
        d._discard_vocab = blob["discard"]
        return d


class TextToLabeledSentence(Transformer):
    """Token list -> LabeledSentence for next-word LM training: data =
    indices[:-1], label = indices[1:]
    (≙ text/TextToLabeledSentence.scala)."""

    def __init__(self, dictionary: Dictionary):
        self.dictionary = dictionary

    def apply_iter(self, it):
        for toks in it:
            idx = [self.dictionary.get_index(t) for t in toks]
            if len(idx) < 2:
                continue
            yield LabeledSentence(idx[:-1], idx[1:])


class LabeledSentenceToSample(Transformer):
    """LabeledSentence -> Sample; either one-hot features (vocab_length set)
    or raw index features; pads to fixed lengths
    (≙ text/LabeledSentenceToSample.scala)."""

    def __init__(self, vocab_length: Optional[int] = None,
                 fixed_data_length: Optional[int] = None,
                 fixed_label_length: Optional[int] = None):
        self.vocab_length = vocab_length
        self.fixed_data_length = fixed_data_length
        self.fixed_label_length = fixed_label_length

    def apply_iter(self, it):
        for s in it:
            dlen = self.fixed_data_length or s.data_length()
            llen = self.fixed_label_length or s.label_length()
            if self.vocab_length:
                feat = np.zeros((dlen, self.vocab_length), np.float32)
                n = min(s.data_length(), dlen)
                feat[np.arange(n), s.data[:n].astype(np.int64)] = 1.0
                if s.data_length() < dlen:  # pad with the last word one-hot
                    feat[n:, int(s.data[n - 1])] = 1.0
            else:
                feat = np.zeros(dlen, np.float32)
                n = min(s.data_length(), dlen)
                feat[:n] = s.data[:n]
            # labels are 1-based for ClassNLL
            lab = np.full(llen, 1.0, np.float32)
            m = min(s.label_length(), llen)
            lab[:m] = s.label[:m] + 1.0
            yield Sample(feat, lab)


def read_localfile(path: str) -> List[str]:
    """≙ pyspark/bigdl/dataset/sentence.py read_localfile."""
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def sentences_split(line: str) -> List[str]:
    return list(SentenceSplitter()([line]))


def sentences_bipadding(sent: str) -> str:
    return f"{SENTENCE_START} {sent} {SENTENCE_END}"


def sentence_tokenizer(sentences: Iterable[str]) -> List[List[str]]:
    tok = SentenceTokenizer()
    return [tok.tokenize(s) for s in sentences]
