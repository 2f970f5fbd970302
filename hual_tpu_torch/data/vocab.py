"""Vocabulary and GloVe embedding matrix (counterpart of
``hual_tpu/data/vocab.py``).

One streaming pass over the GloVe file keeps the vectors of corpus words
only; rows are ordered by corpus frequency.  Word and char tables both start
[PAD, UNK].
"""

from __future__ import annotations

import codecs
from collections import Counter

import numpy as np

PAD, UNK = "<PAD>", "<UNK>"


def count_corpus(datasets) -> tuple[Counter, Counter]:
    """Word and character counters over processed record lists."""
    word_counter: Counter = Counter()
    char_counter: Counter = Counter()
    for data in datasets:
        if data is None:
            continue
        for record in data:
            for word in record["words"]:
                word_counter[word] += 1
                for ch in word:
                    char_counter[ch] += 1
    return word_counter, char_counter


def load_glove_for_words(glove_path: str, words: set[str], dim: int = 300
                         ) -> dict[str, np.ndarray]:
    """word -> vector for the corpus words present in GloVe.  Header and
    malformed lines are skipped; of duplicate tokens the LAST one wins."""
    found: dict[str, np.ndarray] = {}
    with codecs.open(glove_path, mode="r", encoding="utf-8") as f:
        for line in f:
            parts = line.lstrip().rstrip().split(" ")
            if len(parts) == 2 or len(parts) != dim + 1:
                continue
            word = parts[0]
            if word in words:
                found[word] = np.asarray([float(x) for x in parts[1:]],
                                         dtype=np.float32)
    return found


def vocab_emb_gen(datasets, glove_path: str, word_dim: int = 300,
                  char_min_count: int = 5):
    """Word/char dicts and the GloVe matrix.

    Word vocab = [PAD, UNK] + corpus words found in GloVe, by corpus
    frequency; ``vectors`` has no PAD/UNK rows (the model adds them).  Char
    vocab = [PAD, UNK] + chars seen at least ``char_min_count`` times.
    """
    word_counter, char_counter = count_corpus(datasets)
    glove_vectors = load_glove_for_words(glove_path, set(word_counter),
                                         dim=word_dim)

    word_vocab = [w for w, _ in word_counter.most_common() if w in glove_vectors]
    vectors = np.zeros((len(word_vocab), word_dim), dtype=np.float32)
    for i, w in enumerate(word_vocab):
        vectors[i] = glove_vectors[w]

    word_dict = {w: i for i, w in enumerate([PAD, UNK] + word_vocab)}
    char_vocab = [PAD, UNK] + [c for c, n in char_counter.most_common()
                               if n >= char_min_count]
    char_dict = {c: i for i, c in enumerate(char_vocab)}
    return word_dict, char_dict, vectors
