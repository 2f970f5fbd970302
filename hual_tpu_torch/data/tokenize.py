"""Query tokenization (counterpart of ``hual_tpu/data/tokenize.py``).

The same fallback chain: ``nltk.word_tokenize`` when its punkt model is
present, else nltk's Treebank tokenizer over the whole query, else a
pure-python ``\\w+|[^\\w\\s]`` splitter where nltk is not installed.
"""

from __future__ import annotations

import functools
from typing import Callable, List


@functools.cache
def _tokenizer() -> Callable[[str], List[str]]:
    try:
        from nltk.tokenize import word_tokenize

        word_tokenize("probe sentence.", language="english")
        return lambda s: word_tokenize(s, language="english")
    except Exception:
        try:
            from nltk.tokenize import TreebankWordTokenizer

            return TreebankWordTokenizer().tokenize
        except Exception:
            import re

            pattern = re.compile(r"\w+|[^\w\s]")
            return pattern.findall


def tokenize(sentence: str) -> List[str]:
    """Lower-cased word tokenization of one query."""
    return _tokenizer()(sentence.strip().lower())
