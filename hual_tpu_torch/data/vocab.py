"""Vocabulary tokens (counterpart of ``hual_tpu/data/vocab.py``): word and
char tables both start [PAD, UNK]."""

PAD, UNK = "<PAD>", "<UNK>"
