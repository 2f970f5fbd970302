"""Console + file logging (counterpart of ``hual_tpu/runtime/logger.py``)."""

from __future__ import annotations

import logging
import os
import time


def get_logger(log_dir: str, tag: str) -> logging.Logger:
    """One logger (and one open log file) per (log_dir, tag) per process.

    The logger's name carries no timestamp, so a loop that calls this every
    round reuses its handlers; the file name is stamped at the first call.
    """
    os.makedirs(log_dir, exist_ok=True)
    logger = logging.getLogger(f"hual_tpu_torch.{tag}.{os.path.abspath(log_dir)}")
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    if not logger.handlers:
        stamp = time.strftime("%Y%m%d_%H%M%S", time.localtime())
        fmt = logging.Formatter("%(levelname)s:%(message)s")
        ch = logging.StreamHandler()
        ch.setFormatter(fmt)
        logger.addHandler(ch)
        fh = logging.FileHandler(os.path.join(log_dir, f"{stamp}_{tag}.log"))
        fh.setFormatter(fmt)
        fh.setLevel(logging.INFO)
        logger.addHandler(fh)
    return logger
