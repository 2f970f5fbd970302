"""Console + file logging (counterpart of ``hual_tpu/runtime/logger.py``)."""

from __future__ import annotations

import logging
import os
import time


def get_logger(log_dir: str, tag: str, to_file: bool = True) -> logging.Logger:
    """One logger (and one open log file) per (log_dir, tag) per process.

    The logger's name carries no timestamp, so a loop that calls this every
    round reuses its handlers; the file name is stamped at the first call.
    ``to_file=False`` (the ranks after the first under data parallelism)
    logs to the console only and creates nothing.
    """
    if to_file:
        os.makedirs(log_dir, exist_ok=True)
    logger = logging.getLogger(f"hual_tpu_torch.{tag}.{os.path.abspath(log_dir)}")
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    fmt = logging.Formatter("%(levelname)s:%(message)s")
    if not logger.handlers:
        ch = logging.StreamHandler()
        ch.setFormatter(fmt)
        logger.addHandler(ch)
    if to_file and not any(isinstance(h, logging.FileHandler)
                           for h in logger.handlers):
        stamp = time.strftime("%Y%m%d_%H%M%S", time.localtime())
        fh = logging.FileHandler(os.path.join(log_dir, f"{stamp}_{tag}.log"))
        fh.setFormatter(fmt)
        fh.setLevel(logging.INFO)
        logger.addHandler(fh)
    return logger
