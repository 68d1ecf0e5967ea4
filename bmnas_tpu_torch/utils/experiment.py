"""Experiment directory and logging (single process).

Port of ``bmnas_tpu/utils/experiment.py``: the reference's
``<exp>/{architectures,best}`` layout, and a logger that writes to stdout
and ``<exp>/log.txt`` with the '%m/%d %I:%M:%S %p' date format.
"""
from __future__ import annotations

import logging
import os
import sys

LOG_FORMAT = "%(asctime)s %(message)s"
DATE_FORMAT = "%m/%d %I:%M:%S %p"


def create_exp_dir(path: str) -> str:
    os.makedirs(os.path.join(path, "architectures"), exist_ok=True)
    os.makedirs(os.path.join(path, "best"), exist_ok=True)
    return path


def setup_logger(exp_dir: str) -> logging.Logger:
    """The run's logger; a later call moves its log file to the new
    ``exp_dir``."""
    logging.basicConfig(stream=sys.stdout, level=logging.INFO,
                        format=LOG_FORMAT, datefmt=DATE_FORMAT)
    logger = logging.getLogger("bmnas_tpu_torch")
    logger.setLevel(logging.INFO)
    for h in [h for h in logger.handlers
              if isinstance(h, logging.FileHandler)]:
        logger.removeHandler(h)
        h.close()
    fh = logging.FileHandler(os.path.join(exp_dir, "log.txt"))
    fh.setFormatter(logging.Formatter(LOG_FORMAT, datefmt=DATE_FORMAT))
    logger.addHandler(fh)
    return logger
