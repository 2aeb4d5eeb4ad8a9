"""Logger factory and scalar writer, ported from
``ddti_tpu/core/logging.py``: a ``logging`` logger with UTC+8 timestamps,
an INFO console handler and a DEBUG file handler, and a TensorBoard scalar
writer that silently does nothing where tensorboardX is not installed.
"""

from __future__ import annotations

import logging
from datetime import datetime, timedelta, timezone


def create_logger(filename: str, console: bool = True) -> logging.Logger:
    """``console=False`` logs to the file only."""
    def utc8(*args):
        return (datetime.now(tz=timezone.utc) + timedelta(hours=8)).timetuple()

    logger = logging.getLogger(filename)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    if logger.handlers:  # idempotent across repeated calls in one process
        return logger

    fmt = logging.Formatter("%(asctime)s - %(levelname)s - %(message)s")
    fmt.converter = utc8
    if console:
        ch = logging.StreamHandler()
        ch.setLevel(logging.INFO)
        ch.setFormatter(fmt)
        logger.addHandler(ch)
    fh = logging.FileHandler(filename)
    fh.setLevel(logging.DEBUG)
    fh.setFormatter(fmt)
    logger.addHandler(fh)
    return logger


def rank_logger(rank: int) -> logging.Logger:
    """The logger of a data-parallel rank other than 0, which writes
    nothing into the run directory: its warnings go to stderr, tagged with
    the rank."""
    logger = logging.getLogger(f"ddti_tpu_torch.rank{rank}")
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setLevel(logging.WARNING)
        h.setFormatter(logging.Formatter(
            f"rank {rank} - %(levelname)s - %(message)s"))
        logger.addHandler(h)
    return logger


class ScalarWriter:
    """TensorBoard scalar writer; silently no-ops if tensorboardX is
    unavailable, or where ``log_dir`` is None (a data-parallel rank other
    than 0, which writes nothing)."""

    def __init__(self, log_dir: str | None):
        self._w = None
        if log_dir is None:
            return
        try:
            from tensorboardX import SummaryWriter
            self._w = SummaryWriter(log_dir)
        except Exception:
            pass

    def add_scalar(self, tag: str, value, step: int) -> None:
        if self._w is not None:
            self._w.add_scalar(tag, float(value), step)

    def close(self) -> None:
        if self._w is not None:
            self._w.close()
