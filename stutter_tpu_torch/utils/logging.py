"""Structured logging shared by all CLIs (counterpart of ``stutter_tpu/utils/logging.py``).

Capability parity: the reference sets up a per-script file+stream logger with a
timestamped logfile under ``logs/`` (reference ``WavLM_embeddings.py:15-25``,
same pattern in all four scripts). Here one helper serves every entry point:
``setup_logging(tag)`` gives the ``stutter_tpu_torch`` logger, the parent of
every module logger of the package, a stderr handler and the logfile
``logs/{tag}_{YYYYmmdd_HHMMSS}.log`` under the working directory.

One run leaves one logfile, with rank 0's lines, also under ``--devices N``:
the process that launches the ranks owns the file, and ``parallel.mesh``
hands its path to the ranks it spawns; there rank 0 appends to it and every
other rank logs to stderr only. Under ``torchrun``, where no launching
process runs the CLI, rank 0 starts the file itself.
"""

from __future__ import annotations

import logging
import os
import sys
from datetime import datetime

_FORMAT = "%(asctime)s - %(name)s - %(levelname)s - %(message)s"
_configured = False
_logfile: str | None = None  # this run's logfile: written here, or a launcher's


def _rank() -> int:
    """This process's rank in a process group (spawned or ``torchrun``'s), 0 outside one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK", "0"))


def setup_logging(tag: str, log_dir: str = "logs", level: int = logging.INFO) -> logging.Logger:
    """Configure the package's logging with a stream handler and a timestamped
    logfile (rank 0's; the other ranks of a group log to stderr only).

    Idempotent: repeated calls add no duplicate handlers.
    """
    global _configured, _logfile
    logger = logging.getLogger("stutter_tpu_torch")
    if not _configured:
        logger.setLevel(level)
        stream = logging.StreamHandler(sys.stderr)
        stream.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(stream)
        if _rank() == 0:
            try:
                path = _logfile
                if path is None:
                    os.makedirs(log_dir, exist_ok=True)
                    stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
                    path = os.path.join(log_dir, f"{tag}_{stamp}.log")
                fileh = logging.FileHandler(path)
                fileh.setFormatter(logging.Formatter(_FORMAT))
                logger.addHandler(fileh)
                _logfile = fileh.baseFilename
            except OSError:
                logger.warning("could not create log dir %s; logging to stderr only", log_dir)
        _configured = True
    return logger


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(f"stutter_tpu_torch.{name}")


def logfile() -> str | None:
    """The absolute path of this run's logfile, or None."""
    return _logfile


def inherit_logfile(path: str | None) -> None:
    """In a rank spawned by a CLI, before the CLI's ``setup_logging``: rank 0
    appends to the launching process's logfile ``path`` (None: starts its own)."""
    global _logfile
    _logfile = path
