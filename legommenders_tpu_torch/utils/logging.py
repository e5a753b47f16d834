"""Console + file logging with per-class prefixes.

The port's copy of the JAX package's utils/logging.py (the reference
prints with pigmento, mirrored to `checkpoints/.../<signature>.log`,
base_lego.py:158-170): stdlib logging with an optional file mirror.
"""
import logging
import sys

_FORMAT = "%(asctime)s [%(name)s] %(message)s"
_configured = False


def get_logger(name: str = "lego", log_file: str = None) -> logging.Logger:
    global _configured
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    if not _configured:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))
        logging.getLogger().addHandler(handler)
        logging.getLogger().setLevel(logging.INFO)
        _configured = True
    if log_file and not any(
        isinstance(h, logging.FileHandler)
        and getattr(h, "baseFilename", None) == log_file
        for h in logger.handlers
    ):
        fh = logging.FileHandler(log_file)
        fh.setFormatter(logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))
        logger.addHandler(fh)
    return logger
