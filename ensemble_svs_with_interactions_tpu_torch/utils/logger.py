"""stdlib logging factory, as the JAX package's ``utils/logger.py``:
verbose >= 100 -> DEBUG, > 0 -> INFO, else WARN."""

from __future__ import annotations

import logging


def getLogger(verbose: int = 0, name: str = "esvs_torch",
              add_stream_handler: bool = True) -> logging.Logger:
    logger = logging.getLogger(name)
    if verbose >= 100:
        logger.setLevel(logging.DEBUG)
    elif verbose > 0:
        logger.setLevel(logging.INFO)
    else:
        logger.setLevel(logging.WARN)
    if add_stream_handler and not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter("[%(name)s][%(levelname)s] %(message)s"))
        logger.addHandler(handler)
    return logger
