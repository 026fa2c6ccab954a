"""Host helpers (``init_seed``, ``example_xml_file`` and
``example_ust_file`` of the JAX package's ``utils/misc.py``)."""

from __future__ import annotations

import random
from pathlib import Path

import numpy as np
import torch


def init_seed(seed: int) -> None:
    """Seed the host's global RNGs: Python's, NumPy's and torch's.  The
    trainers draw dropout from explicit generators; this covers everything
    else."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def example_xml_file() -> str:
    """Path to the port's copy of the packaged example MusicXML score
    (``_example_data/example_song.musicxml``, byte-equal to the JAX
    package's)."""
    return str(Path(__file__).resolve().parent.parent / "_example_data"
               / "example_song.musicxml")


def example_ust_file() -> str:
    """Path to the port's copy of the packaged example UST score (the same
    six-note phrase as :func:`example_xml_file`, in UTAU format)."""
    return str(Path(__file__).resolve().parent.parent / "_example_data"
               / "example_song.ust")
