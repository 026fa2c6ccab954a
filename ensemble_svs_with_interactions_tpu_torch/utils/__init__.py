"""Configs, scalers, the flax-to-torch weight bridge, and the port's own
copy of the bundled question set."""

from pathlib import Path


def packaged_question_path(name: str = "jp_dev_latest") -> str:
    """Path to a question set (.hed) bundled with the port, under
    ``data/hed/``: a byte-for-byte copy of the JAX package's
    ``recipes/_common/hed/`` file of the same name, so the port reads
    nothing from the JAX package's tree."""
    p = Path(__file__).resolve().parent.parent / "data" / "hed" / f"{name}.hed"
    if not p.exists():
        raise FileNotFoundError(f"no packaged question set named {name!r}: {p}")
    return str(p)
