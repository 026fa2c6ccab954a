"""Tracing and NaN debugging: the counterpart of
``ensemble_svs_with_interactions_tpu/utils/profiling.py``.

Usage::

    from ensemble_svs_with_interactions_tpu_torch.utils.profiling import trace

    with trace("/tmp/torch-trace"):        # no-op when the dir is falsy
        engine.svs_ensemble(labels_list)

writes a Chrome trace (host and, on a card, device activity) into the
directory; :func:`annotate` names a region on its timeline.
"""

from __future__ import annotations

import contextlib
from pathlib import Path

import torch


@contextlib.contextmanager
def trace(log_dir):
    """Profile the block with ``torch.profiler`` into ``log_dir`` as
    ``trace.json`` (falsy -> no-op)."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))


def annotate(name: str):
    """A named region on the trace's timeline."""
    return torch.profiler.record_function(name)


def enable_detect_anomaly():
    """NaN debugging: the backward raises at the operation whose forward
    made a NaN (``torch.autograd.set_detect_anomaly``; the JAX package
    turns on ``jax_debug_nans``).  Process-wide, and slow."""
    torch.autograd.set_detect_anomaly(True)
