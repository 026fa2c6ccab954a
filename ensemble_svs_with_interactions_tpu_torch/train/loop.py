"""Optimizers and learning-rate schedules from torch-style configs, with
the semantics of ``ensemble_svs_with_interactions_tpu/train/loop.py``
(``build_optimizer``, ``build_lr_schedule``), which builds them in optax.

Differences in form, not in the updates: the optimizer is a
``torch.optim`` optimizer over the module's parameters, and the schedule
is a ``LambdaLR`` stepped once per applied update, so step ``n`` uses the
rate optax's schedule gives at count ``n``.  Gradient accumulation
(``optax.MultiSteps``) is not ported.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch


def build_lr_schedule(optimizer_cfg: Dict, scheduler_cfg: Optional[Dict],
                      steps_per_epoch: int = 1) -> Callable[[int], float]:
    """Torch-style scheduler config -> learning rate at each optimizer
    step (the count of updates applied before it).  The reference steps
    its schedulers once per epoch, so the epoch-quantized parameters
    (StepLR step_size, ExponentialLR's step, cosine T_max) are scaled by
    ``steps_per_epoch``; Noam is per step."""
    base_lr = float(optimizer_cfg.get("params", {}).get("lr", 1e-3))
    if not scheduler_cfg or not scheduler_cfg.get("name"):
        return lambda step: base_lr
    name = scheduler_cfg["name"].lower()
    p = scheduler_cfg.get("params", {})
    spe = max(int(steps_per_epoch), 1)
    if name in ("steplr", "exponentiallr"):
        every = int(p.get("step_size", 10)) * spe if name == "steplr" else spe
        gamma = float(p.get("gamma", 0.5 if name == "steplr" else 0.99))
        return lambda step: base_lr * gamma ** (step // every)
    if name in ("cosineannealinglr", "cosine"):
        decay = int(p.get("T_max", 100000)) * spe
        return lambda step: base_lr * 0.5 * (
            1.0 + math.cos(math.pi * min(step, decay) / decay))
    if name in ("noamlr", "noam"):
        warmup = int(p.get("warmup_steps", 4000))
        return lambda step: (base_lr * step / warmup if step < warmup
                             else base_lr * warmup ** 0.5 * step ** -0.5)
    raise ValueError(f"unknown lr scheduler: {name}")


def build_optimizer(params, optimizer_cfg: Dict,
                    scheduler_cfg: Optional[Dict] = None,
                    steps_per_epoch: int = 1):
    """Torch-style optimizer config -> (optimizer, scheduler) over
    ``params``.  ``Adam`` with ``weight_decay > 0`` is decoupled AdamW, as
    the JAX package builds it (optax.adamw), not torch Adam's L2 term."""
    name = optimizer_cfg.get("name", "Adam").lower()
    p = dict(optimizer_cfg.get("params", {}))
    schedule = build_lr_schedule(optimizer_cfg, scheduler_cfg,
                                 steps_per_epoch)
    base_lr = float(p.get("lr", 1e-3))
    betas = tuple(p.get("betas", (0.9, 0.999)))
    weight_decay = float(p.get("weight_decay", 0.0))
    params = list(params)
    if name in ("adam", "adamw"):
        if name == "adamw" or weight_decay > 0:
            opt = torch.optim.AdamW(params, lr=base_lr, betas=betas, eps=1e-8,
                                    weight_decay=weight_decay)
        else:
            opt = torch.optim.Adam(params, lr=base_lr, betas=betas, eps=1e-8)
    elif name == "sgd":
        opt = torch.optim.SGD(params, lr=base_lr,
                              momentum=float(p.get("momentum", 0.0)))
    elif name == "radam":
        opt = torch.optim.RAdam(params, lr=base_lr)
    else:
        raise ValueError(f"unknown optimizer: {name}")
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda step: schedule(step) / base_lr if base_lr else 0.0)
    return opt, scheduler
