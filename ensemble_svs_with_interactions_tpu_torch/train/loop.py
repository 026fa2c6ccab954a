"""Optimizers, learning-rate schedules, gradient accumulation and the
bf16 casts of mixed precision, with the semantics of
``ensemble_svs_with_interactions_tpu/train/loop.py`` (``build_optimizer``,
``build_lr_schedule``, ``amp_cast``, ``amp_uncast``), which builds them in
optax.

Differences in form, not in the updates: the optimizer is a
``torch.optim`` optimizer over the module's parameters, and the schedule
is a ``LambdaLR`` stepped once per applied update, so step ``n`` uses the
rate optax's schedule gives at count ``n``.  ``accum_steps > 1`` wraps
the optimizer in :class:`MultiSteps`, ``optax.MultiSteps``' accumulation.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch


def amp_cast(tree, dtype=torch.bfloat16):
    """Each float32 tensor of a tensor, dict, list or tuple cast to
    ``dtype`` (the bf16 forward of mixed precision).  The cast is
    differentiable, so gradients reach float32 masters as float32.  No
    loss scaling: bfloat16 has float32's exponent range."""
    return _map(lambda t: t.to(dtype) if t.dtype == torch.float32 else t,
                tree)


def amp_uncast(tree):
    """Each bfloat16 tensor of ``tree`` cast back to float32 (model outputs
    before the losses, running statistics before they re-enter the float32
    buffers)."""
    return _map(lambda t: t.float() if t.dtype == torch.bfloat16 else t,
                tree)


def _map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return tree


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


class MultiSteps:
    """Gradient accumulation with ``optax.MultiSteps`` semantics over a
    torch optimizer ``inner``: each :meth:`step` folds the parameters'
    gradients into a running mean ``acc + (g - acc) / (n + 1)``, and every
    ``every_k``-th step the inner optimizer steps once on that mean and the
    mean restarts from zero.  ``emitted`` says whether the last call
    stepped.  A step that is not called (the train steps' NaN-skip) leaves
    the mean and its count as they were."""

    def __init__(self, inner, every_k: int):
        self.inner, self.every_k = inner, int(every_k)
        self.mini_step = 0
        self.emitted = False
        self.acc = [torch.zeros_like(p) for p in self._params()]

    def _params(self):
        return [p for g in self.inner.param_groups for p in g["params"]]

    @property
    def param_groups(self):
        return self.inner.param_groups

    @property
    def state(self):
        return self.inner.state

    def zero_grad(self, set_to_none: bool = True):
        self.inner.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def step(self):
        n = self.mini_step
        params = self._params()
        for p, acc in zip(params, self.acc):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            acc.add_((g - acc) / (n + 1))
        self.emitted = n == self.every_k - 1
        self.mini_step = (n + 1) % self.every_k
        if self.emitted:
            for p, acc in zip(params, self.acc):
                p.grad = acc.clone()
                acc.zero_()
            self.inner.step()


class _EmittedStepsLR:
    """A scheduler that ticks only on the steps a :class:`MultiSteps`
    applied, as optax's inner schedule counts only those."""

    def __init__(self, scheduler, optimizer: MultiSteps):
        self.scheduler, self.optimizer = scheduler, optimizer

    def step(self):
        if self.optimizer.emitted:
            self.scheduler.step()

    def get_last_lr(self):
        return self.scheduler.get_last_lr()


def build_optimizer(params, optimizer_cfg: Dict,
                    scheduler_cfg: Optional[Dict] = None,
                    steps_per_epoch: int = 1, accum_steps: int = 1):
    """Torch-style optimizer config -> (optimizer, scheduler) over
    ``params``.  ``Adam`` with ``weight_decay > 0`` is decoupled AdamW, as
    the JAX package builds it (optax.adamw), not torch Adam's L2 term.
    ``accum_steps > 1`` returns a :class:`MultiSteps` over the optimizer
    and a scheduler that ticks only when it applies an update."""
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
    if int(accum_steps) > 1:
        opt = MultiSteps(opt, accum_steps)
        scheduler = _EmittedStepsLR(scheduler, opt)
    return opt, scheduler
