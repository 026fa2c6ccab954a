"""The training loop's parts, with the semantics of
``ensemble_svs_with_interactions_tpu/train/loop.py``: optimizers,
learning-rate schedules, gradient accumulation and the bf16 casts of mixed
precision (``build_optimizer``, ``amp_cast``); the helpers every train
step shares (the AMP forward, clipping, the NaN-skip); the single-track
train step (``create_train_step``); the train state and its checkpoints,
``dev_metrics.json`` and the metrics log.

Differences in form, not in the updates: the optimizer is a
``torch.optim`` optimizer over the module's parameters, and the schedule
is a ``LambdaLR`` stepped once per applied update, so step ``n`` uses the
rate optax's schedule gives at count ``n``.  ``accum_steps > 1`` wraps
the optimizer in :class:`MultiSteps`, ``optax.MultiSteps``' accumulation.

Checkpoints are flax msgpack (``utils/flax_msgpack``) in the JAX
package's layout: ``params`` and ``batch_stats`` under the flax scope
paths (``utils/flax_port.torch_to_flax``) and ``step``, so the JAX
package reads a port checkpoint's weights and the port a JAX one's.
``opt_state`` is the port's own: the optimizer's per-parameter tensors
(Adam's moments) by flax path, its step count, the schedule's count and
an accumulator's running mean.
"""

from __future__ import annotations

import copy
import inspect
import json
import math
import warnings
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ensemble_svs_with_interactions_tpu_torch.base import BaseModel, PredictionType
from ensemble_svs_with_interactions_tpu_torch.train import losses as L
from ensemble_svs_with_interactions_tpu_torch.utils import flax_msgpack
from ensemble_svs_with_interactions_tpu_torch.utils.flax_port import (
    flax_to_torch,
    torch_to_flax,
)


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


# --------------------------------------------------------------------------
# What every train step shares
# --------------------------------------------------------------------------


def amp_forward(module, args, kwargs, use_amp: bool, train: bool):
    """``module(*args, **kwargs)``; under AMP through
    ``torch.func.functional_call`` with bf16 copies of the float32
    parameters and buffers (the casts are differentiable, so the float32
    masters get float32 gradients) and the outputs cast back to float32.
    After a training forward the bf16 running statistics are copied back
    into the float32 buffers, as the JAX step's ``amp_uncast`` of its
    ``batch_stats`` update."""
    if not use_amp:
        return module(*args, **kwargs)
    buffers = amp_cast(dict(module.named_buffers()))
    outs = torch.func.functional_call(
        module, {**amp_cast(dict(module.named_parameters())), **buffers},
        amp_cast(args), amp_cast(kwargs))
    if train:
        with torch.no_grad():
            for name, buf in module.named_buffers():
                buf.copy_(buffers[name])
    return amp_uncast(outs)


def clip_grads(params, loss, clip_norm: float):
    """Scale the gradients in place by ``min(1, clip / max(|g|, 1e-12))``;
    returns (global norm, whether the loss and the norm are finite)."""
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    gnorm = torch.sqrt(sum((g * g).sum() for g in grads))
    finite = torch.isfinite(gnorm) & torch.isfinite(loss.detach())
    clip = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    for p, g in zip(params, grads):
        p.grad = g.mul_(clip)
    return gnorm, finite


def apply_update(finite, optimizer, scheduler):
    """The NaN-skip: step the optimizer and the schedule only when the step
    was finite, so a non-finite one leaves the parameters, the optimizer
    state (and an accumulator's mean and count) and the schedule as they
    were."""
    if bool(finite):
        optimizer.step()
        if scheduler is not None:
            scheduler.step()


def metrics_to_floats(metrics, device):
    """The metrics as Python floats, read in one device-to-host copy."""
    values = torch.stack([torch.as_tensor(v, device=device).double()
                          for v in metrics.values()]).tolist()
    return dict(zip(metrics, values))


def _accepts(module, name: str) -> bool:
    return name in inspect.signature(module.forward).parameters


# --------------------------------------------------------------------------
# The single-track train step
# --------------------------------------------------------------------------


def create_train_step(module, optimizer, model_config: Dict, scheduler=None,
                      clip_norm: float = 1.0, feats_criterion: str = "mse",
                      pitch_reg_weight: float = 1.0,
                      stream_wise_loss: bool = False, stream_weights=None,
                      use_amp: bool = False, device="cuda"):
    """(train_step, eval_step) for a single-track model, as the JAX
    package's ``create_train_step``.

    ``module`` is moved to ``device``; ``optimizer`` (and ``scheduler``,
    from :func:`build_optimizer`) must be built over its parameters.
    ``train_step(batch, generator)`` takes a batch dict (``in_feats``
    (B, T, Din), ``out_feats`` (B, T, Dout), ``lengths`` (B,), optional
    ``spks`` and ``pitch_reg_dyn_ws`` (B, T, 1); arrays or tensors) and
    the ``torch.Generator`` of the dropout masks, updates the module,
    optimizer and scheduler in place and returns ``{"Loss", "Loss_Feats",
    "Loss_Pitch", "GradNorm"}`` as floats.  The feature loss follows the
    prediction type: the multistream loss over streams (each stage of a
    Post-Net refinement list summed), the masked MDN NLL, the criterion
    between a diffusion or flow-matching decoder's drawn target and its
    prediction (``(noise, x_recon)``), or the criterion (each refinement
    stage summed); ``pitch_reg_weight`` weighs the L1 of
    the residual lf0 of a model that predicts one.  A model that
    overrides ``preprocess_target`` (the shallow-AR models) is taught, and
    scored, on its filtered target.  Clipping, the NaN-skip
    and ``use_amp`` as in ``train.multitrack``'s steps.
    ``eval_step(batch)`` returns (metrics without ``GradNorm``, the
    prediction) without touching anything (prenet dropout from a generator
    seeded 0)."""
    device = torch.device(device)
    module.to(device)
    prediction_type = module.prediction_type()
    has_res_lf0 = module.has_residual_lf0_prediction()
    stream_sizes = list(model_config.get("stream_sizes", []))
    params = [p for p in module.parameters() if p.requires_grad]
    dtype = params[0].dtype
    takes_y, takes_spks = _accepts(module, "y"), _accepts(module, "spks")
    # shallow-AR models override the base hook to train against their
    # analysis-filtered targets; the identity skips the AMP round trip
    filters_target = (getattr(type(module), "preprocess_target",
                              BaseModel.preprocess_target)
                      is not BaseModel.preprocess_target)

    def to_device(batch):
        b = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
        for k in ("in_feats", "out_feats", "pitch_reg_dyn_ws"):
            if k in b:
                b[k] = b[k].to(dtype)
        for k in ("lengths", "spks"):
            if k in b:
                b[k] = b[k].long()
        return b

    def feature_loss(pred_out, out_feats, mask):
        kw = dict(criterion=feats_criterion, stream_wise=stream_wise_loss,
                  stream_weights=stream_weights)
        if prediction_type == PredictionType.MULTISTREAM_HYBRID:
            if L.is_refinement_list(pred_out, stream_sizes):
                return sum(L.multistream_loss(
                    L.split_streams(p, stream_sizes), out_feats, mask,
                    stream_sizes, **kw) for p in pred_out)
            if not isinstance(pred_out, (list, tuple)):
                pred_out = L.split_streams(pred_out, stream_sizes)
            return L.multistream_loss(pred_out, out_feats, mask,
                                      stream_sizes, **kw)
        if prediction_type == PredictionType.PROBABILISTIC:
            return L.mdn_stream_loss(pred_out, out_feats, mask)
        if prediction_type == PredictionType.DIFFUSION:
            noise, x_recon = pred_out
            return L.feats_criterion(x_recon, noise, mask, feats_criterion)
        preds = pred_out if isinstance(pred_out, list) else [pred_out]
        return sum(L.feats_criterion(p, out_feats, mask, feats_criterion)
                   for p in preds)

    def loss_fn(b, generator, train: bool):
        T = b["in_feats"].shape[1]
        mask = (torch.arange(T, device=device)[None, :]
                < b["lengths"][:, None]).to(dtype)[:, :, None]
        out_feats = y = b["out_feats"]
        if filters_target:
            # filtered before the forward pass, in the model's dtype, so
            # teacher forcing and the loss both see the filtered target
            y = module.preprocess_target(amp_cast(y) if use_amp else y)
            out_feats = amp_uncast(y)
        args = [b["in_feats"]]
        if takes_spks and "spks" in b:
            args.append(b["spks"])
        kwargs = {"lengths": b["lengths"], "train": train,
                  "generator": generator}
        if takes_y:
            kwargs["y"] = y
        outs = amp_forward(module, tuple(args), kwargs, use_amp, train)
        pred_out, lf0_residual = outs if has_res_lf0 else (outs, None)
        loss_feats = feature_loss(pred_out, out_feats, mask)
        if pitch_reg_weight > 0 and lf0_residual is not None:
            loss_pitch = L.pitch_regularization_loss(
                lf0_residual, mask, b.get("pitch_reg_dyn_ws", 1.0))
        else:
            loss_pitch = torch.zeros((), device=device)
        loss = loss_feats + pitch_reg_weight * loss_pitch
        return loss, {"Loss": loss, "Loss_Feats": loss_feats,
                      "Loss_Pitch": loss_pitch}, pred_out

    def train_step(batch, generator):
        b = to_device(batch)
        optimizer.zero_grad(set_to_none=False)
        loss, metrics, _ = loss_fn(b, generator, True)
        loss.backward()
        gnorm, finite = clip_grads(params, loss, clip_norm)
        metrics["GradNorm"] = gnorm
        out = metrics_to_floats(metrics, device)
        apply_update(finite, optimizer, scheduler)
        return out

    @torch.no_grad()
    def eval_step(batch):
        generator = torch.Generator(device=device).manual_seed(0)
        _, metrics, pred_out = loss_fn(to_device(batch), generator, False)
        return metrics_to_floats(metrics, device), pred_out

    return train_step, eval_step


# --------------------------------------------------------------------------
# Train state + checkpointing
# --------------------------------------------------------------------------


def _optimizer_of(optimizer):
    return optimizer.inner if isinstance(optimizer, MultiSteps) else optimizer


def _moment_tree(module, names, tensors) -> Dict:
    """Per-parameter tensors (``tensors[i]`` shaped as parameter
    ``names[i]``) in the flax layout of ``module``'s params."""
    twin = copy.deepcopy(module)
    own = dict(twin.named_parameters())
    with torch.no_grad():
        for n, t in zip(names, tensors):
            own[n].copy_(t)
    return torch_to_flax(twin)["params"]


def _moments_from_tree(module, tree) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`_moment_tree`: {parameter name: tensor}."""
    twin = copy.deepcopy(module)
    stats = torch_to_flax(module).get("batch_stats")
    flax_to_torch(twin, {"params": tree,
                         **({"batch_stats": stats} if stats else {})})
    return {n: p.detach() for n, p in twin.named_parameters()}


@dataclass
class TrainState:
    """What a checkpoint holds: flax-layout ``params`` and ``batch_stats``
    (nested dicts of numpy arrays), the port's ``opt_state`` and the count
    of train steps taken."""

    params: Any
    batch_stats: Any
    opt_state: Any
    step: int = 0

    @classmethod
    def capture(cls, module, optimizer=None, scheduler=None, step: int = 0):
        """The state of a module, its optimizer and its schedule."""
        variables = torch_to_flax(module)
        opt_state: Dict = {}
        if optimizer is not None:
            inner = _optimizer_of(optimizer)
            named = [(n, p) for n, p in module.named_parameters()
                     if p in inner.state and inner.state[p]]
            tensor_keys = sorted({
                k for _, p in named for k, v in inner.state[p].items()
                if torch.is_tensor(v) and v.shape == p.shape})
            names = [n for n, _ in named]
            opt_state["moments"] = {
                k: _moment_tree(module, names,
                                [inner.state[p][k] for _, p in named])
                for k in tensor_keys}
            count = (inner.state[named[0][1]].get("step", 0) if named
                     else 0)
            opt_state["count"] = np.asarray(float(count), np.float32)
            if isinstance(optimizer, MultiSteps):
                pnames = [n for n, _ in module.named_parameters()]
                opt_state["accumulator"] = {
                    "mini_step": np.asarray(optimizer.mini_step, np.int32),
                    "mean": _moment_tree(module, pnames, optimizer.acc)}
        if scheduler is not None:
            sched = getattr(scheduler, "scheduler", scheduler)
            opt_state["schedule_count"] = np.asarray(sched.last_epoch,
                                                     np.int32)
        return cls(variables["params"], variables.get("batch_stats", {}),
                   opt_state, int(step))

    def as_pytree(self):
        return {"params": self.params, "batch_stats": self.batch_stats,
                "opt_state": self.opt_state,
                "step": np.asarray(self.step, np.int32)}

    def restore(self, module, optimizer=None, scheduler=None):
        """Load the state into a module (its every parameter and buffer),
        its optimizer and its schedule, in place."""
        flax_to_torch(module, {"params": self.params,
                               **({"batch_stats": self.batch_stats}
                                  if self.batch_stats else {})})
        opt = self.opt_state
        if optimizer is not None and opt.get("moments"):
            inner = _optimizer_of(optimizer)
            dev = next(module.parameters()).device
            count = torch.tensor(float(np.asarray(opt["count"])),
                                 dtype=torch.float32)
            moments = {k: _moments_from_tree(module, tree)
                       for k, tree in opt["moments"].items()}
            for n, p in module.named_parameters():
                state = {k: m[n].to(dev).clone() for k, m in moments.items()}
                if "exp_avg" in state:
                    state["step"] = count.clone()
                inner.state[p] = state
            acc = opt.get("accumulator")
            if isinstance(optimizer, MultiSteps) and acc:
                optimizer.mini_step = int(np.asarray(acc["mini_step"]))
                mean = _moments_from_tree(module, acc["mean"])
                optimizer.acc = [mean[n].to(dev).clone()
                                 for n, _ in module.named_parameters()]
        if scheduler is not None and "schedule_count" in opt:
            sched = getattr(scheduler, "scheduler", scheduler)
            sched.last_epoch = int(np.asarray(opt["schedule_count"]))
            lrs = [base * lam(sched.last_epoch) for base, lam in
                   zip(sched.base_lrs, sched.lr_lambdas)]
            for group, lr in zip(sched.optimizer.param_groups, lrs):
                group["lr"] = lr
            sched._last_lr = lrs


def save_checkpoint(out_dir, state: TrainState, epoch: int,
                    is_best: bool = False, postfix: str = "",
                    save_interval: int = 0):
    """``latest``, ``best_loss`` (when ``is_best``) and ``epoch%04d``
    (every ``save_interval`` epochs) checkpoint files."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    blob = flax_msgpack.to_bytes(state.as_pytree())
    (out_dir / f"latest{postfix}.ckpt").write_bytes(blob)
    if is_best:
        (out_dir / f"best_loss{postfix}.ckpt").write_bytes(blob)
    if save_interval > 0 and epoch % save_interval == 0:
        (out_dir / f"epoch{epoch:04d}{postfix}.ckpt").write_bytes(blob)


def load_checkpoint(path) -> TrainState:
    """A checkpoint written by :func:`save_checkpoint`; restore it with
    :meth:`TrainState.restore`."""
    tree = flax_msgpack.from_bytes(Path(path).read_bytes())
    return TrainState(params=tree["params"],
                      batch_stats=tree.get("batch_stats") or {},
                      opt_state=tree.get("opt_state") or {},
                      step=int(np.asarray(tree["step"])))


def write_dev_metrics(out_dir, best_epoch, best_metrics, final_metrics):
    """``dev_metrics.json`` beside the checkpoints: the best epoch, its dev
    metrics and the last epoch's (with the ``ObjEval_*`` distortions)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    payload = {
        "best_epoch": int(best_epoch),
        "best": {k: float(v) for k, v in (best_metrics or {}).items()},
        "final": {k: float(v) for k, v in (final_metrics or {}).items()},
    }
    (out_dir / "dev_metrics.json").write_text(json.dumps(payload, indent=1))


def _flatten(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _unflatten(flat):
    out: Dict = {}
    for path, v in flat.items():
        node = out
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = v
    return out


def load_params_shape_filtered(path, template_variables):
    """Partial restore: (variables, count copied).  Each params leaf of the
    flax-layout ``template_variables`` whose path and shape a checkpoint
    (either package's, or a bare params tree) also has is taken from it;
    the rest, and ``batch_stats``, stay the template's.  Warm-starts a
    multitrack model from a single-track checkpoint."""
    loaded = flax_msgpack.from_bytes(Path(path).read_bytes())
    flat_l = _flatten(loaded.get("params", loaded))
    out, copied = {}, 0
    for k, v in _flatten(template_variables["params"]).items():
        if k in flat_l and np.shape(flat_l[k]) == np.shape(v):
            out[k] = np.array(flat_l[k])
            copied += 1
        else:
            out[k] = v
    return {**template_variables, "params": _unflatten(out)}, copied


# --------------------------------------------------------------------------
# Metrics writer
# --------------------------------------------------------------------------


class MetricsWriter:
    """``metrics.jsonl`` (always on: one record per call, ``{"step": n,
    "<prefix><name>": value, ...}``) and TensorBoard or MLflow, which are
    optional and give way with a warning when the package is missing."""

    def __init__(self, out_dir, use_tensorboard: bool = True,
                 use_mlflow: bool = False, mlflow_experiment: str = "default",
                 mlflow_run_name: str = None, mlflow_params: Dict = None):
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.jsonl = open(self.out_dir / "metrics.jsonl", "a")
        self.tb = None
        self.mlflow = None
        if use_mlflow:
            try:
                import mlflow

                mlflow.set_tracking_uri(
                    f"file://{self.out_dir.resolve()}/mlruns")
                mlflow.set_experiment(mlflow_experiment)
                mlflow.start_run(run_name=mlflow_run_name)
                if mlflow_params:
                    mlflow.log_params(_flatten_params(mlflow_params))
                self.mlflow = mlflow
            except ImportError:
                warnings.warn("mlflow requested but not installed; metrics "
                              "go to JSONL (and TensorBoard if enabled) only")
        if self.mlflow is None and use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.tb = SummaryWriter(str(self.out_dir / "tensorboard"))
            except ImportError:
                warnings.warn("tensorboard requested but not installed; "
                              "metrics go to JSONL only")

    def log(self, step: int, metrics: Dict[str, float], prefix: str = ""):
        rec = {"step": step,
               **{f"{prefix}{k}": float(v) for k, v in metrics.items()}}
        self.jsonl.write(json.dumps(rec) + "\n")
        self.jsonl.flush()
        if self.tb is not None:
            for k, v in metrics.items():
                self.tb.add_scalar(f"{prefix}{k}", float(v), step)
        if self.mlflow is not None:
            self.mlflow.log_metrics(
                {f"{prefix}{k}".replace("/", "_"): float(v)
                 for k, v in metrics.items()}, step=step)

    def close(self):
        self.jsonl.close()
        if self.tb is not None:
            self.tb.close()
        if self.mlflow is not None:
            self.mlflow.end_run()


def _flatten_params(tree, prefix: str = "", out=None) -> Dict[str, str]:
    """A nested config as dotted MLflow param keys."""
    out = {} if out is None else out
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten_params(v, f"{prefix}{k}.", out)
    else:
        out[prefix[:-1]] = str(tree)
    return out
