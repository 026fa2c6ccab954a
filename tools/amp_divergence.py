"""Where the port's bf16 AMP acoustic trainer parts from the JAX package's,
step by step, on the CPU at the tiny widths of
``tests/test_torch_trainer_amp_acoustic.py``.

    JAX_PLATFORMS=cpu python tools/amp_divergence.py [--steps N]
        [--jax-lstm device|scan]

The JAX multitrack trainer runs the recipe's acoustic phase in AMP (the
tiny flagship, dropout 0, the interaction losses and the pitch
regularization on, SGD, 3 epochs) from one JAX start checkpoint, its LSTM
layers on their device training path (``--jax-lstm device``, the default:
the trainable Pallas recurrence in interpret mode, bf16 out under AMP, as
the port's) or on the masked scan the CPU runs (``--jax-lstm scan``:
float32 out), and each
of its train steps is recorded: the state it started from, the batch, the
interaction weights and the key.  Then, for each recorded step, from that
same state and batch:

* JAX's AMP step keeps its clipped gradient (an SGD transform whose state
  is the gradient);
* the port's AMP step and its float32 step, on the state carried over by
  ``flax_to_torch``, keep theirs (``p.grad`` after the step);
* ``chip_smoke.judge_amp`` holds the port's AMP gradient against JAX's,
  with the port's float32 gradient as the oracle, at the bounds of
  ``tests/test_torch_train_amp.py`` (5e-2 of scale; cosine 0.95, L2 0.35).

One JSON line a step: the three gradient norms, the tensors that fail, the
worst of each clause.  Then the trajectories: the pre-clip ``GradNorm`` of
each train step of JAX's AMP run, the port's AMP run and the port's float32
run, each from the shared start.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from ensemble_svs_with_interactions_tpu.train import (  # noqa: E402
    multitrack_trainer as jax_trainer,
)
from ensemble_svs_with_interactions_tpu.utils.config import (  # noqa: E402
    instantiate as jax_instantiate,
)
from ensemble_svs_with_interactions_tpu_torch.train import (  # noqa: E402
    multitrack as port_mt,
)
from ensemble_svs_with_interactions_tpu_torch.train import (  # noqa: E402
    multitrack_trainer as port_trainer,
)
from ensemble_svs_with_interactions_tpu_torch.train.loop import (  # noqa: E402
    build_optimizer,
)
from ensemble_svs_with_interactions_tpu_torch.utils.config import (  # noqa: E402
    instantiate,
    merge,
)
from ensemble_svs_with_interactions_tpu_torch.utils.flax_port import (  # noqa: E402,E501
    flax_to_torch,
)
from tests.test_torch_train_amp import (  # noqa: E402
    COS_MIN,
    GRAD_RTOL,
    L2_MAX,
    _sgd_keeping_grads,
    jax_device_lstm,
)
from tests.test_torch_trainer_amp_acoustic import (  # noqa: E402
    ACOUSTIC_DATA,
    acoustic_model,
    mt_start,
    phase_config,
    run_jax,
    run_port,
)
from tests.test_torch_trainer_multitrack import TIMING_DIM  # noqa: E402


def record_jax_run(cfg):
    """The JAX AMP trainer's run with each train step recorded as host
    copies: [(state, batch, weights, key, GradNorm)]."""
    steps = []
    create = jax_trainer.create_multitrack_acoustic_train_step

    def wrapped(*args, **kwargs):
        train_step, eval_step = create(*args, **kwargs)

        def step(state, batch, weights, rng):
            host = jax.tree_util.tree_map(np.array, (state, batch, weights,
                                                     rng))
            state, metrics = train_step(state, batch, weights, rng)
            steps.append((*host, float(metrics["GradNorm"])))
            return state, metrics
        return step, eval_step

    jax_trainer.create_multitrack_acoustic_train_step = wrapped
    try:
        run_jax(cfg, True)
    finally:
        jax_trainer.create_multitrack_acoustic_train_step = create
    return steps


def port_grad_norms(cfg, use_amp):
    """The port trainer's pre-clip GradNorm of each train step."""
    norms = []
    create = port_trainer.create_multitrack_acoustic_train_step

    def wrapped(*args, **kwargs):
        train_step, eval_step = create(*args, **kwargs)

        def step(*a, **k):
            metrics = train_step(*a, **k)
            norms.append(float(metrics["GradNorm"]))
            return metrics
        return step, eval_step

    port_trainer.create_multitrack_acoustic_train_step = wrapped
    try:
        run_port(merge(cfg, {"train": {"use_amp": use_amp}}), True)
    finally:
        port_trainer.create_multitrack_acoustic_train_step = create
    return norms


def jax_clipped_grads(cfg, jm, state, batch, weights, key):
    """JAX's AMP step from ``state``: its clipped gradient, by the port's
    parameter names."""
    tx = _sgd_keeping_grads(1.0)
    step, _ = jax_trainer.create_multitrack_acoustic_train_step(
        jm, tx, dict(cfg["model"]),
        clip_norm=float(cfg["train"]["optim"].get("clip_norm", 1.0)),
        feats_criterion=cfg["train"].get("feats_criterion", "mse"),
        pitch_reg_weight=float(cfg["train"].get("pitch_reg_weight", 1.0)),
        sub_require_grad=bool(cfg["train"].get("sub_require_grad", True)),
        use_amp=True, donate=False)
    start = {**state, "opt_state": tx.init(state["params"])}
    new, _ = step(start, {k: jnp.asarray(v) for k, v in batch.items()},
                  {k: jnp.asarray(v) for k, v in weights.items()},
                  jnp.asarray(key))
    grads = jax.tree_util.tree_map(np.asarray, new["opt_state"])
    module = flax_to_torch(instantiate(cfg["model"]["netG"]),
                           {"params": grads,
                            "batch_stats": state["batch_stats"]})
    return {k: p.detach().clone() for k, p in module.named_parameters()}


def port_clipped_grads(cfg, state, batch, weights, use_amp):
    """The port's step from the same state: its clipped gradient."""
    module = flax_to_torch(instantiate(cfg["model"]["netG"]),
                           {"params": state["params"],
                            "batch_stats": state["batch_stats"]})
    opt, _ = build_optimizer(module.parameters(),
                             {"name": "SGD", "params": {"lr": 1.0}})
    step, _ = port_mt.create_multitrack_acoustic_train_step(
        module, opt, dict(cfg["model"]),
        clip_norm=float(cfg["train"]["optim"].get("clip_norm", 1.0)),
        feats_criterion=cfg["train"].get("feats_criterion", "mse"),
        pitch_reg_weight=float(cfg["train"].get("pitch_reg_weight", 1.0)),
        sub_require_grad=bool(cfg["train"].get("sub_require_grad", True)),
        use_amp=use_amp, device="cpu")
    step({k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()},
         {k: float(v) for k, v in weights.items()},
         torch.Generator().manual_seed(0))
    return {k: p.grad.detach().clone() for k, p in module.named_parameters()}


def norm(grads) -> float:
    return float(torch.sqrt(sum((g.double() ** 2).sum()
                                for g in grads.values())))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=0,
                    help="judge only the first N recorded steps (0: all)")
    ap.add_argument("--jax-lstm", choices=("device", "scan"),
                    default="device",
                    help="the JAX LSTM layers' path (default: device)")
    args = ap.parse_args(argv)
    torch.set_num_threads(4)
    with (jax_device_lstm() if args.jax_lstm == "device"
          else contextlib.nullcontext()):
        return run(args)


def run(args) -> int:
    with tempfile.TemporaryDirectory() as root:
        root = Path(root)
        corpus = chip_smoke.write_corpus(root / "corpus", 2, 1, (40, 64),
                                         seed=5, timing_dim=TIMING_DIM)
        cfg = phase_config("acoustic", corpus, root / "exp",
                           acoustic_model(),
                           **{**ACOUSTIC_DATA, "train.logf0_diff_weight": 1.0,
                              "train.mgc_diff_weight": 1.0})
        start = mt_start(cfg, True, root / "start")
        cfg = merge(cfg, {"train": {"use_amp": True, "resume": {
            "checkpoint": str(start)}}})
        run_cfg = lambda name: merge(cfg, {"train": {  # noqa: E731
            "out_dir": str(root / name)}})
        steps = record_jax_run(run_cfg("jax_amp"))
        jm = jax_instantiate(cfg["model"]["netG"])
        first_fail = None
        for k, (state, batch, weights, key, _) in enumerate(
                steps[:args.steps or None]):
            ref = jax_clipped_grads(cfg, jm, state, batch, weights, key)
            got = port_clipped_grads(cfg, state, batch, weights, True)
            f32 = port_clipped_grads(cfg, state, batch, weights, False)
            summary = chip_smoke.amp_summary(chip_smoke.judge_amp(
                got, ref, f32, GRAD_RTOL, COS_MIN, L2_MAX))
            failed = sorted(summary["failed"])
            if failed and first_fail is None:
                first_fail = (k, failed)
            print(json.dumps({
                "step": k, "clipped_norm": {"port_amp": norm(got),
                                            "jax_amp": norm(ref),
                                            "port_f32": norm(f32)},
                "by_clause": summary["by_clause"], "failed": {
                    n: {key: v[key] for key in ("rel_of_scale", "cos",
                                                 "l2_rel")}
                    for n, v in summary["failed"].items()},
                "worst": summary["worst"],
                "max_rel_of_scale": summary["max_rel_of_scale"],
                "unresolved_min_cos": summary["unresolved_min_cos"]}),
                flush=True)
        print(json.dumps({"first_failing_step": first_fail}), flush=True)
        print(json.dumps({"grad_norm_by_step": {
            "jax_amp": [s[-1] for s in steps],
            "port_amp": port_grad_norms(run_cfg("port_amp"), True),
            "port_f32": port_grad_norms(run_cfg("port_f32"), False)}}),
            flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
