"""Hyperparameter sweep over training configs; the port's copy of
``ensemble_svs_with_interactions_tpu/bin/sweep.py`` around the port's
trainers.

The search loop is first-party: grid search over explicit lists, random
search over (log-)uniform ranges, or ``tpe`` — a Tree-structured Parzen
Estimator (Bergstra et al. 2011): after ``n_startup`` random trials, each
parameter's observations are split into the best gamma-quantile ("good")
and the rest ("bad"), Parzen densities l(x)/g(x) are built over each set,
and the next point maximizes the density ratio over ``n_ei_candidates``
draws from l — minimizing the dev ``Loss`` the trainer returns.  The
samplers are host NumPy and draw what the JAX package's draw from the same
seed.  Trials and the winner are written to
``<out_dir>/sweep_results.jsonl`` / ``best_trial.yaml``.  The trainers run
on the base config's ``device`` (``cuda`` unless ``device=cpu``).

Sweep spec (YAML):
  n_trials: 8            # random/tpe; grid mode runs the full grid
  mode: tpe              # tpe | random | grid
  n_startup: 5           # tpe: random warmup trials
  params:
    train.optim.optimizer.params.lr: {low: 1e-4, high: 1e-2, log: true}
    model.netG.hidden_dim: [32, 64, 128]

Usage: python -m ensemble_svs_with_interactions_tpu_torch.bin.sweep
       <base_config.yaml> <sweep.yaml> [--multitrack] [--acoustic]
       [overrides...]
"""

from __future__ import annotations

import argparse
import itertools
import json
from pathlib import Path

import numpy as np

from ensemble_svs_with_interactions_tpu_torch.utils import yaml_io
from ensemble_svs_with_interactions_tpu_torch.utils.config import (
    Config,
    load_config,
    merge,
    parse_overrides,
)


def _set_path(tree: dict, dotted: str, value):
    keys = dotted.split(".")
    node = tree
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


def sample_trials(spec: dict, seed: int = 123):
    """Yield dicts of dotted-path -> value per trial."""
    params = spec["params"]
    mode = spec.get("mode", "random")
    if mode == "grid":
        names = list(params)
        choices = []
        for name in names:
            v = params[name]
            if not isinstance(v, (list, tuple)):
                raise ValueError(f"grid mode needs lists; got {v!r} for {name}")
            choices.append(list(v))
        for combo in itertools.product(*choices):
            yield dict(zip(names, combo))
        return
    rng = np.random.default_rng(spec.get("seed", seed))
    for _ in range(int(spec.get("n_trials", 10))):
        yield {name: sample_param(rng, v) for name, v in params.items()}


def sample_param(rng, v):
    """Draw one value for a sweep param spec: list -> categorical pick;
    {low, high[, log][, int]} -> (log-)uniform with optional rounding."""
    if isinstance(v, (list, tuple)):
        return v[int(rng.integers(len(v)))]
    if isinstance(v, dict):
        lo, hi = float(v["low"]), float(v["high"])
        if v.get("log", False):
            x = float(np.exp(rng.uniform(np.log(lo), np.log(hi))))
        else:
            x = float(rng.uniform(lo, hi))
        return int(round(x)) if v.get("int", False) else x
    raise ValueError(f"unsupported sweep spec: {v!r}")


class TPESampler:
    """Minimal Tree-structured Parzen Estimator for the sweep spec above.

    Numeric params use Parzen (Gaussian-kernel) densities in the search
    space (log-space when ``log: true``) with Scott's-rule bandwidths
    floored at 1/10 of the range; list params use smoothed categorical
    frequencies.  Next point = argmax l(x)/g(x) over ``n_ei_candidates``
    samples drawn from l (the good-trial density).
    """

    def __init__(self, params: dict, seed: int = 123, gamma: float = 0.25,
                 n_startup: int = 5, n_ei_candidates: int = 24):
        self.params = params
        self.rng = np.random.default_rng(seed)
        self.gamma = gamma
        self.n_startup = n_startup
        self.n_ei = n_ei_candidates
        self.history: list = []  # (trial dict, loss)

    def tell(self, trial: dict, loss: float):
        if np.isfinite(loss):
            self.history.append((trial, float(loss)))

    # ---- per-parameter density machinery ---------------------------------
    def _numeric_space(self, v):
        lo, hi = float(v["low"]), float(v["high"])
        if v.get("log", False):
            return np.log(lo), np.log(hi), True
        return lo, hi, False

    def _sample_random(self):
        return {name: sample_param(self.rng, v) for name, v in self.params.items()}

    @staticmethod
    def _parzen_logpdf(x, obs, bw, lo, hi):
        """log density of a uniform-floored Parzen mixture at x."""
        if len(obs) == 0:
            return np.full(np.shape(x), -np.log(hi - lo + 1e-12))
        x = np.asarray(x)[..., None]
        comp = (
            -0.5 * ((x - obs[None, :]) / bw) ** 2
            - np.log(bw * np.sqrt(2 * np.pi))
        )
        # mix with a uniform floor so g never vanishes inside the range
        m = np.logaddexp.reduce(comp, axis=-1) - np.log(len(obs))
        return np.logaddexp(m + np.log(0.9), np.log(0.1 / (hi - lo + 1e-12)))

    def ask(self) -> dict:
        if len(self.history) < self.n_startup:
            return self._sample_random()
        losses = np.asarray([l for _, l in self.history])
        n_good = max(1, int(np.ceil(self.gamma * len(losses))))
        good_idx = set(np.argsort(losses)[:n_good].tolist())

        trial = {}
        for name, v in self.params.items():
            good = [t[name] for i, (t, _) in enumerate(self.history)
                    if i in good_idx]
            bad = [t[name] for i, (t, _) in enumerate(self.history)
                   if i not in good_idx]
            if isinstance(v, (list, tuple)):
                choices = list(v)
                pg = np.array(
                    [1.0 + sum(g == c for g in good) for c in choices]
                )
                pb = np.array(
                    [1.0 + sum(b == c for b in bad) for c in choices]
                )
                pg /= pg.sum()
                pb /= pb.sum()
                cand = self.rng.choice(len(choices), size=self.n_ei, p=pg)
                best = cand[np.argmax(np.log(pg[cand]) - np.log(pb[cand]))]
                trial[name] = choices[int(best)]
            else:
                lo, hi, is_log = self._numeric_space(v)
                xf = lambda u: np.log(u) if is_log else u  # noqa: E731
                g_obs = np.asarray([xf(u) for u in good])
                b_obs = np.asarray([xf(u) for u in bad])
                span = hi - lo
                bw_g = max(span / 10.0, span * len(g_obs) ** -0.2 / 5.0)
                bw_b = max(span / 10.0, span * max(len(b_obs), 1) ** -0.2 / 5.0)
                # draw candidates from l: pick a good obs + kernel noise
                centers = g_obs[self.rng.integers(len(g_obs), size=self.n_ei)]
                cand = np.clip(
                    centers + self.rng.normal(0, bw_g, self.n_ei), lo, hi
                )
                score = self._parzen_logpdf(
                    cand, g_obs, bw_g, lo, hi
                ) - self._parzen_logpdf(cand, b_obs, bw_b, lo, hi)
                x = float(cand[np.argmax(score)])
                x = float(np.exp(x)) if is_log else x
                trial[name] = int(round(x)) if v.get("int", False) else x
        return trial


def run_sweep(base: Config, spec: dict, multitrack: bool, acoustic: bool,
              train_fn=None):
    out_dir = Path(base.train.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    results_path = out_dir / "sweep_results.jsonl"

    if train_fn is not None:
        _train = train_fn
    else:
        from ensemble_svs_with_interactions_tpu_torch.train import (
            multitrack_trainer,
            trainer,
        )

        fn = (multitrack_trainer.train_multitrack_model if multitrack
              else trainer.train_model)

        def _train(cfg):
            return fn(cfg, is_acoustic=acoustic,
                      device=cfg.get("device", "cuda"))

    mode = spec.get("mode", "random")
    sampler = None
    if mode == "tpe":
        sampler = TPESampler(
            spec["params"],
            seed=int(spec.get("seed", 123)),
            gamma=float(spec.get("gamma", 0.25)),
            n_startup=int(spec.get("n_startup", 5)),
            n_ei_candidates=int(spec.get("n_ei_candidates", 24)),
        )
        trial_iter = (sampler.ask() for _ in range(int(spec.get("n_trials", 10))))
    else:
        trial_iter = sample_trials(spec)

    best = (float("inf"), None, None)
    with open(results_path, "w") as f:
        for i, trial in enumerate(trial_iter):
            overrides: dict = {}
            for name, value in trial.items():
                _set_path(overrides, name, value)
            _set_path(overrides, "train.out_dir", str(out_dir / f"trial{i:03d}"))
            cfg = merge(base, overrides)
            metrics = _train(cfg)
            loss = float(metrics.get("Loss", float("nan")))
            if sampler is not None:
                sampler.tell(trial, loss)
            row = {"trial": i, "params": trial, "dev_loss": loss}
            f.write(json.dumps(row) + "\n")
            f.flush()
            print(f"trial {i}: loss={loss:.5f} params={trial}")
            if np.isfinite(loss) and loss < best[0]:
                best = (loss, i, trial)

    if best[1] is not None:
        (out_dir / "best_trial.yaml").write_text(
            yaml_io.dump(
                {"trial": best[1], "dev_loss": best[0], "params": best[2]}
            )
        )
        print(f"best: trial {best[1]} loss={best[0]:.5f} params={best[2]}")
    return best


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("base_config")
    ap.add_argument("sweep_config")
    ap.add_argument("--multitrack", action="store_true")
    ap.add_argument("--acoustic", action="store_true")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)

    base = load_config(args.base_config)
    if args.overrides:
        base = merge(base, parse_overrides(args.overrides))
    spec = yaml_io.load(Path(args.sweep_config).read_text())
    run_sweep(base, spec, args.multitrack, args.acoustic)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
