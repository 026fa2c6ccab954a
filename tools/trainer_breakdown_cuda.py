"""Where the multitrack acoustic trainer's time goes on the card, outside
and inside its train steps.

    python3 tools/trainer_breakdown_cuda.py

The recipe's acoustic phase as ``chip_smoke.py``'s phase ``trainer`` runs
it (``chip_smoke.recipe_phase_config``: the shipped model at full width,
AMP, Adam, 64 crops of 256 frames a batch) on ``chip_smoke.write_corpus``'s
corpus (TRAINER_CORPUS), with the trainer's own pieces timed one by one:

* ``init_s``: building the model and drawing its weights
  (``utils/flax_init``), and moving it to the card;
* ``checkpoint_s``: one ``TrainState.capture`` and one ``save_checkpoint``
  of the latest and best files;
* one epoch of train steps (5 batches, the last a half batch) fed four
  ways, each after a warm-up epoch: ``prefetch`` as the trainer feeds
  them (batches built and pinned on the prefetch thread, copied on the
  training thread), ``prebuilt`` (the same batches built and pinned
  before the epoch), ``resident`` (the same batches already on the
  card), and ``same_batch`` (the first full batch again and again, as
  ``train_bench`` times the bare step);
* ``dev_s``: one dev pass (eval steps over the dev split) and
  ``distortions_s``: its host-side distortions.

Prints one JSON line with the card's name and power limit.  Needs one
CUDA device.
"""

from __future__ import annotations

import json
import sys
import tempfile
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402


def _sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def main() -> int:
    if not torch.cuda.is_available():
        print("trainer_breakdown_cuda: no CUDA device", file=sys.stderr)
        return 2
    from ensemble_svs_with_interactions_tpu_torch.data.dataset import (
        prefetch_batches,
    )
    from ensemble_svs_with_interactions_tpu_torch.data.multitrack import (
        MultiTrackBatchIterator,
        MultiTrackFeatsDataset,
    )
    from ensemble_svs_with_interactions_tpu_torch.train import metrics as M
    from ensemble_svs_with_interactions_tpu_torch.train.loop import (
        TrainState,
        build_optimizer,
        save_checkpoint,
    )
    from ensemble_svs_with_interactions_tpu_torch.train.multitrack import (
        create_multitrack_acoustic_train_step,
    )
    from ensemble_svs_with_interactions_tpu_torch.train.trainer import (
        load_out_scaler,
        pin_batch,
        to_device,
    )
    from ensemble_svs_with_interactions_tpu_torch.utils.config import (
        instantiate,
    )
    from ensemble_svs_with_interactions_tpu_torch.utils.flax_init import (
        init_module,
    )

    dev = torch.device("cuda")
    out = {"card": cs.card_line()}
    with tempfile.TemporaryDirectory() as root:
        root = Path(root)
        corpus = cs.write_corpus(root / "dump", **cs.TRAINER_CORPUS,
                                 seed=cs.SEED)
        cfg = cs.recipe_phase_config("acoustic", corpus, root / "exp")
        model = cfg["model"]
        torch.zeros(1, device=dev)  # the CUDA context, outside the clocks
        out["init_s"], module = _sync_time(
            lambda: init_module(instantiate(model["netG"]), 0).to(dev))
        optim = cfg["train"]["optim"]
        opt, sched = build_optimizer(module.parameters(),
                                     dict(optim["optimizer"]),
                                     dict(optim["lr_scheduler"]),
                                     steps_per_epoch=5)
        step, eval_step = create_multitrack_acoustic_train_step(
            module, opt, dict(model), scheduler=sched, feats_criterion="l1",
            pitch_reg_weight=0.0, use_amp=True, device=dev)
        weights = {"logf0_diff": 0.0, "mgc_diff": 0.0}
        gen = torch.Generator(device=dev).manual_seed(cs.SEED)
        data = {split: MultiTrackFeatsDataset(
            corpus / split / "in_acoustic", corpus / split / "out_acoustic",
            cs.CORPUS_SPKS) for split in ("train_no_dev", "dev")}

        def batches(epoch):
            return MultiTrackBatchIterator(
                data["train_no_dev"], max_tokens=16384, time_multiple=32,
                seed=epoch, length_cap=256)

        def epoch_of(feed):
            times, frames = [], 0
            for b in feed:
                t0 = time.perf_counter()
                step(b, weights, gen)
                times.append(time.perf_counter() - t0)
                frames += int(b["lengths"].sum())
            return {"steps": len(times), "frames": frames,
                    "seconds": sum(times), "frames_per_s": frames / sum(times),
                    "step_s": times}

        def prefetch(epoch):
            def pipeline():
                for b in batches(epoch):
                    yield pin_batch(b, dev)
            return (to_device(p, dev) for p in prefetch_batches(pipeline()))

        built = [pin_batch(b, dev) for b in batches(2)]
        resident = [to_device(b, dev) for b in built]
        torch.cuda.synchronize()
        first = max(resident, key=lambda b: len(b["lengths"]))
        feeds = {
            "prefetch": lambda: prefetch(2),
            "prebuilt": lambda: (to_device(b, dev) for b in built),
            "resident": lambda: iter(resident),
            "same_batch": lambda: iter([first] * len(resident)),
        }
        epoch_of(prefetch(1))  # warm-up epoch
        out["train_epoch"] = {}
        for name, feed in feeds.items():
            epoch_of(feed())  # warm-up of this feed
            out["train_epoch"][name] = epoch_of(feed())

        out_scaler = load_out_scaler(corpus / "scalers" /
                                     "out_acoustic_scaler")
        dev_it = MultiTrackBatchIterator(data["dev"], max_tokens=16384,
                                         time_multiple=32, shuffle=False)
        dev_s = dist_s = 0.0
        for b in dev_it:
            t, (_, pred) = _sync_time(lambda: eval_step(
                to_device(pin_batch(b, dev), dev), weights))
            dev_s += t
            t0 = time.perf_counter()
            M.compute_distortions(pred.float().cpu().numpy(), b["out_feats0"],
                                  b["lengths"], out_scaler,
                                  list(model["stream_sizes"]),
                                  list(model["has_dynamic_features"]),
                                  int(model["num_windows"]))
            dist_s += time.perf_counter() - t0
        out["dev_s"], out["distortions_s"] = dev_s, dist_s

        def checkpoint():
            save_checkpoint(root / "ckpt",
                            TrainState.capture(module, opt, sched, 10), 1,
                            is_best=True)
        out["checkpoint_s"], _ = _sync_time(checkpoint)
        out["checkpoint_mb"] = sum(
            p.stat().st_size for p in (root / "ckpt").iterdir()) / 2 ** 20
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
