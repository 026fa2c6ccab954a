"""One rank of a data-parallel run of the port over gloo on the CPU, for
``tests/test_torch_parallel*.py``.  It imports torch, NumPy and the port,
never JAX.

    python tests/torch_parallel_worker.py JOB.json RANK

``JOB.json`` holds ``kind``, ``port`` (the coordinator's loopback port),
``world`` and the job's files; the rank writes its result beside them as
``result{RANK}.pt``.  Kinds:

* ``allreduce``: a 2-entry CPU mesh a rank (4 shards in all), each entry
  holding rank + 1, summed over every shard: 2 x 1 + 2 x 2 = 6;
* ``step``: ``steps`` multitrack acoustic train steps on this rank's rows
  of ``batch`` (an ``.npz``) from the state dict ``state``; with
  ``ddp: true`` the losses and batch norm use this rank's own counts and
  the gradients are averaged, as ``DistributedDataParallel`` would (a
  planted fault the tests must catch);
* ``trainer``: ``train_multitrack_model`` (``multitrack``) or
  ``train_model`` on the CPU from the config tree ``config``; with ``fn``
  ``postfilter`` or ``vocoder``, ``train_postfilter`` or
  ``train_vocoder``.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from ensemble_svs_with_interactions_tpu_torch.parallel import mesh as M  # noqa: E402,E501


def allreduce(job, rank):
    mesh = M.make_mesh(2, device="cpu")
    assert mesh.world_size == 2 and mesh.rank == rank and mesh.size == 4
    local = torch.stack([torch.full((), float(rank + 1))
                         for _ in mesh.devices])
    return {"total": float(M.all_reduce_sum(local.sum())),
            "shards": [(str(d), sl.start, sl.stop)
                       for d, sl in M.batch_sharding(mesh, 8)]}


def plant_ddp():
    """Per-rank normalisers and batch statistics, averaged gradients."""
    from ensemble_svs_with_interactions_tpu_torch.models import layers
    from ensemble_svs_with_interactions_tpu_torch.train import loop, losses

    losses.global_count = lambda c: torch.clamp(torch.as_tensor(c), min=1.0)
    layers.all_reduce_sum = layers.all_reduce_sum_autograd = lambda t: t
    reduce = loop.reduce_grads

    def averaged(grads, metrics):
        out = reduce(grads, metrics)
        n = M.world_size()
        for g in grads:
            g.div_(n)
        return {k: v / n for k, v in out.items()}

    loop.reduce_grads = averaged
    from ensemble_svs_with_interactions_tpu_torch.train import multitrack

    multitrack.reduce_grads = averaged


def step(job, rank):
    from ensemble_svs_with_interactions_tpu_torch.train import loop
    from ensemble_svs_with_interactions_tpu_torch.train import multitrack as mt
    from ensemble_svs_with_interactions_tpu_torch.utils.config import (
        instantiate,
    )

    if job.get("ddp"):
        plant_ddp()
    module = instantiate(job["config"])
    module.load_state_dict(torch.load(job["state"]))
    opt, sched = loop.build_optimizer(module.parameters(), job["optimizer"])
    train_step, _ = mt.create_multitrack_acoustic_train_step(
        module, opt, {"stream_sizes": job["stream_sizes"]}, scheduler=sched,
        pitch_reg_weight=1.0, device="cpu")
    mesh = M.make_mesh(device=["cpu"])
    batch = dict(np.load(job["batch"]))
    rows, = M.shard_batch(batch, mesh)
    weights = {"logf0_diff": 1.0, "mgc_diff": 1.0}
    g = torch.Generator().manual_seed(0)
    metrics = [train_step(rows, weights, g) for _ in range(job["steps"])]
    return {"metrics": metrics, "state": module.state_dict()}


def trainer(job, rank):
    from ensemble_svs_with_interactions_tpu_torch.train import (
        multitrack_trainer,
        trainer,
    )
    from ensemble_svs_with_interactions_tpu_torch.utils.config import Config

    cfg = Config(job["config"])
    if job.get("fn") == "postfilter":
        from ensemble_svs_with_interactions_tpu_torch.train import (
            postfilter_trainer,
        )

        out = postfilter_trainer.train_postfilter(cfg, device="cpu")
    elif job.get("fn") == "vocoder":
        from ensemble_svs_with_interactions_tpu_torch.train import (
            vocoder_trainer,
        )

        out = vocoder_trainer.train_vocoder(cfg, device="cpu")
    elif job["multitrack"]:
        out = multitrack_trainer.train_multitrack_model(
            cfg, job["acoustic"], device="cpu")
    else:
        out = trainer.train_model(cfg, is_acoustic=job["acoustic"],
                                  device="cpu")
    return {"dev": out}


def main(path, rank):
    job = json.loads(Path(path).read_text())
    torch.set_num_threads(1)
    rank = int(rank)
    if job["kind"] != "trainer":  # the trainers join from their config
        M.maybe_initialize_distributed(f"127.0.0.1:{job['port']}",
                                       job["world"], rank, device="cpu")
    result = {"allreduce": allreduce, "step": step,
              "trainer": trainer}[job["kind"]](job, rank)
    result["world_size"] = M.world_size()
    torch.save(result, Path(path).parent / f"result{rank}.pt")
    M.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:])
