"""The port's parallel layer on the CPU (``parallel/mesh.py``,
``gen.ModelPack.set_mesh`` / ``SPSVS.set_mesh``,
``ops/world/synthesis_sharded.py``) against the JAX package's on its
virtual CPU devices, and the two repairs that came with it: the kernel
build's cross-process file lock and ``train.use_detect_anomaly``.

Rank processes are subprocesses (``tests/torch_parallel_worker.py``) that
import no JAX, joined over a loopback port.  Bounds are the JAX tests':
``tests/test_svs_ensemble.py``'s for the sharded ensemble (streams at
rtol 1e-4, atol 1e-5; int16 waveforms RMS < 1e-4 of full scale,
correlation > 0.9999) and ``tests/test_world.py``'s for time-sharded
synthesis (> 40 dB SNR against the single-device call, the largest error
under 1e-2 of the peak).
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from ensemble_svs_with_interactions_tpu import gen_multitrack as jax_gmt
from ensemble_svs_with_interactions_tpu.io import hts as jax_hts
from ensemble_svs_with_interactions_tpu.ops.world import (
    synthesis as jax_syn,
)
from ensemble_svs_with_interactions_tpu.ops.world import (
    synthesis_sharded as jax_sharded,
)
from ensemble_svs_with_interactions_tpu.parallel import make_mesh as jax_mesh
from ensemble_svs_with_interactions_tpu_torch import gen
from ensemble_svs_with_interactions_tpu_torch.io import hts
from ensemble_svs_with_interactions_tpu_torch.ops import lstm_recurrence
from ensemble_svs_with_interactions_tpu_torch.ops.world import synthesis
from ensemble_svs_with_interactions_tpu_torch.ops.world import (
    synthesis_sharded,
)
from ensemble_svs_with_interactions_tpu_torch.parallel import mesh as M
from ensemble_svs_with_interactions_tpu_torch.train import (
    multitrack_trainer,
)
from ensemble_svs_with_interactions_tpu_torch.train import trainer
from ensemble_svs_with_interactions_tpu_torch.utils.config import (
    instantiate,
    merge,
)
from ensemble_svs_with_interactions_tpu_torch.utils.flax_port import (
    flax_to_torch,
)
from tests.test_torch_svs import _short_labels, engines  # noqa: F401
from tests.test_torch_svs import few_threads  # noqa: F401  (autouse)
from tests.test_torch_svs import tiny_model

WORKER = Path(__file__).resolve().parent / "torch_parallel_worker.py"
REPO = WORKER.parent.parent
WORLD = 2
SNR_DB = 40.0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env() -> dict:
    env = {k: v for k, v in os.environ.items() if not k.startswith("XLA")}
    env["OMP_NUM_THREADS"] = "1"
    return env


def start_ranks(root: Path, jobs: list):
    """One worker process a job (rank r takes ``jobs[r]``, each with the
    same loopback ``port`` and ``world``), started; ``finish_ranks``
    collects them, so the caller can work meanwhile."""
    procs, paths = [], []
    for r, job in enumerate(jobs):
        d = root / f"rank{r}"
        d.mkdir(parents=True, exist_ok=True)
        paths.append(d)
        (d / "job.json").write_text(json.dumps(job))
        procs.append(subprocess.Popen(
            [sys.executable, str(WORKER), str(d / "job.json"), str(r)],
            cwd=REPO, env=rank_env(), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return procs, paths


def finish_ranks(started, timeout: float = 300.0) -> list:
    """The started ranks' results in rank order (each must exit 0)."""
    procs, paths = started
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-4000:]}"
    return [torch.load(d / f"result{r}.pt", weights_only=False)
            for r, d in enumerate(paths)]


def run_ranks(root: Path, jobs: list, timeout: float = 300.0) -> list:
    return finish_ranks(start_ranks(root, jobs), timeout)


def snr_db(ref, got) -> float:
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    return float(20 * np.log10(np.sqrt((ref ** 2).mean()) / np.sqrt(
        ((ref - got) ** 2).mean() + 1e-30)))


# ------------------------------------------------------------ the helpers
def test_mesh_helpers():
    """``make_mesh`` over CPU entries and an explicit list with repeats,
    contiguous ``batch_sharding`` / ``shard_batch``, ``replicate_tree``'s
    copies, and the identities without a process group."""
    mesh = M.make_mesh(3, device="cpu")
    assert mesh.devices == (torch.device("cpu"),) * 3
    assert (mesh.size, mesh.world_size, mesh.rank) == (3, 1, 0)
    assert mesh.axis_names == ("data",)
    assert [sl for _, sl in M.batch_sharding(mesh, 6)] == [
        slice(0, 2), slice(2, 4), slice(4, 6)]
    with pytest.raises(ValueError):
        M.batch_sharding(mesh, 5)
    batch = {"x": np.arange(12.0).reshape(6, 2), "n": np.arange(6)}
    shards = M.shard_batch(batch, mesh)
    assert len(shards) == 3
    for k, s in enumerate(shards):
        assert torch.equal(s["n"], torch.arange(2 * k, 2 * k + 2))
        np.testing.assert_array_equal(s["x"].numpy(),
                                      batch["x"][2 * k: 2 * k + 2])
    assert M.replicate(mesh) == mesh.devices
    twice = M.make_mesh(device=["cpu", "cpu"])
    tree = {"w": torch.ones(2), "b": [torch.zeros(1)]}
    copies = M.replicate_tree(tree, twice)
    assert len(copies) == 2 and torch.equal(copies[1]["w"], tree["w"])
    assert M.make_mesh(1, device=["cpu", "cpu"]).devices == (
        torch.device("cpu"),)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError):
            M.make_mesh(2)
    assert M.maybe_initialize_distributed(None) == 0
    t = torch.arange(3.0, requires_grad=True)
    assert M.all_reduce_sum(t) is t and M.all_reduce_sum_autograd(t) is t
    assert M.all_gather_rows(t) is t and M.world_size() == 1


def test_two_processes_all_reduce_to_six(tmp_path):
    """Two real processes join one gloo group through
    ``maybe_initialize_distributed`` (the counterpart of
    ``tests/test_multihost.py``): each holds a 2-entry CPU mesh, so the
    batch splits into 4 shards, rank 1's the last two; the sum over every
    shard, 2 x 1.0 + 2 x 2.0, is 6.0 on both."""
    port = free_port()
    results = run_ranks(tmp_path, [{"kind": "allreduce", "port": port,
                                    "world": WORLD}] * WORLD)
    for r, res in enumerate(results):
        assert res["world_size"] == WORLD
        assert res["total"] == 6.0
        assert [s[1:] for s in res["shards"]] == [
            (4 * r, 4 * r + 2), (4 * r + 2, 4 * r + 4)]


# ---------------------------------------------------------- set_mesh
def mesh_streams(engine, jax_side: bool, n_tracks: int, mesh):
    """The fused device postprocess's (mgc, lf0, vuv, bap) of an
    ``n_tracks`` pairwise ensemble under ``set_mesh(mesh)``, as host
    arrays of the real tracks."""
    mod = jax_hts if jax_side else hts
    spk_ids = list(range(n_tracks))
    pairs = [(i + 1) % n_tracks for i in range(n_tracks)]
    engine.set_mesh(mesh)
    try:
        labels = [_short_labels(mod) for _ in range(n_tracks)]
        if jax_side:
            e = engine
            dm = jax_gmt.predict_timing_multitrack_batch(
                labels, spk_ids, pairs, e.binary_dict, e.numeric_dict,
                e.timelag_model, e.in_timelag_scaler, e.out_timelag_scaler,
                e.duration_model, e.in_duration_scaler,
                e.out_duration_scaler, frame_period=e.frame_period)
        else:
            dm = engine.predict_timing_multitrack_batch(labels, spk_ids,
                                                        pairs)
        feats, raw = engine._frame_features(dm)
        spks = ([spk_ids[i] for i in range(n_tracks)],
                [spk_ids[pairs[i]] for i in range(n_tracks)])
        if jax_side:
            spks = tuple(np.asarray(s, np.int32) for s in spks)
        out, lengths = engine.acoustic_model.inference_batch(
            feats, spks=spks, sub_index=pairs, method="inference_main",
            device_out=True)
        streams = engine._fused_postprocess(out, lengths, raw, "gv")
    finally:
        engine.set_mesh(None)
    return [np.asarray(s)[:n_tracks] for s in streams], list(lengths)


@pytest.mark.parametrize("n_tracks", [2, 3])
def test_set_mesh_matches_jax(engines, n_tracks):
    """The tiny multitrack pack's ensemble over a 2-entry mesh (3 tracks
    pad to 4 rows, a padding row on the second entry): the streams against
    the JAX engine's on ``make_mesh(2)`` and the port's own on one device,
    and ``svs_ensemble``'s int16 waveforms against the port's one-device
    render."""
    jax_engine, engine = engines
    mesh = M.make_mesh(2, device="cpu")
    ref, lengths = mesh_streams(jax_engine, True, n_tracks, jax_mesh(2))
    got, got_lengths = mesh_streams(engine, False, n_tracks, mesh)
    one, _ = mesh_streams(engine, False, n_tracks, None)
    assert got_lengths == lengths
    for g, r, o in zip(got, ref, one):
        for i, n in enumerate(lengths):
            np.testing.assert_allclose(g[i, :n], r[i, :n], rtol=1e-4,
                                       atol=1e-5)
            np.testing.assert_allclose(g[i, :n], o[i, :n], rtol=1e-4,
                                       atol=1e-5)
    labels = [_short_labels(hts) for _ in range(n_tracks)]
    wavs_ref, _ = engine.svs_ensemble(labels)
    engine.set_mesh(mesh)
    try:
        wavs, _ = engine.svs_ensemble([_short_labels(hts)
                                       for _ in range(n_tracks)])
    finally:
        engine.set_mesh(None)
    assert engine.acoustic_model.mesh is None
    assert len(wavs) == n_tracks
    for wm, wr in zip(wavs, wavs_ref):
        assert len(wm) == len(wr)
        a = wm.astype(np.float64) / 32767.0
        b = wr.astype(np.float64) / 32767.0
        assert np.sqrt(((a - b) ** 2).mean()) < 1e-4
        assert np.corrcoef(a, b)[0, 1] > 0.9999


def test_set_mesh_draws_the_one_device_masks():
    """The tiny acoustic model with the AR F0 decoder's inference dropout
    on (prenet_dropout 0.5): 4 rows over a 2-entry mesh draw the whole
    batch's masks and cut their rows (``parallel.mesh.drawing_rows``), so
    the output is the one-device output; the masks matter (another seed
    moves it)."""
    glob, cfgs, variables, _ = tiny_model()
    net = dict(cfgs["acoustic"]["netG"])
    net["lf0_model"] = dict(net["lf0_model"], prenet_dropout=0.5)
    module = flax_to_torch(instantiate(net), variables["acoustic"])
    pack = gen.ModelPack(module, cfgs["acoustic"], device="cpu")
    rng = np.random.default_rng(3)
    xs = [rng.uniform(0, 1, (n, 86)).astype(np.float32)
          for n in (40, 33, 57, 21)]
    kw = {"spks": ([0, 1, 2, 3], [1, 2, 3, 0]), "sub_index": [1, 2, 3, 0],
          "method": "inference_main"}
    one = pack.inference_batch(xs, **kw)
    pack.set_mesh(M.make_mesh(2, device="cpu"))
    sharded = pack.inference_batch(xs, **kw)
    pack.set_mesh(None)
    for o, s in zip(one, sharded):
        np.testing.assert_allclose(s, o, atol=1e-6)
    orig = gen.AR_SEED
    gen.AR_SEED = orig + 1
    try:
        other = pack.inference_batch(xs, **kw)
    finally:
        gen.AR_SEED = orig
    assert max(np.abs(a - b).max() for a, b in zip(other, one)) > 1e-3


# ------------------------------------------------ time-sharded synthesis
def world_params(T=157, F=513, seed=7):
    rng = np.random.default_rng(seed)
    f0 = np.where(rng.random(T) > 0.3, rng.uniform(100.0, 400.0, T), 0.0)
    sp = np.exp(rng.normal(-8.0, 1.0, (T, F)))
    ap = np.clip(rng.random((T, F)), 0.05, 0.95)
    return f0, sp, ap


def coded_streams(T=157, seed=8):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 0.1, (T, 60)).astype(np.float32),
            np.log(rng.uniform(100, 400, (T, 1))).astype(np.float32),
            (rng.random((T, 1)) > 0.3).astype(np.float32),
            rng.normal(-2, 1, (T, 5)).astype(np.float32))


def assert_snr(ref, got, name, record):
    ref, got = np.asarray(ref), np.asarray(got)
    assert got.shape == ref.shape
    snr = snr_db(ref, got)
    record(f"snr_db_{name}", snr)
    assert snr > SNR_DB, (name, snr)
    assert np.abs(ref - got).max() < 1e-2 * np.abs(ref).max(), name


@pytest.mark.parametrize("shards", [2, 3])
def test_synthesize_time_sharded_matches_jax_and_one_device(
        shards, record_property):
    """WORLD parameters of an odd frame count (padding to the shard count)
    through ``synthesize_time_sharded`` on a CPU mesh against JAX's on
    ``make_mesh(shards)`` (JAX's noise handed to the port) and the port's
    one-device ``synthesize``."""
    f0, sp, ap = world_params()
    fs, hop = 16000, 80
    key = jax.random.PRNGKey(0)
    noise = np.asarray(jax.random.normal(key, (len(f0) * hop,)))
    ref = jax_sharded.synthesize_time_sharded(f0, sp, ap, fs, key=key,
                                              mesh=jax_mesh(shards))
    got = synthesis_sharded.synthesize_time_sharded(
        f0, sp, ap, fs, noise=noise, mesh=M.make_mesh(shards, device="cpu"))
    one = synthesis.synthesize(*(torch.as_tensor(a, dtype=torch.float32)[None]
                                 for a in (f0, sp, ap)),
                               torch.from_numpy(noise)[None], fs)[0]
    assert_snr(ref, got.numpy(), "jax", record_property)
    assert_snr(one.numpy(), got.numpy(), "one_device", record_property)
    assert_snr(jax_syn.synthesize(f0, sp, ap, fs, key=key), got.numpy(),
               "jax_one_device", record_property)


@pytest.mark.parametrize("shards", [2, 8])
def test_synthesize_from_streams_time_sharded_matches_jax_and_one_device(
        shards, record_property):
    """A coded-stream track with the 70 Hz high-pass through
    ``synthesize_from_streams_time_sharded`` against JAX's on
    ``make_mesh(shards)`` (JAX's B = 1 noise row handed to the port), and
    against the port's one-device call; by default the noise is
    ``gen.vocoder_noise``'s B = 1 row, so the default call equals the
    engine's one-device render of the track."""
    streams = coded_streams()
    fs, hop = 48000, 240
    T = len(streams[1])
    key = jax.random.PRNGKey(11)
    noise = np.asarray(jax.random.normal(key, (1, T * hop)))[0]
    ref = jax_sharded.synthesize_from_streams_time_sharded(
        *streams, fs, key=key, highpass_cutoff=70.0, mesh=jax_mesh(shards))
    mesh = M.make_mesh(shards, device="cpu")
    got = synthesis_sharded.synthesize_from_streams_time_sharded(
        *streams, fs, noise=noise, highpass_cutoff=70.0, mesh=mesh)
    assert_snr(ref, got.numpy(), "jax", record_property)
    tensors = [torch.from_numpy(a)[None] for a in streams]
    one = synthesis.synthesize_from_streams(
        *tensors, gen.vocoder_noise(1, T * hop, "cpu"), fs,
        highpass_cutoff=70.0)[0]
    default = synthesis_sharded.synthesize_from_streams_time_sharded(
        *streams, fs, highpass_cutoff=70.0, mesh=mesh)
    assert_snr(one.numpy(), default.numpy(), "one_device", record_property)


# ------------------------------------------------------------ the repairs
STUB_NVCC = """#!{python}
import sys, time
from pathlib import Path
out = Path(sys.argv[sys.argv.index("-o") + 1])
with open(out.parent / "nvcc_runs", "a") as f:
    f.write(out.name + "\\n")
time.sleep(1.0)
out.write_bytes(b"stub")
"""

BUILD = """
import sys
from pathlib import Path
sys.path.insert(0, {repo!r})
from ensemble_svs_with_interactions_tpu_torch.ops import lstm_recurrence as lr
lr.BUILD_DIR = Path({build!r})
lr._find_nvcc = lambda: {nvcc!r}
print(sorted(p.name for p in lr.build().values()))
"""


def test_kernel_build_runs_nvcc_once_across_processes(tmp_path):
    """Two processes build the kernels at once into one empty build
    directory with a stub ``nvcc`` that takes a second: the file lock lets
    one build and the other load its libraries, so each source is
    compiled once."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(STUB_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    build = tmp_path / "_build"
    code = BUILD.format(repo=str(REPO), build=str(build), nvcc=str(nvcc))
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert outs[0] == outs[1]
    runs = (build / "nvcc_runs").read_text().split()
    assert len(runs) == len(lstm_recurrence.SOURCES), runs


def timing_config(corpus, out_dir, multitrack: bool):
    if multitrack:
        from tests.test_torch_trainer_multitrack import (
            TIMING_DATA,
            phase_config,
            timing_model,
        )

        return phase_config("duration", corpus, out_dir,
                            timing_model("duration"),
                            **{**TIMING_DATA, "train.nepochs": 1})
    from tests.test_torch_trainer import _timing_model
    from tests.test_torch_trainer_multitrack import TIMING_DIM

    cfg = chip_smoke.recipe_phase_config(
        "duration", corpus, out_dir, multitrack=False, **{
            "train.nepochs": 1, "data.batch_max_frames": 24})
    model = _timing_model()
    model["netG"]["in_dim"] = TIMING_DIM
    return merge(cfg, {"model": model})


@pytest.mark.parametrize("multitrack", [False, True],
                         ids=["train_model", "train_multitrack_model"])
def test_detect_anomaly_raises_on_a_planted_nan(tmp_path, multitrack):
    """``train.use_detect_anomaly``: a NaN planted in a tiny timing model's
    forward (its first Dense's output) makes the backward raise at the
    operation that made it, as JAX's ``jax_debug_nans`` raises; without
    the flag the trainer's NaN-skip steps over it."""
    from tests.test_torch_trainer_multitrack import TIMING_DIM

    corpus = chip_smoke.write_corpus(tmp_path / "corpus", 2, 1, (40, 64),
                                     seed=5, timing_dim=TIMING_DIM)
    mod = multitrack_trainer if multitrack else trainer
    orig = mod.instantiate

    def planted(node):
        module = orig(node)
        dense = next(m for m in module.modules()
                     if isinstance(m, torch.nn.Linear))
        dense.register_forward_hook(lambda m, i, o: o * float("nan"))
        return module

    def run(flag, out):
        cfg = merge(timing_config(corpus, tmp_path / out, multitrack),
                    {"train": {"use_detect_anomaly": flag}})
        if multitrack:
            return mod.train_multitrack_model(cfg, False, device="cpu")
        return mod.train_model(cfg, is_acoustic=False, device="cpu")

    mod.instantiate = planted
    try:
        assert not np.isfinite(run(False, "off")["Loss"])
        with pytest.raises(RuntimeError, match="nan"):
            run(True, "on")
    finally:
        mod.instantiate = orig
        torch.autograd.set_detect_anomaly(False)
