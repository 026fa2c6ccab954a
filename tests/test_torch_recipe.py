"""The recipe end to end on the port (stages -1 to 7, 10 and 11 of
``bin/run_recipe.py``) and its CLIs, against the JAX package's stage
functions and CLIs, on the CPU.

One module-scoped synthetic jaCappella corpus (``tests/util.
build_synthetic_jacappella_corpus``, 2 singers x 3 songs at 24 kHz) goes
through the port's runner, ``--stage -1 --stop-stage 7`` and then
``--stage 11``, with ``device=cpu``, on the packaged recipe merged with the
JAX e2e test's overrides (``tests/util.multitrack_mini_recipe_overrides``).
Two changes to those, both for the comparisons: the mini model configs are
written without YAML aliases (the port's YAML subset reads none) and with
the AR log-F0 decoder's ``prenet_dropout`` at 0 (its inference masks come
from each framework's own generator and cannot match); and stage 7 and 11
read one eval segment (``song2_seg0``, both singers), links made before the
run to the labels stage -1 writes, to bound the cost.  The JAX package then
runs on the port's work directory: no JAX training runs here, since
``tests/test_torch_trainer_multitrack.py`` holds the trainers.

* the phase configs (``_train_cfg``, ``_resolve_lf0_stats``) equal JAX's;
* stage 6: the JAX runner's ``stage6_pack`` on a copy of the work
  directory gives the same pack: configs equal when parsed, the question
  set and scalers byte-equal, every weight and batch statistic bitwise;
* stage 7: JAX's ``synthesis_multitrack.main`` on the port's pack and
  labels writes the same files; timing dumps equal, the streams within
  STREAM_RTOL of each stream's scale (postprocessed streams, whose GV
  postfilter magnifies small differences: ``chip_smoke.POST_ATOL``'s
  bound), each wav at SNR >= 40 dB with the port's vocoder noise fed to
  the JAX vocoder;
* stage 11: JAX's ``evaluate_timing_multitrack.main`` writes the same
  timelag dumps; the durations are MDN means in float32, unrounded, held
  at TIMING_RTOL (``tests/test_torch_multitrack_pairs.py``'s bound);
  ``QUALITY.json`` is byte-equal to JAX's ``_write_quality_json`` of the
  same work directory;
* stage 10 with a tiny hn-uSFGAN, one step: the config the port hands
  ``train_vocoder`` equals the one the JAX stage builds (but for the
  packaged vocoder config's null ``train.out_dir``), and the pack serves
  ``vocoder_type="auto"`` in both engines;
* the single-track CLIs (``synthesis``, ``evaluate_timing``) on one
  seeded single-track pack, ``sweep`` in its three modes with a seeded
  fake trainer, ``train_acoustic_multi``, and the default device.

The JAX side's flax ``init`` calls (the templates that stage 6 restores
the checkpoints into, and that its engines restore a pack into) are traced
by ``jax.eval_shape`` (``tests/test_torch_svs.traced_flax_inits``): the
same structure without a compile; every value comes from the files.
"""

import hashlib
import json
import os
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from scipy.io import wavfile

from ensemble_svs_with_interactions_tpu.bin import run_recipe as jax_recipe
from ensemble_svs_with_interactions_tpu.utils.config import (
    load_config as jax_load,
)
from ensemble_svs_with_interactions_tpu.utils.config import merge as jax_merge
from ensemble_svs_with_interactions_tpu_torch import gen
from ensemble_svs_with_interactions_tpu_torch.bin import run_recipe
from ensemble_svs_with_interactions_tpu_torch.utils.config import load_config
from tests.test_torch_svs import traced_flax_inits
from tests.util import (
    build_synthetic_jacappella_corpus,
    multitrack_mini_recipe_overrides,
    write_multitrack_mini_model_configs,
)

SR = 24000
SPKS = ["alto", "soprano"]
SEGMENT = "song2_seg0"
RECIPE = (Path(__file__).resolve().parents[1] /
          "ensemble_svs_with_interactions_tpu" / "recipes" /
          "jaCappella_dev_48k_world_multitrack" / "config.yaml")
STREAM_RTOL = 1e-3
TIMING_RTOL = 1e-5
SNR_DB = 40.0
PHASES = ("timelag", "duration", "acoustic")
STREAMS = ("mgc", "logF0", "vuv", "bap")
_NET = {"blockA": 0, "cycleA": 0, "blockF": 0, "cycleF": 0,
        "cascade_mode": 0}
# stage 10 at the corpus's 24 kHz: static streams 8 + 1 + 1 + 3, aux 11,
# hop 120 = 5 * 4 * 3 * 2; tiny networks, one step of 2 crops
VOCODER = {
    "data": {"sample_rate": SR, "stream_sizes": [8, 1, 1, 3],
             "crop_frames": 32},
    "model": {
        "generator": {
            "residual_channels": 4, "gate_channels": 8, "skip_channels": 4,
            "aux_channels": 11,
            "upsample_params": {"upsample_scales": [5, 4, 3, 2]},
            "harmonic_network_params": {**_NET, "blockA": 4, "cycleA": 2},
            "noise_network_params": {**_NET, "blockF": 2, "cycleF": 2},
            "filter_network_params": {**_NET, "blockF": 4, "cycleF": 2},
            "periodicity_estimator_params": {"conv_layers": 2,
                                             "kernel_size": 3,
                                             "dilation": 1}},
        "discriminator": {
            "fft_sizes": [64, 128], "hop_sizes": [16, 32],
            "win_lengths": [32, 64], "periods": [2, 3],
            "spectral_discriminator_params": {"channels": 4},
            "period_discriminator_params": {
                "channels": 4, "max_downsample_channels": 16,
                "downsample_scales": [3, 3, 1]}}},
    "train": {
        "nepochs": 1, "steps_per_epoch": 1, "batch_size": 2,
        "stft_loss": {"fft_size": 256, "hop_size": 64, "win_length": 256,
                      "sampling_rate": SR, "n_mels": 10},
        "source_loss": {"sampling_rate": SR, "fft_size": 2048,
                        "f0_ceil": 400, "n_mels": 10}},
}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Tiny tensors gain nothing from torch's threads, and the suite's
    other workers keep the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def port_vocoder_noise():
    """``jax.random.normal`` drawing the port's WORLD ``vocoder_noise``."""
    def normal(key, shape, dtype=jnp.float32):
        n = gen.vocoder_noise(1, int(np.prod(shape)), "cpu").numpy()
        return jnp.asarray(n.reshape(shape), dtype)
    return normal


def snr_db(ref, got):
    ref, got = ref.astype(np.float64), got.astype(np.float64)
    err = np.sum((got - ref) ** 2)
    return 10 * np.log10(np.sum(ref ** 2) / max(err, 1e-30))


def files(root: Path):
    return sorted(p.relative_to(root) for p in root.rglob("*")
                  if p.is_file())


def write_conf(conf: Path):
    """The e2e test's mini model configs, without aliases, the AR
    decoder's prenet dropout 0."""
    write_multitrack_mini_model_configs(conf)
    for f in conf.glob("*.yaml"):
        cfg = json.loads(json.dumps(yaml.safe_load(f.read_text())))
        if "lf0_model" in cfg["netG"]:
            cfg["netG"]["lf0_model"]["prenet_dropout"] = 0.0
        f.write_text(yaml.safe_dump(cfg))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The port's run: {recipe, work, data, one, cfg (JAX-materialized)}."""
    root = tmp_path_factory.mktemp("recipe")
    corpus = build_synthetic_jacappella_corpus(root / "corpus", spks=SPKS,
                                               sr=SR)
    work, conf = root / "work", root / "conf"
    write_conf(conf)
    data = work / "data"
    over = multitrack_mini_recipe_overrides(corpus, work, conf, data,
                                            spks=SPKS, sr=SR)
    one = root / "one_segment"
    one.mkdir()
    for spk in SPKS:
        (one / f"{spk}_{SEGMENT}.lab").symlink_to(
            data / "acoustic/label_phone_score" / f"{spk}_{SEGMENT}.lab")
    over["synthesis"]["label_dir"] = str(one)
    over["timing_eval"]["score_label_dir"] = str(one)
    over["device"] = "cpu"
    over["vocoder"] = {**VOCODER, "model_config": str(
        (RECIPE.parent / yaml.safe_load(RECIPE.read_text())["vocoder"][
            "model_config"]).resolve())}
    recipe = root / "recipe.yaml"
    recipe.write_text(yaml.safe_dump(json.loads(json.dumps(
        jax_merge(jax_load(RECIPE), over)))))
    assert run_recipe.main([str(recipe), "--stage", "-1", "--stop-stage",
                            "7"]) == 0
    assert run_recipe.main([str(recipe), "--stage", "11", "--stop-stage",
                            "11"]) == 0
    cfg = jax_recipe._materialize_packaged_configs(jax_load(recipe),
                                                   root.resolve())
    return {"root": root, "recipe": recipe, "work": work, "data": data,
            "one": one, "cfg": cfg}


def jax_work_copy(run, name):
    """A work directory holding the port's scalers and checkpoints, its
    dumps linked."""
    dst = run["root"] / name
    dst.mkdir()
    for d in ("scalers", "exp"):
        shutil.copytree(run["work"] / d, dst / d)
    os.symlink(run["work"] / "dump", dst / "dump")
    return dst


# ------------------------------------------------------------ the configs


@pytest.mark.parametrize("phase", PHASES)
def test_phase_configs_match_jax(run, phase):
    """The trainer's config of each phase (the acoustic one with the lf0
    statistics filled from the fitted scalers) equals the JAX runner's on
    the same recipe and work directory."""
    cfg = run_recipe._materialize_packaged_configs(
        load_config(run["recipe"]), run["root"].resolve())
    got = run_recipe._phase_cfg(cfg, run["work"], phase)
    want = jax_recipe._train_cfg(run["cfg"], run["work"], phase)
    if phase == "acoustic":
        want = jax_recipe._resolve_lf0_stats(run["cfg"], run["work"], want)
        stats = got["model"]["netG"]["lf0_model"]
        assert all(isinstance(stats[k], float) for k in (
            "in_lf0_min", "in_lf0_max", "out_lf0_mean", "out_lf0_scale"))
    assert json.loads(json.dumps(got)) == json.loads(json.dumps(want))
    assert got["train"]["out_dir"] == str(run["work"] / "exp" / phase)


# ---------------------------------------------------------------- stage 6


@pytest.fixture(scope="module")
def jax_pack(run):
    """The JAX runner's stage 6 on a copy of the port's work directory."""
    work = jax_work_copy(run, "jax_stage6")
    with traced_flax_inits():
        jax_recipe.stage6_pack(run["cfg"], work)
    return work / "packed_model"


def test_stage6_writes_the_same_files(run, jax_pack):
    got = run["work"] / "packed_model"
    # stage 10 adds the vocoder to the port's pack later
    assert [p for p in files(got)
            if not p.name.startswith("vocoder_")] == files(jax_pack)
    for rel in files(jax_pack):
        if rel.suffix == ".yaml":
            assert yaml.safe_load((got / rel).read_text()) == \
                yaml.safe_load((jax_pack / rel).read_text()), rel
        elif rel.suffix != ".params":
            assert (got / rel).read_bytes() == \
                (jax_pack / rel).read_bytes(), rel
    glob = yaml.safe_load((got / "config.yaml").read_text())
    assert glob["sample_rate"] == SR
    assert glob["timelag"]["allowed_range"] == [-20, 19]


@pytest.mark.parametrize("phase", PHASES)
def test_stage6_weights_are_bitwise_jax_s(run, jax_pack, phase):
    """Every weight (and the acoustic model's batch statistics) restored
    from both packs, bitwise, and equal to the best checkpoint's."""
    from flax import serialization

    def leaves(path):
        tree = serialization.msgpack_restore(path.read_bytes())
        return jax.tree_util.tree_leaves_with_path(tree)

    name = f"{phase}_model.params"
    got = leaves(run["work"] / "packed_model" / name)
    want = leaves(jax_pack / name)
    ckpt = dict(leaves(run["work"] / "exp" / phase / "best_loss.ckpt"))
    assert [p for p, _ in got] == [p for p, _ in want]
    collections = {p[0].key for p, _ in got}
    assert collections == ({"params", "batch_stats"} if phase == "acoustic"
                           else {"params"})
    for (p, g), (_, w) in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype == np.float32, p
        np.testing.assert_array_equal(g, w, err_msg=str(p))
        np.testing.assert_array_equal(g, np.asarray(ckpt[p]), err_msg=str(p))


# ---------------------------------------------------------------- stage 7


@pytest.fixture(scope="module")
def jax_synthesis(run):
    from ensemble_svs_with_interactions_tpu.bin import synthesis_multitrack

    out = run["root"] / "jax_synthesis"
    with traced_flax_inits(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal", port_vocoder_noise())
        assert synthesis_multitrack.main([
            str(run["work"] / "packed_model"), str(run["one"]), str(out),
            "--spk-names", ",".join(SPKS), "--verbose", "0"]) == 0
    return out


def test_stage7_writes_the_same_files(run, jax_synthesis):
    got = files(run["work"] / "synthesis")
    assert got == files(jax_synthesis)
    names = {f"{a}_{SEGMENT}_with_{b}" for a, b in (SPKS, SPKS[::-1])}
    assert {p.stem for p in got} == names
    assert {str(p.parent) for p in got} == {
        "wav", "timelag", "duration", *STREAMS}


@pytest.mark.parametrize("kind", ("timelag", "duration"))
def test_stage7_timing_dumps_equal_jax_s(run, jax_synthesis, kind):
    for f in sorted((jax_synthesis / kind).glob("*.npy")):
        np.testing.assert_array_equal(
            np.load(run["work"] / "synthesis" / kind / f.name), np.load(f))


@pytest.mark.parametrize("kind", STREAMS)
def test_stage7_streams_match_jax(run, jax_synthesis, kind):
    for f in sorted((jax_synthesis / kind).glob("*.npy")):
        want = np.load(f)
        got = np.load(run["work"] / "synthesis" / kind / f.name)
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_allclose(
            got, want, rtol=0, atol=STREAM_RTOL * np.abs(want).max())


def test_stage7_wavs_match_jax(run, jax_synthesis):
    for f in sorted((jax_synthesis / "wav").glob("*.wav")):
        sr_j, want = wavfile.read(f)
        sr, got = wavfile.read(run["work"] / "synthesis" / "wav" / f.name)
        assert sr == sr_j == SR and got.dtype == want.dtype == np.int16
        assert got.shape == want.shape
        assert np.abs(got.astype(np.int64)).max() > 0
        assert snr_db(want, got) > SNR_DB, (f.name, snr_db(want, got))


# --------------------------------------------------------------- stage 11


def test_stage11_dumps_match_jax(run):
    from ensemble_svs_with_interactions_tpu.bin import (
        evaluate_timing_multitrack,
    )

    out = run["root"] / "jax_timing_eval"
    with traced_flax_inits():
        assert evaluate_timing_multitrack.main([
            str(run["work"] / "packed_model"), str(run["one"]),
            str(run["data"] / "acoustic/label_phone_align"), str(out),
            "--spk-names", ",".join(SPKS)]) == 0
    got = run["work"] / "timing_eval"
    assert files(got) == files(out) and len(files(out)) == 4
    for f in sorted((out / "timelag").glob("*.npy")):
        np.testing.assert_array_equal(np.load(got / "timelag" / f.name),
                                      np.load(f))
    for f in sorted((out / "duration").glob("*.npy")):
        want = np.load(f)
        np.testing.assert_allclose(np.load(got / "duration" / f.name), want,
                                   rtol=TIMING_RTOL)


def test_quality_json_is_jax_s(run):
    """``QUALITY.json`` byte-equal to the JAX runner's of the same work
    directory, with every phase's best and final dev metrics, finite."""
    work = jax_work_copy(run, "jax_quality")
    jax_recipe._write_quality_json(run["cfg"], work)
    got = (run["work"] / "QUALITY.json").read_bytes()
    assert got == (work / "QUALITY.json").read_bytes()
    quality = json.loads(got)
    assert sorted(quality) == sorted(PHASES)
    ac = quality["acoustic"]["best"]
    for k in ("ObjEval_MGC_MCD", "ObjEval_BAP_MCD", "ObjEval_VUV_ERR",
              "ObjEval_F0_RMSE", "Loss"):
        assert np.isfinite(ac[k]), (k, ac)
    for phase in PHASES:
        assert np.isfinite(quality[phase]["best"]["Loss"]), quality[phase]


def test_the_e2e_test_s_checks_hold(run):
    """``tests/test_recipe_multitrack_e2e.py``'s structural checks on the
    port's run: the corpus, the song-level splits keeping both singers
    paired, the interaction losses logged, the paired wavs and the timing
    dumps."""
    data, work = run["data"], run["work"]
    assert len(list((data / "acoustic/wav").glob("*.wav"))) >= 4
    assert len(list((data / "timelag/label_phone_align").glob("*.lab"))) >= 4
    lists = {s: (data / "lists" / f"{s}.list").read_text().split()
             for s in ("train_no_dev", "dev", "eval")}
    assert all(lists.values())
    songs = {s: {u.split("_")[1] for u in us} for s, us in lists.items()}
    assert songs == {"train_no_dev": {"song0"}, "dev": {"song1"},
                     "eval": {"song2"}}
    for us in lists.values():
        for seg in {u.split("_", 1)[1] for u in us}:
            assert {f"{s}_{seg}" for s in SPKS} <= set(us)
    keys = set()
    for line in (work / "exp/acoustic/metrics.jsonl").read_text().splitlines():
        keys |= set(json.loads(line))
    assert any("LogF0_Interaction" in k for k in keys), keys
    assert any("MGC-0th_Interaction" in k for k in keys), keys
    wavs = sorted((work / "synthesis/wav").glob("*_with_*.wav"))
    assert len(wavs) >= 2
    sr, x = wavfile.read(wavs[0])
    assert sr == SR and np.abs(x.astype(np.int64)).max() > 0
    for kind in ("timelag", "duration"):
        assert len(list((work / "synthesis" / kind).glob("*.npy"))) >= 2
    assert len(list((work / "timing_eval").rglob("*.npy"))) >= 2
    for phase in PHASES:
        assert (work / "exp" / phase / "best_loss.ckpt").exists()
    # the recipe's checkpoint_epoch_interval is never read, as in JAX
    assert not list((work / "exp").rglob("epoch*.ckpt"))


# --------------------------------------------------------------- stage 10


@pytest.fixture(scope="module")
def stage10(run):
    """Stage 10 of both runners on the port's work directory after stage
    11: the configs each hands its trainer (JAX's stopped there), the
    prepared features' digests before and after the JAX stage."""
    from ensemble_svs_with_interactions_tpu.train import (
        vocoder_trainer as jvt,
    )
    from ensemble_svs_with_interactions_tpu_torch.train import (
        vocoder_trainer as pvt,
    )

    seen = {}

    class Stop(Exception):
        pass

    def record(config, device="cuda"):
        seen["port"] = (json.loads(json.dumps(config)), str(device))
        return train(config, device)

    def stop(config):
        seen["jax"] = json.loads(json.dumps(config))
        raise Stop

    def digests():
        voc = run["work"] / "vocoder"
        return {str(p): hashlib.sha256((voc / p).read_bytes()).hexdigest()
                for p in files(voc)}

    train = pvt.train_vocoder
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pvt, "train_vocoder", record)
        mp.setattr(jvt, "train_vocoder", stop)
        assert run_recipe.main([str(run["recipe"]), "--stage", "10",
                                "--stop-stage", "10"]) == 0
        seen["features"] = digests()
        with pytest.raises(Stop):
            jax_recipe.stage10_train_vocoder(run["cfg"], run["work"])
        seen["features_jax"] = digests()
    return seen


def test_stage10_trains_on_jax_s_config(run, stage10):
    """The vocoder's train config equals the JAX stage's but for
    ``train.out_dir``: the packaged vocoder config's ``out_dir: null``,
    lifted into the recipe, reaches the JAX trainer as it is (which then
    cannot open its directory); the port trains in the runner's."""
    config, device = stage10["port"]
    want = stage10["jax"]
    assert want["train"]["out_dir"] is None
    assert config["train"]["out_dir"] == str(run["work"] / "exp" / "vocoder")
    want["train"]["out_dir"] = config["train"]["out_dir"]
    assert config == want and device == "cpu"
    assert config["data"]["sample_rate"] == SR
    assert config["data"]["stream_sizes"] == [8, 1, 1, 3]
    assert stage10["features"] == stage10["features_jax"]
    assert len(stage10["features"]) == 2 * 8  # feats + wave, 8 segments
    exp = run["work"] / "exp" / "vocoder"
    assert (exp / "best_loss.ckpt").exists()
    line = json.loads((exp / "metrics.jsonl").read_text().splitlines()[0])
    assert all(np.isfinite(v) for v in line.values())


def test_stage10_pack_serves_auto_in_both_engines(run, stage10):
    """Both engines open the pack with its vocoder and resolve
    ``vocoder_type="auto"`` to it; the port's generator holds the weights
    of the vocoder's best checkpoint."""
    from ensemble_svs_with_interactions_tpu.svs import SPSVS as JaxSPSVS
    from ensemble_svs_with_interactions_tpu_torch.svs import SPSVS
    from ensemble_svs_with_interactions_tpu_torch.utils import flax_msgpack
    from ensemble_svs_with_interactions_tpu_torch.utils.flax_port import (
        torch_to_flax,
    )

    packed = run["work"] / "packed_model"
    engine = SPSVS(packed, device="cpu")
    with traced_flax_inits():
        jax_engine = JaxSPSVS(packed)
    assert engine.default_vocoder_type == jax_engine.default_vocoder_type \
        == "usfgan"
    assert engine._validate_synthesis_args("auto", "gv") == "usfgan"
    got = jax.tree_util.tree_leaves_with_path(
        torch_to_flax(engine.vocoder.module)["params"])
    ckpt = flax_msgpack.from_bytes(
        (run["work"] / "exp" / "vocoder" / "best_loss.ckpt").read_bytes())
    want = dict(jax.tree_util.tree_leaves_with_path(ckpt["params"]))
    assert len(got) == len(want)
    for p, g in got:
        np.testing.assert_array_equal(g, want[p], err_msg=str(p))


# -------------------------------------------------------- the single track


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    """A seeded single-track pack (the tiny voice of
    ``tests/test_torch_svs_single.py``, the weights the port's modules'
    flax-scheme initial ones) and one label file of the fixture's first 4
    s, with its aligned twin one frame later."""
    from ensemble_svs_with_interactions_tpu_torch.io import hts
    from ensemble_svs_with_interactions_tpu_torch.utils.config import (
        instantiate,
    )
    from ensemble_svs_with_interactions_tpu_torch.utils.flax_init import (
        init_variables,
    )
    from ensemble_svs_with_interactions_tpu_torch.utils.packing import (
        pack_model,
    )
    from ensemble_svs_with_interactions_tpu_torch.utils.scalers import (
        MinMaxScaler,
        StandardScaler,
    )
    from tests.test_torch_svs import _short_labels, tiny_phases
    from tests.test_torch_svs_single import single_track_configs
    from tests.util import HED

    root = tmp_path_factory.mktemp("single")
    timelag, duration, acoustic, ss = single_track_configs()
    cfgs = {"timelag": timelag, "duration": duration, "acoustic": acoustic}
    mean, scale = np.zeros(sum(ss)), np.ones(sum(ss)) * 0.1
    mean[ss[0]] = np.log(220.0)
    stats = {"timelag": (82, np.zeros(1), np.ones(1) * 2),
             "duration": (82, np.ones(1) * 10, np.ones(1) * 2),
             "acoustic": (86, mean, scale)}
    glob = {"sample_rate": SR, "frame_period": 5, "feature_type": "world",
            "use_world_codec": True, "relative_f0": False}
    seeds = dict(zip(PHASES, (2, 1, 0)))
    pack_model(root / "packed", glob, HED, tiny_phases(
        cfgs, stats, MinMaxScaler, StandardScaler,
        lambda ph: {"variables": init_variables(
            instantiate(cfgs[ph]["netG"]), seeds[ph])}))
    for d in ("score", "align"):
        (root / d).mkdir()
    score = _short_labels(hts, 4.0)
    score.save(root / "score" / "utt.lab")
    align = hts.load(root / "score" / "utt.lab")
    align.start_times = [align.start_times[0]] + [
        t + 50000 for t in align.start_times[1:]]
    align.end_times = [t + 50000 for t in align.end_times]
    align.save(root / "align" / "utt.lab")
    return root


def test_single_track_synthesis_matches_jax(single):
    """``bin/synthesis.py``: one wav of the same length, SNR >= 40 dB."""
    from ensemble_svs_with_interactions_tpu.bin import synthesis as jsyn
    from ensemble_svs_with_interactions_tpu_torch.bin import synthesis

    args = [str(single / "packed"), str(single / "score")]
    assert synthesis.main([*args, str(single / "port_wav"), "--verbose",
                           "0", "--device", "cpu"]) == 0
    with traced_flax_inits(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal", port_vocoder_noise())
        assert jsyn.main([*args, str(single / "jax_wav"), "--verbose",
                          "0"]) == 0
    sr_j, want = wavfile.read(single / "jax_wav" / "utt.wav")
    sr, got = wavfile.read(single / "port_wav" / "utt.wav")
    assert sr == sr_j == SR and got.dtype == want.dtype == np.int16
    assert got.shape == want.shape and np.abs(want).max() > 0
    assert snr_db(want, got) > SNR_DB, snr_db(want, got)


def test_single_track_evaluate_timing_matches_jax(single):
    from ensemble_svs_with_interactions_tpu.bin import evaluate_timing as jev
    from ensemble_svs_with_interactions_tpu_torch.bin import evaluate_timing

    args = [str(single / "packed"), str(single / "score"),
            str(single / "align")]
    assert evaluate_timing.main([*args, str(single / "port_te"),
                                 "--device", "cpu"]) == 0
    with traced_flax_inits():
        assert jev.main([*args, str(single / "jax_te")]) == 0
    assert files(single / "port_te") == files(single / "jax_te") == [
        Path("duration/utt.npy"), Path("timelag/utt.npy")]
    np.testing.assert_array_equal(
        np.load(single / "port_te/timelag/utt.npy"),
        np.load(single / "jax_te/timelag/utt.npy"))
    np.testing.assert_allclose(
        np.load(single / "port_te/duration/utt.npy"),
        np.load(single / "jax_te/duration/utt.npy"), rtol=TIMING_RTOL)


def test_clis_run_on_the_card_unless_asked(single, tmp_path):
    """Without ``--device`` each CLI opens its engine on ``cuda``: with no
    card it raises, nothing falls back to the CPU."""
    from ensemble_svs_with_interactions_tpu_torch.bin import (
        evaluate_timing,
        evaluate_timing_multitrack,
        synthesis,
        synthesis_multitrack,
    )

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    packed, score = str(single / "packed"), str(single / "score")
    calls = [
        (synthesis.main, [packed, score, str(tmp_path / "a")]),
        (synthesis_multitrack.main, [packed, score, str(tmp_path / "b"),
                                     "--spk-names", "x"]),
        (evaluate_timing.main, [packed, score, score, str(tmp_path / "c")]),
        (evaluate_timing_multitrack.main, [packed, score, score,
                                           str(tmp_path / "d")]),
    ]
    for main, argv in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)


# ----------------------------------------------------- sweep and trainers


SWEEPS = {
    "grid": {"mode": "grid", "params": {
        "train.optim.optimizer.params.lr": [0.001, 0.01],
        "model.netG.hidden_dim": [8, 16, 32]}},
    "random": {"mode": "random", "n_trials": 5, "seed": 7, "params": {
        "train.optim.optimizer.params.lr": {"low": 1e-4, "high": 1e-1,
                                            "log": True},
        "model.netG.hidden_dim": [8, 16, 32],
        "model.netG.num_layers": {"low": 1, "high": 4, "int": True}}},
    "tpe": {"mode": "tpe", "n_trials": 12, "n_startup": 4, "seed": 3,
            "gamma": 0.3, "n_ei_candidates": 16, "params": {
                "train.optim.optimizer.params.lr": {"low": 1e-4,
                                                    "high": 1e-1,
                                                    "log": True},
                "model.netG.hidden_dim": [8, 16, 32],
                "train.dropout": {"low": 0.0, "high": 0.5}}},
}


def fake_train(seen):
    """A trainer stand-in: a seeded dev ``Loss`` of the trial's values
    (its noise seeded by the trial's index in ``train.out_dir``)."""
    def train(cfg, is_acoustic=False, device=None):
        seen.append((bool(is_acoustic), device))
        trial = int(Path(cfg["train"]["out_dir"]).name[len("trial"):])
        lr = float(cfg["train"]["optim"]["optimizer"]["params"]["lr"])
        net = cfg["model"]["netG"]
        loss = ((np.log10(lr) + 2.0) ** 2 + 0.1 * (net["hidden_dim"] != 16)
                + 0.05 * net.get("num_layers", 2)
                + float(cfg["train"].get("dropout", 0.0))
                + 0.01 * np.random.default_rng(trial).standard_normal())
        return {"Loss": float(loss)}
    return train


@pytest.mark.parametrize("mode", sorted(SWEEPS))
def test_sweep_matches_jax(tmp_path, mode):
    """``bin/sweep.py`` in each mode, its trainer a seeded fake on both
    sides: the same trials, ``sweep_results.jsonl`` and ``best_trial.yaml``
    byte-equal to JAX's; the port's trainer called with the acoustic flag
    and the base config's device."""
    from ensemble_svs_with_interactions_tpu.bin import sweep as jsweep
    from ensemble_svs_with_interactions_tpu.train import (
        multitrack_trainer as jmt,
    )
    from ensemble_svs_with_interactions_tpu_torch.bin import sweep
    from ensemble_svs_with_interactions_tpu_torch.train import (
        multitrack_trainer as pmt,
    )

    base = tmp_path / "base.yaml"
    base.write_text(yaml.safe_dump({
        "model": {"netG": {"hidden_dim": 4, "num_layers": 2}},
        "train": {"optim": {"optimizer": {"name": "Adam",
                                          "params": {"lr": 0.1}}}}}))
    spec = tmp_path / "sweep.yaml"
    spec.write_text(yaml.safe_dump(SWEEPS[mode]))
    seen = {"jax": [], "port": []}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmt, "train_multitrack_model",
                   lambda cfg, is_acoustic: fake_train(seen["jax"])(
                       cfg, is_acoustic))
        mp.setattr(pmt, "train_multitrack_model", fake_train(seen["port"]))
        for side, mod in (("jax", jsweep), ("port", sweep)):
            over = [f"train.out_dir={tmp_path / side}"]
            if side == "port":
                over.append("device=cpu")
            assert mod.main([str(base), str(spec), "--multitrack",
                             "--acoustic", *over]) == 0
    n = {"grid": 6, "random": 5, "tpe": 12}[mode]
    assert len(seen["port"]) == len(seen["jax"]) == n
    assert set(seen["port"]) == {(True, "cpu")}
    for name in ("sweep_results.jsonl", "best_trial.yaml"):
        got = (tmp_path / "port" / name).read_bytes()
        assert got == (tmp_path / "jax" / name).read_bytes(), name
    best = yaml.safe_load((tmp_path / "port" / "best_trial.yaml").read_text())
    rows = [json.loads(line) for line in (tmp_path / "port" /
            "sweep_results.jsonl").read_text().splitlines()]
    assert best["dev_loss"] == min(r["dev_loss"] for r in rows)


def test_tpe_sampler_draws_jax_s():
    """The TPE sampler alone, told the same losses, asks for bitwise the
    JAX sampler's points (the host NumPy draws of one seed)."""
    from ensemble_svs_with_interactions_tpu.bin.sweep import (
        TPESampler as JaxTPE,
    )
    from ensemble_svs_with_interactions_tpu_torch.bin.sweep import TPESampler

    params = SWEEPS["tpe"]["params"]
    got, want = TPESampler(params, seed=5, n_startup=3), JaxTPE(
        params, seed=5, n_startup=3)
    for k in range(20):
        a, b = got.ask(), want.ask()
        assert a == b, k
        loss = float(np.log10(a["train.optim.optimizer.params.lr"]) ** 2)
        got.tell(a, loss)
        want.tell(b, loss)


def test_train_acoustic_multi_trains_the_acoustic_model(tmp_path):
    """``bin/train_acoustic_multi.py`` hands the single-track trainer the
    merged config with ``is_acoustic=True``, as the JAX CLI does, on the
    config's device."""
    from ensemble_svs_with_interactions_tpu.bin import (
        train_acoustic_multi as jcli,
    )
    from ensemble_svs_with_interactions_tpu_torch.bin import (
        train_acoustic_multi,
    )
    from ensemble_svs_with_interactions_tpu_torch.train import trainer

    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump({
        "data": {"spk_names": ["a", "b"]},
        "train": {"nepochs": 3, "out_dir": "x"}}))
    seen = {}
    argv = [str(path), "train.nepochs=1", "data.batch_max_frames=64",
            "device=cpu"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trainer, "train_model",
                   lambda cfg, is_acoustic, device: seen.update(
                       port=(json.loads(json.dumps(cfg)), is_acoustic,
                             device)))
        mp.setattr(jcli, "train_model", lambda cfg, is_acoustic: seen.update(
            jax=(json.loads(json.dumps(cfg)), is_acoustic)))
        assert train_acoustic_multi.main(argv) == 0
        assert jcli.main(argv) == 0
    cfg, is_acoustic, device = seen["port"]
    assert (cfg, is_acoustic) == seen["jax"]
    assert is_acoustic is True and device == "cpu"
    assert cfg["train"]["nepochs"] == 1
    assert cfg["data"]["batch_max_frames"] == 64
    assert train_acoustic_multi.main([]) == 1
