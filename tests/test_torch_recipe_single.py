"""The single-track recipe with its learned postfilter (stages 0 to 9 of
``bin/run_recipe.py``) on the port, against the JAX package's stage
functions and engine, on the CPU.

The recipe is ``tests/test_recipe_e2e.py``'s: its corpus (the three
fixture songs cut to 8 s, synthetic audio at 24 kHz), its model configs
(``MDNv2`` timing models, a tiny ``ResSkipF0FFConvLSTM``), its training
and postfilter sections, with ``device: cpu``.  The port's runner runs
stages 0 to 9 once (module-scoped); the JAX package then runs on the
port's work directory, so no JAX model trains here
(``tests/test_torch_postfilter_train.py`` holds the trainers):

* the phases' trainer configs equal the JAX runner's, ResSkip's null lf0
  statistics filled from the scalers;
* stage 8: JAX's ``stage8_postfilter_features`` on the port's pack gives
  the same pairs at PAIR_ATOL and the same scaler files bitwise;
* stage 9: the trainer config the port builds equals the one JAX's stage
  hands its trainer; JAX's pack step on the port's checkpoint writes the
  port's pack (configs equal, scalers byte for byte, every weight
  bitwise; the msgpack files order their keys as each package's modules
  do);
* the pack opens in both engines: ``svs(post_filter_type="nnsvs")`` on an
  eval song gives the same durations, streams within STREAM_RTOL of each
  stream's scale and a waveform at SNR >= SNR_DB, with both packages'
  noise replayed (``tests/test_torch_postfilter._noise``, the port's
  WORLD noise);
* stage 9 packs the checkpoint where the trainer wrote it when the
  recipe moves ``postfilter.train.out_dir`` (the JAX runner reads
  ``exp/postfilter`` whatever it trained into).
"""

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
from ensemble_svs_with_interactions_tpu.io import hts as jax_hts
from ensemble_svs_with_interactions_tpu.svs import SPSVS as JaxSPSVS
from ensemble_svs_with_interactions_tpu.utils.config import (
    load_config as jax_load,
)
from ensemble_svs_with_interactions_tpu_torch import gen
from ensemble_svs_with_interactions_tpu_torch.bin import run_recipe
from ensemble_svs_with_interactions_tpu_torch.io import hts
from ensemble_svs_with_interactions_tpu_torch.models import postfilters
from ensemble_svs_with_interactions_tpu_torch.svs import SPSVS
from ensemble_svs_with_interactions_tpu_torch.utils import flax_msgpack
from ensemble_svs_with_interactions_tpu_torch.utils.config import load_config
from tests.test_recipe_e2e import _write_model_configs
from tests.test_torch_postfilter import _noise
from tests.test_torch_svs import traced_flax_inits
from tests.util import FIXTURE_LABS, HED, synth_wav_from_labels, trim_labels

SR = 24000
PAIR_ATOL = 1e-5
STREAM_RTOL = 1e-3
SNR_DB = 40.0
STREAMS = ("mgc", "lf0", "vuv", "bap")


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def replay_noise(mp):
    """Both packages' postfilter noise from ``_noise``; JAX's WORLD noise
    the port's."""
    def normal(key, shape, dtype=jnp.float32):
        shape = tuple(int(s) for s in shape)
        if len(shape) <= 2:
            n = gen.vocoder_noise(1, int(np.prod(shape)), "cpu").numpy()
            return jnp.asarray(n.reshape(shape), dtype)
        return jnp.asarray(_noise(shape), dtype)

    mp.setattr(jax.random, "normal", normal)
    mp.setattr(postfilters, "draw_noise",
               lambda shape, generator: torch.from_numpy(_noise(shape)))


def write_corpus(root: Path):
    """``tests/test_recipe_e2e.py``'s corpus."""
    (root / "lab").mkdir(parents=True)
    (root / "wav").mkdir()
    binary_dict, numeric_dict = jax_hts.load_question_set(HED)
    rng = np.random.default_rng(0)
    utts = []
    for path in FIXTURE_LABS:
        labels = trim_labels(jax_hts.load(path), 8.0)
        utt = Path(path).stem
        labels.save(root / "lab" / f"{utt}.lab")
        wavfile.write(root / "wav" / f"{utt}.wav", SR, synth_wav_from_labels(
            labels, binary_dict, numeric_dict, rng, sr=SR))
        utts.append(utt)
    (root / "utt_list.txt").write_text("\n".join(utts) + "\n")


def e2e_recipe(corpus: Path, conf: Path, work: Path):
    """The JAX e2e test's recipe (``test_full_recipe``) without its vocoder
    section, on the CPU."""
    train = {"nepochs": 2,
             "optim": {"optimizer": {"name": "Adam", "params": {"lr": 0.002}}}}
    adam = {"optimizer": {"name": "Adam", "params": {"lr": 0.0005}}}
    pf = "ensemble_svs_with_interactions_tpu.models"
    return {
        "seed": 1234, "verbose": 0, "work_dir": str(work),
        "question_path": HED, "device": "cpu",
        "data": {"utt_list": str(corpus / "utt_list.txt"), "n_dev": 1,
                 "n_eval": 1},
        "features": {
            "n_jobs": 1,
            "timelag": {"label_phone_score_dir": str(corpus / "lab"),
                        "label_phone_align_dir": str(corpus / "lab")},
            "duration": {"label_dir": str(corpus / "lab")},
            "acoustic": {
                "wav_dir": str(corpus / "wav"),
                "label_dir": str(corpus / "lab"),
                "params": {"sample_rate": SR, "f0_extractor": "dio",
                           "f0_floor": 120, "f0_ceil": 500, "mgc_order": 24,
                           "use_world_codec": True, "relative_f0": False,
                           "dynamic_features_flags": [False] * 4}}},
        "timelag": {"model_config": str(conf / "timelag.yaml"),
                    "train": train},
        "duration": {"model_config": str(conf / "duration.yaml"),
                     "train": train},
        "acoustic": {"model_config": str(conf / "acoustic.yaml"),
                     "train": {**train, "pitch_reg_weight": 1.0},
                     "data": {"time_multiple": 32}},
        "synthesis": {"label_dir": str(corpus / "lab")},
        "postfilter": {
            "model": {
                "netG": {"_target_": f"{pf}.postfilters.Conv2dPostFilter",
                         "channels": 4},
                "netD": {"_target_": f"{pf}.discriminators.Conv2dD",
                         "channels": 4, "padding": None}},
            "train": {"nepochs": 1,
                      "optim": {"netG": adam, "netD": adam,
                                "clip_norm": 1.0}}},
    }


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The port's runner, stages 0 to 9: {root, recipe, work, cfg}."""
    root = tmp_path_factory.mktemp("single")
    write_corpus(root / "corpus")
    _write_model_configs(root / "conf")
    work = root / "work"
    recipe = root / "recipe.yaml"
    recipe.write_text(yaml.safe_dump(json.loads(json.dumps(
        e2e_recipe(root / "corpus", root / "conf", work)))))
    assert run_recipe.main([str(recipe), "--stage", "0", "--stop-stage",
                            "9"]) == 0
    return {"root": root, "recipe": recipe, "work": work,
            "cfg": jax_load(recipe)}


def jax_work(run, name):
    """A work directory for the JAX stages: the port's dumps and pack
    linked, its scalers and experiment directory copied."""
    dst = run["root"] / name
    dst.mkdir()
    for d in ("dump", "packed_model"):
        os.symlink(run["work"] / d, dst / d)
    for d in ("scalers", "exp"):
        shutil.copytree(run["work"] / d, dst / d)
    return dst


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _files(root: Path):
    return sorted(p.relative_to(root) for p in root.rglob("*")
                  if p.is_file())


@pytest.mark.parametrize("phase", ("timelag", "duration", "acoustic"))
def test_phase_configs_match_jax(run, phase):
    """Each phase's trainer config equals the JAX runner's; the acoustic
    ResSkip's four null lf0 statistics are filled from the fitted scalers
    as JAX fills them."""
    got = run_recipe._phase_cfg(load_config(run["recipe"]), run["work"],
                                phase)
    want = jax_recipe._train_cfg(run["cfg"], run["work"], phase)
    if phase == "acoustic":
        want = jax_recipe._resolve_lf0_stats(run["cfg"], run["work"], want)
        net = got["model"]["netG"]
        assert all(isinstance(net[k], float) for k in (
            "in_lf0_min", "in_lf0_max", "out_lf0_mean", "out_lf0_scale"))
    assert json.loads(json.dumps(got)) == json.loads(json.dumps(want))


@pytest.fixture(scope="module")
def jax_stage8(run):
    work = jax_work(run, "jax8")
    with traced_flax_inits():
        jax_recipe.stage8_postfilter_features(run["cfg"], work)
    return work


def test_stage8_pairs_match_jax(run, jax_stage8):
    """One pair per train and dev utterance, in the normalized static
    domain, the same as JAX's."""
    got = _files(run["work"] / "postfilter")
    assert got == _files(jax_stage8 / "postfilter")
    assert len(got) == 4
    for f in got:
        a = np.load(run["work"] / "postfilter" / f)
        b = np.load(jax_stage8 / "postfilter" / f)
        assert a.shape == b.shape and a.dtype == b.dtype == np.float32
        assert a.shape[1] == 30
        np.testing.assert_allclose(a, b, rtol=0, atol=PAIR_ATOL,
                                   err_msg=str(f))


def test_stage8_scalers_are_jax_s_bitwise(run, jax_stage8):
    for name in ("mean", "var", "scale"):
        f = f"scalers/out_postfilter_scaler_{name}.npy"
        assert (run["work"] / f).read_bytes() == (jax_stage8 /
                                                  f).read_bytes()


@pytest.fixture(scope="module")
def jax_stage9(run):
    """JAX's stage 9 with its trainer replaced by a recorder, on a copy of
    the port's work directory (its checkpoint in ``exp/postfilter``)."""
    from ensemble_svs_with_interactions_tpu.train import postfilter_trainer

    work = jax_work(run, "jax9")
    os.unlink(work / "packed_model")
    shutil.copytree(run["work"] / "packed_model", work / "packed_model")
    for f in (work / "packed_model").glob("*postfilter*"):
        f.unlink()
    shutil.copytree(run["work"] / "postfilter", work / "postfilter")
    seen = []
    with traced_flax_inits(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(postfilter_trainer, "train_postfilter", seen.append)
        jax_recipe.stage9_train_postfilter(run["cfg"], work)
    return work, seen[0]


def test_stage9_trains_on_jax_s_config(run, jax_stage9):
    _, want = jax_stage9
    got = run_recipe.postfilter_train_config(load_config(run["recipe"]),
                                             run["work"])
    assert json.loads(json.dumps(got)) == json.loads(json.dumps(
        {k: v for k, v in want.items()}).replace(
        str(run["root"] / "jax9"), str(run["work"])))


def test_stage9_pack_is_jax_s(run, jax_stage9):
    """JAX's pack step on the port's checkpoint writes the port's files."""
    work, _ = jax_stage9
    names = sorted(p.name for p in (run["work"] / "packed_model").glob(
        "*postfilter*"))
    assert names == ["out_postfilter_scaler_mean.npy",
                     "out_postfilter_scaler_scale.npy",
                     "out_postfilter_scaler_var.npy",
                     "postfilter_model.params", "postfilter_model.yaml"]
    for n in names:
        got, want = run["work"] / "packed_model" / n, work / \
            "packed_model" / n
        if n.endswith(".yaml"):
            assert load_config(got) == jax_load(want)
        elif n.endswith(".params"):
            g, w = (dict(_leaves(flax_msgpack.from_bytes(f.read_bytes())))
                    for f in (got, want))
            assert sorted(g) == sorted(w)
            for p, a in g.items():
                np.testing.assert_array_equal(a, w[p], err_msg=p)
        else:
            assert got.read_bytes() == want.read_bytes(), n


@pytest.fixture(scope="module")
def rendered(run):
    """Both engines on the port's pack, one eval song: (port, JAX) as
    (duration-modified labels, streams, waveform)."""
    lab = sorted((run["root"] / "corpus" / "lab").glob("*.lab"))[0]
    packed = run["work"] / "packed_model"
    out = []
    with pytest.MonkeyPatch.context() as mp:
        replay_noise(mp)
        for mod, engine in ((hts, SPSVS(packed, device="cpu")),
                            (jax_hts, None)):
            if engine is None:
                with traced_flax_inits():
                    engine = JaxSPSVS(packed)
            labels = mod.load(lab)
            dm = engine.predict_timing(labels.copy())
            acoustic = engine.predict_acoustic(dm)
            streams = engine.postprocess_acoustic(
                acoustic, dm, post_filter_type="nnsvs")
            wav, sr = engine.svs(mod.load(lab), post_filter_type="nnsvs",
                                 dtype=np.float32)
            assert sr == SR
            out.append((dm, streams, np.asarray(wav)))
    return out


def test_svs_with_the_postfilter_matches_jax(run, rendered):
    (dm, streams, wav), (jdm, jstreams, jwav) = rendered
    assert list(dm.start_times) == list(jdm.start_times)
    assert list(dm.end_times) == list(jdm.end_times)
    for name, g, w in zip(STREAMS, streams, jstreams):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=STREAM_RTOL * np.abs(w).max(),
                                   err_msg=name)
    assert wav.shape == jwav.shape and np.abs(wav).max() > 0
    err = np.sum((wav.astype(np.float64) - jwav) ** 2)
    snr = 10 * np.log10(np.sum(jwav.astype(np.float64) ** 2) / max(err,
                                                                     1e-30))
    assert snr > SNR_DB, snr


def test_the_postfilter_changes_the_streams(run, rendered):
    """The packed postfilter is applied: nnsvs differs from no filter."""
    engine = SPSVS(run["work"] / "packed_model", device="cpu")
    (dm, streams, _), _ = rendered
    plain = engine.postprocess_acoustic(engine.predict_acoustic(dm), dm,
                                        post_filter_type="none")
    assert engine.postfilter_model is not None
    assert not np.allclose(plain[0], streams[0], atol=1e-4)


def test_stage9_packs_where_the_trainer_wrote(run):
    """``postfilter.train.out_dir`` moved: the port's stage 9 trains there
    and packs that checkpoint."""
    cfg = load_config(run["recipe"])
    work = run["root"] / "moved"
    for d in ("scalers", "postfilter"):
        shutil.copytree(run["work"] / d, work / d)
    (work / "packed_model").mkdir()
    out = run["root"] / "elsewhere"
    cfg["postfilter"]["train"]["out_dir"] = str(out)
    run_recipe.stage9_train_postfilter(cfg, work)
    assert (out / "best_loss.ckpt").exists()
    assert not (work / "exp" / "postfilter").exists()
    assert (work / "packed_model" / "postfilter_model.params").exists()


# ------------------------------------------ chip_smoke's recipe_single


def test_chip_single_recipe_is_the_shipped_configs(tmp_path):
    """``chip_smoke.single_recipe`` names the shipped MDNv2, ResSkip and
    mgc postfilter configs, the packaged recipe's acoustic features, one
    dev and one eval utterance, and runs on the card (no ``device``)."""
    import chip_smoke

    recipe = chip_smoke.single_recipe(tmp_path / "corpus", tmp_path / "w")
    packaged = yaml.safe_load(chip_smoke.RECIPE.read_text())
    assert "device" not in recipe and "multitrack" not in recipe
    assert recipe["features"]["acoustic"]["params"] == \
        packaged["features"]["acoustic"]["params"]
    assert (recipe["data"]["n_dev"], recipe["data"]["n_eval"]) == (1, 1)
    for phase, rel in (("timelag", "timelag/timelag_mdn.yaml"),
                       ("duration", "duration/duration_mdn.yaml"),
                       ("acoustic", "acoustic/acoustic_resf0convlstm.yaml")):
        assert recipe[phase]["model_config"] == str(chip_smoke.CONFIGS /
                                                    rel)
        assert recipe[phase]["train"]["nepochs"] == chip_smoke.SINGLE_EPOCHS
        assert "spk_names" not in recipe[phase]["data"]
    assert recipe["postfilter"]["model_config"].endswith(
        "postfilter/postfilter_mgc.yaml")


def _fake_row(name):
    import chip_smoke

    row = {k: 1.0 for k in chip_smoke.TIMES + chip_smoke.PREPASS + (
        "library_input_gemm_ms", "loop_bound_ms", "bound_ms",
        "bound_fma_ms", "bound_3xtf32_ms", "loop_bound_fma_ms",
        "loop_bound_3xtf32_ms", "loop_mma_rows")}
    row.update(name=name, kernel="k", bound_by="operations", B=1, T=8,
               H=256, max_abs_err=1e-7, max_rel_err=1e-6)
    return row


def test_chip_kernels_line_has_every_key():
    """The ``kernels`` line from rows of every phase: each kernel with the
    contract's keys, the single-track recipe's launches under
    ``launches_by_path`` and its rows under ``recipe_single_rows``, the
    NPSS voice's under ``recipe_npss`` and ``recipe_npss_rows``, the AR
    option voices' under ``ar_options``, the mel
    voice's under ``mel_voice`` and ``mel_voice_rows`` and the
    multi-speaker voice's under ``multi_speaker`` and
    ``multi_speaker_rows``, phase ``parallel``'s under ``parallel`` (their
    errors counted in ``max_abs_err``, dW_h's
    relative one in ``max_rel_err``; the rows keep cuDNN's input GEMM
    time, and the NPSS rows the kernel that served them and both bounds,
    the BPTT's at the float32 FMA and the tensor cores' rates with the
    rows its loop took on the tensor cores)."""
    import chip_smoke as cs

    shapes = sorted(set(cs.RECURRENCE_SHAPES)
                    | set(cs.DIFFUSION_LAUNCHES_BY_HIDDEN))
    kernel_rows = {(H, c): _fake_row("lstm_recurrence") for H in shapes
                   for c in (False, True)}
    single_rows = {(H, False): _fake_row("lstm_recurrence")
                   for H in cs.RECURRENCE_SHAPES}
    train_rows = {}
    for H, T in cs.TRAIN_LAUNCHES_BY_SHAPE:
        for c in (False, True):
            train_rows["lstm_recurrence", H, T, c] = _fake_row(
                "lstm_recurrence")
        for name in ("lstm_bptt", "lstm_dwh"):
            train_rows[name, H, T, None] = _fake_row(name)
    ones = {k: 1 for k in cs.TRAIN_COUNTERS}
    errs = {"lstm_recurrence": 0.0, "lstm_recurrence_c": 0.0,
            "lstm_bptt": 0.0, "lstm_dwh_rel": 0.0}
    single = {k: 7 for k in cs.TRAIN_COUNTERS}
    rows = {f"train {n} B=4 T=256": _fake_row(n)
            for n in ("lstm_recurrence", "lstm_bptt", "lstm_dwh")}
    npss = {k: 25 for k in cs.TRAIN_COUNTERS}
    npss_rows = {f"train {n} B=64 T=128": {**_fake_row(n), "H": 1024,
                                           "max_abs_err": 3e-5}
                 for n in ("lstm_recurrence", "lstm_bptt", "lstm_dwh")}
    ar = {k: 45 for k in cs.TRAIN_COUNTERS}
    mel = {k: 13 for k in cs.TRAIN_COUNTERS}
    mel_rows = {"svs B=1 H=128": {**_fake_row("lstm_recurrence"), "H": 128,
                                  "max_abs_err": 4e-5}}
    for n in ("lstm_recurrence", "lstm_bptt", "lstm_dwh"):
        mel_rows[f"train {n} H=64 T=256"] = {
            **_fake_row(n), "H": 64, "max_abs_err": 2e-5,
            "max_rel_err": 5e-6}
    ms = {k: 23 for k in cs.TRAIN_COUNTERS}
    ms_rows = {f"train {n} H=512 T=256": {
        **_fake_row(n), "H": 512, "max_abs_err": 6e-5, "max_rel_err": 7e-6}
        for n in ("lstm_recurrence", "lstm_bptt", "lstm_dwh")}
    par = {k: 92 for k in cs.TRAIN_COUNTERS}
    line = cs.kernels_line(kernel_rows, single_rows, train_rows, 3,
                           {"pairwise": 2}, ones, ones, ones, errs, ones,
                           single, rows, npss, npss_rows, ar, mel,
                           mel_rows, ms, ms_rows, par)
    keys = {"name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms"}
    assert [k["name"] for k in line["kernels"]] == list(cs.TRAIN_COUNTERS)
    for k in line["kernels"]:
        assert keys <= set(k), k["name"]
        assert k["launches_by_path"]["recipe_single"] == 7
        assert list(k["recipe_single_rows"]) == [
            f"train {k['name']} B=4 T=256"]
        assert k["launches_by_path"]["recipe_npss"] == 25
        assert k["launches_by_path"]["ar_options"] == 45
        assert list(k["recipe_npss_rows"]) == [
            f"train {k['name']} B=64 T=128"]
        npss_row = k["recipe_npss_rows"][f"train {k['name']} B=64 T=128"]
        assert npss_row["H"] == 1024
        assert npss_row["library_input_gemm_ms"] == 1.0
        assert npss_row["kernel"] == "k"
        assert npss_row["bound_3xtf32_ms"] == 1.0
        if k["name"] == "lstm_bptt":
            assert npss_row["loop_bound_3xtf32_ms"] == 1.0
            assert npss_row["bound_fma_ms"] == 1.0
            assert npss_row["loop_bound_fma_ms"] == 1.0
            assert npss_row["loop_mma_rows"] == 1.0
        assert k["launches_by_path"]["mel_voice"] == 13
        assert f"train {k['name']} H=64 T=256" in k["mel_voice_rows"]
        assert k["launches_by_path"]["multi_speaker"] == 23
        assert k["launches_by_path"]["parallel"] == 92
        assert list(k["multi_speaker_rows"]) == [
            f"train {k['name']} H=512 T=256"]
    by = {k["name"]: k for k in line["kernels"]}
    assert by["lstm_recurrence"]["max_abs_err"] == 6e-5
    assert list(by["lstm_recurrence"]["mel_voice_rows"]) == [
        "svs B=1 H=128", "train lstm_recurrence H=64 T=256"]
    assert by["lstm_bptt"]["max_abs_err"] == 6e-5
    assert by["lstm_dwh"]["max_rel_err"] == 7e-6
