"""The recipe's data stages (-1 corpus preparation, 0 lists, 1 features,
2 scalers) on the port against the JAX package's, on the CPU.

One module-scoped synthetic jaCappella corpus (``tests/util.
build_synthetic_jacappella_corpus``, 2 singers x 3 songs at 24 kHz, one
singer's wavs 24-bit) goes through the JAX ``bin/run_recipe.main`` and the
port's, both ``--stage -1 --stop-stage 2`` on the packaged recipe with the
JAX e2e test's overrides (``tests/util.multitrack_mini_recipe_overrides``),
twice:

* ``native-48k``: the native WORLD path with the recipe's acoustic params
  verbatim (48 kHz, so the 24 kHz wavs are resampled; mgc order 59, 5
  coded aperiodicities: 67 outputs);
* ``numpy-24k``: the NumPy path (``ESVS_DISABLE_NATIVE=1``), the e2e
  test's acoustic params (24 kHz, mgc order 7).

The JAX side keeps the e2e test's ``n_jobs: 1``; the port takes the
recipe's ``n_jobs: 4`` (its process pool).  Every file either runner
writes is compared: lists and labels by bytes, wavs by samples, every
``.npy`` (features, note times, waves, postfilter targets, scalers) by
bytes.  Then the stage CLIs one by one, the runner's stage ranges (a
multitrack recipe's refusal of stages 8 and 9), and the YAML subset on
the recipe file.
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest
import yaml
from scipy.io import wavfile

from tests.util import (
    build_synthetic_jacappella_corpus,
    multitrack_mini_recipe_overrides,
)
from tests.test_torch_svs import few_threads  # noqa: F401  (autouse)

SR = 24000
SPKS = ["alto", "soprano"]
RECIPE = (Path(__file__).resolve().parents[1] /
          "ensemble_svs_with_interactions_tpu" / "recipes" /
          "jaCappella_dev_48k_world_multitrack" / "config.yaml")
RUNS = ("native-48k", "numpy-24k")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return build_synthetic_jacappella_corpus(
        tmp_path_factory.mktemp("jacappella"), spks=SPKS, sr=SR)


def write_recipe(root: Path, corpus, side: str, verbatim: bool):
    """The packaged recipe with the e2e test's overrides as a file under
    ``root/side``; the port's keeps the recipe's ``n_jobs``; ``verbatim``
    keeps the recipe's acoustic params.  Returns (recipe path, work)."""
    from ensemble_svs_with_interactions_tpu.utils.config import (
        load_config,
        merge,
    )

    work = root / side / "work"
    over = multitrack_mini_recipe_overrides(
        corpus, work, root / "conf", work / "data", spks=SPKS, sr=SR)
    if side == "port":
        del over["features"]["n_jobs"]
    if verbatim:
        del over["features"]["acoustic"]["params"]
    recipe = merge(load_config(RECIPE), over)
    path = root / side / "recipe.yaml"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(yaml.safe_dump(json.loads(json.dumps(recipe))))
    return path, work


@pytest.fixture(scope="module", params=RUNS)
def runs(request, corpus, tmp_path_factory):
    """{side: work dir} after both runners ran stages -1 to 2."""
    from ensemble_svs_with_interactions_tpu.bin.run_recipe import (
        main as jax_main,
    )
    from ensemble_svs_with_interactions_tpu_torch.bin.run_recipe import (
        main as port_main,
    )

    root = tmp_path_factory.mktemp(request.param)
    numpy_path = request.param.startswith("numpy")
    verbatim = request.param.endswith("48k")
    old = os.environ.get("ESVS_DISABLE_NATIVE")
    os.environ["ESVS_DISABLE_NATIVE"] = "1" if numpy_path else "0"
    try:
        works = {}
        for side, main in (("jax", jax_main), ("port", port_main)):
            path, works[side] = write_recipe(root, corpus, side, verbatim)
            assert main([str(path), "--stage", "-1", "--stop-stage",
                         "2"]) == 0
    finally:
        if old is None:
            del os.environ["ESVS_DISABLE_NATIVE"]
        else:
            os.environ["ESVS_DISABLE_NATIVE"] = old
    return {"name": request.param, **works}


def files(work: Path, suffix: str = ""):
    return sorted(p.relative_to(work) for p in work.rglob(f"*{suffix}")
                  if p.is_file())


def test_runner_writes_the_same_paths(runs):
    got, want = files(runs["port"]), files(runs["jax"])
    assert got == want
    kinds = {str(p).split("/")[0] for p in got}
    assert kinds == {"data", "lists", "dump", "scalers"}
    assert len([p for p in got if p.suffix == ".npy"]) > 200


def test_lists_and_labels_are_byte_equal(runs):
    names = files(runs["jax"], ".lab") + files(runs["jax"], ".list") + \
        files(runs["jax"], ".txt")
    assert len(names) > 40
    for rel in names:
        assert (runs["port"] / rel).read_bytes() == \
            (runs["jax"] / rel).read_bytes(), rel
    lists = runs["port"] / "lists"
    songs = {s: {u.split("_")[1] for u in (lists / f"{s}.list").read_text()
                 .split()} for s in ("train_no_dev", "dev", "eval")}
    assert songs == {"train_no_dev": {"song0"}, "dev": {"song1"},
                     "eval": {"song2"}}


def test_wavs_are_sample_equal(runs):
    names = files(runs["jax"], ".wav")
    assert len(names) >= 8
    for rel in names:
        sr, got = wavfile.read(runs["port"] / rel)
        sr_j, want = wavfile.read(runs["jax"] / rel)
        assert sr == sr_j == SR and got.dtype == want.dtype == np.int16
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("suffix", ("-feats.npy", "-times.npy",
                                    "-wave.npy"))
def test_dumps_are_bitwise(runs, suffix):
    names = files(runs["jax"] / "dump", suffix)
    assert names
    for rel in names:
        assert (runs["port"] / "dump" / rel).read_bytes() == \
            (runs["jax"] / "dump" / rel).read_bytes(), rel
    if suffix == "-feats.npy":
        pf = [p for p in names if "out_postfilter" in str(p)]
        assert pf and all("org" in str(p) for p in pf)


def test_scalers_are_bitwise(runs):
    names = files(runs["jax"] / "scalers")
    assert len(names) == 15  # 3 minmax x 2 files + 3 standard x 3
    for rel in names:
        assert (runs["port"] / "scalers" / rel).read_bytes() == \
            (runs["jax"] / "scalers" / rel).read_bytes(), rel


def test_acoustic_width_follows_the_rate(runs):
    """The e2e params give mgc 8 + lf0 + vuv + 3 bands at 24 kHz; the
    recipe's give 60 + 1 + 1 + 5 = 67 at 48 kHz, with 5 ms of 48 kHz wave
    per frame."""
    org = runs["port"] / "dump" / "dev" / "org" / "out_acoustic"
    feats = sorted(org.glob("*-feats.npy"))
    x = np.load(feats[0])
    wave = np.load(str(feats[0]).replace("-feats", "-wave"))
    width, sr = (13, 24000) if runs["name"].endswith("24k") else (67, 48000)
    assert x.shape[1] == width and x.dtype == np.float32
    assert len(wave) == len(x) * sr // 200
    norm = np.concatenate([np.load(p) for p in sorted(
        (runs["port"] / "dump" / "train_no_dev" / "norm" / "out_acoustic")
        .glob("*-feats.npy"))])
    assert np.isfinite(norm).all()
    np.testing.assert_allclose(norm.mean(0), 0.0, atol=1e-4)


# ------------------------------------------------------- the CLIs alone


def _cfg_file(path: Path, data: Path, out: Path, utt_list: Path):
    from ensemble_svs_with_interactions_tpu_torch.utils import (
        packaged_question_path,
    )

    cfg = {
        "utt_list": str(utt_list), "out_dir": str(out),
        "question_path": packaged_question_path(), "n_jobs": 2,
        "timelag": {
            "label_phone_score_dir": str(data / "timelag/label_phone_score"),
            "label_phone_align_dir": str(data / "timelag/label_phone_align"),
        },
        "duration": {"label_dir": str(data / "duration/label_phone_align")},
        "acoustic": {
            "wav_dir": str(data / "acoustic/wav"),
            "label_dir": str(data / "acoustic/label_phone_align"),
            "params": {"sample_rate": SR, "f0_floor": 120, "f0_ceil": 700,
                       "mgc_order": 7, "num_windows": 3,
                       "relative_f0": True, "use_world_codec": False},
        },
    }
    path.write_text(yaml.safe_dump(cfg))
    return path


def _same_tree(got: Path, want: Path):
    names = files(want)
    assert names and files(got) == names
    for rel in names:
        assert (got / rel).read_bytes() == (want / rel).read_bytes(), rel


def test_stage_clis_match_jax(corpus, tmp_path):
    """data_prep_multitrack, prepare_features (single-track: no note
    times; with deltas, relative F0 and sp2mc mgc), its multitrack and
    _sync variants, fit_scaler and preprocess_normalize, each CLI on the
    same inputs in both packages, every output byte-equal."""
    from ensemble_svs_with_interactions_tpu.bin import (
        data_prep_multitrack as jdp,
        fit_scaler as jfit,
        prepare_features as jpf,
        prepare_features_multitrack as jpfm,
        prepare_features_multitrack_sync as jpfs,
        preprocess_normalize as jnorm,
    )
    from ensemble_svs_with_interactions_tpu_torch.bin import (
        data_prep_multitrack as dp,
        fit_scaler as fit,
        prepare_features as pf,
        prepare_features_multitrack as pfm,
        prepare_features_multitrack_sync as pfs,
        preprocess_normalize as norm,
    )

    args = ["--spk-list", ",".join(SPKS), "--silence-threshold", "0.4",
            "--dev-songs", "song1", "--eval-songs", "song2"]
    for side, mod in (("jax", jdp), ("port", dp)):
        assert mod.main([str(corpus), str(tmp_path / side / "data"),
                         *args]) == 0
    _same_tree(tmp_path / "port" / "data", tmp_path / "jax" / "data")

    data = tmp_path / "jax" / "data"
    utts = data / "lists" / "dev.list"
    for name, jmod, mod in (("single", jpf, pf), ("multi", jpfm, pfm),
                            ("sync", jpfs, pfs)):
        for side, m in (("jax", jmod), ("port", mod)):
            cfg = _cfg_file(tmp_path / f"{side}_{name}.yaml", data,
                            tmp_path / side / name, utts)
            assert m.main([str(cfg), "n_jobs=1" if side == "jax" else
                           "n_jobs=2"]) == 0
        _same_tree(tmp_path / "port" / name, tmp_path / "jax" / name)
        times = files(tmp_path / "port" / name, "-times.npy")
        assert bool(times) == (name == "sync")
    x = np.load(next((tmp_path / "port" / "single" / "out_acoustic")
                     .glob("*-feats.npy")))
    assert x.shape[1] == 3 * (8 + 1 + 3) + 1

    feats = tmp_path / "jax" / "sync"
    for phase, kind in (("in_acoustic", "minmax"),
                        ("out_acoustic", "standard")):
        for side, fmod, nmod in (("jax", jfit, jnorm), ("port", fit, norm)):
            prefix = tmp_path / side / "scalers" / phase
            prefix.parent.mkdir(parents=True, exist_ok=True)
            assert fmod.main([str(feats / phase), str(prefix), "--type",
                              kind, "--utt-list", str(utts)]) == 0
            assert nmod.main([str(feats / phase), str(prefix),
                              str(tmp_path / side / "norm" / phase),
                              "--type", kind]) == 0
    _same_tree(tmp_path / "port" / "scalers", tmp_path / "jax" / "scalers")
    _same_tree(tmp_path / "port" / "norm", tmp_path / "jax" / "norm")


def test_scaler_fits_match_jax():
    """partial_fit over uneven batches, and fit, bitwise the JAX
    scalers' (a constant column takes scale 1 in both)."""
    from ensemble_svs_with_interactions_tpu.utils import scalers as js
    from ensemble_svs_with_interactions_tpu_torch.utils import scalers as ps

    rng = np.random.default_rng(0)
    batches = [rng.normal(3.0, 2.0, size=(n, 4)) for n in (5, 17, 1, 40)]
    for b in batches:
        b[:, 2] = 7.0
    for cls in ("StandardScaler", "MinMaxScaler"):
        got, want = getattr(ps, cls)(), getattr(js, cls)()
        for b in batches:
            got.partial_fit(b)
            want.partial_fit(b)
        for attr in ("mean_", "var_", "scale_", "min_", "data_min_",
                     "data_max_"):
            if hasattr(want, attr):
                np.testing.assert_array_equal(getattr(got, attr),
                                              getattr(want, attr))
        got.fit(batches[1])
        want.fit(batches[1])
        np.testing.assert_array_equal(got.scale_, want.scale_)


# ----------------------------------------------------------- the runner


@pytest.mark.parametrize("stages,multitrack", [
    (("-1", "8"), True), (("8", "8"), True), (("5", "10"), True),
    (("9", "9"), True), (("0", "9"), False), (("2", "20"), False)])
def test_runner_refuses_unwired_stages(tmp_path, monkeypatch, stages,
                                       multitrack):
    """A multitrack recipe's range that reaches stage 8 or 9 (the learned
    postfilter's pairs and training, single-track only) raises before a
    stage runs: stage 8 with the JAX runner's ValueError, stage 9 alone
    with the port's; a single-track range runs its stages, 8 and 9
    included, in order.  The default range, 0 to 7 as the JAX runner's,
    runs those stages."""
    from ensemble_svs_with_interactions_tpu.bin import run_recipe as jax_rr
    from ensemble_svs_with_interactions_tpu_torch.bin import run_recipe

    work = tmp_path / "work"
    args = [str(RECIPE), "--stage", stages[0], "--stop-stage", stages[1],
            f"work_dir={work}", f"multitrack={str(multitrack).lower()}"]
    ran = []
    monkeypatch.setattr(run_recipe, "STAGES", {
        k: (lambda cfg, w, k=k: ran.append(k)) for k in run_recipe.STAGES})
    first, last = int(stages[0]), int(stages[1])
    if multitrack:
        with pytest.raises(ValueError) as err:
            run_recipe.main(args)
        if first <= 8:
            with pytest.raises(ValueError) as want:
                jax_rr.stage8_postfilter_features(jax_rr.Config(
                    {"multitrack": True}), work)
            assert str(err.value) == str(want.value)
        else:
            assert "stage 9" in str(err.value)
            assert "single-track" in str(err.value)
        assert not work.exists() and ran == []
    else:
        assert run_recipe.main(args) == 0
        assert ran == list(range(first, min(last, 11) + 1))
        assert 8 in ran and 9 in ran
    ran.clear()
    assert run_recipe.main([str(RECIPE), f"work_dir={work}"]) == 0
    assert ran == list(range(8))
    assert sorted(run_recipe.STAGES) == list(range(-1, 12))


def test_stage0_splits_without_lists_dir(tmp_path):
    """Without ``data.lists_dir`` stage 0 splits ``data.utt_list`` (seeded
    shuffle) as the JAX runner does."""
    from ensemble_svs_with_interactions_tpu.bin.run_recipe import (
        main as jax_main,
    )
    from ensemble_svs_with_interactions_tpu_torch.bin.run_recipe import main

    utts = tmp_path / "utts.list"
    utts.write_text("\n".join(f"u{k:02d}" for k in range(23)) + "\n")
    for side, m in (("jax", jax_main), ("port", main)):
        assert m([str(RECIPE), "--stage", "0", "--stop-stage", "0",
                  f"work_dir={tmp_path / side}", "data.lists_dir=null",
                  f"data.utt_list={utts}", "data.shuffle_utt_list=true",
                  "data.n_dev=3"]) == 0
    _same_tree(tmp_path / "port", tmp_path / "jax")


def test_materialized_recipe_matches_jax():
    """The packaged recipe read by the port's YAML subset, its model
    configs resolved and the vocoder's sections loaded, equals the JAX
    runner's."""
    from ensemble_svs_with_interactions_tpu.bin.run_recipe import (
        _materialize_packaged_configs as jax_materialize,
    )
    from ensemble_svs_with_interactions_tpu.utils.config import (
        load_config as jax_load,
    )
    from ensemble_svs_with_interactions_tpu_torch.bin.run_recipe import (
        _materialize_packaged_configs,
    )
    from ensemble_svs_with_interactions_tpu_torch.utils.config import (
        load_config,
    )

    got = _materialize_packaged_configs(load_config(RECIPE),
                                        RECIPE.parent.resolve())
    want = jax_materialize(jax_load(RECIPE), RECIPE.parent.resolve())
    assert json.loads(json.dumps(got)) == json.loads(json.dumps(want))
    assert got["vocoder"]["model"]["generator"]
    assert Path(got["question_path"]).exists()


def test_recipe_yaml_subset_matches_pyyaml():
    """The port's YAML subset reads the recipe file (its data_prep and
    features blocks: nulls, flow lists such as [-20, 19]) as PyYAML
    does."""
    from ensemble_svs_with_interactions_tpu_torch.utils import yaml_io

    text = RECIPE.read_text()
    got = yaml_io.load(text)
    assert got == yaml.safe_load(text)
    assert got["data_prep"]["timelag_allowed_range"] == [-20, 19]
    assert got["features"]["acoustic"]["params"]["f0_floor"] is None
