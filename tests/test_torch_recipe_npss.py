"""The single-track recipe's acoustic phase with the deterministic NPSS
cascade (stages 5 to 7 of ``bin/run_recipe.py``) on the port, against the
JAX package's stage functions and engine, on the CPU.

The recipe is ``tests/test_recipe_e2e.py``'s (its corpus, ``MDNv2``
timing models, training sections; ``tests/test_torch_recipe_single.
e2e_recipe``; the acoustic phase one epoch) with the acoustic model
swapped for a tiny
``acoustic_npss_ar_mgcf0bap.yaml``: the same classes (the AR residual-F0
lf0 decoder, ``BiLSTMNonAttentiveDecoder`` mgc and bap decoders with
Post-Nets and the go frame -4, an FFConvLSTM vuv model), the lf0
statistics left null for the runner to fill, prenet dropout 0 (its masks
cannot match across frameworks).  The port's runner runs stages 0 to 7
once (module-scoped, ``device: cpu``); the JAX package then runs on the
port's work directory, so no JAX model trains here
(``tests/test_torch_npss_steps.py`` holds the train step):

* stage 5's trainer config equals the JAX runner's, the cascade's null
  lf0 statistics (its own and its lf0 model's) filled from the scalers;
* stage 6: JAX's ``stage6_pack`` on the port's checkpoints writes the
  port's pack (configs equal, scalers byte for byte, every weight
  bitwise);
* stage 7 rendered every song of its label directory, and the pack opens
  in both engines: ``svs()`` of a song gives the same durations, streams within
  STREAM_RTOL of each stream's scale and a waveform at SNR >= SNR_DB
  with the port's WORLD noise replayed in JAX.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from ensemble_svs_with_interactions_tpu.bin import run_recipe as jax_recipe
from ensemble_svs_with_interactions_tpu.io import hts as jax_hts
from ensemble_svs_with_interactions_tpu.svs import SPSVS as JaxSPSVS
from ensemble_svs_with_interactions_tpu.utils.config import (
    load_config as jax_load,
)
from ensemble_svs_with_interactions_tpu_torch import gen
from ensemble_svs_with_interactions_tpu_torch.bin import run_recipe
from ensemble_svs_with_interactions_tpu_torch.io import hts
from ensemble_svs_with_interactions_tpu_torch.svs import SPSVS
from ensemble_svs_with_interactions_tpu_torch.utils import flax_msgpack
from ensemble_svs_with_interactions_tpu_torch.utils.config import load_config
from tests.test_recipe_e2e import _write_model_configs
from tests.test_torch_npss_ar import cascade_config
from tests.test_torch_recipe_single import e2e_recipe, write_corpus
from tests.test_torch_svs import traced_flax_inits

SR = 24000
STREAM_RTOL = 1e-3
SNR_DB = 40.0
STREAMS = ("mgc", "lf0", "vuv", "bap")
LF0_KEYS = ("in_lf0_min", "in_lf0_max", "out_lf0_mean", "out_lf0_scale")


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def npss_config():
    """``tests/test_torch_npss_ar.cascade_config`` (the shipped cascade's
    shape, vuv on (mgc, lf0); one-layer stream decoders, whose layer
    boundary that file holds) on the e2e recipe's streams 25 + 1 + 1 + 3,
    every lf0 statistic null."""
    cfg = cascade_config(vuv_bap=False)
    net = cfg["netG"]
    for name in ("mgc_model", "bap_model"):
        net[name]["decoder_layers"] = 1
    ss = [25, 1, 1, 3]
    net.update(out_dim=sum(ss), stream_sizes=ss, out_lf0_idx=25)
    net["mgc_model"]["out_dim"] = 25
    net["vuv_model"]["in_dim"] = 86 + 25 + 1
    for node in (net, net["lf0_model"]):
        node.update({k: None for k in LF0_KEYS})
    return {**cfg, "stream_sizes": ss}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The port's runner, stages 0 to 7: {root, recipe, work, cfg}."""
    root = tmp_path_factory.mktemp("npss")
    write_corpus(root / "corpus")
    _write_model_configs(root / "conf")
    # no YAML aliases: the port's YAML subset does not read them
    (root / "conf" / "acoustic.yaml").write_text(yaml.safe_dump(
        json.loads(json.dumps(npss_config()))))
    work = root / "work"
    recipe = root / "recipe.yaml"
    cfg = e2e_recipe(root / "corpus", root / "conf", work)
    cfg["acoustic"]["train"]["nepochs"] = 1
    recipe.write_text(yaml.safe_dump(json.loads(json.dumps(cfg))))
    assert run_recipe.main([str(recipe), "--stage", "0", "--stop-stage",
                            "7"]) == 0
    return {"root": root, "recipe": recipe, "work": work,
            "cfg": jax_load(recipe)}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def test_acoustic_phase_config_matches_jax(run):
    """Stage 5 trains on the JAX runner's config: the cascade's and its
    lf0 model's null lf0 statistics filled from the fitted scalers."""
    got = run_recipe._phase_cfg(load_config(run["recipe"]), run["work"],
                                "acoustic")
    want = jax_recipe._resolve_lf0_stats(
        run["cfg"], run["work"],
        jax_recipe._train_cfg(run["cfg"], run["work"], "acoustic"))
    net = got["model"]["netG"]
    for node in (net, net["lf0_model"]):
        assert all(isinstance(node[k], float) for k in LF0_KEYS)
    assert json.loads(json.dumps(got)) == json.loads(json.dumps(want))
    assert (run["work"] / "exp" / "acoustic" / "best_loss.ckpt").exists()


def test_stage6_pack_is_jax_s(run):
    """JAX's ``stage6_pack`` on a copy of the port's work directory (its
    templates traced, every value from the port's checkpoints) writes the
    port's files."""
    work = run["root"] / "jax6"
    work.mkdir()
    os.symlink(run["work"] / "dump", work / "dump")
    for d in ("scalers", "exp"):
        shutil.copytree(run["work"] / d, work / d)
    with traced_flax_inits():
        jax_recipe.stage6_pack(run["cfg"], work)
    got_dir, want_dir = run["work"] / "packed_model", work / "packed_model"
    names = sorted(p.name for p in got_dir.iterdir())
    assert names == sorted(p.name for p in want_dir.iterdir())
    assert "acoustic_model.params" in names
    for n in names:
        got, want = got_dir / n, want_dir / n
        if n.endswith(".yaml"):
            assert load_config(got) == jax_load(want), n
        elif n.endswith(".params"):
            g, w = (dict(_leaves(flax_msgpack.from_bytes(f.read_bytes())))
                    for f in (got, want))
            assert sorted(g) == sorted(w), n
            for p, a in g.items():
                np.testing.assert_array_equal(a, w[p], err_msg=f"{n} {p}")
        else:
            assert got.read_bytes() == want.read_bytes(), n


@pytest.fixture(scope="module")
def rendered(run):
    """Both engines on the port's pack, one song: (port, JAX) as
    (duration-modified labels, streams, waveform)."""
    lab = sorted((run["root"] / "corpus" / "lab").glob("*.lab"))[-1]
    packed = run["work"] / "packed_model"

    def normal(key, shape, dtype=jnp.float32):
        shape = tuple(int(s) for s in shape)
        n = gen.vocoder_noise(1, int(np.prod(shape)), "cpu").numpy()
        return jnp.asarray(n.reshape(shape), dtype)

    out = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal", normal)
        for mod, engine in ((hts, SPSVS(packed, device="cpu")),
                            (jax_hts, None)):
            if engine is None:
                with traced_flax_inits():
                    engine = JaxSPSVS(packed)
            dm = engine.predict_timing(mod.load(lab))
            streams = engine.postprocess_acoustic(engine.predict_acoustic(
                dm), dm)
            wav, sr = engine.svs(mod.load(lab), dtype=np.float32)
            assert sr == SR
            out.append((dm, streams, np.asarray(wav)))
    return lab, out


def test_svs_matches_jax(run, rendered):
    lab, ((dm, streams, wav), (jdm, jstreams, jwav)) = rendered
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


def test_stage7_rendered_the_label_dir(run):
    """Stage 7 (``bin/synthesis.py`` on the pack) wrote one waveform a
    label file of ``synthesis.label_dir``, each non-silent."""
    from scipy.io import wavfile

    labs = sorted((run["root"] / "corpus" / "lab").glob("*.lab"))
    wavs = sorted((run["work"] / "synthesis").rglob("*.wav"))
    assert [w.stem for w in wavs] == [p.stem for p in labs]
    for w in wavs:
        sr, x = wavfile.read(w)
        assert sr == SR and np.abs(x).max() > 0, w
