"""The port's flagship slice, ``SPSVS.svs_ensemble``, against the JAX
engine, both opening the same packed model directory (written by the JAX
package's ``pack_model``), at tiny dims on a shortened fixture (4 tracks,
pairwise ring).

Durations must match exactly.  The acoustic model's output and the
post-processed (mgc, lf0, vuv, bap) streams are compared at atol 1e-4:
float32 on both sides with other summation orders, through an AR decoder
that at these dims does not amplify rounding.  The AR decoder's
inference-time prenet dropout cannot reproduce jax.random's bits, so the
config sets ``prenet_dropout = 0`` (tests/test_torch_models.py checks the
dropout itself).  The vocoder's noise differs between frameworks, so the
waveforms are checked for shape, type and content here and compared by
SNR with shared noise in tests/test_torch_world.py.
"""

import contextlib
import copy
import functools
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ensemble_svs_with_interactions_tpu import gen_multitrack as jax_gmt
from ensemble_svs_with_interactions_tpu.io import hts as jax_hts
from ensemble_svs_with_interactions_tpu.svs import SPSVS as JaxSPSVS
from ensemble_svs_with_interactions_tpu.utils.config import (
    instantiate as jax_instantiate,
)
from ensemble_svs_with_interactions_tpu.utils.packing import pack_model
from ensemble_svs_with_interactions_tpu.utils.scalers import (
    MinMaxScaler as JaxMinMax,
    StandardScaler as JaxStandard,
)
from ensemble_svs_with_interactions_tpu_torch.io import hts
from ensemble_svs_with_interactions_tpu_torch.svs import SPSVS
from tests.util import HED, NIT_LAB

SR = 24000
N_SPK = 4
ATOL = 1e-4
PKG = "ensemble_svs_with_interactions_tpu.models"
REPO = Path(__file__).resolve().parent.parent


@contextlib.contextmanager
def traced_flax_inits():
    """While entered, flax's ``Module.init`` traces its variables by
    ``jax.eval_shape`` instead of computing them (no compile): for opening
    a JAX engine, whose every ``init`` builds a template that
    ``from_bytes`` fills from the packed files and that raises on a leaf
    the files lack."""
    import flax.linen as nn

    init = nn.Module.init
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nn.Module, "init", lambda self, *a, **k: jax.eval_shape(
            lambda: init(self, *a, **k)))
        yield


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads while a module runs (the port's test modules
    import this): the tiny widths gain nothing from more, and more
    OpenMP threads wait busily against the suite's other workers for the
    cores, which doubled a module's CPU time."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run_cached(name, fn):
    """``fn()``, a deterministic tree of NumPy arrays, made once a test
    run: the first process that needs it writes it beside the run's
    compilation cache (``tests/conftest.py``'s ``ESVS_TEST_JAXCACHE``), the
    others (the other workers, later modules) read it back.  For the flax
    ``init`` of a fixture's model, which eagerly takes half a minute."""
    import os
    import pickle

    root = os.environ.get("ESVS_TEST_JAXCACHE")
    if not root:
        return fn()
    path = Path(root) / f"{name}.pkl"
    if path.exists():
        return pickle.loads(path.read_bytes())
    value = fn()
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    tmp.write_bytes(pickle.dumps(value))
    os.replace(tmp, path)
    return value


def _configs(mgc_dim=8, bap_dim=3):
    ss = [mgc_dim, 1, 1, bap_dim]
    timing = {
        "netG": {
            "_target_": f"{PKG}.MultiTrackVariancePredictor", "in_dim": 82,
            "out_dim": 1, "num_speaker": N_SPK, "spk_embed_dim": 4,
            "num_layers": 2, "hidden_dim": 8, "kernel_size": 3,
            "use_mdn": True, "num_gaussians": 2,
        },
        "stream_sizes": [1], "has_dynamic_features": [False],
        "num_windows": 1,
    }
    timelag = {
        "netG": dict(timing["netG"], out_dim=3),
        "stream_sizes": [3], "has_dynamic_features": [True],
        "num_windows": 3,
    }
    dec = {"in_dim": 10, "ff_hidden_dim": 8, "conv_hidden_dim": 8,
           "lstm_hidden_dim": 4, "num_lstm_layers": 2}
    acoustic = {
        "netG": {
            "_target_": f"{PKG}.acoustic.MultiTrackMultistreamSeparateF0ParametricModel",
            "in_dim": 86, "out_dim": sum(ss), "stream_sizes": ss,
            "reduction_factor": 4, "in_rest_idx": 0, "in_lf0_idx": 51,
            "out_lf0_idx": mgc_dim, "in_lf0_min": 4.5, "in_lf0_max": 6.5,
            "out_lf0_mean": float(np.log(220.0)), "out_lf0_scale": 0.1,
            "encoder": {
                "_target_": f"{PKG}.MultiTrackLSTMEncoder", "in_dim": 86,
                "hidden_dim": 4, "out_dim": 8, "num_layers": 2,
                "in_ph_start_idx": 3, "in_ph_end_idx": 50, "embed_dim": 8,
            },
            "lf0_model": {
                "_target_": f"{PKG}.acoustic.MultiTrackBiLSTMResF0NonAttentiveDecoder",
                "in_dim": 86, "out_dim": 1, "ff_hidden_dim": 8,
                "conv_hidden_dim": 8, "lstm_hidden_dim": 4,
                "num_lstm_layers": 2, "decoder_layers": 1,
                "decoder_hidden_dim": 8, "prenet_layers": 0,
                "prenet_hidden_dim": 4, "prenet_dropout": 0.0,
                "scaled_tanh": True, "zoneout": 0.0, "reduction_factor": 4,
                "downsample_by_conv": True, "in_lf0_idx": 51,
                "out_lf0_idx": 0, "in_lf0_min": 4.5, "in_lf0_max": 6.5,
                "out_lf0_mean": float(np.log(220.0)), "out_lf0_scale": 0.1,
                "in_ph_start_idx": 3, "in_ph_end_idx": 50, "embed_dim": 8,
            },
            "mgc_model": {"_target_": f"{PKG}.FFConvLSTM", **dec,
                          "out_dim": ss[0]},
            "vuv_model": {"_target_": f"{PKG}.FFConvLSTM", **dec,
                          "out_dim": ss[2]},
            "bap_model": {"_target_": f"{PKG}.FFConvLSTM", **dec,
                          "out_dim": ss[3]},
            "speaker_embedding": {
                "_target_": f"{PKG}.SpeakerEmbedding",
                "num_embeddings": N_SPK, "embedding_dim": 8,
            },
        },
        "stream_sizes": ss, "has_dynamic_features": [False] * 4,
        "num_windows": 1,
    }
    return timelag, timing, acoustic, ss


@functools.lru_cache(maxsize=None)
def _tiny_variables():
    """The tiny multitrack model's flax ``init`` (eager, so slow: made
    once a run, ``run_cached``; ``tiny_model`` hands out copies)."""
    return run_cached("tiny_multitrack_variables", _init_tiny_variables)


def _init_tiny_variables():
    timelag, duration, acoustic, ss = _configs()
    rngs = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1),
            "prenet": jax.random.PRNGKey(2)}
    spks = (jnp.zeros((1,), jnp.int32), jnp.ones((1,), jnp.int32))

    def init_timing(cfg):
        return jax_instantiate(cfg["netG"]).init(
            rngs, jnp.zeros((1, 8, 164)), spks, jnp.asarray([8]))

    T = 8
    variables = {
        "timelag": init_timing(timelag),
        "duration": init_timing(duration),
        "acoustic": jax_instantiate(acoustic["netG"]).init(
            rngs, jnp.zeros((1, T, 86)), jnp.zeros((1, T, 86)), spks,
            jnp.asarray([T]),
            (jnp.zeros((1, T, sum(ss))), jnp.zeros((1, T, sum(ss))))),
    }
    return jax.tree_util.tree_map(np.asarray, variables)


def tiny_model():
    """(global config, {phase: model config}, {phase: flax variables as
    numpy}, {phase: (in_dim, out mean, out scale)}) of the tiny multitrack
    model."""
    timelag, duration, acoustic, ss = _configs()
    variables = copy.deepcopy(_tiny_variables())
    out_dim = sum(ss)
    mean = np.zeros(out_dim)
    scale = np.ones(out_dim) * 0.1
    mean[ss[0]] = np.log(220.0)
    stats = {
        "timelag": (82, np.zeros(3), np.ones(3) * 2),
        "duration": (82, np.ones(1) * 10, np.ones(1) * 2),
        "acoustic": (86, mean, scale),
    }
    cfgs = {"timelag": timelag, "duration": duration, "acoustic": acoustic}
    glob = {"sample_rate": SR, "frame_period": 5, "feature_type": "world",
            "use_world_codec": True, "relative_f0": False,
            "spk_list": [f"spk{i}" for i in range(N_SPK)]}
    return glob, cfgs, variables, stats


def tiny_phases(cfgs, stats, minmax, standard, weights):
    """``pack_model``'s phases: the scaler classes given, the weights
    entries from ``weights(phase)``."""
    return {
        ph: {"model_config": cfgs[ph], **weights(ph),
             "in_scaler": minmax(np.zeros(d), np.ones(d)),
             "out_scaler": standard(m, s ** 2, s)}
        for ph, (d, m, s) in stats.items()
    }


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """(JAX engine, port engine), both opening one directory that the JAX
    package's ``pack_model`` wrote from the flax variables and scalers."""
    glob, cfgs, variables, stats = tiny_model()
    model_dir = tmp_path_factory.mktemp("packed_mt4")
    pack_model(model_dir, glob, HED, tiny_phases(
        cfgs, stats, JaxMinMax, JaxStandard,
        lambda ph: {"variables": variables[ph]}))
    with traced_flax_inits():
        jax_engine = JaxSPSVS(model_dir)
    return jax_engine, SPSVS(model_dir, device="cpu")


def _short_labels(mod, seconds=4.0):
    labels = mod.load(NIT_LAB)
    n = next(i for i, e in enumerate(labels.end_times) if e > seconds * 1e7)
    return labels[: max(n, 10)]


def assert_slice_matches(jax_engine, engine):
    """Durations exactly, frame features exactly, the acoustic output and
    the post-processed streams at ATOL, and the port's rendered int16
    audio of the right shape and content."""
    N = 4
    spk_ids, pairs = list(range(N)), [(i + 1) % N for i in range(N)]

    ref_dm = jax_gmt.predict_timing_multitrack_batch(
        [_short_labels(jax_hts) for _ in range(N)], spk_ids, pairs,
        jax_engine.binary_dict, jax_engine.numeric_dict,
        jax_engine.timelag_model, jax_engine.in_timelag_scaler,
        jax_engine.out_timelag_scaler, jax_engine.duration_model,
        jax_engine.in_duration_scaler, jax_engine.out_duration_scaler,
        frame_period=jax_engine.frame_period)
    got_dm = engine.predict_timing_multitrack_batch(
        [_short_labels(hts) for _ in range(N)], spk_ids, pairs)
    for r, g in zip(ref_dm, got_dm):
        assert list(g.start_times) == list(r.start_times)
        assert list(g.end_times) == list(r.end_times)

    ref_feats, ref_raw = jax_engine._frame_features(ref_dm)
    feats, raw = engine._frame_features(got_dm)
    for r, g in zip(ref_feats, feats):
        np.testing.assert_array_equal(g, r)

    spks = ([spk_ids[i] for i in range(N)],
            [spk_ids[pairs[i]] for i in range(N)])
    ref_out, lengths = jax_engine.acoustic_model.inference_batch(
        ref_feats, spks=tuple(jnp.asarray(s, jnp.int32) for s in spks),
        sub_index=pairs, method="inference_main", device_out=True)
    out, lengths_port = engine.acoustic_model.inference_batch(
        feats, spks=spks, sub_index=pairs, method="inference_main",
        device_out=True)
    np.testing.assert_array_equal(lengths_port, lengths)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=ATOL)

    ref_streams = jax_engine._fused_postprocess(ref_out, lengths, ref_raw,
                                                "gv")
    streams = engine._fused_postprocess(out, lengths, raw, "gv")
    for r, g in zip(ref_streams, streams):
        r, g = np.asarray(r), g.numpy()
        for i in range(N):
            np.testing.assert_allclose(g[i, : lengths[i]],
                                       r[i, : lengths[i]], atol=ATOL)

    wavs, sr = engine.svs_ensemble([_short_labels(hts) for _ in range(N)],
                                   spk_ids=spk_ids)
    assert sr == SR and len(wavs) == N
    hop = SR * 5 // 1000
    for wav, n in zip(wavs, lengths):
        assert wav.dtype == np.int16 and len(wav) == n * hop
        assert np.abs(wav.astype(np.int64)).max() > 0
    assert set(engine.last_stage_times) >= {
        "timing_feats", "acoustic_dispatch", "postproc_dispatch", "vocoder",
        "timing_models", "frame_feats"}


def test_svs_ensemble_slice_matches_jax(engines):
    assert_slice_matches(*engines)


def test_svs_ensemble_takes_the_jax_signature(engines):
    """``svs_ensemble(labels, vocoder_type, post_filter_type, vuv_threshold,
    dtype, spk_ids, pairs, blocked_stage_times)``: the positional
    ``"world"`` renders what the keyword call renders; other output dtypes
    render as the JAX engine's do (float32 of its lengths and dtype, int32
    through ``postprocess_waveform``); a neural vocoder type with none
    packed raises ValueError, as an unknown name does."""
    jax_engine, engine = engines
    labels = [_short_labels(hts) for _ in range(4)]
    wavs, sr = engine.svs_ensemble(labels, "world")
    ref, sr_ref = engine.svs_ensemble(labels, vocoder_type="world",
                                      post_filter_type="gv",
                                      vuv_threshold=0.5, dtype=np.int16)
    assert sr == sr_ref == SR
    for a, b in zip(wavs, ref):
        np.testing.assert_array_equal(a, b)
    auto, _ = engine.svs_ensemble(labels, "auto", "gv", 0.5, np.int16,
                                  list(range(4)), [1, 2, 3, 0])
    for a, b in zip(auto, ref):
        np.testing.assert_array_equal(a, b)
    floats, _ = engine.svs_ensemble(labels, dtype=np.float32)
    ref_floats, _ = jax_engine.svs_ensemble(
        [_short_labels(jax_hts) for _ in range(4)], dtype=np.float32)
    for a, b, c in zip(floats, ref_floats, ref):
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        assert len(a) == len(c) and 0 < np.abs(a).max() <= 1.0
    ints, _ = engine.svs_ensemble(labels, dtype=np.int32)
    for a, b in zip(ints, floats):
        assert a.dtype == np.int32 and a.shape == b.shape
        # a peak-normalized float cast as numpy casts it: truncated to
        # -1, 0 or 1, with the peak at +-1
        assert set(np.unique(a).tolist()) <= {-1, 0, 1}
        assert np.abs(a).max() == 1
    # no packed vocoder: a neural type raises ValueError, as in the JAX
    # engine
    for kw in ({"vocoder_type": "pwg"}, {"vocoder_type": "usfgan"}):
        with pytest.raises(ValueError, match="packed neural vocoder"):
            engine.svs_ensemble(labels, **kw)
    with pytest.raises(ValueError, match="vocoder type"):
        engine.svs_ensemble(labels, "hifigan")
    with pytest.raises(ValueError, match="post-filter type"):
        engine.svs_ensemble(labels, "world", "wiener")


def test_instantiate_maps_jax_targets_to_port():
    from ensemble_svs_with_interactions_tpu_torch.models import FFConvLSTM
    from ensemble_svs_with_interactions_tpu_torch.utils.config import (
        resolve_target,
    )

    assert resolve_target(f"{PKG}.FFConvLSTM") is FFConvLSTM
    assert resolve_target(
        "ensemble_svs_with_interactions_tpu_torch.models.FFConvLSTM"
    ) is FFConvLSTM


def test_port_imports_no_jax():
    """The port (the serving path with its packed-directory reader and
    writer, the neural vocoders and their training, the diffusion and
    flow-matching models and the NPSS cascade, the train steps,
    the trainers with their datasets, metrics, renders, initializers and
    CLIs, the recipe's data stages -1 to 2 with the native WORLD analysis,
    their CLIs, the recipe runner with stages 3-7, 10 and 11, the
    synthesis, timing-evaluation, multi-speaker training and sweep CLIs,
    the score front ends, the NEUTRINO engine, its CLIs and server, the
    model registry and ``run_svs``, the device MLPG, the reference
    checkpoint importer and the remaining host CLIs),
    chip_smoke.py's and both benches' own imports leave JAX, flax, yaml,
    msgpack and the JAX package out of the process.  The port's name
    starts with the JAX package's, so the check is on exact names and the
    ``pkg.`` prefix."""
    code = (
        "import sys\n"
        "import ensemble_svs_with_interactions_tpu_torch.svs\n"
        "import ensemble_svs_with_interactions_tpu_torch.ops.lstm_recurrence\n"
        "import ensemble_svs_with_interactions_tpu_torch.train.multitrack\n"
        "import ensemble_svs_with_interactions_tpu_torch.train.loop\n"
        "import ensemble_svs_with_interactions_tpu_torch.train.trainer\n"
        "import ensemble_svs_with_interactions_tpu_torch.train"
        ".multitrack_trainer\n"
        "import ensemble_svs_with_interactions_tpu_torch.train.eval_render\n"
        "import ensemble_svs_with_interactions_tpu_torch.utils.flax_init\n"
        "import ensemble_svs_with_interactions_tpu_torch.bin.train\n"
        "import ensemble_svs_with_interactions_tpu_torch.bin.train_acoustic\n"
        "import ensemble_svs_with_interactions_tpu_torch.bin"
        ".train_multitrack\n"
        "import ensemble_svs_with_interactions_tpu_torch.bin"
        ".train_acoustic_multitrack\n"
        "import ensemble_svs_with_interactions_tpu_torch.models.acoustic\n"
        "import ensemble_svs_with_interactions_tpu_torch.models.acoustic"
        ".npss\n"
        "import ensemble_svs_with_interactions_tpu_torch.models.diffsinger\n"
        "import ensemble_svs_with_interactions_tpu_torch.models"
        ".flow_matching\n"
        "import ensemble_svs_with_interactions_tpu_torch.models.wavenet\n"
        "import ensemble_svs_with_interactions_tpu_torch.models.vocoders\n"
        "import ensemble_svs_with_interactions_tpu_torch.train.vocoder\n"
        "import ensemble_svs_with_interactions_tpu_torch.train"
        ".vocoder_trainer\n"
        "import ensemble_svs_with_interactions_tpu_torch.bin.train_vocoder\n"
        "import ensemble_svs_with_interactions_tpu_torch.bin"
        ".prepare_voc_features\n"
        "import ensemble_svs_with_interactions_tpu_torch.utils.precision\n"
        "import ensemble_svs_with_interactions_tpu_torch.utils.packing\n"
        "import ensemble_svs_with_interactions_tpu_torch.utils.yaml_io\n"
        "import ensemble_svs_with_interactions_tpu_torch.utils.flax_msgpack\n"
        "import ensemble_svs_with_interactions_tpu_torch.native\n"
        "import ensemble_svs_with_interactions_tpu_torch.ops.world.analysis\n"
        "import ensemble_svs_with_interactions_tpu_torch.ops.world.codec\n"
        "import ensemble_svs_with_interactions_tpu_torch.ops.praat\n"
        "import ensemble_svs_with_interactions_tpu_torch.ops.pitch\n"
        "import ensemble_svs_with_interactions_tpu_torch.ops.sptk\n"
        "import ensemble_svs_with_interactions_tpu_torch.ops.mlpg\n"
        "import ensemble_svs_with_interactions_tpu_torch.data.data_source\n"
        "import ensemble_svs_with_interactions_tpu_torch.utils.scalers\n"
        "import ensemble_svs_with_interactions_tpu_torch.bin"
        ".data_prep_multitrack\n"
        "import ensemble_svs_with_interactions_tpu_torch.bin.prepare_features\n"
        "import ensemble_svs_with_interactions_tpu_torch.bin"
        ".prepare_features_multitrack\n"
        "import ensemble_svs_with_interactions_tpu_torch.bin"
        ".prepare_features_multitrack_sync\n"
        "import ensemble_svs_with_interactions_tpu_torch.bin.fit_scaler\n"
        "import ensemble_svs_with_interactions_tpu_torch.bin"
        ".preprocess_normalize\n"
        "import ensemble_svs_with_interactions_tpu_torch.bin.run_recipe\n"
        "import ensemble_svs_with_interactions_tpu_torch.bin"
        ".synthesis_multitrack\n"
        "import ensemble_svs_with_interactions_tpu_torch.bin.synthesis\n"
        "import ensemble_svs_with_interactions_tpu_torch.bin.evaluate_timing\n"
        "import ensemble_svs_with_interactions_tpu_torch.bin"
        ".evaluate_timing_multitrack\n"
        "import ensemble_svs_with_interactions_tpu_torch.bin"
        ".train_acoustic_multi\n"
        "import ensemble_svs_with_interactions_tpu_torch.bin.sweep\n"
        "import ensemble_svs_with_interactions_tpu_torch.frontend.musicxml\n"
        "import ensemble_svs_with_interactions_tpu_torch.frontend.ust\n"
        "import ensemble_svs_with_interactions_tpu_torch.frontend._inventory\n"
        "import ensemble_svs_with_interactions_tpu_torch.neutrino\n"
        "import ensemble_svs_with_interactions_tpu_torch.pretrained\n"
        "import ensemble_svs_with_interactions_tpu_torch.bin.neutrino\n"
        "import ensemble_svs_with_interactions_tpu_torch.bin.nsf\n"
        "import ensemble_svs_with_interactions_tpu_torch.bin"
        ".neutrino_server\n"
        "import ensemble_svs_with_interactions_tpu_torch.bin.run_svs\n"
        "import ensemble_svs_with_interactions_tpu_torch.ops.mlpg\n"
        "import ensemble_svs_with_interactions_tpu_torch.models\n"
        "import ensemble_svs_with_interactions_tpu_torch.utils.torch_port\n"
        "import ensemble_svs_with_interactions_tpu_torch.bin.enunu2nnsvs\n"
        "import ensemble_svs_with_interactions_tpu_torch.bin.generate\n"
        "import ensemble_svs_with_interactions_tpu_torch.bin.anasyn\n"
        "import ensemble_svs_with_interactions_tpu_torch.bin.sv56\n"
        "import ensemble_svs_with_interactions_tpu_torch.bin"
        ".pitch_augmentation\n"
        "import ensemble_svs_with_interactions_tpu_torch.bin"
        ".overwrite_phoneme_flags\n"
        "import ensemble_svs_with_interactions_tpu_torch.bin.opencpop2nnsvs\n"
        "import ensemble_svs_with_interactions_tpu_torch.bin.nnsvs2opencpop\n"
        "import ensemble_svs_with_interactions_tpu_torch.bin.nnsvs2usfgan\n"
        "import ensemble_svs_with_interactions_tpu_torch.bin.plot_metrics\n"
        "import ensemble_svs_with_interactions_tpu_torch.bin"
        ".visualize_vibrato\n"
        "import ensemble_svs_with_interactions_tpu_torch.bin.compare_parity\n"
        "import chip_smoke\n"
        "import bench_cuda\n"
        "import bench_train_cuda\n"
        "jp = 'ensemble_svs_with_interactions_tpu'\n"
        "bad = [m for m in sys.modules\n"
        "       if m in ('jax', 'flax', 'yaml', 'msgpack', jp)\n"
        "       or m.startswith(('jax.', 'flax.', 'yaml.', 'msgpack.',\n"
        "                        jp + '.'))]\n"
        "print(bad)\n"
        "assert not bad, bad\n"
        "assert 'ensemble_svs_with_interactions_tpu_torch' in sys.modules\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_port_question_set_is_the_jax_packages():
    """The port keeps its own copy of the bundled question set, byte-equal
    to the JAX package's."""
    from ensemble_svs_with_interactions_tpu.utils import (
        packaged_question_path as jax_question_path,
    )
    from ensemble_svs_with_interactions_tpu_torch.utils import (
        packaged_question_path,
    )

    port = Path(packaged_question_path())
    assert port.parent.parent.parent.name == (
        "ensemble_svs_with_interactions_tpu_torch")
    assert port.read_bytes() == Path(jax_question_path()).read_bytes()
    with pytest.raises(FileNotFoundError):
        packaged_question_path("no_such_set")
