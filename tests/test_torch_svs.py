"""The port's flagship slice, ``SPSVS.svs_ensemble``, against the JAX
engine built from the same configs, weights and scalers, at tiny dims on
a shortened fixture (4 tracks, pairwise ring).

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

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

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
from ensemble_svs_with_interactions_tpu_torch.utils.config import instantiate
from ensemble_svs_with_interactions_tpu_torch.utils.flax_port import (
    flax_to_torch,
)
from ensemble_svs_with_interactions_tpu_torch.utils.scalers import (
    MinMaxScaler,
    StandardScaler,
)
from tests.util import HED, NIT_LAB

SR = 24000
N_SPK = 4
ATOL = 1e-4
PKG = "ensemble_svs_with_interactions_tpu.models"
REPO = Path(__file__).resolve().parent.parent


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


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """(JAX engine, port engine) from one set of configs, flax variables
    (carried into the port's state dicts by flax_to_torch) and scalers."""
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
    variables = jax.tree_util.tree_map(np.asarray, variables)
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

    def phases(minmax, standard, weights):
        return {
            ph: {"model_config": cfgs[ph], **weights(ph),
                 "in_scaler": minmax(np.zeros(d), np.ones(d)),
                 "out_scaler": standard(m, s ** 2, s)}
            for ph, (d, m, s) in stats.items()
        }

    def state_dict(ph):
        module = instantiate(cfgs[ph]["netG"])
        return {"state_dict": flax_to_torch(module, variables[ph]).state_dict()}

    model_dir = tmp_path_factory.mktemp("packed_mt4")
    pack_model(model_dir, glob, HED, phases(
        JaxMinMax, JaxStandard, lambda ph: {"variables": variables[ph]}))
    return (JaxSPSVS(model_dir),
            SPSVS(glob, HED, phases(MinMaxScaler, StandardScaler, state_dict),
                  device="cpu"))


def _short_labels(mod, seconds=4.0):
    labels = mod.load(NIT_LAB)
    n = next(i for i, e in enumerate(labels.end_times) if e > seconds * 1e7)
    return labels[: max(n, 10)]


def test_svs_ensemble_slice_matches_jax(engines):
    jax_engine, engine = engines
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
    """The port, and chip_smoke.py's own imports, leave JAX, flax and the
    JAX package out of the process.  The port's name starts with the JAX
    package's, so the check is on exact names and the ``pkg.`` prefix."""
    code = (
        "import sys\n"
        "import ensemble_svs_with_interactions_tpu_torch.svs\n"
        "import ensemble_svs_with_interactions_tpu_torch.ops.lstm_recurrence\n"
        "import chip_smoke\n"
        "jp = 'ensemble_svs_with_interactions_tpu'\n"
        "bad = [m for m in sys.modules if m in ('jax', 'flax', jp)\n"
        "       or m.startswith(('jax.', 'flax.', jp + '.'))]\n"
        "print(bad)\n"
        "assert not bad, bad\n"
        "assert 'ensemble_svs_with_interactions_tpu_torch' in sys.modules\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
