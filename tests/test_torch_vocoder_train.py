"""The port's vocoder GAN step and trainer against the JAX package's on the
CPU, at tiny widths.

* One and then three GAN steps against the JAX step from the same weights
  and batches: hn-uSFGAN with the log-mel and residual source losses and a
  UnivNet multi-resolution multi-period discriminator, SiFiGAN with a
  HiFiGAN multi-scale multi-period discriminator and feature matching,
  PWG with its discriminator and the multi-resolution STFT loss; the
  metrics at 1e-4 relative, the weights after the steps at 1e-5.  Every
  family trains with the shipped Adam config, ``b1: 0.5, b2: 0.9``, which
  both packages read as (0.9, 0.999).  Two judges are wider, for float32
  conditioning that the port shares with JAX:
  - ``GradNorm_G`` at 1e-3: the residual source loss's gradient weighs
    each STFT bin of the source by 1 / |X|, so at these widths the
    generator's gradient norm moves by 2.6e-4 between the port in float32
    and the port in float64 on the same weights and batch;
  - Adam divides each gradient element by its own RMS, so an element whose
    gradient is float noise moves by up to lr either way: at most 1 in
    500 weights may differ by more than 1e-5 (2 of PWG's 1,194 do, one by
    4.0e-4, within the 2 lr x steps that bounds every weight).
* The adversarial gate (``discriminator_train_start_steps``) and a NaN
  batch leave the networks and their Adam state as they were.
* The crops and ``train_vocoder``'s batch stream bitwise the JAX
  trainer's (its probe batch first, a short utterance edge-padded).
* The CLI for 1 epoch of 3 steps: JAX's metric keys, a ``best_loss.ckpt``
  that the JAX package's ``load_checkpoint`` restores whole, and the
  stage-10 pack loaded by both packages' ``load_vocoder``.
* ``bin/prepare_voc_features.py`` writes the JAX CLI's files.
"""

import json

import jax
import numpy as np
import optax
import pytest
import torch

from ensemble_svs_with_interactions_tpu.bin import (
    prepare_voc_features as jax_prepare,
)
from ensemble_svs_with_interactions_tpu.models.vocoders import (
    cheaptrick as jct,
)
from ensemble_svs_with_interactions_tpu.svs import (
    load_vocoder as jax_load_vocoder,
)
from ensemble_svs_with_interactions_tpu.train import loop as jax_loop
from ensemble_svs_with_interactions_tpu.train import vocoder as jvoc
from ensemble_svs_with_interactions_tpu.train import (
    vocoder_trainer as jax_trainer,
)
from ensemble_svs_with_interactions_tpu.utils.config import (
    instantiate as jax_instantiate,
)
from ensemble_svs_with_interactions_tpu_torch.bin import (
    prepare_voc_features,
    train_vocoder as train_cli,
)
from ensemble_svs_with_interactions_tpu_torch.models.vocoders import (
    SignalGenerator,
    dilated_factor,
)
from ensemble_svs_with_interactions_tpu_torch.svs import load_vocoder
from ensemble_svs_with_interactions_tpu_torch.train import (
    vocoder as voc,
    vocoder_trainer as trainer,
)
from ensemble_svs_with_interactions_tpu_torch.train.loop import (
    build_optimizer,
)
from ensemble_svs_with_interactions_tpu_torch.utils import flax_msgpack
from ensemble_svs_with_interactions_tpu_torch.utils.config import (
    _wrap,
    instantiate,
    save_config,
)
from ensemble_svs_with_interactions_tpu_torch.utils.flax_port import (
    torch_to_flax,
)
from tests.test_torch_vocoders import _HN, GENERATORS, UP

VOC = "ensemble_svs_with_interactions_tpu.models.vocoders"
SR, FRAME_PERIOD, HOP = 4800, 1.25, UP   # hop 6 = the tiny upsampling
B, TF = 2, 64
T = TF * HOP
ADAM = {"name": "Adam", "params": {"lr": 2.0e-4, "b1": 0.5, "b2": 0.9}}  # shipped
METRIC_RTOL = 1e-4
GRADNORM_RTOL = 1e-3
PARAM_ATOL = 1e-5
PARAM_FAR_SHARE = 1 / 500
LR, STEPS = 2.0e-4, 3
_SPEC = {"fft_sizes": [64, 128], "hop_sizes": [16, 32],
         "win_lengths": [32, 64]}
_PERIOD = {"channels": 4, "max_downsample_channels": 16,
           "downsample_scales": [3, 3, 1]}
_MEL = {"_target_": "usfgan.losses.MelSpectralLoss", "fft_size": 64,
        "hop_size": 16, "win_length": 64, "sampling_rate": SR, "n_mels": 10,
        "fmin": 0, "fmax": None}
# family -> (model, train): the shipped configs' keys at tiny widths
FAMILIES = {
    "hn_usfgan": ({
        "signal_types": ["sine", "noise"],
        "generator": {"_target_": f"{VOC}.ParallelHnUSFGANGenerator", **_HN},
        "discriminator": {
            "_target_": f"{VOC}.UnivNetMultiResolutionMultiPeriodDiscriminator",
            **_SPEC, "periods": [2, 3],
            "spectral_discriminator_params": {"channels": 4},
            "period_discriminator_params": _PERIOD}}, {
        "lambda_stft": 45.0, "lambda_source": 1.0, "lambda_adv": 1.0,
        "lambda_feat_match": 0.0, "stft_loss": _MEL,
        "source_loss": {"sampling_rate": SR, "fft_size": 256,
                        "f0_floor": 70, "f0_ceil": 400, "n_mels": 10,
                        "fmin": 0, "fmax": None}}),
    "sifigan": ({
        "signal_types": ["sine"],
        "generator": {**GENERATORS["sifigan"][0], "channels": 16,
                      "resblock_kernel_sizes": [3],
                      "resblock_dilations": [[1, 2]]},
        "discriminator": {
            "_target_": f"{VOC}.HiFiGANMultiScaleMultiPeriodDiscriminator",
            "scales": 2, "periods": [2, 3],
            "scale_discriminator_params": {
                "channels": 8, "max_downsample_channels": 32,
                "max_groups": 4, "kernel_sizes": [5, 7, 3, 3],
                "downsample_scales": [2, 4, 1]},
            "period_discriminator_params": _PERIOD}}, {
        "lambda_stft": 45.0, "lambda_adv": 1.0, "lambda_feat_match": 2.0,
        "stft_loss": _MEL}),
    "pwg": ({
        "signal_types": ["noise"], "noise_amp": 1.0,
        "generator": GENERATORS["pwg"][0],
        "discriminator": {"_target_": f"{VOC}.PWGDiscriminator",
                          "layers": 4, "conv_channels": 6}}, {
        "lambda_stft": 1.0, "lambda_adv": 4.0, **_SPEC}),
}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Tiny tensors gain nothing from torch's threads, and the suite's
    other workers keep the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def config(family, in_dir="", out_dir="", **train):
    model, train_cfg = FAMILIES[family]
    return _wrap({
        "seed": 3, "verbose": 0,
        "data": {"train_no_dev": {"in_dir": str(in_dir)}, "sample_rate": SR,
                 "frame_period": FRAME_PERIOD, "stream_sizes": [2, 1, 1, 3],
                 "crop_frames": TF},
        "model": {"dense_factor": 4, "sine_amp": 0.1, "noise_amp": 0.003,
                  **model},
        "train": {"out_dir": str(out_dir), "nepochs": 1,
                  "steps_per_epoch": 3, "batch_size": B,
                  "optim": {"netG": {"optimizer": ADAM},
                            "netD": {"optimizer": ADAM}},
                  **train_cfg, **train}})


def batch(signal_types, seed, aux=2 + 3):
    """A seeded vocoder batch: a gliding F0 with unvoiced frames, its
    excitation and dilation factors, random features and audio."""
    rng = np.random.default_rng(seed)
    f0 = 150 + 100 * np.sin(np.arange(TF) / 7.0 + rng.uniform(0, 6, (B, 1)))
    f0 = f0 * (rng.uniform(size=(B, TF)) > 0.15)
    sg = SignalGenerator(SR, HOP, 0.1, 0.003, signal_types)
    return {
        "x": np.stack([sg(f, seed=seed + i) for i, f in enumerate(f0)]),
        "c": rng.standard_normal((B, TF, aux)).astype(np.float32),
        "d": np.stack([np.repeat(dilated_factor(f, SR, 4), HOP)
                       for f in f0]).astype(np.float32),
        "y": (0.3 * rng.standard_normal((B, T, 1))).astype(np.float32),
        "f0": f0.astype(np.float32)}


def port_step(cfg, seed=0):
    torch.manual_seed(seed)
    gen = trainer.build_generator(cfg)
    dis = instantiate(cfg.model.discriminator)
    return trainer.gan_step(cfg, gen, dis, "cpu"), gen, dis


def jax_step(cfg, gen, dis):
    """The JAX trainer's step (its config reading, ``train_vocoder:
    199-276``) on the port's weights, and its start state."""
    t = cfg.train
    jgen = jax_instantiate(cfg.model.generator)
    jdis = jax_instantiate(cfg.model.discriminator)
    optG = jax_loop.build_optimizer(dict(t.optim.netG.optimizer))
    optD = jax_loop.build_optimizer(dict(t.optim.netD.optimizer))
    src = dict(t.get("source_loss", {}) or {})
    layer = fb = None
    if float(t.get("lambda_source", 0.0)) > 0:
        layer = jct.CheapTrickLayer(SR, HOP, src["fft_size"],
                                    src["f0_floor"], src["f0_ceil"])
        from ensemble_svs_with_interactions_tpu.data.data_source import (
            mel_filterbank,
        )

        fb = np.asarray(mel_filterbank(SR, src["fft_size"], src["n_mels"],
                                       0, None), np.float32)
    mel = "stft_loss" in t
    step = jvoc.create_vocoder_gan_train_step(
        jgen, jdis, optG, optD, stft_weight=float(t.lambda_stft),
        adv_weight=float(t.lambda_adv),
        fm_weight=float(t.get("lambda_feat_match", 0.0)),
        fft_sizes=tuple(t.get("fft_sizes", [1024, 2048, 512])),
        hop_sizes=tuple(t.get("hop_sizes", [120, 240, 50])),
        win_lengths=tuple(t.get("win_lengths", [600, 1200, 240])),
        stft_loss_type="mel" if mel else "multi_resolution",
        mel_loss_params=dict(t.get("stft_loss", {}) or {}),
        source_weight=float(t.get("lambda_source", 0.0)),
        cheaptrick_layer=layer, source_mel_fb=fb)
    pG, pD = torch_to_flax(gen)["params"], torch_to_flax(dis)["params"]
    state = {"paramsG": pG, "paramsD": pD, "optG_state": optG.init(pG),
             "optD_state": optD.init(pD), "step": 0}
    return step, state


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def assert_params_close(module, jax_params):
    """Every weight within 2 lr x steps of JAX's, all but PARAM_FAR_SHARE
    of them within PARAM_ATOL."""
    got, ref = _leaves(torch_to_flax(module)["params"]), _leaves(jax_params)
    assert [p for p, _ in got] == [p for p, _ in ref]
    diff = np.concatenate([np.abs(g - np.asarray(r)).ravel()
                           for (_, g), (_, r) in zip(got, ref)])
    assert diff.max() <= 2 * LR * STEPS, diff.max()
    assert (diff > PARAM_ATOL).mean() <= PARAM_FAR_SHARE, np.sort(diff)[-5:]


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def three_steps(request):
    """Three steps of each family through both packages: (family, port
    metrics, JAX metrics, port G, port D, JAX state)."""
    cfg = config(request.param)
    step, gen, dis = port_step(cfg)
    jstep, state = jax_step(cfg, gen, dis)
    signals = cfg.model.signal_types
    got, ref = [], []
    for i in range(STEPS):
        b = batch(signals, seed=10 + i)
        got.append({k: float(v) for k, v in step(
            {k: torch.from_numpy(v) for k, v in b.items()}).items()})
        state, m = jstep(state, b)
        ref.append({k: float(v) for k, v in m.items()})
    return request.param, got, ref, gen, dis, state


def test_gan_steps_match_jax(three_steps):
    _, got, ref, gen, dis, state = three_steps
    for g, r in zip(got, ref):
        assert sorted(g) == sorted(r)
        for k in r:
            rtol = GRADNORM_RTOL if k == "GradNorm_G" else METRIC_RTOL
            np.testing.assert_allclose(g[k], r[k], rtol=rtol, atol=1e-7,
                                       err_msg=k)
    assert_params_close(gen, state["paramsG"])
    assert_params_close(dis, state["paramsD"])


def test_gan_step_metric_keys_are_jax(three_steps):
    family, got, ref, *_ = three_steps
    # jit returns its dict sorted; the port keeps the JAX source's order
    assert list(got[0]) == list(voc.METRIC_KEYS)
    assert sorted(got[0]) == sorted(ref[0])
    if family == "hn_usfgan":
        assert got[0]["Loss_Source"] > 0
        assert got[0]["Loss_STFT_SC"] == got[0]["Loss_STFT_Mag"]


def test_adam_reads_betas_as_jax_does():
    """``b1`` / ``b2`` (the shipped configs' keys) are not read: both
    packages build Adam with (0.9, 0.999)."""
    p = torch.nn.Parameter(torch.ones(3))
    opt, _ = build_optimizer([p], ADAM)
    assert opt.param_groups[0]["betas"] == (0.9, 0.999)
    jopt = jax_loop.build_optimizer(ADAM)
    jp = jax.numpy.ones(3)
    js = jopt.init(jp)
    for g in ([1.0, -2.0, 0.5], [0.3, 0.1, -4.0]):
        p.grad = torch.tensor(g)
        opt.step()
        u, js = jopt.update(jax.numpy.asarray(g), js, jp)
        jp = optax.apply_updates(jp, u)
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp),
                               rtol=0, atol=1e-7)


def _snapshot(module, opt):
    return ([t.detach().clone() for t in module.parameters()],
            {id(p): {k: v.clone() for k, v in s.items()}
             for p, s in opt.state.items()})


def _same(a, b):
    params_a, state_a = a
    params_b, state_b = b
    return (all(torch.equal(x, y) for x, y in zip(params_a, params_b))
            and state_a.keys() == state_b.keys()
            and all(torch.equal(state_a[k][n], state_b[k][n])
                    for k in state_a for n in state_a[k]))


def test_discriminator_waits_for_its_start_step():
    cfg = config("pwg", discriminator_train_start_steps=2)
    step, gen, dis = port_step(cfg)
    optD = step.optimizers[1]
    start = _snapshot(dis, optD)
    for i in range(3):
        m = step({k: torch.from_numpy(v)
                  for k, v in batch(["noise"], seed=i).items()})
        assert (float(m["Loss_Adv"]) == 0.0) == (i < 2)
        assert _same(start, _snapshot(dis, optD)) == (i < 2)


def test_nan_batch_leaves_both_networks():
    cfg = config("pwg")
    step, gen, dis = port_step(cfg)
    optG, optD = step.optimizers
    step({k: torch.from_numpy(v) for k, v in batch(["noise"], 0).items()})
    before = [_snapshot(gen, optG), _snapshot(dis, optD)]
    bad = batch(["noise"], 1)
    bad["y"][0, 5, 0] = np.nan
    m = step({k: torch.from_numpy(v) for k, v in bad.items()})
    assert not np.isfinite(float(m["GradNorm_G"]))
    assert not np.isfinite(float(m["GradNorm_D"]))
    assert _same(before[0], _snapshot(gen, optG))
    assert _same(before[1], _snapshot(dis, optD))
    assert step.state["step"] == 2


def write_corpus(root, n=3, short=40, frames=200, seed=0):
    """Feature and waveform dumps (mgc 2, lf0, vuv, bap 3) of gliding
    sines, as the JAX package's vocoder CLI test writes them; the first
    utterance is shorter than a crop."""
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        Tf = short if i == 0 else frames
        feats = (rng.normal(size=(Tf, 7)) * 0.1).astype(np.float32)
        lf0 = np.log(200 + 20 * np.sin(np.arange(Tf) / 10 + i))
        feats[:, 2] = lf0
        feats[:, 3] = (rng.uniform(size=Tf) > 0.1).astype(np.float32)
        phase = 2 * np.pi * np.cumsum(np.repeat(np.exp(lf0), HOP)) / SR
        np.save(root / f"u{i}-feats.npy", feats)
        np.save(root / f"u{i}-wave.npy",
                (0.3 * np.sin(phase)).astype(np.float32))
    return root


def test_crops_are_bitwise_jax(tmp_path):
    """Both packages' crops from one seed: the probe batch, then full
    batches, one item of which is a short, edge-padded utterance."""
    cfg = config("hn_usfgan", write_corpus(tmp_path / "in"))
    port = trainer.vocoder_crops(cfg)
    sr, hop, lf0, vuv, aux = trainer.stream_layout(cfg)
    ref = jax_trainer._VocoderCrops(
        cfg.data.train_no_dev.in_dir, sr, hop, TF, lf0, vuv, aux,
        signal_types=("sine", "noise"))
    rngs = [np.random.default_rng(3), np.random.default_rng(3)]
    padded = False
    for n in (1, 4, 4, 4):
        got, want = port.batch(rngs[0], n), ref.batch(rngs[1], n)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        padded |= bool((got["y"][:, -HOP:] == 0).all(axis=(1, 2)).any())
    assert padded


def test_train_vocoder_batch_stream_is_jax(tmp_path, monkeypatch):
    """``train_vocoder``'s batches are what the JAX trainer draws: a probe
    of 1 from ``default_rng(seed)``, then ``batch_size`` a step."""
    cfg = config("pwg", write_corpus(tmp_path / "in"), tmp_path / "exp",
                 nepochs=2, steps_per_epoch=2)
    seen = []
    draw = trainer._VocoderCrops.batch

    def record(self, rng, n):
        out = draw(self, rng, n)
        seen.append(out)
        return out

    monkeypatch.setattr(trainer._VocoderCrops, "batch", record)
    trainer.train_vocoder(cfg, device="cpu")
    sr, hop, lf0, vuv, aux = trainer.stream_layout(cfg)
    ref = jax_trainer._VocoderCrops(
        cfg.data.train_no_dev.in_dir, sr, hop, TF, lf0, vuv, aux,
        signal_types=("noise",), noise_amp=1.0)
    rng = np.random.default_rng(int(cfg.seed))
    want = [ref.batch(rng, n) for n in (1, B, B, B, B)]
    assert len(seen) == len(want)
    for got, w in zip(seen, want):
        for k in w:
            np.testing.assert_array_equal(got[k], w[k], err_msg=k)


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """``bin/train_vocoder.py`` on the tiny hn-uSFGAN for 1 epoch of 3
    steps, then the stage-10 pack."""
    root = tmp_path_factory.mktemp("voc")
    cfg = config("hn_usfgan", write_corpus(root / "in"), root / "exp")
    save_config(cfg, root / "config.yaml")
    assert train_cli.main([str(root / "config.yaml"), "device=cpu"]) == 0
    trainer.pack_vocoder(cfg, root / "exp", root / "packed")
    return cfg, root


def test_cli_writes_jax_metrics_and_checkpoints(cli_run):
    cfg, root = cli_run
    lines = [json.loads(s) for s in
             (root / "exp" / "metrics.jsonl").read_text().splitlines()]
    assert len(lines) == 1 and lines[0]["step"] == 1
    assert sorted(lines[0]) == sorted(
        ["step"] + [f"train_no_dev/{k}" for k in voc.METRIC_KEYS])
    assert all(np.isfinite(v) for v in lines[0].values())
    for name in ("latest.ckpt", "best_loss.ckpt"):
        assert (root / "exp" / name).exists()


def test_best_checkpoint_restores_in_jax(cli_run):
    """The JAX package's ``load_checkpoint`` restores ``best_loss.ckpt``
    whole (flax ``msgpack_restore`` + ``from_state_dict``) against its own
    generator's ``TrainState``; the params are the port's."""
    cfg, root = cli_run
    jgen = jax_instantiate(cfg.model.generator)
    b = batch(["sine", "noise"], 0)
    params = jax.eval_shape(lambda k: jgen.init(k, b["x"], b["c"], b["d"]),
                            jax.random.PRNGKey(0))["params"]
    opt = jax_loop.build_optimizer(ADAM)
    state = jax_loop.load_checkpoint(
        root / "exp" / "best_loss.ckpt",
        jax_loop.TrainState(params, {}, opt.init(params), 0))
    assert int(state.step) == 3
    assert int(state.opt_state[0].count) == 3
    mine = flax_msgpack.from_bytes(
        (root / "exp" / "best_loss.ckpt").read_bytes())
    for (p, g), (_, r) in zip(_leaves(mine["params"]),
                              _leaves(state.params)):
        np.testing.assert_array_equal(g, np.asarray(r), err_msg=str(p))
    # skip convs get no gradient: their Adam moments stay zero
    mu = state.opt_state[0].mu["harmonic_network"]["adaptive0"]["Conv_1"]
    assert not np.asarray(mu["kernel"]).any()


def test_packed_vocoder_loads_in_both_engines(cli_run):
    cfg, root = cli_run
    rng = np.random.default_rng(0)
    f0 = (180 + 40 * np.sin(np.arange(50) / 6.0))[:, None]
    f0[::9] = 0
    aux = rng.standard_normal((50, 5)).astype(np.float32)
    voc, _, kind = load_vocoder(root / "packed", SR, FRAME_PERIOD,
                                device="cpu")
    jvoc_, _, jkind = jax_load_vocoder(root / "packed", SR, FRAME_PERIOD)
    assert kind == jkind == "usfgan"
    got, ref = voc.inference(f0, aux), jvoc_.inference(f0, aux)
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())


def test_prepare_voc_features_writes_jax_files(tmp_path):
    rng = np.random.default_rng(0)
    dump = tmp_path / "dump"
    dump.mkdir()
    for i in range(2):
        np.save(dump / f"u{i}-feats.npy",
                rng.standard_normal((30, 15 + 3 + 1 + 9)))
        np.save(dump / f"u{i}-wave.npy",
                rng.standard_normal(30 * HOP).astype(np.float32))
    args = ["--stream-sizes", "15,3,1,9", "--num-windows", "3",
            "--has-dynamic-features", "1,1,0,1"]
    prepare_voc_features.main([str(dump), str(tmp_path / "port"), *args])
    jax_prepare.main([str(dump), str(tmp_path / "jax"), *args])
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert len(names) == 4
    for name in names:
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes()), name


def test_train_vocoder_refuses_more_than_one_process(tmp_path):
    """Two processes at a coordinator without this process's rank: refused
    before the trainer joins a group."""
    cfg = config("pwg", write_corpus(tmp_path / "in"), tmp_path / "exp")
    cfg["distributed"] = {"coordinator": "127.0.0.1:1", "num_processes": 2}
    with pytest.raises(ValueError, match="process_id"):
        trainer.train_vocoder(cfg, device="cpu")
