"""The port's two benches on the CPU at tiny widths: each prints one JSON
line with its keys.  Their numbers mean something only on the card
(``python3 bench_cuda.py``, ``python3 bench_train_cuda.py``); here the
line says the device was the CPU and carries no device metric."""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import bench  # noqa: E402
import bench_cuda  # noqa: E402
import bench_train_cuda  # noqa: E402
import chip_smoke  # noqa: E402


def _one_json_line(script, *args):
    """The bench run as a command: ``python <script> --device cpu --tiny
    ...`` prints one JSON line."""
    # two threads: tiny widths gain nothing from more, and the suite's
    # other workers keep the cores
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    r = subprocess.run([sys.executable, script, "--device", "cpu", "--tiny",
                        *args],
                       cwd=REPO, capture_output=True, text=True, timeout=600,
                       env=env)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    lines = r.stdout.strip().splitlines()
    assert len(lines) == 1, lines
    return json.loads(lines[0])


@pytest.fixture
def run_main(capsys):
    """The bench's ``main(["--device", "cpu", "--tiny", ...])`` in this
    process (two torch threads, as the command's): it returns 0 and
    prints one JSON line, which this returns parsed.  The command's own
    entry is held by ``test_bench_cuda_tiny_prints_one_json_line``."""
    def run(module, *args):
        n = torch.get_num_threads()
        torch.set_num_threads(2)
        try:
            capsys.readouterr()
            assert module.main(["--device", "cpu", "--tiny", *args]) == 0
        finally:
            torch.set_num_threads(n)
        lines = capsys.readouterr().out.strip().splitlines()
        assert len(lines) == 1, lines
        return json.loads(lines[0])

    return run


def _refused(capsys, *args):
    """``bench_cuda.main``'s exit code for arguments its parser refuses
    (in this process: the parser stops before any model is built)."""
    capsys.readouterr()
    with pytest.raises(SystemExit) as stop:
        bench_cuda.main(["--device", "cpu", *args])
    return stop.value.code


def test_bench_cuda_tiny_prints_one_json_line():
    out = _one_json_line("bench_cuda.py")
    assert out["metric"] == "rtf_4part_flagship_multitrack_48k"
    assert out["unit"] == "ratio" and out["value"] > 0
    assert len(out["all_runs_sec"]) == out["calls"] == bench_cuda.TINY_CALLS
    assert out["audio_seconds"] > 3
    assert out["value"] == sorted(out["all_runs_sec"])[
        len(out["all_runs_sec"]) // 2] / out["audio_seconds"]
    assert set(out["stages_sec"]) >= {
        "timing_feats", "acoustic_dispatch", "postproc_dispatch", "vocoder",
        "timing_models", "frame_feats", "vocoder_device", "vocoder_d2h"}
    assert {"acoustic_blocked", "postproc_blocked"} <= set(
        out["stages_blocked_sec"])
    assert out["weights_on_device_before_first_call"] is True
    assert out["pack_sec"] > 0 and out["load_sec"] > 0
    assert out["tracks"] == 4 and len(out["wav_lengths"]) == 4
    # on the CPU: no kernel launched and no device metric
    assert out["device"] == "cpu" and out["card"] is None
    assert out["lstm_launches_per_call"] == 0
    assert out["lstm_kernel_by_hidden"] is None
    assert out["peak_mem_gib"] is None


def test_bench_cuda_diffusion_tiny_prints_one_json_line(run_main):
    """``--acoustic diffusion``: the recipe's diffusion voice renders the
    same ring (speakers below its 3) under its own metric."""
    out = run_main(bench_cuda, "--acoustic", "diffusion")
    assert out["metric"] == "rtf_4part_diffusion_multitrack_48k"
    assert out["acoustic"] == "diffusion"
    assert out["spk_ids"] == chip_smoke.DIFFUSION_SPK_IDS
    assert max(out["spk_ids"]) < chip_smoke.DIFFUSION_SPKS
    assert out["unit"] == "ratio" and out["value"] > 0
    assert len(out["all_runs_sec"]) == out["calls"] == bench_cuda.TINY_CALLS
    assert out["audio_seconds"] > 3 and len(out["wav_lengths"]) == 4
    assert {"acoustic_blocked", "postproc_blocked"} <= set(
        out["stages_blocked_sec"])
    assert out["device"] == "cpu" and out["card"] is None
    assert out["lstm_launches_per_call"] == 0 and out["peak_mem_gib"] is None


def test_bench_cuda_usfgan_tiny_prints_one_json_line(run_main, capsys):
    """``--vocoder usfgan``: the flagship's ring with the recipe's neural
    vocoder packed beside it, under its own metric, with the generator's
    bound over the call's tracks (no device time on the CPU)."""
    out = run_main(bench_cuda, "--vocoder", "usfgan")
    assert out["metric"] == "rtf_4part_flagship_usfgan_48k"
    assert out["vocoder"] == "usfgan" and out["acoustic"] == "flagship"
    assert out["unit"] == "ratio" and out["value"] > 0
    assert len(out["all_runs_sec"]) == out["calls"] == bench_cuda.TINY_CALLS
    assert out["audio_seconds"] > 3 and len(out["wav_lengths"]) == 4
    assert out["stages_sec"]["vocoder"] > 0
    vb = out["vocoder_bound"]
    assert vb["bound_by"] == "operations" and vb["bound_ms"] > 0
    assert math.isclose(vb["tflop"] * 1e12, vb["mflop_per_sample"] * 1e6
                        * sum(out["wav_lengths"]), rel_tol=1e-9)
    assert out["device"] == "cpu" and out["card"] is None
    assert out["vocoder_ms_all"] is None and out["peak_mem_gib"] is None
    assert _refused(capsys, "--vocoder", "usfgan", "--acoustic",
                    "diffusion") == 2
    assert "--vocoder" in capsys.readouterr().err


def test_vocoder_is_the_shipped_generator():
    """``chip_smoke.vocoder_phase`` packs the JAX package's shipped
    hn-uSFGAN generator and its excitation settings verbatim, with a
    StandardScaler in-scaler over the 65 aux dims; ``tiny`` keeps the
    class, the aux layout and the 240x upsampling."""
    import yaml

    shipped = yaml.safe_load((chip_smoke.CONFIGS / chip_smoke.VOCODER_CONFIG)
                             .read_text())["model"]
    cfg, in_scaler, out_scaler = chip_smoke.vocoder_phase()
    assert cfg["netG"] == shipped["generator"]
    for k in ("signal_types", "dense_factor", "sine_amp", "noise_amp"):
        assert cfg[k] == shipped[k]
    assert out_scaler is None and in_scaler.mean_.shape == (65,)
    assert (in_scaler.scale_ > 0).all()
    tiny = chip_smoke.vocoder_phase(tiny=True)[0]["netG"]
    for k in ("_target_", "aux_channels", "upsample_params"):
        assert tiny[k] == shipped["generator"][k]


def test_diffusion_voice_is_the_shipped_config():
    """``chip_smoke.diffusion_acoustic_config`` is the shipped
    ``multitrack_acoustic_npss_diff_mgcbap.yaml`` (and its ``_subtrack``
    twin) with only the lf0 fields the recipe fills from data set;
    ``tiny`` keeps the classes, the stream layout and the 3 speakers."""
    import yaml

    root = chip_smoke.CONFIGS
    for subtrack in (False, True):
        rel = chip_smoke.DIFFUSION_CONFIG
        if subtrack:
            rel = rel.replace(".yaml", "_subtrack.yaml")
        shipped = yaml.safe_load((root / rel).read_text())
        for node in (shipped["netG"], shipped["netG"]["lf0_model"]):
            for k, v in chip_smoke.SINGLE_LF0.items():
                assert node[k] is None
                node[k] = v
        got = chip_smoke.diffusion_acoustic_config(subtrack=subtrack)
        assert got == shipped
    tiny = chip_smoke.diffusion_acoustic_config(tiny=True, k_step=3)
    net = tiny["netG"]
    assert net["speaker_embedding"]["num_embeddings"] == 3
    assert tiny["stream_sizes"] == got["stream_sizes"] == [60, 1, 1, 5]
    assert net["mgc_model"]["K_step"] == net["bap_model"]["K_step"] == 3
    for k in ("lf0_model", "mgc_model", "bap_model", "vuv_model"):
        assert net[k]["_target_"] == got["netG"][k]["_target_"]


def test_bench_cuda_single_track_tiny_prints_one_json_line(run_main):
    """``--single-track``: the stock single-track voice through
    ``SPSVS.svs``, its median RTF and stage times."""
    out = run_main(bench_cuda, "--single-track")
    assert out["metric"] == "rtf_single_track_48k"
    assert out["unit"] == "ratio" and out["value"] > 0
    assert len(out["all_runs_sec"]) == out["calls"] == bench_cuda.TINY_CALLS
    assert out["audio_seconds"] > 3
    assert out["value"] == sorted(out["all_runs_sec"])[
        len(out["all_runs_sec"]) // 2] / out["audio_seconds"]
    assert set(out["stages_sec"]) == {
        "timing", "acoustic", "postprocess_acoustic", "vocoder",
        "postprocess_waveform"}
    assert out["pack_sec"] > 0 and out["load_sec"] > 0
    assert out["dtype"] == "int16"
    assert out["device"] == "cpu" and out["card"] is None
    assert out["lstm_launches_per_call"] == 0
    assert out["lstm_launches_by_hidden"] == {}
    assert out["lstm_kernel_by_hidden"] is None
    assert out["peak_mem_gib"] is None


def test_bench_cuda_single_track_postfilter_tiny_prints_one_json_line(
        run_main, capsys):
    """``--single-track --post-filter nnsvs``: the voice packed with the
    merged learned postfilter renders through ``svs(post_filter_type=
    "nnsvs")``; the same 7-call median RTF under its own metric."""
    out = run_main(bench_cuda, "--single-track", "--post-filter", "nnsvs")
    assert out["metric"] == "rtf_single_track_nnsvs_48k"
    assert out["post_filter_type"] == "nnsvs" and out["postfilter_packed"]
    assert out["unit"] == "ratio" and out["value"] > 0
    assert len(out["all_runs_sec"]) == out["calls"] == bench_cuda.TINY_CALLS
    assert out["stages_sec"]["postprocess_acoustic"] > 0
    assert out["device"] == "cpu" and out["card"] is None
    assert out["peak_mem_gib"] is None
    assert _refused(capsys, "--post-filter", "nnsvs") == 2
    assert "--single-track" in capsys.readouterr().err


def test_postfilter_is_the_shipped_stream_filters():
    """``chip_smoke.postfilter_config`` merges the JAX package's shipped
    mgc and bap postfilters as ``bin/merge_postfilters.py`` does; ``tiny``
    narrows the channels only."""
    import yaml

    cfg = chip_smoke.postfilter_config()
    net = cfg["netG"]
    root = chip_smoke.CONFIGS / "postfilter"
    mgc = yaml.safe_load((root / "postfilter_mgc.yaml").read_text())
    bap = yaml.safe_load((root / "postfilter_bap.yaml").read_text())
    assert net["mgc_postfilter"] == mgc["netG"]["mgc_postfilter"]
    assert net["bap_postfilter"] == bap["netG"]["bap_postfilter"]
    assert net["lf0_postfilter"] is None
    assert net["stream_sizes"] == cfg["stream_sizes"] == [60, 1, 1, 5]
    assert net["_target_"].endswith("postfilters.MultistreamPostFilter")
    tiny = chip_smoke.postfilter_config(tiny=True)["netG"]
    assert tiny["mgc_postfilter"] == {**net["mgc_postfilter"], "channels": 4}
    assert tiny["bap_postfilter"] == {**net["bap_postfilter"], "channels": 4}


def test_single_track_voice_is_the_shipped_config():
    """``chip_smoke.single_phases`` is the JAX package's shipped
    single-track configs with only the lf0 fields the recipe fills from
    data set, and ``tiny=True`` keeps their classes and stream layout."""
    import yaml

    cfg_dir = REPO / "ensemble_svs_with_interactions_tpu" / "configs"
    _, phases = chip_smoke.single_phases()
    _, tiny = chip_smoke.single_phases(tiny=True)
    for phase, rel in (("acoustic", "acoustic/acoustic_multistream_ar_f0"),
                       ("timelag", "timelag/timelag_vp_mdn"),
                       ("duration", "duration/duration_vp_mdn")):
        shipped = yaml.safe_load((cfg_dir / f"{rel}.yaml").read_text())
        got = phases[phase][0]
        if phase == "acoustic":
            for node in (shipped["netG"], shipped["netG"]["lf0_model"]):
                for k, v in chip_smoke.SINGLE_LF0.items():
                    assert node[k] is None
                    node[k] = v
        assert got == shipped

        def targets(node):
            if isinstance(node, dict):
                return [node.get("_target_")] + [
                    t for v in node.values() for t in targets(v)]
            return []

        assert targets(tiny[phase][0]) == targets(got)
        assert tiny[phase][0]["stream_sizes"] == got["stream_sizes"]


def test_bench_train_cuda_tiny_prints_one_json_line(run_main):
    out = run_main(bench_train_cuda)
    assert out["metric"] == "train_frames_per_sec_flagship_multitrack"
    B, T = bench_train_cuda.TINY_B, bench_train_cuda.TINY_T
    assert out["geometry"] == f"{B}x{T}"
    assert len(out["all_step_sec"]) == out["steps"] == 5
    assert out["frames_per_sec"] == out["value"] == B * T / out[
        "median_step_sec"]
    assert set(out["split_sec"]) == {"forward", "backward", "optimizer"}
    assert out["flops_per_step"] == (out["flops_torch_ops"]
                                     + out["flops_lstm_kernels"])
    assert out["flops_torch_ops"] > 0 and out["flops_lstm_kernels"] > 0
    assert "FlopCounterMode" in out["flops_convention"]
    assert "67e12" in out["mfu_convention"]
    assert out["peak_flop_per_s"] == 67e12
    assert "float32" in out["peak_convention"]
    assert all(isinstance(x, float) for x in out["losses"])
    assert out["use_amp"] is False
    assert out["device"] == "cpu" and out["card"] is None
    assert out["mfu"] is None and out["tflops_per_sec"] is None
    assert out["peak_mem_gib"] is None


def test_bench_train_cuda_amp_raises(run_main):
    """``--tiny --amp --device cpu``: the bf16 AMP arm prints one JSON line
    with ``use_amp`` true, its MFU over the named bf16 peak (None on the
    CPU) and finite losses."""
    out = run_main(bench_train_cuda, "--amp")
    assert out["metric"] == "train_frames_per_sec_flagship_multitrack"
    assert out["use_amp"] is True
    assert len(out["all_step_sec"]) == out["steps"] == 5
    assert out["frames_per_sec"] == out["value"] > 0
    assert out["flops_per_step"] == (out["flops_torch_ops"]
                                     + out["flops_lstm_kernels"])
    assert out["peak_flop_per_s"] == 989e12
    assert "bf16" in out["peak_convention"]
    assert "989e12" in out["mfu_convention"]
    assert all(isinstance(x, float) and math.isfinite(x)
               for x in out["losses"])
    assert out["device"] == "cpu" and out["mfu"] is None


def test_bench_train_cuda_trainer_tiny_prints_one_json_line(run_main):
    """``--trainer --tiny --device cpu``: the recipe's acoustic phase
    through the trainer on a small corpus prints one JSON line with the
    trainer's frames/s over its wall time, the steps' share, each epoch's
    dev loss, the files it wrote and the bare AMP step beside it."""
    out = run_main(bench_train_cuda, "--trainer")
    assert out["metric"] == "trainer_frames_per_sec_flagship_multitrack"
    assert out["value"] == out["frames_per_s"] == (out["train_frames"]
                                                   / out["wall_s"])
    # 2 segments x 6 pairs, crops of 32 frames, 4 a batch: 3 steps an epoch
    assert out["steps"] == 3 * out["epochs"]
    assert out["train_frames"] == 12 * 32 * out["epochs"]
    assert 0 < out["train_steps_s"] + out["dev_steps_s"] < out["wall_s"]
    assert len(out["dev_loss"]) == out["epochs"]
    assert all(math.isfinite(x) for x in out["dev_loss"])
    assert {"latest.ckpt", "best_loss.ckpt", "metrics.jsonl",
            "dev_metrics.json"} <= set(out["files"])
    assert out["use_amp"] is True
    assert out["bare_step"]["frames_per_s"] > 0
    assert out["device"] == "cpu" and out["peak_mem_gib"] is None


def test_benches_need_a_card_unless_the_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for bench_main in (bench_cuda.main, bench_train_cuda.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench_main(["--tiny"])


def test_the_flagship_is_bench_py_s():
    """The benches' flagship (``chip_smoke.flagship_acoustic_config``) is
    ``bench.py``'s at its widths, and ``tiny=True`` keeps its classes and
    stream layout."""
    assert chip_smoke.flagship_acoustic_config(4) == \
        bench.flagship_acoustic_config(4)
    full, ss = chip_smoke.flagship_acoustic_config(4)
    tiny, ss_tiny = chip_smoke.flagship_acoustic_config(4, tiny=True)
    assert ss == ss_tiny == [60, 1, 1, 5]

    def targets(node):
        if isinstance(node, dict):
            return [node.get("_target_")] + [
                t for v in node.values() for t in targets(v)]
        return []

    assert targets(full) == targets(tiny)


def test_train_lstm_shapes_give_the_launch_table():
    """The LSTM runs a flagship train step makes, by (H, T), are the table
    ``chip_smoke.py`` checks the card's launch counts against, and the
    kernels' operation count follows from it."""
    ac, _ = chip_smoke.flagship_acoustic_config(4)
    shapes = chip_smoke.train_lstm_shapes(ac["netG"], chip_smoke.TRAIN_T)
    assert shapes == chip_smoke.TRAIN_LAUNCHES_BY_SHAPE
    B = chip_smoke.TRAIN_B
    H, T = 512, 256
    one = (2 * B * (T - 1) * H * 4 * H + 12 * B * T * H    # forward
           + 2 * B * (T - 1) * H * 4 * H + B * T * 4 * H   # pre-pass
           + 2 * B * (T - 1) * 4 * H * H + 30 * B * T * H  # loop
           + 2 * B * (T - 1) * H * 4 * H)                  # dW_h
    assert chip_smoke.lstm_kernel_flops({(H, T): 1}, B) == one


def test_bench_train_cuda_vocoder_tiny_prints_one_json_line(run_main):
    """``--vocoder --tiny --device cpu``: the tiny hn-uSFGAN GAN step
    prints one JSON line with its samples/s over the median step, the
    step's operation bound and finite metrics; no device metric."""
    out = run_main(bench_train_cuda, "--vocoder")
    assert out["metric"] == "vocoder_train_samples_per_sec"
    assert out["unit"] == "samples/s"
    assert len(out["step_ms"]) == 2
    assert out["value"] == out["samples_per_sec"] == out[
        "samples_per_step"] / (out["median_step_ms"] / 1e3)
    assert out["samples_per_step"] == (chip_smoke.VOCODER_REF_B
                                       * chip_smoke.VOCODER_REF_FRAMES * 240)
    vb = out["vocoder_train_bound"]
    assert vb["tflop"] > 0 and vb["bound_by"] == "operations"
    assert out["finite"] and set(out["metrics"]) >= {
        "Loss_G", "Loss_Source", "Loss_D", "GradNorm_G", "GradNorm_D"}
    assert out["device"] == "cpu" and out["card"] is None
    assert out["peak_mem_gib"] is None and out["device_busy_share"] is None


def test_vocoder_training_is_the_shipped_config(tmp_path):
    """The full-width vocoder training config is the JAX package's
    ``configs/vocoder/vocoder_parallel_hn_usfgan.yaml`` with its corpus and
    output set; the tiny families keep the shipped train sections."""
    import yaml

    shipped = yaml.safe_load(
        (chip_smoke.CONFIGS / chip_smoke.VOCODER_CONFIG).read_text())
    cfg = chip_smoke.vocoder_train_config(tmp_path / "in", tmp_path / "exp")
    assert cfg["model"] == shipped["model"]
    assert cfg["train"] == {**shipped["train"], "out_dir": str(
        tmp_path / "exp")}
    assert cfg["data"] == {**shipped["data"],
                           "train_no_dev": {"in_dir": str(tmp_path / "in")}}
    tiny = chip_smoke.tiny_vocoder_trainings(tmp_path / "in",
                                             tmp_path / "exp")
    for family, rel in (("hn_usfgan", chip_smoke.VOCODER_CONFIG),
                        ("sifigan", chip_smoke.VOCODER_SIFIGAN_CONFIG),
                        ("pwg", chip_smoke.VOCODER_PWG_CONFIG)):
        train = yaml.safe_load((chip_smoke.CONFIGS / rel).read_text())[
            "train"]
        got = dict(tiny[family]["train"])
        for k in ("out_dir", "batch_size", "discriminator_train_start_steps"):
            got.pop(k, None)
            train.pop(k, None)
        assert got == train, family
        assert (tiny[family]["model"]["discriminator"]["_target_"]
                == yaml.safe_load((chip_smoke.CONFIGS / rel).read_text())[
                    "model"]["discriminator"]["_target_"])
