"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper).

    python3 chip_smoke.py

Drives the port's main path, the flagship 4-part pairwise ensemble
through ``SPSVS.svs_ensemble`` at the verbatim widths of ``bench.py``
(random weights from a seeded generator), and holds every hand-written
kernel of that path against its plain PyTorch version on the card.
Phases, each printing JSON lines:

1. the card (``nvidia-smi`` name and power limit) and the kernel build;
2. the LSTM recurrence kernel against its plain version at the path's
   shapes (B = 4, T = 6656, H = 62, 64, 256, 512), with and without the
   cell-sequence output, with times, the bound and a library yardstick;
3. the slice: engine build, a warm-up, then three timed ``svs_ensemble``
   calls on 4 copies of the 31.2 s fixture with the launch count reset
   just before and read just after;
4. the same modules on the CPU (plain recurrence) against the card on a
   shortened input, and the AR lf0 decoder against a float64 oracle;
5. a ``kernels`` line, the card line, and last ``{"ok": true, ...}``.

Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.  Imports nothing of JAX or the JAX package.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
FIXTURE = REPO / "tests" / "data" / "nit_song070" / "nitech_jp_song070_f001_004.lab"
QST = (REPO / "ensemble_svs_with_interactions_tpu" / "recipes" / "_common"
       / "hed" / "jp_dev_latest.hed")
PKG = "ensemble_svs_with_interactions_tpu"
SEED = 0

# card peaks for the bound (NVIDIA H100 SXM data sheet, dense)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12

KERNEL_ATOL = 1e-4   # float32 kernel vs plain loop, other summation order
MODULE_ATOL = 1e-3   # full-width modules, card vs CPU, several layers deep
# AR lf0 decoder, float32 against a float64 oracle (PARITY.md, "AR parity
# under chaos"): the card may sit no farther from the oracle than 3x the
# CPU's own float32 run, or within AR_ABS_ATOL when the loop is tame
AR_HEADROOM = 3.0
AR_ABS_ATOL = 5e-4
N_TRACKS = 4
N_CALLS = 3
# single-direction LSTM recurrences per svs_ensemble call, by hidden width
# (encoder 512 x 3 layers x 2 directions; mgc 256, lf0 64, vuv 64, bap 62
# at 2 layers x 2 directions each)
LAUNCHES_BY_HIDDEN = {512: 6, 256: 4, 64: 8, 62: 4}
LAUNCHES_PER_CALL = sum(LAUNCHES_BY_HIDDEN.values())
RECURRENCE_SHAPES = [62, 64, 256, 512]
T_FRAMES = 6656   # 6240 frames of the fixture, rounded up to FRAME_BUCKET


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


# ----------------------------------------------------------- bench configs
# verbatim copies of bench.py's flagship configs (flagship_acoustic_config,
# the timelag/duration netGs and the scalers of build_flagship_engine)
def flagship_acoustic_config(n_spk: int = 4):
    MGC, BAP = 60, 5
    SS = [MGC, 1, 1, BAP]
    OUT = sum(SS)
    lf0_model = {
        "_target_": f"{PKG}.models.acoustic.MultiTrackBiLSTMResF0NonAttentiveDecoder",
        "in_dim": 86, "out_dim": 1,
        "in_ph_start_idx": 3, "in_ph_end_idx": 50, "embed_dim": 256,
        "ff_hidden_dim": 256, "conv_hidden_dim": 128, "lstm_hidden_dim": 64,
        "num_lstm_layers": 2, "decoder_layers": 1, "decoder_hidden_dim": 256,
        "prenet_layers": 0, "prenet_hidden_dim": 16, "prenet_dropout": 0.5,
        "scaled_tanh": True, "zoneout": 0.0,
        "reduction_factor": 4, "downsample_by_conv": True,
        "in_lf0_idx": 51, "out_lf0_idx": 0,
        "in_lf0_min": 4.72, "in_lf0_max": 6.84,
        "out_lf0_mean": float(np.log(260.0)), "out_lf0_scale": 0.24,
    }
    encoder = {
        "_target_": f"{PKG}.models.MultiTrackLSTMEncoder",
        "in_dim": 86, "in_ph_start_idx": 3, "in_ph_end_idx": 50,
        "embed_dim": 256, "hidden_dim": 512, "out_dim": 1024,
        "num_layers": 3, "dropout": 0.0, "bidirectional": True,
        "init_type": "kaiming_normal",
    }

    def ffconvlstm(out_dim, ff, conv, lstm, dropout):
        return {
            "_target_": f"{PKG}.models.FFConvLSTM",
            "in_dim": 1026, "ff_hidden_dim": ff, "conv_hidden_dim": conv,
            "lstm_hidden_dim": lstm, "num_lstm_layers": 2,
            "bidirectional": True, "out_dim": out_dim, "dropout": dropout,
        }

    ac = {
        "netG": {
            "_target_": f"{PKG}.models.acoustic.MultiTrackMultistreamSeparateF0ParametricModel",
            "in_dim": 86, "out_dim": OUT, "stream_sizes": SS,
            "reduction_factor": 4,
            "in_rest_idx": 0, "in_lf0_idx": 51, "out_lf0_idx": MGC,
            "in_lf0_min": 4.72, "in_lf0_max": 6.84,
            "out_lf0_mean": float(np.log(260.0)), "out_lf0_scale": 0.24,
            "encoder": encoder,
            "lf0_model": lf0_model,
            "mgc_model": ffconvlstm(MGC, 1024, 512, 256, 0.1),
            "vuv_model": ffconvlstm(1, 256, 128, 64, 0.1),
            "bap_model": ffconvlstm(BAP, 256, 128, 62, 0.0),
            "speaker_embedding": {
                "_target_": f"{PKG}.models.SpeakerEmbedding",
                "num_embeddings": n_spk, "embedding_dim": 256, "std": 0.01,
            },
        },
        "stream_sizes": SS,
        "has_dynamic_features": [False, False, False, False],
        "num_windows": 1,
    }
    return ac, SS


def flagship_phases(n_spk: int = 4):
    """(global config, {phase: (model_config, in_scaler, out_scaler)})."""
    from ensemble_svs_with_interactions_tpu_torch.utils.scalers import (
        MinMaxScaler,
        StandardScaler,
    )

    MGC, BAP = 60, 5
    OUT = MGC + 1 + 1 + BAP
    tl = {
        "netG": {
            "_target_": f"{PKG}.models.MultiTrackVariancePredictor",
            "in_dim": 82, "out_dim": 3, "hidden_dim": 32, "num_layers": 3,
            "kernel_size": 3, "dropout": 0.5, "use_mdn": True,
            "num_gaussians": 4, "init_type": "kaiming_normal",
            "num_speaker": n_spk, "spk_embed_dim": 16,
        },
        "stream_sizes": [3],
        "has_dynamic_features": [True],
        "num_windows": 3,
    }
    du = {
        "netG": {
            "_target_": f"{PKG}.models.MultiTrackVariancePredictor",
            "in_dim": 82, "out_dim": 1, "hidden_dim": 256, "num_layers": 5,
            "kernel_size": 5, "dropout": 0.5, "use_mdn": True,
            "num_gaussians": 4, "init_type": "kaiming_normal",
            "num_speaker": n_spk, "spk_embed_dim": 16,
        },
        "stream_sizes": [1],
        "has_dynamic_features": [False],
        "num_windows": 1,
    }
    ac, _ = flagship_acoustic_config(n_spk)
    mean = np.zeros(OUT)
    scale = np.ones(OUT) * 0.1
    mean[MGC] = np.log(260.0)
    scale[MGC] = 0.24
    glob = {
        "sample_rate": 48000, "frame_period": 5, "feature_type": "world",
        "use_world_codec": True, "relative_f0": False,
        "spk_list": [f"spk{i}" for i in range(n_spk)],
    }
    phases = {
        "timelag": (tl, MinMaxScaler(np.zeros(82), np.ones(82)),
                    StandardScaler(np.zeros(3), np.ones(3) * 4,
                                   np.ones(3) * 2)),
        "duration": (du, MinMaxScaler(np.zeros(82), np.ones(82)),
                     StandardScaler(np.ones(1) * 10, np.ones(1) * 4,
                                    np.ones(1) * 2)),
        "acoustic": (ac, MinMaxScaler(np.zeros(86), np.ones(86)),
                     StandardScaler(mean, scale ** 2, scale)),
    }
    return glob, phases


def random_state_dicts(phases, seed: int):
    """Random weights: each phase's module built under a seeded generator
    (torch's own initializers), as a state dict."""
    from ensemble_svs_with_interactions_tpu_torch.utils.config import (
        instantiate,
    )

    out = {}
    for k, (name, (cfg, _, _)) in enumerate(sorted(phases.items())):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed + k)
            out[name] = instantiate(cfg["netG"]).state_dict()
    return out


def build_engine(device, weights):
    from ensemble_svs_with_interactions_tpu_torch.svs import SPSVS

    glob, phases = flagship_phases()
    return SPSVS(glob, QST, {
        name: {"model_config": cfg, "state_dict": weights[name],
               "in_scaler": sc_in, "out_scaler": sc_out}
        for name, (cfg, sc_in, sc_out) in phases.items()
    }, device=device)


# ------------------------------------------------------------------ timing
def cuda_ms(fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def recurrence_bound_times(B, T, H, want_c):
    """(bytes time, operations time) in ms for the recurrence's work: each
    input read once and each output written once over the memory rate; the
    h @ W_h multiply-adds plus the gate arithmetic (about 12 operations per
    unit and step) over the float32 rate."""
    nbytes = 4 * (B * T * 4 * H + H * 4 * H + B * T * H * (2 if want_c else 1))
    flops = 2 * B * T * H * 4 * H + 12 * B * T * H
    return 1e3 * nbytes / PEAK_BYTES_PER_S, 1e3 * flops / PEAK_FP32_FLOP_PER_S


def bound(t_bytes, t_ops):
    """The least time, the larger of the two, and which one it is."""
    return max(t_bytes, t_ops), "bytes" if t_bytes > t_ops else "operations"


def cudnn_lstm_ms(xw, w_h, reps):
    """Yardstick: (ms of one cuDNN LSTM call computing the same recurrence,
    ms of the input GEMM inside it).  cuDNN always projects its input, so
    its input weights are the identity (gates xw + h W_h) and the call
    includes a (B*T, 4H) x (4H, 4H) float32 GEMM that the port's kernel does
    not do; that GEMM is timed alone beside it.  Timed here only; the port
    never calls either."""
    B, T, H4 = xw.shape
    H = H4 // 4
    lstm = torch.nn.LSTM(H4, H, batch_first=True).cuda()
    eye = torch.eye(H4, device="cuda")
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(eye)
        lstm.weight_hh_l0.copy_(w_h.t())
        lstm.bias_ih_l0.zero_()
        lstm.bias_hh_l0.zero_()
        lstm(xw)
        torch.nn.functional.linear(xw, eye)
        return (cuda_ms(lambda: lstm(xw), reps),
                cuda_ms(lambda: torch.nn.functional.linear(xw, eye), reps))


# ------------------------------------------------------------------ phases
def phase_build(lr):
    t0 = time.time()
    lib = lr.build()
    build_s = time.time() - t0
    ptxas = [ln.strip() for ln in lib.with_suffix(".log").read_text()
             .splitlines() if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "card": card_line(), "kernel_build_s": build_s,
          "library": lib.name, "ptxas": ptxas,
          "torch": torch.__version__, "cuda": torch.version.cuda})


def phase_kernels(lr):
    results = {}
    g = torch.Generator(device="cuda").manual_seed(SEED)
    B, T = N_TRACKS, T_FRAMES
    for H in RECURRENCE_SHAPES:
        xw = torch.randn(B, T, 4 * H, device="cuda", generator=g)
        w_h = torch.randn(H, 4 * H, device="cuda", generator=g) / H ** 0.5
        for want_c in (False, True):
            got = lr.lstm_recurrence(xw, w_h, want_c)
            ref = lr.lstm_recurrence_reference(xw, w_h, want_c)
            pairs = zip(got, ref) if want_c else [(got, ref)]
            err = max((a - b).abs().max().item() for a, b in pairs)
            ms = cuda_ms(lambda: lr.lstm_recurrence(xw, w_h, want_c), 5)
            plain_ms = cuda_ms(
                lambda: lr.lstm_recurrence_reference(xw, w_h, want_c), 1)
            t_bytes, t_ops = recurrence_bound_times(B, T, H, want_c)
            bound_ms, bound_by = bound(t_bytes, t_ops)
            library_ms, gemm_ms = ((None, None) if want_c
                                   else cudnn_lstm_ms(xw, w_h, 5))
            row = {"phase": "kernel", "name": "lstm_recurrence", "B": B,
                   "T": T, "H": H, "want_c": want_c, "max_abs_err": err,
                   "atol": KERNEL_ATOL, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "bytes_ms": t_bytes, "operations_ms": t_ops,
                   "library_ms": library_ms,
                   "library_input_gemm_ms": gemm_ms}
            emit(row)
            assert np.isfinite(err) and err < KERNEL_ATOL, row
            results[(H, want_c)] = row
    return results


def phase_slice(lr, weights, labels):
    t0 = time.time()
    engine = build_engine("cuda", weights)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    t0 = time.time()
    engine.svs_ensemble([lab.copy() for lab in labels],
                        spk_ids=list(range(N_TRACKS)))
    warm_s = time.time() - t0

    lr.lstm_recurrence.launches = 0
    runs = []
    for _ in range(N_CALLS):
        t0 = time.time()
        wavs, sr = engine.svs_ensemble([lab.copy() for lab in labels],
                                       spk_ids=list(range(N_TRACKS)))
        runs.append({"seconds": time.time() - t0,
                     "stages": dict(engine.last_stage_times)})
    launches = lr.lstm_recurrence.launches

    audio_s = max(len(w) for w in wavs) / sr
    emit({"phase": "slice", "engine_build_s": build_s, "warmup_s": warm_s,
          "runs_s": [r["seconds"] for r in runs],
          "rtf": [r["seconds"] / audio_s for r in runs],
          "stages": runs[len(runs) // 2]["stages"], "audio_seconds": audio_s,
          "wav_lengths": [len(w) for w in wavs], "calls": N_CALLS,
          "launches": launches,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
    assert launches == LAUNCHES_PER_CALL * N_CALLS, launches
    for w in wavs:
        assert w.dtype == np.int16 and len(w) > 30 * sr, (w.dtype, len(w))
        assert np.abs(w.astype(np.int64)).max() > 0
    engine.svs_ensemble([lab.copy() for lab in labels],
                        spk_ids=list(range(N_TRACKS)),
                        blocked_stage_times=True)
    emit({"phase": "slice_blocked", "stages": engine.last_stage_times})
    return engine, launches


def phase_reference(engine, weights, labels):
    """The card against the CPU (plain recurrence) on the first seconds of
    the fixture: durations exactly; the multitrack encoder (H = 512), the
    lf0 encoder (64) and the mgc/vuv/bap decoders (256/64/62) at
    MODULE_ATOL on the same inputs.  The free-running AR lf0 decoder gets
    the same dropout masks on both sides (a CPU generator seeded with
    ``AR_SEED``, as the engine draws them) and is held against a float64
    oracle, the CPU model run in float64: the card may sit no farther from
    it than AR_HEADROOM times the CPU's own float32 run, or AR_ABS_ATOL."""
    from ensemble_svs_with_interactions_tpu_torch.gen import (
        AR_SEED,
        FRAME_BUCKET,
        _round_up,
    )
    from ensemble_svs_with_interactions_tpu_torch.models.acoustic.util import (
        point_estimate,
    )

    t0 = time.time()
    cpu = build_engine("cpu", weights)
    short = [lab[:60] for lab in labels]
    N = len(short)
    pairs = [(i + 1) % N for i in range(N)]
    spk_ids = list(range(N))
    dm = engine.predict_timing_multitrack_batch(short, spk_ids, pairs)
    dm_cpu = cpu.predict_timing_multitrack_batch(short, spk_ids, pairs)
    for a, b in zip(dm, dm_cpu):
        assert list(a.start_times) == list(b.start_times)
        assert list(a.end_times) == list(b.end_times)
    feats, _ = engine._frame_features(dm)
    T = _round_up(max(len(f) for f in feats), FRAME_BUCKET)
    x = np.zeros((N, T, feats[0].shape[1]), np.float32)
    for i, f in enumerate(feats):
        x[i, : len(f)] = f
    lengths = np.asarray([len(f) for f in feats])

    @torch.no_grad()
    def modules(m, dev, dec_in=None, ar_only=False):
        dtype = next(m.parameters()).dtype
        xm = torch.from_numpy(x).to(dev, dtype)
        xs = xm[torch.as_tensor(pairs, device=dev)]
        ln = torch.as_tensor(lengths, device=dev)
        spk_m = m._expand_spk(torch.as_tensor(spk_ids, device=dev), T)
        spk_s = m._expand_spk(torch.as_tensor(pairs, device=dev), T)
        out = {"ar_lf0": point_estimate(m.lf0_model(
            xm, xs, spk_m, spk_s, ln,
            generator=torch.Generator().manual_seed(AR_SEED))[0])}
        if not ar_only:
            out["encoder"] = m.encoder(xm, xs, spk_embs=(spk_m, spk_s),
                                       lengths=ln)
            out["lf0_encoder"] = m.lf0_model.encode(xm, xs, spk_m, spk_s, ln)
            if dec_in is None:
                dec_in = torch.cat([out["encoder"], xm[..., :1],
                                    out["ar_lf0"]], dim=-1).cpu()
            d = dec_in.to(dev)
            for k in ("mgc_model", "vuv_model", "bap_model"):
                out[k] = getattr(m, k)(d, ln)
        return {k: v.cpu().double() for k, v in out.items()}, dec_in

    ref, dec_in = modules(cpu.acoustic_model.module, cpu.device)
    got, _ = modules(engine.acoustic_model.module, engine.device, dec_in)
    oracle, _ = modules(copy.deepcopy(cpu.acoustic_model.module).double(),
                        cpu.device, ar_only=True)
    valid = torch.from_numpy(np.arange(T)[None, :] < lengths[:, None])

    def dist(a, b):
        return (a - b)[valid].abs().max().item()

    errs = {k: dist(got[k], ref[k]) for k in ref}
    ar = {"card_vs_f64": dist(got["ar_lf0"], oracle["ar_lf0"]),
          "cpu_f32_vs_f64": dist(ref["ar_lf0"], oracle["ar_lf0"])}
    ar_limit = max(AR_ABS_ATOL, AR_HEADROOM * ar["cpu_f32_vs_f64"])
    emit({"phase": "reference", "frames": lengths.tolist(), "T": T,
          "max_abs_err": errs, "atol": MODULE_ATOL, "ar_lf0": ar,
          "ar_lf0_limit": ar_limit, "seconds": time.time() - t0})
    for k, e in errs.items():
        if k != "ar_lf0":
            assert np.isfinite(e) and e < MODULE_ATOL, (k, e)
    assert np.isfinite(ar["card_vs_f64"]) and ar["card_vs_f64"] <= ar_limit, ar
    for k in ref:
        assert torch.isfinite(got[k]).all(), k


def kernels_line(kernel_rows, launches):
    """The recurrence kernel's entry: ``launches`` from the slice's run of
    N_CALLS calls; ms, plain_ms, library_ms and the bound summed over one
    call's launches at the path's shapes (LAUNCHES_BY_HIDDEN), from the
    kernel phase's rows."""
    rows = {H: kernel_rows[(H, False)] for H in RECURRENCE_SHAPES}

    def per_call(key):
        return sum(n * rows[H][key] for H, n in LAUNCHES_BY_HIDDEN.items())

    bound_ms, bound_by = bound(per_call("bytes_ms"), per_call("operations_ms"))
    return {"kernels": [{
        "name": "lstm_recurrence", "route": "cuda",
        "source": "ensemble_svs_with_interactions_tpu_torch/csrc/lstm_recurrence.cu",
        "replaces": "ensemble_svs_with_interactions_tpu/ops/pallas_lstm.py:30",
        "launches": launches, "calls": N_CALLS,
        "launches_per_call": launches // N_CALLS,
        "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
        "ms": per_call("ms"), "plain_ms": per_call("plain_ms"),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": per_call("library_ms"),
        "library_input_gemm_ms": per_call("library_input_gemm_ms"),
    }]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import ensemble_svs_with_interactions_tpu_torch as port
    from ensemble_svs_with_interactions_tpu_torch.io import hts
    from ensemble_svs_with_interactions_tpu_torch.ops import (
        lstm_recurrence as lr,
    )

    if Path(port.__file__).resolve().parent.parent != REPO:
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    phase_build(lr)
    kernel_rows = phase_kernels(lr)

    weights = random_state_dicts(flagship_phases()[1], SEED)
    labels = [hts.load(FIXTURE) for _ in range(N_TRACKS)]
    engine, launches = phase_slice(lr, weights, labels)
    phase_reference(engine, weights, labels)
    emit(kernels_line(kernel_rows, launches))
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
