"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper).

    python3 chip_smoke.py

Drives the port's two paths at the verbatim widths of the flagship
(random weights from a seeded generator): serving, the 4-part pairwise
ensemble through ``SPSVS.svs_ensemble`` as ``bench.py`` runs it, and
training, the multitrack acoustic train step as ``bench_train.py`` runs
it.  It holds every hand-written kernel of those paths against its plain
PyTorch version on the card.  Phases, each printing JSON lines:

1. the card (``nvidia-smi`` name and power limit) and the kernel build
   (one ``nvcc`` per source, run at once);
2. ``kernel``: the LSTM recurrence kernel against its plain version at the
   serving shapes (B = 4, T = 6656, H = 62, 64, 256, 512), with and without
   the cell-sequence output, with times (and microseconds per step), the
   bound and a library yardstick; each recurrence row names the kernel
   the launch's dispatch chose for its shape;
3. ``train_kernel``: the recurrence (both modes), the BPTT kernel and the
   dW_h kernel against their plain versions at the training shapes
   (B = 64; T = 256, and T = 64 for the AR decoder's H = 256 cell); BPTT
   rows give microseconds per step, the bound of the reverse loop alone,
   and the gate pre-pass timed and checked alone beside its bound and a
   ``torch.addmm`` of the same product; dW_h also gives its achieved
   TFLOP/s and checks that two launches agree bitwise;
4. ``slice``: the random weights written by ``utils/packing.pack_model``
   into a temporary directory and opened by ``SPSVS(model_dir)``, the
   normal entry point (``pack_s``, ``load_s``), a warm-up, then three
   timed ``svs_ensemble`` calls on 4 copies of the 31.2 s fixture with the
   launch count reset just before and read just after;
5. ``packed``: the same weights built in memory by ``SPSVS.from_parts``
   render the fixture with durations and int16 audio bitwise equal to the
   loaded engine's;
6. ``reference``: the same modules on the CPU (plain recurrence) against
   the card on a shortened input, and the AR lf0 decoder against a
   float64 oracle;
7. ``train``: ``bench_train.py``'s workload, 64 pairs x 256 frames with
   Adam, 2 warm-up steps and TRAIN_STEPS timed ones with the launch counts
   reset just before and read just after, then one step split into
   forward, backward and optimizer;
8. ``train_reference``: one step at full width without dropout, B = 4,
   on the card against the same step on the CPU (loss, every gradient,
   the new batch statistics);
9. a ``kernels`` line, the card line, and last ``{"ok": true, ...}``.

``bench_cuda.py`` and ``bench_train_cuda.py`` share this file's flagship
configs, weights and kernel operation counts.

Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.  Imports nothing of JAX or the JAX package.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
FIXTURE = REPO / "tests" / "data" / "nit_song070" / "nitech_jp_song070_f001_004.lab"
PKG = "ensemble_svs_with_interactions_tpu"
SEED = 0

# card peaks for the bound (NVIDIA H100 SXM data sheet, dense)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12
PEAK_3XTF32_FLOP_PER_S = 495e12 / 3  # TF32 tensor cores, 3 products each

KERNEL_ATOL = 1e-4   # float32 kernel vs plain loop, other summation order
MODULE_ATOL = 1e-3   # full-width modules, card vs CPU, several layers deep
DWH_RTOL = 1e-4     # dW_h sums B(T-1) = 16,320 terms: relative to its max
# AR lf0 decoder, float32 against a float64 oracle (PARITY.md, "AR parity
# under chaos"): the card may sit no farther from the oracle than 3x the
# CPU's own float32 run, or within AR_ABS_ATOL when the loop is tame
AR_HEADROOM = 3.0
AR_ABS_ATOL = 5e-4
# one train step, card against CPU, dropout off: the loss, the updated
# running statistics, and each gradient within TRAIN_GRAD_RTOL of its
# largest entry.  Two gradients are judged otherwise:
# * one that is zero in exact arithmetic (a conv bias in front of a
#   training-mode batch norm, whose mean removes it) holds only rounding
#   noise, so each gradient's scale is at least GRAD_SCALE_FLOOR of the
#   largest gradient entry of the model;
# * a conv weight in front of a training-mode batch norm gets a gradient
#   that is a small difference of large terms, which float32 resolves
#   only to a few digits on any device.  So the step also runs in float64
#   on the CPU, as an oracle, and a gradient passes where the card's
#   distance from the oracle is at most AR_HEADROOM times the CPU float32
#   run's own (PARITY.md's criterion for chaotic paths).
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_RTOL = 1e-3
GRAD_SCALE_FLOOR = 1e-4
TRAIN_STATS_ATOL = 1e-4
N_TRACKS = 4
N_CALLS = 3
# single-direction LSTM recurrences per svs_ensemble call, by hidden width
# (encoder 512 x 3 layers x 2 directions; mgc 256, lf0 64, vuv 64, bap 62
# at 2 layers x 2 directions each)
LAUNCHES_BY_HIDDEN = {512: 6, 256: 4, 64: 8, 62: 4}
LAUNCHES_PER_CALL = sum(LAUNCHES_BY_HIDDEN.values())
RECURRENCE_SHAPES = [62, 64, 256, 512]
T_FRAMES = 6656   # 6240 frames of the fixture, rounded up to FRAME_BUCKET
# bench_train.py's geometry: 64 pairs x 256-frame crops, Adam at 1e-3
TRAIN_B, TRAIN_T = 64, 256
TRAIN_STEPS = 5
REF_B = 4
# single-direction LSTM recurrences per train step, by (hidden width,
# sequence length): each track pass runs the encoder (512 x 3 x 2), the
# lf0 model's biLSTM (64 x 2 x 2) and AR decoder cell (256, at the
# reduced rate T / 4), and mgc / vuv / bap (256 / 64 / 62, 2 x 2 each);
# the main and the sub track make two passes.  Each runs the forward
# kernel (want_c), the BPTT kernel and the dW_h kernel once.
TRAIN_LAUNCHES_BY_SHAPE = {(512, 256): 12, (256, 256): 8, (256, 64): 2,
                           (64, 256): 16, (62, 256): 8}
TRAIN_LAUNCHES_PER_STEP = sum(TRAIN_LAUNCHES_BY_SHAPE.values())


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


# ----------------------------------------------------------- bench configs
# verbatim copies of bench.py's flagship configs (flagship_acoustic_config,
# the timelag/duration netGs and the scalers of build_flagship_engine).
# ``tiny=True`` narrows every width for the benches' CPU tests (TINY); the
# stream layout and the model classes stay.
TINY = {"embed": 8, "enc_hidden": 8, "enc_out": 16, "enc_layers": 2,
        "ff": 8, "conv": 8, "lstm": 4, "dec": 8, "spk": 8, "tl": 8, "du": 8,
        "layers": 2}


def flagship_acoustic_config(n_spk: int = 4, tiny: bool = False):
    MGC, BAP = 60, 5
    w = TINY if tiny else {}
    SS = [MGC, 1, 1, BAP]
    OUT = sum(SS)
    lf0_model = {
        "_target_": f"{PKG}.models.acoustic.MultiTrackBiLSTMResF0NonAttentiveDecoder",
        "in_dim": 86, "out_dim": 1,
        "in_ph_start_idx": 3, "in_ph_end_idx": 50,
        "embed_dim": w.get("embed", 256), "ff_hidden_dim": w.get("ff", 256),
        "conv_hidden_dim": w.get("conv", 128),
        "lstm_hidden_dim": w.get("lstm", 64), "num_lstm_layers": 2,
        "decoder_layers": 1, "decoder_hidden_dim": w.get("dec", 256),
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
        "embed_dim": w.get("embed", 256),
        "hidden_dim": w.get("enc_hidden", 512),
        "out_dim": w.get("enc_out", 1024),
        "num_layers": w.get("enc_layers", 3), "dropout": 0.0,
        "bidirectional": True, "init_type": "kaiming_normal",
    }

    def ffconvlstm(out_dim, ff, conv, lstm, dropout):
        if tiny:
            ff, conv, lstm = w["ff"], w["conv"], w["lstm"]
        return {
            "_target_": f"{PKG}.models.FFConvLSTM",
            "in_dim": encoder["out_dim"] + 2, "ff_hidden_dim": ff,
            "conv_hidden_dim": conv, "lstm_hidden_dim": lstm,
            "num_lstm_layers": 2, "bidirectional": True, "out_dim": out_dim,
            "dropout": dropout,
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
                "num_embeddings": n_spk,
                "embedding_dim": w.get("spk", 256), "std": 0.01,
            },
        },
        "stream_sizes": SS,
        "has_dynamic_features": [False, False, False, False],
        "num_windows": 1,
    }
    return ac, SS


def flagship_phases(n_spk: int = 4, tiny: bool = False):
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
            "in_dim": 82, "out_dim": 3,
            "hidden_dim": TINY["tl"] if tiny else 32,
            "num_layers": TINY["layers"] if tiny else 3,
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
            "in_dim": 82, "out_dim": 1,
            "hidden_dim": TINY["du"] if tiny else 256,
            "num_layers": TINY["layers"] if tiny else 5,
            "kernel_size": 5, "dropout": 0.5, "use_mdn": True,
            "num_gaussians": 4, "init_type": "kaiming_normal",
            "num_speaker": n_spk, "spk_embed_dim": 16,
        },
        "stream_sizes": [1],
        "has_dynamic_features": [False],
        "num_windows": 1,
    }
    ac, _ = flagship_acoustic_config(n_spk, tiny)
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
    """The flagship engine built in memory (``SPSVS.from_parts``) from
    state dicts."""
    from ensemble_svs_with_interactions_tpu_torch.svs import SPSVS
    from ensemble_svs_with_interactions_tpu_torch.utils import (
        packaged_question_path,
    )

    glob, phases = flagship_phases()
    return SPSVS.from_parts(glob, packaged_question_path(), {
        name: {"model_config": cfg, "state_dict": weights[name],
               "in_scaler": sc_in, "out_scaler": sc_out}
        for name, (cfg, sc_in, sc_out) in phases.items()
    }, device=device)


def pack_flagship(model_dir, weights, tiny: bool = False):
    """Write the flagship with the given state dicts as a packed model
    directory (``utils/packing.pack_model``, through ``torch_to_flax``)."""
    from ensemble_svs_with_interactions_tpu_torch.utils import (
        packaged_question_path,
    )
    from ensemble_svs_with_interactions_tpu_torch.utils.config import (
        instantiate,
    )
    from ensemble_svs_with_interactions_tpu_torch.utils.packing import (
        pack_model,
    )

    glob, phases = flagship_phases(tiny=tiny)
    parts = {}
    for name, (cfg, sc_in, sc_out) in phases.items():
        module = instantiate(cfg["netG"])
        module.load_state_dict(weights[name])
        parts[name] = {"model_config": cfg, "module": module,
                       "in_scaler": sc_in, "out_scaler": sc_out}
    return pack_model(model_dir, glob, packaged_question_path(), parts)


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


def recurrence_ops(B, T, H):
    """Operations of the recurrence: the h @ W_h multiply-adds plus the gate
    arithmetic, about 12 operations per unit and step."""
    return 2 * B * T * H * 4 * H + 12 * B * T * H


def gates_ops(B, T, H):
    """Operations of the BPTT's gate pre-pass: the h_{t-1} W_h
    multiply-adds plus the bias add."""
    return 2 * B * T * H * 4 * H + B * T * 4 * H


def bptt_loop_ops(B, T, H):
    """Operations of the BPTT's reverse loop: the dz_{t+1} W_h^T
    multiply-adds plus about 30 elementwise operations per unit and
    step."""
    return 2 * B * T * 4 * H * H + 30 * B * T * H


def recurrence_bound_times(B, T, H, want_c):
    """(bytes time, operations time) in ms for the recurrence's work: each
    input read once and each output written once over the memory rate;
    ``recurrence_ops`` over the float32 rate."""
    nbytes = 4 * (B * T * 4 * H + H * 4 * H + B * T * H * (2 if want_c else 1))
    return (1e3 * nbytes / PEAK_BYTES_PER_S,
            1e3 * recurrence_ops(B, T, H) / PEAK_FP32_FLOP_PER_S)


def bptt_bound_times(B, T, H):
    """(bytes time, operations time) in ms for the whole BPTT launch: xw,
    W_h, h, c and dy read once, dxw written once; the gates' operations
    (``gates_bound_times``) plus the loop's (``bptt_loop_bound_times``),
    each at the rate of the instruction that does them."""
    nbytes = 4 * (2 * B * T * 4 * H + H * 4 * H + 3 * B * T * H)
    return (1e3 * nbytes / PEAK_BYTES_PER_S,
            gates_bound_times(B, T, H)[1] + bptt_loop_bound_times(B, T, H)[1])


def gates_bound_times(B, T, H):
    """(bytes time, operations time) in ms for the BPTT's gate pre-pass: xw,
    h and W_h read once, the gates written once; the h_{t-1} W_h
    multiply-adds plus the bias add at the rate of the instruction the
    pre-pass uses: float32 FMA at H <= 64, 3xTF32 on the tensor cores above
    (PEAK_3XTF32_FLOP_PER_S, as ``dwh_bound_times``)."""
    nbytes = 4 * (2 * B * T * 4 * H + B * T * H + H * 4 * H)
    rate = PEAK_FP32_FLOP_PER_S if H <= 64 else PEAK_3XTF32_FLOP_PER_S
    return 1e3 * nbytes / PEAK_BYTES_PER_S, 1e3 * gates_ops(B, T, H) / rate


def bptt_loop_bound_times(B, T, H):
    """(bytes time, operations time) in ms for the BPTT's reverse loop
    after the pre-pass: the gates, c and dy read once and W_h once, dz
    written once; the dz_{t+1} W_h^T multiply-adds plus about 30
    elementwise operations per unit and step over the float32 rate."""
    nbytes = 4 * (2 * B * T * 4 * H + H * 4 * H + 2 * B * T * H)
    return (1e3 * nbytes / PEAK_BYTES_PER_S,
            1e3 * bptt_loop_ops(B, T, H) / PEAK_FP32_FLOP_PER_S)


def dwh_flops(B, T, H):
    """Operations of dW_h = sum h_{t-1}^T dz_t: 2 B (T-1) H 4H."""
    return 2 * B * (T - 1) * H * 4 * H


def dwh_bound_times(B, T, H):
    """(bytes time, operations time) in ms for dW_h: h and dz read once,
    dW_h written once; its operations at the rate of the instruction the
    kernel uses, 3xTF32 on the tensor cores (three TF32 products per
    float32 product: PEAK_3XTF32_FLOP_PER_S)."""
    nbytes = 4 * (B * T * H + B * T * 4 * H + H * 4 * H)
    return (1e3 * nbytes / PEAK_BYTES_PER_S,
            1e3 * dwh_flops(B, T, H) / PEAK_3XTF32_FLOP_PER_S)


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


def cudnn_lstm_bwd_ms(xw, w_h, dy, reps):
    """Yardstick: (ms of cuDNN LSTM's backward alone, data and weight
    gradients, for the same recurrence as ``cudnn_lstm_ms`` sets it up; ms
    of its input-side work that the port's BPTT does not do: dx = dz W_ih
    and dW_ih = dz^T x, two (B*T, 4H) x (4H, 4H) float32 GEMMs, timed
    alone).  Timed here only; the port never calls either."""
    B, T, H4 = xw.shape
    H = H4 // 4
    lstm = torch.nn.LSTM(H4, H, batch_first=True).cuda()
    eye = torch.eye(H4, device="cuda")
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(eye)
        lstm.weight_hh_l0.copy_(w_h.t())
        lstm.bias_ih_l0.zero_()
        lstm.bias_hh_l0.zero_()
    x = xw.detach().clone().requires_grad_(True)
    out, _ = lstm(x)
    inputs = [x, *lstm.parameters()]

    def backward():
        torch.autograd.grad(out, inputs, dy, retain_graph=True)

    dz = xw.reshape(B * T, H4)

    def input_gemms():
        torch.matmul(dz, eye)
        torch.matmul(dz.t(), dz)

    backward()
    input_gemms()
    return cuda_ms(backward, reps), cuda_ms(input_gemms, reps)


# ------------------------------------------------------------------ phases
def ptxas_report(log: str) -> list:
    """One entry per compiled kernel (every template instantiation) from
    nvcc's ``-Xptxas -v`` report: its mangled name, then its registers,
    stack, spill and shared-memory lines."""
    out = []
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            out.append({"kernel": ln.split("'")[1], "ptxas": []})
        elif out and ("registers" in ln or "spill" in ln):
            out[-1]["ptxas"].append(ln.strip())
    return out


def phase_build(lr):
    t0 = time.time()
    libs = lr.build()
    build_s = time.time() - t0
    ptxas = {name: ptxas_report(lib.with_suffix(".log").read_text())
             for name, lib in libs.items()}
    emit({"phase": "build", "card": card_line(), "kernel_build_s": build_s,
          "libraries": [lib.name for lib in libs.values()], "ptxas": ptxas,
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
            row = {"phase": "kernel", "name": "lstm_recurrence",
                   "kernel": lr.lstm_recurrence_kernel_name(B, H), "B": B,
                   "T": T, "H": H, "want_c": want_c, "max_abs_err": err,
                   "atol": KERNEL_ATOL, "ms": ms, "us_per_step": 1e3 * ms / T,
                   "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "bytes_ms": t_bytes, "operations_ms": t_ops,
                   "library_ms": library_ms,
                   "library_input_gemm_ms": gemm_ms}
            emit(row)
            assert np.isfinite(err) and err < KERNEL_ATOL, row
            results[(H, want_c)] = row
    return results


def phase_train_kernels(lr):
    """The training path's kernels at its shapes (TRAIN_LAUNCHES_BY_SHAPE,
    batch TRAIN_B): the recurrence in both modes, the BPTT kernel (dxw)
    and the dW_h kernel, each against its plain version."""
    rows = {}
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    B = TRAIN_B
    for H, T in TRAIN_LAUNCHES_BY_SHAPE:
        xw = torch.randn(B, T, 4 * H, device="cuda", generator=g)
        w_h = torch.randn(H, 4 * H, device="cuda", generator=g) / H ** 0.5
        dy = torch.randn(B, T, H, device="cuda", generator=g)
        base = {"phase": "train_kernel", "B": B, "T": T, "H": H}
        library_ms, gemm_ms = cudnn_lstm_ms(xw, w_h, 10)
        for want_c in (False, True):
            got = lr.lstm_recurrence(xw, w_h, want_c)
            ref = lr.lstm_recurrence_reference(xw, w_h, want_c)
            pairs = zip(got, ref) if want_c else [(got, ref)]
            err = max((a - b).abs().max().item() for a, b in pairs)
            t_bytes, t_ops = recurrence_bound_times(B, T, H, want_c)
            ms = cuda_ms(lambda: lr.lstm_recurrence(xw, w_h, want_c), 10)
            row = {**base, "name": "lstm_recurrence",
                   "kernel": lr.lstm_recurrence_kernel_name(B, H),
                   "want_c": want_c, "max_abs_err": err, "atol": KERNEL_ATOL,
                   "ms": ms, "us_per_step": 1e3 * ms / T,
                   "plain_ms": cuda_ms(lambda: lr.lstm_recurrence_reference(
                       xw, w_h, want_c), 1),
                   "bytes_ms": t_bytes, "operations_ms": t_ops,
                   "library_ms": library_ms, "library_input_gemm_ms": gemm_ms}
            row["bound_ms"], row["bound_by"] = bound(t_bytes, t_ops)
            emit(row)
            assert np.isfinite(err) and err < KERNEL_ATOL, row
            rows["lstm_recurrence", H, T, want_c] = row

        h, c = lr.lstm_recurrence(xw, w_h, want_c=True)
        dxw = lr.lstm_bptt(xw, w_h, h, c, dy)
        dxw_ref, dwh_ref = lr.lstm_recurrence_bwd_reference(xw, w_h, h, c, dy)
        err = (dxw - dxw_ref).abs().max().item()
        t_bytes, t_ops = bptt_bound_times(B, T, H)
        library_ms, gemm_ms = cudnn_lstm_bwd_ms(xw, w_h, dy, 5)
        ms = cuda_ms(lambda: lr.lstm_bptt(xw, w_h, h, c, dy), 10)
        row = {**base, "name": "lstm_bptt", "max_abs_err": err,
               "atol": KERNEL_ATOL, "ms": ms, "us_per_step": 1e3 * ms / T,
               "plain_ms": cuda_ms(lambda: lr.lstm_recurrence_bwd_reference(
                   xw, w_h, h, c, dy), 1),
               "bytes_ms": t_bytes, "operations_ms": t_ops,
               "library_ms": library_ms, "library_input_gemm_ms": gemm_ms,
               "loop_bound_ms": bound(*bptt_loop_bound_times(B, T, H))[0],
               **prepass_row(lr, xw, w_h, h)}
        row["bound_ms"], row["bound_by"] = bound(t_bytes, t_ops)
        emit(row)
        assert np.isfinite(err) and err < KERNEL_ATOL, row
        assert row["prepass_max_abs_err"] < KERNEL_ATOL, row
        rows["lstm_bptt", H, T, None] = row

        # dW_h alone on the plain loop's dz, and the two kernels together
        # against the loop's own dW_h
        dwh = lr.lstm_dwh(h, dxw_ref)
        dwh_plain = lr.lstm_dwh_reference(h, dxw_ref)
        scale = dwh_plain.abs().max().item()
        err = (dwh - dwh_plain).abs().max().item()
        err_loop = (lr.lstm_dwh(h, dxw) - dwh_ref).abs().max().item()
        hprev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)
        dwh_again = lr.lstm_dwh(h, dxw_ref)
        t_bytes, t_ops = dwh_bound_times(B, T, H)
        ms = cuda_ms(lambda: lr.lstm_dwh(h, dxw_ref), 10)
        row = {**base, "name": "lstm_dwh", "max_abs_err": err,
               "max_rel_err": err / scale, "max_rel_err_vs_loop":
               err_loop / scale, "rtol_of_max": DWH_RTOL,
               "bitwise_repeatable": bool(torch.equal(dwh, dwh_again)),
               "ms": ms, "tflops": dwh_flops(B, T, H) / ms / 1e9,
               "plain_ms": cuda_ms(lambda: lr.lstm_dwh_reference(h, dxw_ref),
                                   10),
               "bytes_ms": t_bytes, "operations_ms": t_ops,
               "library_ms": cuda_ms(lambda: torch.matmul(
                   hprev.reshape(-1, H).t(), dxw_ref.reshape(-1, 4 * H)), 10)}
        row["bound_ms"], row["bound_by"] = bound(t_bytes, t_ops)
        emit(row)
        assert np.isfinite(err) and err <= DWH_RTOL * scale, row
        assert err_loop <= DWH_RTOL * scale, row
        assert row["bitwise_repeatable"], row
        rows["lstm_dwh", H, T, None] = row
    return rows


def prepass_row(lr, xw, w_h, h):
    """The BPTT's gate pre-pass alone (its part of the row's ``ms``): its
    error against its plain version, its time, the plain version's, its
    bound, and as its yardstick one ``torch.addmm`` of the same product in
    float32 (TF32 off), without the activations; timed here only."""
    B, T, H = h.shape
    err = (lr.lstm_gates(xw, w_h, h)
           - lr.lstm_gates_reference(xw, w_h, h)).abs().max().item()
    hprev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)
    a, x = hprev.reshape(-1, H), xw.reshape(-1, 4 * H)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        library_ms = cuda_ms(lambda: torch.addmm(x, a, w_h), 10)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return {"prepass_ms": cuda_ms(lambda: lr.lstm_gates(xw, w_h, h), 10),
            "prepass_max_abs_err": err,
            "prepass_plain_ms": cuda_ms(
                lambda: lr.lstm_gates_reference(xw, w_h, h), 1),
            "prepass_bound_ms": bound(*gates_bound_times(B, T, H))[0],
            "prepass_library_ms": library_ms}


def phase_slice(lr, weights, labels):
    """The engine through the normal entry point: the weights packed into a
    temporary directory, then ``SPSVS(model_dir)``."""
    from ensemble_svs_with_interactions_tpu_torch.svs import SPSVS

    with tempfile.TemporaryDirectory() as model_dir:
        t0 = time.time()
        pack_flagship(model_dir, weights)
        pack_s = time.time() - t0
        t0 = time.time()
        engine = SPSVS(model_dir, device="cuda")
        torch.cuda.synchronize()
        load_s = time.time() - t0
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
    emit({"phase": "slice", "pack_s": pack_s, "load_s": load_s,
          "warmup_s": warm_s,
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


def phase_packed(engine, weights, labels):
    """The engine ``SPSVS.from_parts`` builds from the same weights renders
    the fixture with durations and int16 audio bitwise equal to those of
    the engine loaded from the packed directory."""
    t0 = time.time()
    parts = build_engine("cuda", weights)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    N = len(labels)
    spk_ids, pairs = list(range(N)), [(i + 1) % N for i in range(N)]
    durations = [
        [(list(lab.start_times), list(lab.end_times))
         for lab in e.predict_timing_multitrack_batch(
             [lab.copy() for lab in labels], spk_ids, pairs)]
        for e in (engine, parts)]
    wavs = [e.svs_ensemble([lab.copy() for lab in labels], spk_ids=spk_ids)[0]
            for e in (engine, parts)]
    same_audio = [bool(np.array_equal(a, b)) for a, b in zip(*wavs)]
    emit({"phase": "packed", "from_parts_build_s": build_s,
          "durations_equal": durations[0] == durations[1],
          "audio_bitwise_equal": same_audio,
          "wav_lengths": [len(w) for w in wavs[1]]})
    assert durations[0] == durations[1], "durations differ"
    assert all(same_audio), same_audio


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


def train_batch(B: int, T: int, out_dim: int):
    """bench_train.py's batch (its lines 102-111): numpy seed 0."""
    rng = np.random.default_rng(0)
    return {
        "in_feats0": rng.uniform(0, 1, (B, T, 86)).astype(np.float32),
        "out_feats0": rng.normal(size=(B, T, out_dim)).astype(np.float32),
        "in_feats1": rng.uniform(0, 1, (B, T, 86)).astype(np.float32),
        "out_feats1": rng.normal(size=(B, T, out_dim)).astype(np.float32),
        "spks0": np.zeros((B,), np.int32),
        "spks1": np.ones((B,), np.int32),
        "lengths": np.full((B,), T, dtype=np.int32),
    }


def build_trainer(cfg, ss, state_dict, device, dtype=torch.float32):
    """(module, train_step) of the flagship acoustic model: Adam at 1e-3,
    pitch_reg_weight 1, sub_require_grad True, clip 1.0 (bench_train.py)."""
    from ensemble_svs_with_interactions_tpu_torch.train.loop import (
        build_optimizer,
    )
    from ensemble_svs_with_interactions_tpu_torch.train.multitrack import (
        create_multitrack_acoustic_train_step,
    )
    from ensemble_svs_with_interactions_tpu_torch.utils.config import (
        instantiate,
    )

    module = instantiate(cfg)
    module.load_state_dict(state_dict)
    module.to(dtype)
    opt, sched = build_optimizer(module.parameters(),
                                 {"name": "Adam", "params": {"lr": 1e-3}})
    step, _ = create_multitrack_acoustic_train_step(
        module, opt, {"stream_sizes": list(ss)}, scheduler=sched,
        clip_norm=1.0, pitch_reg_weight=1.0, sub_require_grad=True,
        device=device)
    return module, step


def seeded_state_dict(cfg, seed):
    from ensemble_svs_with_interactions_tpu_torch.utils.config import (
        instantiate,
    )

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return instantiate(cfg).state_dict()


TRAIN_WEIGHTS = {"logf0_diff": 1.0, "mgc_diff": 1.0}
TRAIN_COUNTERS = ("lstm_recurrence", "lstm_bptt", "lstm_dwh")


def phase_train(lr):
    """bench_train.py's flagship step: 2 warm-up steps, TRAIN_STEPS timed
    ones (host clock around a step that ends in a host copy of its
    metrics), with the kernel launch counts reset just before and read just
    after, then one step synchronized after each phase."""
    ac, ss = flagship_acoustic_config(4)
    _, step = build_trainer(ac["netG"], ss, seeded_state_dict(ac["netG"], SEED),
                            "cuda")
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in
             train_batch(TRAIN_B, TRAIN_T, sum(ss)).items()}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    losses = []
    t0 = time.time()
    for _ in range(2):
        losses.append(step(batch, TRAIN_WEIGHTS, gen)["Loss"])
    warm_s = time.time() - t0

    for name in TRAIN_COUNTERS:
        getattr(lr, name).launches = 0
    torch.cuda.reset_peak_memory_stats()
    step_s = []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(step(batch, TRAIN_WEIGHTS, gen)["Loss"])
        step_s.append(time.perf_counter() - t0)
    launches = {name: getattr(lr, name).launches for name in TRAIN_COUNTERS}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    losses.append(step(batch, TRAIN_WEIGHTS, gen,
                       blocked_phase_times=True)["Loss"])
    median = float(np.median(step_s))
    emit({"phase": "train", "B": TRAIN_B, "T": TRAIN_T, "warmup_s": warm_s,
          "steps_s": step_s, "median_step_s": median,
          "frames_per_s": TRAIN_B * TRAIN_T / median,
          "split_s": step.last_phase_times, "losses": losses,
          "peak_mem_gib": peak, "steps": TRAIN_STEPS,
          "launches": launches,
          "launches_per_step": {k: v / TRAIN_STEPS
                                for k, v in launches.items()},
          "expected_per_step": TRAIN_LAUNCHES_PER_STEP})
    assert all(np.isfinite(x) for x in losses), losses
    for name, n in launches.items():
        assert n == TRAIN_LAUNCHES_PER_STEP * TRAIN_STEPS, (name, n)
    return launches


def phase_train_reference():
    """One step at full width with dropout off, B = REF_B, on the card
    against the same step on the CPU (plain recurrence and BPTT loops) in
    float32 and in float64: the loss, each parameter's (clipped) gradient,
    and the running statistics after the step (see TRAIN_GRAD_RTOL)."""
    ac, ss = flagship_acoustic_config(4)
    cfg = copy.deepcopy(ac["netG"])
    cfg["mgc_model"]["dropout"] = cfg["vuv_model"]["dropout"] = 0.0
    cfg["lf0_model"]["prenet_dropout"] = 0.0
    state = seeded_state_dict(cfg, SEED)
    batch = train_batch(REF_B, TRAIN_T, sum(ss))
    t0 = time.time()
    runs = {}
    for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float32),
                       ("cpu", torch.float64)):
        module, step = build_trainer(cfg, ss, state, dev, dtype)
        metrics = step(batch, TRAIN_WEIGHTS,
                       torch.Generator(device=dev).manual_seed(SEED))
        runs[dev, dtype] = (metrics,
                            {n: p.grad.detach().cpu().double()
                             for n, p in module.named_parameters()},
                            {n: b.detach().cpu().double()
                             for n, b in module.named_buffers()})
    m_gpu, g_gpu, s_gpu = runs["cuda", torch.float32]
    m_cpu, g_cpu, s_cpu = runs["cpu", torch.float32]
    _, g_64, _ = runs["cpu", torch.float64]
    loss_rel = abs(m_gpu["Loss"] - m_cpu["Loss"]) / abs(m_cpu["Loss"])
    floor = GRAD_SCALE_FLOOR * max(g.abs().max().item() for g in g_64.values())
    grads = {}
    for n, g in g_64.items():
        scale = max(g.abs().max().item(), floor)
        card = (g_gpu[n] - g_cpu[n]).abs().max().item()
        card_64 = (g_gpu[n] - g).abs().max().item()
        cpu_64 = (g_cpu[n] - g).abs().max().item()
        grads[n] = {"rel_of_max": card / scale,
                    "card_vs_f64": card_64, "cpu_f32_vs_f64": cpu_64,
                    "ok": card / scale < TRAIN_GRAD_RTOL
                    or card_64 <= AR_HEADROOM * cpu_64}
    stats_err = max((s_gpu[n] - v).abs().max().item()
                    for n, v in s_cpu.items())
    worst = max(grads, key=lambda n: grads[n]["rel_of_max"])
    by_oracle = {n: v for n, v in grads.items()
                 if v["rel_of_max"] >= TRAIN_GRAD_RTOL}
    emit({"phase": "train_reference", "B": REF_B, "T": TRAIN_T,
          "loss": [m_gpu["Loss"], m_cpu["Loss"]], "loss_rel_err": loss_rel,
          "grad_norm": [m_gpu["GradNorm"], m_cpu["GradNorm"]],
          "params": len(grads),
          "max_grad_rel_err": grads[worst]["rel_of_max"], "worst_grad": worst,
          "judged_by_f64_oracle": by_oracle,
          "grads_at_scale_floor": sum(
              g.abs().max().item() < floor for g in g_64.values()),
          "stats_max_abs_err": stats_err,
          "limits": {"loss_rtol": TRAIN_LOSS_RTOL,
                     "grad_rtol_of_max": TRAIN_GRAD_RTOL,
                     "grad_f64_headroom": AR_HEADROOM,
                     "stats_atol": TRAIN_STATS_ATOL},
          "seconds": time.time() - t0})
    assert np.isfinite(m_gpu["Loss"]) and loss_rel < TRAIN_LOSS_RTOL
    bad = [n for n, v in grads.items() if not v["ok"]]
    assert not bad, {n: grads[n] for n in bad}
    assert stats_err < TRAIN_STATS_ATOL, stats_err


def _sum_rows(rows, counts, keys):
    """{key: sum of count * row[key]} over rows weighted by counts."""
    return {k: sum(n * rows[s][k] for s, n in counts.items()) for k in keys}


TIMES = ("ms", "plain_ms", "bytes_ms", "operations_ms", "library_ms")
PREPASS = ("prepass_ms", "prepass_bound_ms", "prepass_library_ms")


def _entry(name, source, sums, **extra):
    bound_ms, bound_by = bound(sums["bytes_ms"], sums["operations_ms"])
    return {"name": name, "route": "cuda",
            "source": f"ensemble_svs_with_interactions_tpu_torch/csrc/{source}",
            **extra, "ms": sums["ms"], "plain_ms": sums["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": sums["library_ms"]}


def kernels_line(kernel_rows, train_rows, slice_launches, train_launches):
    """One entry per kernel.  ``launches`` counts the kernel's launches in
    the paths' runs (N_CALLS svs_ensemble calls, TRAIN_STEPS train steps).
    The recurrence's times, bound and yardstick are summed over one
    svs_ensemble call's launches (LAUNCHES_BY_HIDDEN), with the same sums
    over one train step (TRAIN_LAUNCHES_BY_SHAPE, the want_c mode) under
    ``train_step``; the BPTT and dW_h kernels' are summed over one train
    step, the BPTT's with the part its gate pre-pass takes (``prepass_ms``,
    with its bound and its ``torch.addmm`` yardstick) and the bound of its
    reverse loop alone (``loop_bound_ms``).  All come from the kernel
    phases' rows; the recurrence's training-shape yardstick is cuDNN's
    forward, which gives no cell sequence."""
    serving = {H: kernel_rows[(H, False)] for H in RECURRENCE_SHAPES}
    serve = _sum_rows(serving, LAUNCHES_BY_HIDDEN,
                      TIMES + ("library_input_gemm_ms",))

    def train_sums(name, want_c=None, keys=TIMES):
        rows = {s: train_rows[name, *s, want_c]
                for s in TRAIN_LAUNCHES_BY_SHAPE}
        return _sum_rows(rows, TRAIN_LAUNCHES_BY_SHAPE, keys), rows

    fwd, _ = train_sums("lstm_recurrence", True)
    fwd_bound = bound(fwd["bytes_ms"], fwd["operations_ms"])
    bptt, bptt_rows = train_sums("lstm_bptt", keys=TIMES + (
        "library_input_gemm_ms", "loop_bound_ms") + PREPASS)
    dwh, dwh_rows = train_sums("lstm_dwh")
    rec_err = max(r["max_abs_err"] for r in list(kernel_rows.values())
                  + [r for k, r in train_rows.items()
                     if k[0] == "lstm_recurrence"])
    per_step = TRAIN_LAUNCHES_PER_STEP
    return {"kernels": [
        _entry("lstm_recurrence", "lstm_recurrence.cu", serve,
               replaces="ensemble_svs_with_interactions_tpu/ops/pallas_lstm.py:30",
               launches=slice_launches + train_launches["lstm_recurrence"],
               launches_by_path={"svs_ensemble": slice_launches,
                                 "train": train_launches["lstm_recurrence"]},
               calls=N_CALLS, launches_per_call=slice_launches // N_CALLS,
               train_steps=TRAIN_STEPS, launches_per_step=per_step,
               max_abs_err=rec_err,
               kernel_by_shape={
                   **{f"svs H={H}": serving[H]["kernel"]
                      for H in RECURRENCE_SHAPES},
                   **{f"train H={H} T={T}":
                      train_rows["lstm_recurrence", H, T, True]["kernel"]
                      for H, T in TRAIN_LAUNCHES_BY_SHAPE}},
               library_input_gemm_ms=serve["library_input_gemm_ms"],
               train_step={"ms": fwd["ms"], "plain_ms": fwd["plain_ms"],
                           "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1],
                           "library_ms": fwd["library_ms"]}),
        _entry("lstm_bptt", "lstm_bptt.cu", bptt,
               replaces="ensemble_svs_with_interactions_tpu/ops/pallas_lstm.py:139",
               launches=train_launches["lstm_bptt"], calls=TRAIN_STEPS,
               launches_per_step=per_step,
               max_abs_err=max(r["max_abs_err"] for r in bptt_rows.values()),
               library_input_gemm_ms=bptt["library_input_gemm_ms"],
               loop_bound_ms=bptt["loop_bound_ms"],
               **{k: bptt[k] for k in PREPASS}),
        _entry("lstm_dwh", "lstm_bptt.cu", dwh,
               replaces="ensemble_svs_with_interactions_tpu/ops/pallas_lstm.py:139",
               launches=train_launches["lstm_dwh"], calls=TRAIN_STEPS,
               launches_per_step=per_step,
               max_abs_err=max(r["max_abs_err"] for r in dwh_rows.values()),
               max_rel_err=max(r["max_rel_err"] for r in dwh_rows.values())),
    ]}


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
    train_rows = phase_train_kernels(lr)

    weights = random_state_dicts(flagship_phases()[1], SEED)
    labels = [hts.load(FIXTURE) for _ in range(N_TRACKS)]
    engine, launches = phase_slice(lr, weights, labels)
    phase_packed(engine, weights, labels)
    phase_reference(engine, weights, labels)
    del engine
    train_launches = phase_train(lr)
    phase_train_reference()
    emit(kernels_line(kernel_rows, train_rows, launches, train_launches))
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
