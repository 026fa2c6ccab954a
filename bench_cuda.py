"""Serving benchmark of the PyTorch/CUDA port: ``bench.py``'s workload on
one NVIDIA GPU, through the port's normal entry point.

    python3 bench_cuda.py

The flagship of ``bench.py`` at its widths (``chip_smoke.flagship_phases``:
the MultiTrackVariancePredictor timing models and the
MultiTrackMultistreamSeparateF0ParametricModel acoustic model) gets random
torch weights from seed 0, is written by ``utils/packing.pack_model`` into
a temporary directory and opened by ``SPSVS(model_dir)``.  Four copies of
``tests/data/nit_song070/nitech_jp_song070_f001_004.lab`` (31.2 s) render
as a pairwise ring: one warm-up call, then 7 timed calls (host clock
around a call that ends in a host copy of the int16 audio), then one call
with ``blocked_stage_times=True``.

Prints ONE JSON line: the median RTF under
``metric: "rtf_4part_flagship_multitrack_48k"``, every run's seconds, the
audio seconds, the median run's ``last_stage_times``, the blocked run's,
the LSTM kernel launches per call and the kernel each width ran, the peak
device memory, the pack and load seconds, and the card's name and power
limit as ``nvidia-smi`` gives them.  No TPU number is a target here.

``--single-track`` measures single-singer serving instead: the stock
single-track voice (``chip_smoke.single_phases``: the JAX package's
``configs/acoustic/acoustic_multistream_ar_f0.yaml`` and
``{timelag,duration}_vp_mdn.yaml`` at their widths, random weights from
seed 0) packed and opened the same way renders one copy of the fixture
through ``SPSVS.svs``: one warm-up call, then 7 timed calls.  Its line
carries the median RTF under ``metric: "rtf_single_track_48k"``, the
median run's ``last_stage_times``, ``load_sec`` and the same device keys.
``--post-filter nnsvs`` packs the voice with the merged learned
postfilter (``chip_smoke.postfilter_config``: the JAX package's
``configs/postfilter/postfilter_{mgc,bap}.yaml`` stream filters, random
weights from seed 3) and renders with ``post_filter_type="nnsvs"``; the
metric is then ``rtf_single_track_nnsvs_48k``.

``--acoustic diffusion`` renders the same 4-part ring with the recipe's
diffusion ensemble voice instead (``chip_smoke.diffusion_phases``: the JAX
package's ``configs/acoustic/multitrack_acoustic_npss_diff_mgcbap.yaml``
at its widths, two 100-step DDPM chains, with the flagship's timing
models, random weights from seed 0, speakers 0, 1, 2, 0 of its 3): the
same calls and keys, the median RTF under
``metric: "rtf_4part_diffusion_multitrack_48k"``.

``--vocoder usfgan`` renders the flagship's ring with the recipe's neural
vocoder instead of WORLD: the flagship packed with
``chip_smoke.vocoder_phase`` (the JAX package's
``configs/vocoder/vocoder_parallel_hn_usfgan.yaml`` generator at its
widths, random weights from seed 4, a seeded in-scaler), the same calls
and clock with ``vocoder_type="usfgan"``, the median RTF under
``metric: "rtf_4part_flagship_usfgan_48k"``, and each timed call's
generator device time (CUDA events, ``vocoder_ms_all``) beside its
float32 bound (``vocoder_bound``, ``chip_smoke.vocoder_bound``).

``--device cpu --tiny`` (narrow widths, the first seconds of the fixture,
one timed call and no warm-up; the diffusion chains TINY_CHAIN_STEPS
long) exists for
the CPU test only: it reports no device metric.  Without a card, the
default device fails.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time

import numpy as np
import torch

import chip_smoke
from chip_smoke import FIXTURE, N_TRACKS, SEED

METRIC = "rtf_4part_flagship_multitrack_48k"
DIFFUSION_METRIC = "rtf_4part_diffusion_multitrack_48k"
USFGAN_METRIC = "rtf_4part_flagship_usfgan_48k"
SINGLE_METRIC = "rtf_single_track_48k"
POSTFILTER_METRIC = "rtf_single_track_nnsvs_48k"
WARMUP_CALLS = 1
TIMED_CALLS = 7
TINY_CALLS = 1
TINY_SECONDS = 4.0
TINY_CHAIN_STEPS = 4


def load_labels(tiny: bool):
    from ensemble_svs_with_interactions_tpu_torch.io import hts

    labels = hts.load(FIXTURE)
    if tiny:
        n = next(i for i, e in enumerate(labels.end_times)
                 if e > TINY_SECONDS * 1e7)
        labels = labels[:n]
    return labels


def card_info(device: torch.device) -> dict:
    """The device the numbers were taken on; ``nvidia-smi``'s name and power
    limit on a card."""
    if device.type != "cuda":
        return {"device": "cpu", "kind": "cpu", "count": 0, "card": None}
    return {"device": "cuda", "kind": torch.cuda.get_device_name(device),
            "count": torch.cuda.device_count(),
            "card": chip_smoke.card_line()}


def bench_device(name: str) -> torch.device:
    """The device to measure on; the card unless the CPU is asked for, and
    no card raises rather than measure the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the bench measures the card; "
                           "--device cpu is for its CPU test")
    return device


def sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(device: torch.device, tiny: bool, acoustic: str = "flagship",
        vocoder: str = "world") -> dict:
    """The 4-part ring with the flagship's acoustic model or, for
    ``acoustic="diffusion"``, the recipe's diffusion voice; WORLD or, for
    ``vocoder="usfgan"``, the recipe's neural vocoder packed beside the
    flagship."""
    from ensemble_svs_with_interactions_tpu_torch.ops import (
        lstm_recurrence as lr,
    )
    from ensemble_svs_with_interactions_tpu_torch.svs import SPSVS

    diffusion = acoustic == "diffusion"
    if diffusion:
        glob, phases = chip_smoke.diffusion_phases(
            tiny=tiny, k_step=TINY_CHAIN_STEPS if tiny else None)
        spk_ids = chip_smoke.DIFFUSION_SPK_IDS
    else:
        glob, phases = chip_smoke.flagship_phases(tiny=tiny)
        spk_ids = list(range(N_TRACKS))
    neural = vocoder != "world"
    if neural:
        glob, phases = chip_smoke.with_vocoder((glob, phases), tiny)
    weights = chip_smoke.random_state_dicts(phases, SEED)
    with tempfile.TemporaryDirectory() as model_dir:
        t0 = time.perf_counter()
        chip_smoke.pack_phases(model_dir, glob, phases, weights)
        pack_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        engine = SPSVS(model_dir, device=device)
        sync(device)
        load_s = time.perf_counter() - t0
    on_device = all(p.device.type == device.type for m in (
        engine.timelag_model, engine.duration_model, engine.acoustic_model)
        for p in m.module.parameters())
    labels = load_labels(tiny)
    log = []
    timed = neural and device.type == "cuda"
    if timed:
        chip_smoke.time_vocoder(engine.vocoder.module, log)

    def call(**kw):
        return engine.svs_ensemble([labels.copy() for _ in range(N_TRACKS)],
                                   vocoder_type=vocoder, spk_ids=spk_ids,
                                   **kw)

    def vocoder_ms():
        return chip_smoke.vocoder_ms(log) if timed else None

    warmups = 0 if tiny else WARMUP_CALLS
    t0 = time.perf_counter()
    for _ in range(warmups):
        call()
    warmup_s = time.perf_counter() - t0
    vocoder_ms()

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    chip_smoke.reset_launches(lr)
    times, stages, voc_ms = [], [], []
    calls = TINY_CALLS if tiny else TIMED_CALLS
    for _ in range(calls):
        t0 = time.perf_counter()
        wavs, sr = call()
        times.append(time.perf_counter() - t0)
        stages.append(dict(engine.last_stage_times))
        voc_ms.append(vocoder_ms())
    launches = lr.lstm_recurrence.launches
    peak = (torch.cuda.max_memory_allocated(device) / 2 ** 30
            if device.type == "cuda" else None)
    call(blocked_stage_times=True)
    blocked = dict(engine.last_stage_times)
    vocoder_ms()

    order = int(np.argsort(times)[len(times) // 2])
    audio_s = len(wavs[0]) / sr
    widths = sorted({m.w_h.shape[0] for m in engine.acoustic_model.module
                     .modules() if hasattr(m, "w_h")})
    hop = int(engine.sample_rate * engine.frame_period / 1000)
    return {
        "metric": (DIFFUSION_METRIC if diffusion else USFGAN_METRIC
                   if neural else METRIC),
        "value": times[order] / audio_s, "unit": "ratio",
        "acoustic": acoustic, "spk_ids": spk_ids, "vocoder": vocoder,
        "vocoder_ms_all": voc_ms if timed else None,
        "vocoder_bound": (chip_smoke.vocoder_bound(
            engine.vocoder.module, [len(w) // hop for w in wavs],
            chip_smoke.VOCODER_SIGNALS, hop) if neural else None),
        "all_runs_sec": times, "audio_seconds": audio_s,
        "rtf_all": [t / audio_s for t in times], "calls": calls,
        "warmup_calls": warmups, "warmup_sec": warmup_s,
        "stages_sec": stages[order], "stages_blocked_sec": blocked,
        "lstm_launches_per_call": launches / calls,
        "lstm_kernel_by_hidden": (
            {str(H): lr.lstm_recurrence_kernel_name(N_TRACKS, H)
             for H in widths} if device.type == "cuda" else None),
        "peak_mem_gib": peak, "pack_sec": pack_s, "load_sec": load_s,
        "weights_on_device_before_first_call": on_device,
        "wav_lengths": [len(w) for w in wavs], "tracks": N_TRACKS,
        "fixture": FIXTURE.name, "tiny": tiny,
        **card_info(device),
    }


def run_single(device: torch.device, tiny: bool,
               post_filter: str = "gv") -> dict:
    """``--single-track``: the stock single-track voice through
    ``SPSVS.svs(post_filter_type=post_filter)``, packed with the learned
    postfilter for ``nnsvs``."""
    from ensemble_svs_with_interactions_tpu_torch.ops import (
        lstm_recurrence as lr,
    )
    from ensemble_svs_with_interactions_tpu_torch.svs import SPSVS

    glob, phases = chip_smoke.single_phases(
        tiny=tiny, postfilter=post_filter == "nnsvs")
    weights = chip_smoke.random_state_dicts(phases, SEED)
    with tempfile.TemporaryDirectory() as model_dir:
        t0 = time.perf_counter()
        chip_smoke.pack_phases(model_dir, glob, phases, weights)
        pack_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        engine = SPSVS(model_dir, device=device)
        sync(device)
        load_s = time.perf_counter() - t0
    labels = load_labels(tiny)
    warmups = 0 if tiny else WARMUP_CALLS
    t0 = time.perf_counter()
    for _ in range(warmups):
        engine.svs(labels.copy(), post_filter_type=post_filter)
    warmup_s = time.perf_counter() - t0

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    chip_smoke.reset_launches(lr)
    times, stages = [], []
    calls = TINY_CALLS if tiny else TIMED_CALLS
    for _ in range(calls):
        t0 = time.perf_counter()
        wav, sr = engine.svs(labels.copy(), post_filter_type=post_filter)
        times.append(time.perf_counter() - t0)
        stages.append(dict(engine.last_stage_times))
    by_width = dict(lr.lstm_recurrence.launches_by_width)
    peak = (torch.cuda.max_memory_allocated(device) / 2 ** 30
            if device.type == "cuda" else None)
    order = int(np.argsort(times)[len(times) // 2])
    audio_s = len(wav) / sr
    return {
        "metric": (POSTFILTER_METRIC if post_filter == "nnsvs"
                   else SINGLE_METRIC),
        "value": times[order] / audio_s, "post_filter_type": post_filter,
        "postfilter_packed": engine.postfilter_model is not None,
        "unit": "ratio", "all_runs_sec": times, "audio_seconds": audio_s,
        "rtf_all": [t / audio_s for t in times], "calls": calls,
        "warmup_calls": warmups, "warmup_sec": warmup_s,
        "stages_sec": stages[order],
        "lstm_launches_per_call": lr.lstm_recurrence.launches / calls,
        "lstm_launches_by_hidden": {str(H): n / calls
                                    for H, n in sorted(by_width.items())},
        "lstm_kernel_by_hidden": (
            {str(H): lr.lstm_recurrence_kernel_name(1, H) for H in by_width}
            if device.type == "cuda" else None),
        "peak_mem_gib": peak, "pack_sec": pack_s, "load_sec": load_s,
        "dtype": str(wav.dtype), "fixture": FIXTURE.name, "tiny": tiny,
        **card_info(device),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--tiny", action="store_true",
                   help="narrow widths and a short input (CPU test only)")
    p.add_argument("--single-track", action="store_true",
                   help="single-singer serving through SPSVS.svs")
    p.add_argument("--post-filter", choices=("gv", "nnsvs"),
                   help="with --single-track: svs()'s post_filter_type "
                        "(default gv); nnsvs packs the learned postfilter")
    p.add_argument("--acoustic", choices=("flagship", "diffusion"),
                   default="flagship",
                   help="the 4-part ring's acoustic model: the flagship's "
                        "or the recipe's diffusion voice")
    p.add_argument("--vocoder", choices=("world", "usfgan"),
                   default="world",
                   help="the flagship ring's vocoder: WORLD or the "
                        "recipe's packed hn-uSFGAN")
    args = p.parse_args(argv)
    device = bench_device(args.device)
    if args.vocoder != "world" and (args.single_track
                                    or args.acoustic != "flagship"):
        p.error("--vocoder is for the flagship's 4-part ring")
    if args.single_track:
        if args.acoustic != "flagship":
            p.error("--acoustic is for the 4-part ring")
        out = run_single(device, args.tiny, args.post_filter or "gv")
    elif args.post_filter:
        p.error("--post-filter needs --single-track")
    else:
        out = run(device, args.tiny, args.acoustic, args.vocoder)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
