"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper).

    python3 chip_smoke.py

Drives the port's paths at the verbatim widths of the flagship (random
weights from a seeded generator): serving, the 4-part pairwise ensemble
through ``SPSVS.svs_ensemble`` as ``bench.py`` runs it, and one pair
through the per-pair API the recipe's synthesis stage calls; the same
ensemble with the recipe's diffusion voice (two DDPM spectral chains) and
with the recipe's neural vocoder (hn-uSFGAN), and that vocoder's
training (its GAN step, its CLI and the recipe's stage-10 pack);
single-singer serving through ``SPSVS.svs`` on the stock single-track
voice, with GV, the learned postfilter, the merlin postfilter and uncoded
WORLD features; and training, the multitrack acoustic train step as ``bench_train.py`` runs
it, in float32 and in the recipe's bf16 AMP arm, the duration model's
train step, and the recipe's three training phases through the trainers,
from feature dumps to a packed voice; and the recipe end to end: its data
stages (corpus preparation, features with the native WORLD analysis,
scalers) on the host, then its runner's training, packing, synthesis,
vocoder and timing-evaluation stages on the card; and the single-track
recipe with its learned postfilter trained and merged (stages 0 to 9),
then its acoustic phase with the NPSS voices trained, packed and served;
a reference NNSVS voice converted by the importer and served; and the mel
voice (log-mel features, a DDPM mel decoder, the mel
postfilter and the hn-uSFGAN on the mel) served and trained.
It holds every hand-written kernel of those paths against its plain
PyTorch version on the card.  Phases, each printing JSON lines:

1. the card (``nvidia-smi`` name and power limit) and the kernel build
   (one ``nvcc`` per source, run at once);
2. ``kernel``: the LSTM recurrence kernel against its plain version at the
   serving shapes (B = 4, T = 6656, H = 62, 64, 256, 512, and the
   diffusion voice's 128), with and without
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
6a. ``kernel_b1`` (run with phase 2): the recurrence at B = 1, T = 6656,
   the shapes single-singer serving gives it;
6b. ``pairwise``: the flagship's per-pair path (``svs_pair``, as
   ``bin/synthesis_multitrack.py``'s ``svs_multitrack``: timing each way,
   the main track's acoustic features at B = 1, the host postprocess,
   WORLD, the waveform's postprocess) on the fixture paired with itself
   sung 15.25 ms late, three timed pairs with the launch counts reset
   just before and read just after; then the card against the CPU over
   the first 60 labels: timing each way exactly, the modules on the
   pair's input as phase ``reference`` holds them;
6c. ``single``: the stock single-track voice (the JAX package's
   ``configs/acoustic/acoustic_multistream_ar_f0.yaml`` and
   ``{timelag,duration}_vp_mdn.yaml`` at their widths, seeded random
   weights), packed with the merged learned postfilter
   (``postfilter_config``) and opened by ``SPSVS(model_dir)``, three timed
   ``svs()`` calls on the fixture with the launch counts by width reset
   just before and read just after, one float32 call, one with segmented
   synthesis and one ``svs_ensemble`` of 4 copies (the single-track
   branch);
6d. ``single_reference``: the same pack opened on the CPU against the
   card on the first 60 labels: durations, modules, the AR lf0 decoder
   against a float64 oracle and the postprocessed streams;
6e. ``postfilter``: three timed ``svs(post_filter_type="nnsvs")`` calls
   (launch counts as phase ``single``), the postfilter's device time alone
   beside its bound, the module on the card against the CPU on the same
   input and noise, and the postprocessed streams against the CPU engine
   over the first 60 labels;
6f. ``world_params``: ``svs()`` with the merlin postfilter, with
   ``use_world_codec: false`` and on a voice predicting 25-dim
   mel-cepstral aperiodicity, each call's streams through
   ``predict_waveform`` on the card and on the CPU with the same noise,
   held at 40 dB SNR;
6g. ``diffusion``: the recipe's diffusion ensemble voice
   (``diffusion_phases``: the JAX package's
   ``configs/acoustic/multitrack_acoustic_npss_diff_mgcbap.yaml`` at its
   widths with the flagship's timing models, 3 singers) packed and opened
   by ``SPSVS(model_dir)``, a warm-up, then three timed ``svs_ensemble``
   calls on 4 copies of the fixture with the launch counts by width reset
   just before and read just after (DIFFUSION_LAUNCHES_BY_HIDDEN a call),
   each chain's device time (CUDA events) beside the chains' float32
   bound (``chain_bound``), the peak memory, a call with blocked stage
   times, and one call with TF32 allowed in the chains (its time and its
   acoustic output's distance from float32);
6h. ``diffusion_reference``: the same pack on the CPU against the card
   on one track over one 512-frame bucket: timing each way exactly, the
   AR lf0 decoder against a float64 oracle, the mgc and bap chains (the
   card's noise replayed on the CPU) and the vuv model at MODULE_ATOL, and
   the rendered pair at SNR_DB;
6i. ``vocoder``: the flagship packed with the recipe's neural vocoder
   (``vocoder_phase``: the JAX package's
   ``configs/vocoder/vocoder_parallel_hn_usfgan.yaml`` generator at its
   widths, seeded random weights and in-scaler) and opened by
   ``SPSVS(model_dir)``, whose ``"auto"`` vocoder is ``usfgan``; a
   warm-up, then three timed ``svs_ensemble(vocoder_type="auto")`` calls
   on 4 copies of the fixture with the launch counts reset just before
   each and read just after, the generator's device time (CUDA events)
   beside its float32 bound (``vocoder_bound``), the stages and the peak
   memory; one ``svs()`` of the single-track voice with the same vocoder
   and one flagship pair, both with ``"auto"``;
6j. ``vocoder_reference``: the same pack on the CPU against the card over
   the first VOCODER_REF_LABELS labels as a pair's main track: identical streams into
   both ``predict_waveform``s, the generator's output within
   VOCODER_RTOL of its peak and the waveform at VOCODER_SNR_DB; the PWG,
   SiFiGAN, HiFiGAN and a narrowed hn-uSFGAN generator card against CPU;
6k. ``vocoder_train``: the recipe's vocoder training at full width, the
   JAX package's ``configs/vocoder/vocoder_parallel_hn_usfgan.yaml``
   verbatim (``vocoder_train_config``) on a synthetic corpus written on
   the host (``write_vocoder_corpus``): VOCODER_TRAIN_WARMUP warm-up and
   VOCODER_TRAIN_STEPS GAN steps of 8 x 15,360 samples timed by CUDA
   events, the peak memory, one profiled step and the step's operation
   bound (``vocoder_train_bench``, which ``bench_train_cuda.py
   --vocoder`` runs); then ``bin/train_vocoder.py`` for 1 epoch of
   VOCODER_CLI_STEPS steps, its ``best_loss.ckpt`` packed by the stage-10
   step (``train/vocoder_trainer.pack_vocoder``) into the single-track
   voice's pack, opened by ``SPSVS(model_dir)`` (``"auto"`` is
   ``usfgan``) and one ``svs()`` of VOCODER_REF_LABELS labels, its launch
   counts reset just before and read just after;
6l. ``vocoder_train_reference``: one GAN step of hn-uSFGAN (UnivNet
   discriminators, mel and source losses), SiFiGAN (HiFiGAN multi-scale
   multi-period, feature matching) and PWG at tiny widths
   (``tiny_vocoder_trainings``), card against CPU in float32 and float64
   (``hold_gan_step``);
6m. ``surface`` (run right after ``world_params``, on its engines): the
   score-to-audio surface over the stock single-track voice: the
   packaged example MusicXML and UST scores through
   ``frontend.load_score`` and the ``NEUTRINO`` engine on the card
   (timing, phraselist, f0/mgc/bap, the ``NSF`` waveform); N_CALLS timed
   ``SPSVS.svs_streaming`` calls on the fixture (seconds to the first
   chunk, RTF) with the launch counts by width reset just before and
   read just after each (LAUNCHES_BY_HIDDEN a segment); one call at
   depth 1, bitwise equal to depth 2's; one with the learned postfilter
   (cuDNN's TF32 switch off after it); the first SURFACE_REF_SEGMENTS
   chunks against the CPU engine with the card's noise; the HTTP server
   (``bin/neutrino_server.py``) in a thread: /healthcheck, /timing,
   /acoustic, /waveform and /stream alone and SURFACE_STREAMS at once,
   each equal to a serial render; ``bin/run_svs.main`` through
   ``pretrained.register_model``;
6n. ``importer`` (after ``pairwise``): a reference NNSVS pack in the
   published tarballs' layout (``write_reference_pack``: the shipped
   ``timelag_mdn.yaml``, ``duration_mdn.yaml`` and
   ``acoustic_resf0convlstm.yaml`` at full width under the reference's
   ``_target_`` names, seeded ``torch.nn`` layers in the reference's names)
   converted by ``bin/enunu2nnsvs.convert_nnsvs_pack`` and served by
   ``SPSVS(voice_dir)``: the weights bitwise the reference's, N_CALLS
   ``svs()`` calls with the launches by width reset just before and read
   just after each (IMPORTER_LAUNCHES_BY_HIDDEN), card against CPU;
   ``bin/generate.py`` on the card and the CPU; the device MLPG against
   the host path at MLPG_T x MLPG_D; ``postfilter_sp.yaml`` and
   ``vocoder_hifigan.yaml`` at the shipped widths (a forward and one GAN
   step each, card against CPU with a float64 oracle); ``bin/anasyn.py``
   card against CPU;
6o. ``parallel`` (after ``pairwise``, on its engine): the 4-part
   ensemble under ``set_mesh(make_mesh())`` (bitwise the one-device
   render on one card) and over a PAR_WORLD-entry mesh of cuda:0 (streams
   within PAR_STREAM_ATOL, int16 waveforms by the JAX tests' bound,
   launches per shard); one track's streams through
   ``synthesize_from_streams_time_sharded`` over PAR_WORLD shards of
   cuda:0 against one device (SNR, seconds); the flagship's train step at
   full width on PAR_WORLD processes sharing the card over gloo (a global
   batch of PAR_B x TRAIN_T, mixed lengths and a padding row, PAR_STEPS
   SGD steps) against one process on the whole batch (loss and summed
   update by the train step's rule, 46 launches of each kernel a step on
   each rank); ``train_multitrack_model`` for one epoch in a process of
   its own under an NCCL group of one rank, bitwise the run with no group
   (``tools/chip_parallel.py`` runs the phase alone);
7. ``train``: ``bench_train.py``'s workload, 64 pairs x 256 frames with
   Adam, 2 warm-up steps and TRAIN_STEPS timed ones with the launch counts
   reset just before and read just after, then one step split into
   forward, backward and optimizer and one under ``FlopCounterMode``
   (``train_bench``, which ``bench_train_cuda.py`` runs too);
8. ``train_reference``: one step at full width without dropout, B = 4,
   on the card against the same step on the CPU (loss, every gradient,
   the new batch statistics);
9. ``train_amp``: phase 7 in the bf16 AMP arm (``use_amp=True``; the LSTM
   recurrences stay float32 on the same kernels, 46 launches per step
   each), its MFU over the dense bf16 peak, and one step under
   ``torch.profiler`` where no other recurrence kernel may appear;
10. ``train_amp_reference``: phase 8's step in the AMP arm, card against
    CPU, and the card's AMP loss against its float32 loss;
11. ``timing_train``: the duration model at ``bench.py``'s widths in the
    AMP arm on 64 note-merged pairs x 500 positions (2 warm-up and
    TRAIN_STEPS timed steps), then one small step card against CPU;
11a. ``trainer``: the recipe's timelag, duration and acoustic phases
    (the acoustic one as shipped and with the interaction weights at 1)
    through ``train_multitrack_model``, and the single-track voice's
    acoustic model through ``train_model``, at full width on a synthetic
    3-singer corpus (TRAINER_CORPUS, SMOKE_TRAINER_EPOCHS epoch), one line per
    run with the launch counts reset just before and read just after, and
    for the acoustic runs each kernel held against its plain version at
    the run's own batch shapes (``hold_trainer_kernels``);
    then ``trainer_render``: the trained acoustic and timing checkpoints
    packed by ``pack_model``, one pair rendered through
    ``SPSVS(model_dir)``, and the first dev loss from one start
    checkpoint, card against CPU;
11b. ``recipe_data``: the recipe's data stages on the port, on the host:
    a 48 kHz jaCappella-layout corpus (``write_jacappella_corpus``: the
    recipe's 3 singers x 3 songs of RECIPE_SONG_S s, one singer's wavs
    24-bit) through ``bin/run_recipe.main`` on the shipped recipe with
    ``--stage -1 --stop-stage 2``, only paths and song lists overridden
    (``recipe_data_overrides``); each stage's wall seconds, stage 1's
    seconds per second of audio with the native WORLD analysis and again
    with NumPy (``ESVS_DISABLE_NATIVE=1``, the same lists), the largest
    native-against-NumPy difference per dump kind within the analysis's
    tolerances (``native_vs_numpy``), and the counts of segments, dumps
    and scaler files; it fails if the native library did not build;
11c. ``recipe``: the recipe's stages 3-7, 10 and 11 through
    ``bin/run_recipe.main`` on that work directory, on the card, at the
    shipped models' full widths (``recipe_overrides``: RECIPE_EPOCHS epochs
    a phase, the timing models' ``in_dim`` 82, stage 7 and 11 on the eval
    song's first RECIPE_SEGMENTS segments, RECIPE_VOCODER_STEPS vocoder
    steps): each stage's seconds, the phases' losses, the launches over
    stages 3-5 and over 7 + 11, each kernel held at the acoustic phase's
    batch shapes, the pairs rendered and their RTF, ``QUALITY.json``;
    ``recipe_vocoder_pack``: the stage-10 pack resolves
    ``vocoder_type="auto"`` to its vocoder; ``recipe_reference``: one
    pair of stage 7 on the card against the CPU (durations, streams, SNR);
11d. ``recipe_single``: the single-track recipe with its learned
    postfilter (``single_recipe``) through ``bin/run_recipe.main`` on a
    48 kHz single-singer corpus (``write_single_corpus``: 6 utterances of
    SINGLE_SONG_S s, one dev, one eval): stages 0-2 on the host, 3-9 on
    the card with the shipped ``timelag_mdn.yaml``, ``duration_mdn.yaml``
    (``MDNv2``) and ``acoustic_resf0convlstm.yaml``
    (``ResSkipF0FFConvLSTM``, biLSTM 256 x 2) at full width, stage 9 once
    with ``postfilter_mgc.yaml`` and once with ``postfilter_bap.yaml``,
    each into its own ``train.out_dir``, then ``bin/merge_postfilters.py``
    on the two checkpoints into the pack; each stage's seconds, the
    launches by kernel over stages 3-5, 7, 8 and each stage 9, each
    kernel timed and held against its plain version at the shapes those
    stages gave it (the forward at B = 1 and the stage-8 T, the dev
    pass's; the train step's forward, BPTT and dW_h), with its bound and
    cuDNN's or ``torch.matmul``'s time; the mgc pair's GAN step at full
    width (median of PF_GAN_STEPS warm steps beside the float32 bound of
    its convolutions, peak memory) and held card against CPU on
    PF_HOLD_FRAMES frames (``hold_pf_gan``); the merged pack's
    ``svs(post_filter_type="nnsvs")`` on the eval utterance, card against
    CPU (durations, streams, SNR) and timed;
11e. ``recipe_npss``: the NPSS voices on that recipe (``npss_recipe``:
    its corpus, dump, scalers and timing models, each voice in its own
    work directory): stages 5-7 with the shipped
    ``acoustic_npss_ar_mgcf0bap.yaml`` (the deterministic AR cascade; its
    mgc decoder's cells at H = 1024) and then ``acoustic_npss_mdn.yaml``
    at their widths, each stage timed, the launches counted over 5
    (NPSS_STEP_LAUNCHES a train step and dev batch) and over 7
    (NPSS_SVS_LAUNCHES); one train step of each voice card against CPU in
    float32 (also with cuDNN off) and in the AMP arm (``hold_npss_step``)
    and its ``svs()`` of
    the eval utterance card against CPU; the H = 1024 forward, BPTT and
    dW_h timed and held against their plain versions at stage 5's shapes
    and at the recipe's full batch, with bounds (the forward's also at
    the 3xTF32 rate its kernel uses) and cuDNN's times, and the forward
    at 200 rows (NPSS_WIDE_B) and the BPTT at NPSS_BPTT_WIDE_B rows;
11h. ``ar_options``: the AR decoder options on the same recipe
    (``ar_option_voice``): stages 5-7 of two voices that
    ``ar_option_netg`` builds from ``acoustic_npss_ar_mgcf0bap.yaml``,
    ``npss_ar_tacotron`` (every AR decoder with a 2-layer pre-net and
    zoneout 0.1, so its teacher-forced cells step in PyTorch) and
    ``npss_mdn_ar`` (the MDN cascade, pre-nets on, zoneout 0), each stage
    timed, the launches counted over 5 and 7 and checked against
    ``ar_option_launches`` of the packed model, a train step card against
    CPU with every mask on (one CPU generator) and ``svs()`` of the eval
    utterance card against CPU;
11f. ``mel_voice``: the mel voice (``mel_phases``: the JAX package's
    ``configs/acoustic/acoustic_melf0_ar_f0_diff_mel.yaml``,
    ``configs/postfilter/postfilter_mel.yaml`` and the recipe's
    hn-uSFGAN at ``aux_channels`` 80, with ``timelag_mdn.yaml`` and
    ``duration_mdn.yaml``, at their widths, seeded random weights) packed
    and opened by ``SPSVS(model_dir)``: ``svs()`` of the fixture under
    ``gv`` and under ``nnsvs`` with the launch counts by width reset just
    before and read just after each (MEL_LAUNCHES_BY_HIDDEN); the card
    against the CPU on its first MEL_REF_SECONDS with the card's chain
    noise replayed (durations, streams, SNR); the recurrence at B = 1 over
    the fixture at H = 64 and 128 and the train step's kernels at its
    shapes (MEL_TRAIN_LAYERS, B = 4) against their plain versions; the
    voice through the single-track trainer on a synthetic corpus
    (launches MEL_STEP_LAUNCHES a step and dev batch); one train step of
    it and of ``acoustic_diffusion_melf0.yaml`` and
    ``acoustic_flowmatching_melf0.yaml`` card against CPU;
11g. ``multi_speaker``: the multi-speaker voice (the JAX package's
    ``configs/acoustic/multi_speaker_acoustic_multistream_ar_f0.yaml`` at
    its widths): the train step's kernels at its new shapes
    (MULTI_SPEAKER_NEW_SHAPES, B = 4) against their plain versions; one
    train step of it (float32, AMP) and of each ZOO_STEP_CONFIGS model
    card against CPU; ``bin/train_acoustic_multi.py`` on a synthetic
    three-singer corpus from a fixed start (launches
    MULTI_SPEAKER_STEP_LAUNCHES a step and dev batch); the checkpoint
    packed and two speakers rendered over the fixture through
    ``gen.predict_acoustic(spk=k)``, the host postprocess and WORLD, the
    launch counts by width reset just before and read just after each
    (MULTI_SPEAKER_LAUNCHES_BY_HIDDEN), each against the CPU (SNR);
12. a ``kernels`` line, the card line, and last ``{"ok": true, ...}``.

``bench_cuda.py`` and ``bench_train_cuda.py`` share this file's flagship
and diffusion configs, weights and kernel operation counts.

Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.  Imports nothing of JAX or the JAX package.
"""

from __future__ import annotations

import copy
import inspect
import json
import shutil
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
PEAK_BF16_FLOP_PER_S = 989e12  # bf16 tensor cores

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
# the relative change of the weights (seeded, normal) by which a step's
# kinks are measured where they answer rounding: the flax-scheme
# multi-speaker voice's float32 step has ReLUs near zero whose flips move
# its decoders' conv-stack gradients by up to 3.4% of their scale (the
# card's cuDNN-off step parts from the CPU's by as much); at 1e-5 every
# such gradient moves, the kink-free ones by under 2e-4 of their scale
NUDGE_RTOL = 1e-5
TRAIN_STATS_ATOL = 1e-4
# the AMP arm (bf16 forward and backward over float32 masters, the LSTM
# recurrences float32): one step at REF_B, card against CPU, dropout off.
# The loss within AMP_LOSS_RTOL; each gradient by ``judge_amp``: within
# AMP_GRAD_RTOL of its scale, max(its largest CPU entry,
# AMP_GRAD_SCALE_FLOOR x the largest gradient entry), or, where two bf16
# runs of the step differ by more, pointing where the CPU's points and as
# long: cosine at least AMP_COS_MIN, L2 distance at most AMP_L2_MAX of the
# CPU's norm, and no farther from the CPU's float32 step than AR_HEADROOM
# times the CPU's AMP step (or times AMP_GRAD_RTOL of the scale); one
# that vanishes in float32 (under AMP_VANISH of the largest entry) holds
# rounding noise and passes within the floor.  Two bf16 runs differ most
# where a training-mode batch norm takes E[x^2] - E[x]^2 in bf16, as the
# JAX package computes it: the card and the CPU sum in other orders, and
# their gradients reached cosine 0.846 and an L2 distance of 0.562 of the
# norm at worst (PERF.md).
# Code on the card is held tightly by the float32 step
# (``phase_train_reference``); a zero or inverted gradient fails here.
# The card's AMP loss sits within AMP_VS_F32_RTOL of its float32 loss.
AMP_LOSS_RTOL = 1e-2
AMP_GRAD_RTOL = 5e-2
AMP_GRAD_SCALE_FLOOR = 1e-3
AMP_VANISH = 1e-6
AMP_COS_MIN = 0.8
AMP_L2_MAX = 0.65
AMP_VS_F32_RTOL = 2e-2
# the duration model's step (bench.py's widths), card against CPU on a
# small batch: float32 by the train step's rule above; AMP by
# ``judge_amp`` at TIMING_RTOL, with cosine at least TIMING_COS_MIN and
# an L2 distance at most TIMING_L2_MAX where it is farther (readings:
# 0.9918 and 0.128 at worst)
TIMING_RTOL = 2e-2
TIMING_COS_MIN = 0.98
TIMING_L2_MAX = 0.2
N_TRACKS = 4
N_CALLS = 3
# the single-track voice's streams after postprocess, card against CPU on
# valid frames (each stream a host postprocess of the acoustic features)
POST_ATOL = 1e-3
# the learned postfilter, card against CPU on the same input and noise:
# the largest difference over the output's largest entry.  Its
# convolutions run in float32 (TF32 off); in TF32 a 5 x 5 convolution over
# 129 channels sits about 5e-4 of its scale off
POSTFILTER_RTOL = 1e-4
# ...on the first frames of the fixture's input: the CPU's convolutions
# over all 6656 frames (325 GFLOP) would take seconds
POSTFILTER_REF_FRAMES = 2048
# WORLD waveforms, card against CPU from the same streams and noise: the
# vocoder's bound (tests/test_torch_world.py)
SNR_DB = 40.0
# the per-pair phase's sub track: the fixture sung 3.05 frames (15.25 ms)
# late, off the frame grid, in 100 ns units
SUB_LAG = 152500
# the mel-cepstral aperiodicity dims of the world_params phase's second
# voice (the recipe's mcep-aperiodicity packs)
MCEP_AP_DIM = 25
# single-track configurations shipped in the JAX package, read as files
CONFIGS = REPO / PKG / "configs"
# the recipes fill the lf0 fields from the data's statistics; the flagship's
SINGLE_LF0 = {"in_lf0_min": 4.72, "in_lf0_max": 6.84,
              "out_lf0_mean": float(np.log(260.0)), "out_lf0_scale": 0.24}
# single-direction LSTM recurrences per svs_ensemble call (B = 4) and per
# single-track svs call (B = 1), by hidden width (encoder 512 x 3 layers x
# 2 directions; mgc 256, lf0 64, vuv 64, bap 62 at 2 layers x 2 directions
# each)
LAUNCHES_BY_HIDDEN = {512: 6, 256: 4, 64: 8, 62: 4}
LAUNCHES_PER_CALL = sum(LAUNCHES_BY_HIDDEN.values())
RECURRENCE_SHAPES = [62, 64, 256, 512]
T_FRAMES = 6656   # 6240 frames of the fixture, rounded up to FRAME_BUCKET
# bench_train.py's geometry: 64 pairs x 256-frame crops, Adam at 1e-3
TRAIN_B, TRAIN_T = 64, 256
TRAIN_STEPS = 5
REF_B = 4
# the timing models' batches: 64 note-merged pairs x 500 positions, the
# 32,000 positions MultiTrackBatchIterator packs by default
TIMING_B, TIMING_T = 64, 500
TIMING_REF_B, TIMING_REF_T = 4, 64
# single-direction LSTM recurrences per train step, by (hidden width,
# sequence length): each track pass runs the encoder (512 x 3 x 2), the
# lf0 model's biLSTM (64 x 2 x 2) and AR decoder cell (256, at the
# reduced rate T / 4), and mgc / vuv / bap (256 / 64 / 62, 2 x 2 each);
# the main and the sub track make two passes.  Each runs the forward
# kernel (want_c), the BPTT kernel and the dW_h kernel once.
TRAIN_LAUNCHES_BY_SHAPE = {(512, 256): 12, (256, 256): 8, (256, 64): 2,
                           (64, 256): 16, (62, 256): 8}
TRAIN_LAUNCHES_PER_STEP = sum(TRAIN_LAUNCHES_BY_SHAPE.values())


_STARTED = time.time()


def emit(obj):
    """One JSON line; a phase's line also gets ``script_s``, the seconds
    since the script started."""
    if "phase" in obj:
        obj = {**obj, "script_s": time.time() - _STARTED}
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


# each phase's offset from the weights' seed
PHASE_SEEDS = {"acoustic": 0, "duration": 1, "timelag": 2, "postfilter": 3,
               "vocoder": 4}


def random_state_dicts(phases, seed: int):
    """Random weights: each phase's module built under a seeded generator
    (torch's own initializers, seed + PHASE_SEEDS[phase]), as a state
    dict."""
    from ensemble_svs_with_interactions_tpu_torch.utils.config import (
        instantiate,
    )

    out = {}
    for name, (cfg, _, _) in phases.items():
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed + PHASE_SEEDS[name])
            out[name] = instantiate(cfg["netG"]).state_dict()
    return out


def build_engine(device, weights, voice=None):
    """The engine built in memory (``SPSVS.from_parts``) from state dicts:
    the flagship's, or ``voice``, a (global config, phases) pair such as
    ``single_phases()``."""
    from ensemble_svs_with_interactions_tpu_torch.svs import SPSVS
    from ensemble_svs_with_interactions_tpu_torch.utils import (
        packaged_question_path,
    )

    glob, phases = voice or flagship_phases()
    return SPSVS.from_parts(glob, packaged_question_path(), {
        name: {"model_config": cfg, "state_dict": weights[name],
               "in_scaler": sc_in, "out_scaler": sc_out}
        for name, (cfg, sc_in, sc_out) in phases.items()
    }, device=device)


def pack_flagship(model_dir, weights, tiny: bool = False):
    """Write the flagship with the given state dicts as a packed model
    directory."""
    return pack_phases(model_dir, *flagship_phases(tiny=tiny), weights)


def pack_phases(model_dir, glob, phases, weights):
    """Write ``phases`` with the given state dicts as a packed model
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

    parts = {}
    for name, (cfg, sc_in, sc_out) in phases.items():
        module = instantiate(cfg["netG"])
        module.load_state_dict(weights[name])
        parts[name] = {"model_config": cfg, "module": module,
                       "in_scaler": sc_in, "out_scaler": sc_out}
    return pack_model(model_dir, glob, packaged_question_path(), parts)


def shipped_config(rel: str) -> dict:
    """A config file of the JAX package's ``configs/`` as plain dicts, read
    by the port's own YAML subset (a file, not an import)."""
    from ensemble_svs_with_interactions_tpu_torch.utils import yaml_io

    return json.loads(json.dumps(yaml_io.load((CONFIGS / rel).read_text())))


def postfilter_config(tiny: bool = False) -> dict:
    """The merged learned postfilter, as ``bin/merge_postfilters.py`` writes
    one: a ``MultistreamPostFilter`` over the streams (60, 1, 1, 5) whose
    ``mgc_postfilter`` is ``postfilter/postfilter_mgc.yaml``'s (a
    ``Conv2dPostFilter``: 64 channels, 5 x 5, frame-wise noise smoothed
    over 100 frames, on mgc dims 2-59) and whose ``bap_postfilter`` is
    ``postfilter/postfilter_bap.yaml``'s (32 channels, 5 x 1, bin-wise
    noise smoothed over 5).  ``tiny=True``: 4 channels each."""
    ss = [60, 1, 1, 5]
    mgc = shipped_config("postfilter/postfilter_mgc.yaml")["netG"]
    bap = shipped_config("postfilter/postfilter_bap.yaml")["netG"]
    mgc, bap = mgc["mgc_postfilter"], bap["bap_postfilter"]
    if tiny:
        mgc["channels"] = bap["channels"] = 4
    target = f"{PKG}.models.postfilters.MultistreamPostFilter"
    return {"netG": {"_target_": target, "mgc_postfilter": mgc,
                     "bap_postfilter": bap, "lf0_postfilter": None,
                     "stream_sizes": ss},
            "stream_sizes": ss, "has_dynamic_features": [False] * 4,
            "num_windows": 1}


def single_phases(tiny: bool = False, postfilter: bool = False,
                  bap_dim: int = None):
    """The stock single-track voice, (global config, {phase: (model_config,
    in_scaler, out_scaler)}): ``acoustic/acoustic_multistream_ar_f0.yaml``
    and ``{timelag,duration}/*_vp_mdn.yaml`` verbatim, the lf0 fields the
    recipe fills from data set to SINGLE_LF0, and the flagship's scalers.
    ``postfilter=True`` adds the merged learned postfilter
    (``postfilter_config``, its scaler the acoustic one's); ``bap_dim``
    makes the acoustic model predict that many aperiodicity dims (more
    than 5: mel-cepstral aperiodicity).  ``tiny=True`` narrows every width
    (TINY) for the CPU tests; the stream layout and the model classes
    stay."""
    from ensemble_svs_with_interactions_tpu_torch.utils.scalers import (
        MinMaxScaler,
        StandardScaler,
    )

    ac = shipped_config("acoustic/acoustic_multistream_ar_f0.yaml")
    tl = shipped_config("timelag/timelag_vp_mdn.yaml")
    du = shipped_config("duration/duration_vp_mdn.yaml")
    net = ac["netG"]
    if bap_dim is not None:
        ac["stream_sizes"][3] = net["stream_sizes"][3] = bap_dim
        net["out_dim"] = sum(net["stream_sizes"])
        net["bap_model"]["out_dim"] = bap_dim
    for node in (net, net["lf0_model"]):
        node.update({k: v for k, v in SINGLE_LF0.items() if node[k] is None})
    if tiny:
        w = TINY
        net["encoder"].update(embed_dim=w["embed"], hidden_dim=w["enc_hidden"],
                              out_dim=w["enc_out"], num_layers=w["enc_layers"])
        net["lf0_model"].update(
            embed_dim=w["embed"], ff_hidden_dim=w["ff"],
            conv_hidden_dim=w["conv"], lstm_hidden_dim=w["lstm"],
            decoder_hidden_dim=w["dec"])
        for k in ("mgc_model", "vuv_model", "bap_model"):
            net[k].update(in_dim=w["enc_out"] + 2, ff_hidden_dim=w["ff"],
                          conv_hidden_dim=w["conv"], lstm_hidden_dim=w["lstm"])
        for cfg in (tl, du):
            cfg["netG"].update(hidden_dim=w["tl"], num_layers=w["layers"])
    out = sum(ac["stream_sizes"])
    mgc = ac["stream_sizes"][0]
    mean = np.zeros(out)
    scale = np.ones(out) * 0.1
    mean[mgc] = np.log(260.0)
    scale[mgc] = 0.24
    glob = {"sample_rate": 48000, "frame_period": 5, "feature_type": "world",
            "use_world_codec": True, "relative_f0": False}
    phases = {
        "timelag": (tl, MinMaxScaler(np.zeros(82), np.ones(82)),
                    StandardScaler(np.zeros(1), np.ones(1) * 4,
                                   np.ones(1) * 2)),
        "duration": (du, MinMaxScaler(np.zeros(82), np.ones(82)),
                     StandardScaler(np.ones(1) * 10, np.ones(1) * 4,
                                    np.ones(1) * 2)),
        "acoustic": (ac, MinMaxScaler(np.zeros(86), np.ones(86)),
                     StandardScaler(mean, scale ** 2, scale)),
    }
    if postfilter:
        phases["postfilter"] = (postfilter_config(tiny), None,
                                StandardScaler(mean, scale ** 2, scale))
    return glob, phases


DIFFUSION_CONFIG = "acoustic/multitrack_acoustic_npss_diff_mgcbap.yaml"
# the recipe's three singers (the config's speaker_embedding.num_embeddings)
DIFFUSION_SPKS = 3


def diffusion_acoustic_config(tiny: bool = False, subtrack: bool = False,
                              k_step: int = None) -> dict:
    """The recipe's diffusion ensemble voice, ``DIFFUSION_CONFIG`` (or its
    ``_subtrack`` twin) verbatim, the lf0 fields the recipe fills from
    data set to SINGLE_LF0.  ``tiny=True`` narrows every width (TINY; the
    denoisers to 8 channels over 3 and 2 layers) for the CPU tests, and
    ``k_step`` sets both chains' length; the stream layout, the classes,
    the samplers and the 3 speakers stay."""
    rel = DIFFUSION_CONFIG.replace(".yaml", "_subtrack.yaml" if subtrack
                                   else ".yaml")
    ac = shipped_config(rel)
    net = ac["netG"]
    for node in (net, net["lf0_model"]):
        node.update({k: v for k, v in SINGLE_LF0.items() if node[k] is None})
    chains = (net["mgc_model"], net["bap_model"])
    if k_step is not None:
        for d in chains:
            d["K_step"] = k_step
    if tiny:
        w = TINY
        net["lf0_model"].update(
            embed_dim=w["embed"], ff_hidden_dim=w["ff"],
            conv_hidden_dim=w["conv"], lstm_hidden_dim=w["lstm"],
            decoder_hidden_dim=w["dec"])
        encoders = [d["encoder"] for d in chains] + [net["vuv_model"]]
        for enc in encoders:
            enc.update(embed_dim=w["embed"], ff_hidden_dim=w["ff"],
                       conv_hidden_dim=w["conv"], lstm_hidden_dim=w["lstm"])
        for d, layers in zip(chains, (3, 2)):
            d["encoder"]["out_dim"] = 8
            d["denoise_fn"].update(encoder_hidden_dim=8, residual_channels=8,
                                   residual_layers=layers)
        net["speaker_embedding"]["embedding_dim"] = w["embed"]
    return ac


def diffusion_phases(tiny: bool = False, subtrack: bool = False,
                     k_step: int = None):
    """(global config, {phase: (model_config, in_scaler, out_scaler)}) of
    the diffusion voice: ``diffusion_acoustic_config`` with the flagship's
    timing models and scalers for DIFFUSION_SPKS singers."""
    glob, phases = flagship_phases(n_spk=DIFFUSION_SPKS, tiny=tiny)
    _, sc_in, sc_out = phases["acoustic"]
    phases["acoustic"] = (diffusion_acoustic_config(tiny, subtrack, k_step),
                          sc_in, sc_out)
    return glob, phases


MULTI_SPEAKER_CONFIG = "acoustic/multi_speaker_acoustic_multistream_ar_f0.yaml"


def multi_speaker_acoustic_config(tiny: bool = False) -> dict:
    """The multi-speaker voice, ``MULTI_SPEAKER_CONFIG`` verbatim (a
    ``MultiSpeakerMultistreamSeparateF0ParametricModel``: the 512 x 3
    biLSTM encoder, the AR residual-F0 lf0 decoder, FFConvLSTM mgc / vuv /
    bap decoders at H = 256 / 64 / 64, a 17 x 256 speaker table), the lf0
    fields the recipe fills from data set to SINGLE_LF0.  ``tiny=True``
    narrows every width (TINY; the speaker table to the embedding width)
    for the CPU tests; the stream layout and the classes stay."""
    ac = shipped_config(MULTI_SPEAKER_CONFIG)
    net = ac["netG"]
    for node in (net, net["lf0_model"]):
        node.update({k: v for k, v in SINGLE_LF0.items() if node[k] is None})
    if tiny:
        w = TINY
        net["encoder"].update(embed_dim=w["embed"], hidden_dim=w["enc_hidden"],
                              out_dim=w["enc_out"], num_layers=w["enc_layers"])
        net["lf0_model"].update(
            embed_dim=w["embed"], ff_hidden_dim=w["ff"],
            conv_hidden_dim=w["conv"], lstm_hidden_dim=w["lstm"],
            decoder_hidden_dim=w["dec"])
        for k in ("mgc_model", "vuv_model", "bap_model"):
            net[k].update(in_dim=w["enc_out"] + 2, ff_hidden_dim=w["ff"],
                          conv_hidden_dim=w["conv"], lstm_hidden_dim=w["lstm"])
        net["speaker_embedding"]["embedding_dim"] = w["embed"]
    return ac


def multi_speaker_phases(tiny: bool = False):
    """(global config, {phase: (model_config, in_scaler, out_scaler)}) of
    the multi-speaker voice: ``multi_speaker_acoustic_config`` with the
    stock single-track voice's timing models and scalers
    (``single_phases``)."""
    glob, phases = single_phases(tiny=tiny)
    _, sc_in, sc_out = phases["acoustic"]
    phases["acoustic"] = (multi_speaker_acoustic_config(tiny), sc_in, sc_out)
    return glob, phases


def speaker_acoustic(gen_module, engine, labels, spk):
    """``gen_module.predict_acoustic`` (the port's ``gen``, or another
    package's of the same signature) of ``engine``'s acoustic pack on the
    timed ``labels`` for speaker ``spk``, with the options
    ``SPSVS.predict_acoustic`` passes: denormalized features (T, D)."""
    return gen_module.predict_acoustic(
        labels, engine.acoustic_model, engine.in_acoustic_scaler,
        engine.out_acoustic_scaler, engine.binary_dict, engine.numeric_dict,
        subphone_features=engine._subphone_features(),
        log_f0_conditioning=engine._log_f0_conditioning(),
        force_clip_input_features=engine._force_clip("acoustic"),
        frame_period=engine.frame_period, spk=spk)


def multi_speaker_trainer_config(corpus, out_dir, model=None, **overrides):
    """The single-track trainer's config for the multi-speaker voice, as
    ``bin/train_acoustic_multi.py`` takes it: the recipe's acoustic data
    and train sections with its ``spk_names`` (``CORPUS_SPKS``, the
    prefixes ``write_corpus`` gives the files), the corpus's acoustic
    dumps and out scaler, ``model`` (``multi_speaker_acoustic_config()``
    by default) and ``overrides`` (dotted keys) over it all."""
    from ensemble_svs_with_interactions_tpu_torch.utils.config import merge

    cfg = recipe_phase_config("acoustic", corpus, out_dir, multitrack=False,
                              **overrides)
    model = multi_speaker_acoustic_config() if model is None else model
    return merge({k: v for k, v in cfg.items() if k != "model"},
                 {"model": model,
                  "data": {"spk_names": list(CORPUS_SPKS)}})


MEL_CONFIG = "acoustic/acoustic_melf0_ar_f0_diff_mel.yaml"
MEL_POSTFILTER = "postfilter/postfilter_mel.yaml"
MEL_ONLY_CONFIGS = {"diffusion_melf0": "acoustic/acoustic_diffusion_melf0.yaml",
                    "flowmatching_melf0":
                        "acoustic/acoustic_flowmatching_melf0.yaml"}
MEL_DIMS = 80


def mel_acoustic_config(tiny: bool = False, k_step: int = None) -> dict:
    """The mel voice, ``MEL_CONFIG`` verbatim (the AR residual-F0 lf0
    decoder, r = 4, over a Sinsy biLSTM 64 x 2; the DDPM mel decoder of
    K_step 100 with an FFConvLSTM condition encoder, biLSTM 128 x 2, and a
    20 x 256 ``DiffNet``; the FFConvLSTM vuv decoder, biLSTM 64 x 2), the
    lf0 fields the recipe fills from data set to SINGLE_LF0 (the netG's
    ``out_lf0_idx`` is the mel width, 80).  ``k_step`` sets the chain's
    length; ``tiny=True`` narrows every width (TINY; the denoiser to 8
    channels over 2 layers), the streams and classes stay."""
    ac = shipped_config(MEL_CONFIG)
    net = ac["netG"]
    for node in (net, net["lf0_model"]):
        node.update({k: v for k, v in SINGLE_LF0.items() if node[k] is None})
    mel = net["mel_model"]
    if k_step is not None:
        mel["K_step"] = k_step
    if tiny:
        w = TINY
        net["lf0_model"].update(
            embed_dim=w["embed"], ff_hidden_dim=w["ff"],
            conv_hidden_dim=w["conv"], lstm_hidden_dim=w["lstm"],
            decoder_hidden_dim=w["dec"])
        for enc in (mel["encoder"], net["vuv_model"]):
            enc.update(embed_dim=w["embed"], ff_hidden_dim=w["ff"],
                       conv_hidden_dim=w["conv"], lstm_hidden_dim=w["lstm"])
        mel["encoder"]["out_dim"] = 8
        mel["denoise_fn"].update(encoder_hidden_dim=8, residual_channels=8,
                                 residual_layers=2)
    return ac


def mel_postfilter_config(tiny: bool = False) -> dict:
    """``MEL_POSTFILTER`` verbatim (a ``MelF0MultistreamPostFilter``: the
    mel stream through a ``Conv2dPostFilter`` of 64 channels, 5 x 5,
    frame-wise noise smoothed over 100 frames; lf0 and vuv untouched);
    ``tiny=True``: 4 channels."""
    cfg = shipped_config(MEL_POSTFILTER)
    cfg.pop("netD")
    if tiny:
        cfg["netG"]["mel_postfilter"]["channels"] = 4
    return cfg


def mel_only_config(name: str, tiny: bool = False) -> dict:
    """``MEL_ONLY_CONFIGS[name]`` verbatim: a bare DDPM or flow-matching
    decoder over the 80 mel bands with a 4-block FFT encoder (256 wide, 2
    heads) and a 20 x 256 ``DiffNet``; ``tiny=True`` narrows it (FFT 8
    wide over 2 blocks, ``DiffNet`` 8 x 2, K_step 4, 2 sampling steps)."""
    cfg = shipped_config(MEL_ONLY_CONFIGS[name])
    if tiny:
        net = cfg["netG"]
        net["encoder"].update(hidden_dim=8, num_layers=2, kernel_size=3)
        net["denoise_fn"].update(encoder_hidden_dim=8, residual_channels=8,
                                 residual_layers=2)
        if "K_step" in net:
            net["K_step"] = 4
        else:
            net["sampling_steps"] = 2
    return cfg


def mel_phases(tiny: bool = False, k_step: int = None):
    """The mel voice, (global config, {phase: (model_config, in_scaler,
    out_scaler)}): ``timelag/timelag_mdn.yaml`` and
    ``duration/duration_mdn.yaml`` verbatim (``MDNv2``), the acoustic
    model of ``mel_acoustic_config``, the mel postfilter
    (``mel_postfilter_config``, its scaler the acoustic one's) and the
    recipe's hn-uSFGAN with ``aux_channels`` 80 (``vocoder_phase``: the
    mel its aux input, F0 from lf0).  ``feature_type`` is ``melf0``;
    ``tiny=True`` narrows every width for the CPU tests."""
    from ensemble_svs_with_interactions_tpu_torch.utils.scalers import (
        MinMaxScaler,
        StandardScaler,
    )

    tl = shipped_config("timelag/timelag_mdn.yaml")
    du = shipped_config("duration/duration_mdn.yaml")
    if tiny:
        for cfg in (tl, du):
            cfg["netG"].update(hidden_dim=TINY["tl"],
                               num_layers=TINY["layers"])
    # a random DDPM chain ends near +-1 (its clip) times norm_scale, 10:
    # a mel scale of 0.08 puts that at +-0.8 around -2.5 in log10 mel, the
    # range of real features; the input's pitch column maps SINGLE_LF0's
    # range onto [0, 1] as the recipe's min-max scaler does, so the
    # residual lf0 lands near the score's
    out = MEL_DIMS + 2
    mean, scale = np.full(out, -2.5), np.full(out, 0.08)
    mean[MEL_DIMS:], scale[MEL_DIMS:] = (np.log(260.0), 0.5), (0.24, 0.5)
    sc_out = StandardScaler(mean, scale ** 2, scale)
    lo, hi = SINGLE_LF0["in_lf0_min"], SINGLE_LF0["in_lf0_max"]
    sc_min, sc_scale = np.zeros(86), np.ones(86)
    lf0_idx = mel_acoustic_config()["netG"]["in_lf0_idx"]
    sc_min[lf0_idx], sc_scale[lf0_idx] = -lo / (hi - lo), 1.0 / (hi - lo)
    glob = {"sample_rate": 48000, "frame_period": 5, "feature_type": "melf0",
            "use_world_codec": True, "relative_f0": False}
    phases = {
        "timelag": (tl, MinMaxScaler(np.zeros(82), np.ones(82)),
                    StandardScaler(np.zeros(1), np.ones(1) * 4,
                                   np.ones(1) * 2)),
        "duration": (du, MinMaxScaler(np.zeros(82), np.ones(82)),
                     StandardScaler(np.ones(1) * 10, np.ones(1) * 4,
                                    np.ones(1) * 2)),
        "acoustic": (mel_acoustic_config(tiny, k_step),
                     MinMaxScaler(sc_min, sc_scale), sc_out),
    }
    phases["postfilter"] = (mel_postfilter_config(tiny), None, sc_out)
    phases["vocoder"] = vocoder_phase(tiny, aux_channels=MEL_DIMS)
    return glob, phases


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
    """Operations of the recurrence: the h_{t-1} @ W_h multiply-adds of
    the T - 1 steps after the first (h_{-1} = 0, as ``gates_ops`` and
    ``dwh_flops`` count) plus the gate arithmetic, about 12 operations
    per unit and step."""
    return 2 * B * (T - 1) * H * 4 * H + 12 * B * T * H


def gates_ops(B, T, H):
    """Operations of the BPTT's gate pre-pass: the h_{t-1} W_h
    multiply-adds of the T - 1 steps after the first (h_{-1} = 0, as
    ``dwh_flops`` counts) plus the bias add of every step."""
    return 2 * B * (T - 1) * H * 4 * H + B * T * 4 * H


def bptt_loop_ops(B, T, H):
    """Operations of the BPTT's reverse loop: the dz_{t+1} W_h^T
    multiply-adds of the T - 1 steps before the last (dz_T = 0) plus about
    30 elementwise operations per unit and step."""
    return 2 * B * (T - 1) * 4 * H * H + 30 * B * T * H


BPTT_LAUNCH_ROWS = 512  # kLaunchRowsB in csrc/lstm_bptt.cu
BPTT_SIMT_ROWS = 8      # kSimtRowsB there: launches this small take FMAs


def bptt_mma_rows(kernel, B):
    """Rows of a batch of B whose reverse loop multiplies on the tensor
    cores in 3xTF32: none unless ``kernel`` is lstm_bptt_mma_kernel; there,
    the rows of each launch (BPTT_LAUNCH_ROWS rows at most) of more than
    BPTT_SIMT_ROWS rows.  The other rows' loop runs on float32 FMAs."""
    if kernel != "lstm_bptt_mma_kernel":
        return 0
    last = B % BPTT_LAUNCH_ROWS
    return B - last + (last if last > BPTT_SIMT_ROWS else 0)


def recurrence_bound_times(B, T, H, want_c):
    """(bytes time, operations time) in ms for the recurrence's work: each
    input read once and each output written once over the memory rate;
    ``recurrence_ops`` over the float32 rate."""
    nbytes = 4 * (B * T * 4 * H + H * 4 * H + B * T * H * (2 if want_c else 1))
    return (1e3 * nbytes / PEAK_BYTES_PER_S,
            1e3 * recurrence_ops(B, T, H) / PEAK_FP32_FLOP_PER_S)


def recurrence_3xtf32_bound_ms(B, T, H, want_c):
    """The recurrence's least time with its h @ W_h multiply-adds on the
    TF32 tensor cores in 3xTF32, the instruction the H > 512 kernel uses
    (PEAK_3XTF32_FLOP_PER_S), beside ``recurrence_bound_times``'
    float32 FMA rate: the larger of the bytes time and that."""
    t_bytes, _ = recurrence_bound_times(B, T, H, want_c)
    return max(t_bytes, 1e3 * recurrence_ops(B, T, H) / PEAK_3XTF32_FLOP_PER_S)


def bptt_bound_times(B, T, H, mma_rows=0):
    """(bytes time, operations time) in ms for the whole BPTT launch: xw,
    W_h, h, c and dy read once, dxw written once; the gates' operations
    (``gates_bound_times``) plus the loop's (``bptt_loop_bound_times``,
    with ``mma_rows`` of the B rows on the tensor cores), each at the rate
    of the instruction that does them."""
    nbytes = 4 * (2 * B * T * 4 * H + H * 4 * H + 3 * B * T * H)
    return (1e3 * nbytes / PEAK_BYTES_PER_S,
            gates_bound_times(B, T, H)[1]
            + bptt_loop_bound_times(B, T, H, mma_rows)[1])


def gates_bound_times(B, T, H):
    """(bytes time, operations time) in ms for the BPTT's gate pre-pass: xw,
    h and W_h read once, the gates written once; the h_{t-1} W_h
    multiply-adds plus the bias add at the rate of the instruction the
    pre-pass uses: float32 FMA at H <= 64, 3xTF32 on the tensor cores above
    (PEAK_3XTF32_FLOP_PER_S, as ``dwh_bound_times``)."""
    nbytes = 4 * (2 * B * T * 4 * H + B * T * H + H * 4 * H)
    rate = PEAK_FP32_FLOP_PER_S if H <= 64 else PEAK_3XTF32_FLOP_PER_S
    return 1e3 * nbytes / PEAK_BYTES_PER_S, 1e3 * gates_ops(B, T, H) / rate


def bptt_loop_bound_times(B, T, H, mma_rows=0):
    """(bytes time, operations time) in ms for the BPTT's reverse loop
    after the pre-pass: the gates, c and dy read once and W_h once, dz
    written once; the dz_{t+1} W_h^T multiply-adds plus about 30
    elementwise operations per unit and step (``bptt_loop_ops``), those of
    ``mma_rows`` rows at the 3xTF32 tensor-core rate
    (PEAK_3XTF32_FLOP_PER_S) and the rest at the float32 FMA rate."""
    nbytes = 4 * (2 * B * T * 4 * H + H * 4 * H + 2 * B * T * H)
    return (1e3 * nbytes / PEAK_BYTES_PER_S,
            1e3 * (bptt_loop_ops(mma_rows, T, H) / PEAK_3XTF32_FLOP_PER_S
                   + bptt_loop_ops(B - mma_rows, T, H)
                   / PEAK_FP32_FLOP_PER_S))


def bptt_row(lr, xw, w_h, h, c, dy, base):
    """The BPTT launch (pre-pass and loop) on these inputs against the plain
    loop: its error, the loop kernel that served it, its time and the
    plain version's, its bounds (whole launch and loop alone) with the
    loop's products at the rate of the instruction that served them
    (``bptt_mma_rows``), the pre-pass alone (``prepass_row``) and cuDNN's
    backward as its yardstick.  Rows of
    lstm_bptt_mma_kernel also carry both bounds with every row's loop at
    the float32 FMA rate (``*_fma_ms``, the figures earlier rows give) and
    on the tensor cores in 3xTF32 (``*_3xtf32_ms``).  Returns the row,
    dxw and the plain (dxw, dW_h)."""
    B, T, H = h.shape
    dxw = lr.lstm_bptt(xw, w_h, h, c, dy)
    dxw_ref, dwh_ref = lr.lstm_recurrence_bwd_reference(xw, w_h, h, c, dy)
    err = (dxw - dxw_ref).abs().max().item()
    kernel = lr.lstm_bptt_kernel_name(B, H)
    mma_rows = bptt_mma_rows(kernel, B)
    t_bytes, t_ops = bptt_bound_times(B, T, H, mma_rows)
    library_ms, gemm_ms = cudnn_lstm_bwd_ms(xw, w_h, dy, 5)
    ms = cuda_ms(lambda: lr.lstm_bptt(xw, w_h, h, c, dy), 10)
    row = {**base, "name": "lstm_bptt", "kernel": kernel,
           "loop_mma_rows": mma_rows, "max_abs_err": err,
           "atol": KERNEL_ATOL, "ms": ms, "us_per_step": 1e3 * ms / T,
           "plain_ms": cuda_ms(lambda: lr.lstm_recurrence_bwd_reference(
               xw, w_h, h, c, dy), 1),
           "bytes_ms": t_bytes, "operations_ms": t_ops,
           "library_ms": library_ms, "library_input_gemm_ms": gemm_ms,
           "loop_bound_ms": bound(*bptt_loop_bound_times(
               B, T, H, mma_rows))[0],
           **prepass_row(lr, xw, w_h, h)}
    if kernel == "lstm_bptt_mma_kernel":
        for key, rows in (("fma", 0), ("3xtf32", B)):
            row[f"bound_{key}_ms"] = bound(*bptt_bound_times(B, T, H,
                                                             rows))[0]
            row[f"loop_bound_{key}_ms"] = bound(*bptt_loop_bound_times(
                B, T, H, rows))[0]
    row["bound_ms"], row["bound_by"] = bound(t_bytes, t_ops)
    emit(row)
    assert np.isfinite(err) and err < KERNEL_ATOL, row
    assert row["prepass_max_abs_err"] < KERNEL_ATOL, row
    return row, dxw, dxw_ref, dwh_ref


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


def phase_kernels(lr, B=N_TRACKS, modes=(False, True), phase="kernel",
                  shapes=RECURRENCE_SHAPES, T=T_FRAMES):
    """The recurrence at the serving shapes: B rows (N_TRACKS for
    ``svs_ensemble``, 1 for ``svs``) of T steps (T_FRAMES, the fixture's),
    each width of ``shapes`` (the flagship's RECURRENCE_SHAPES, and for
    ``svs_ensemble`` the diffusion voice's too), in each of ``modes``
    (want_c)."""
    results = {}
    g = torch.Generator(device="cuda").manual_seed(SEED + B - N_TRACKS)
    for H in shapes:
        xw = torch.randn(B, T, 4 * H, device="cuda", generator=g)
        w_h = torch.randn(H, 4 * H, device="cuda", generator=g) / H ** 0.5
        for want_c in modes:
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
            row = {"phase": phase, "name": "lstm_recurrence",
                   "kernel": lr.lstm_recurrence_kernel_name(B, H), "B": B,
                   "T": T, "H": H, "want_c": want_c, "max_abs_err": err,
                   "atol": KERNEL_ATOL, "ms": ms, "us_per_step": 1e3 * ms / T,
                   "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "bound_3xtf32_ms": recurrence_3xtf32_bound_ms(
                       B, T, H, want_c),
                   "bytes_ms": t_bytes, "operations_ms": t_ops,
                   "library_ms": library_ms,
                   "library_input_gemm_ms": gemm_ms,
                   "library_tf32": torch.backends.cudnn.allow_tf32}
            emit(row)
            assert np.isfinite(err) and err < KERNEL_ATOL, row
            results[(H, want_c)] = row
    return results


def phase_train_kernels(lr, B=TRAIN_B, shapes=TRAIN_LAUNCHES_BY_SHAPE,
                        phase="train_kernel"):
    """The training path's kernels at its shapes (TRAIN_LAUNCHES_BY_SHAPE,
    batch TRAIN_B, as ``bench_train.py`` runs it, unless ``shapes`` and
    ``B`` name others): the recurrence in both modes, the BPTT kernel
    (dxw) and the dW_h kernel, each against its plain version."""
    rows = {}
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    for H, T in shapes:
        xw = torch.randn(B, T, 4 * H, device="cuda", generator=g)
        w_h = torch.randn(H, 4 * H, device="cuda", generator=g) / H ** 0.5
        dy = torch.randn(B, T, H, device="cuda", generator=g)
        base = {"phase": phase, "B": B, "T": T, "H": H}
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
                   "bound_3xtf32_ms": recurrence_3xtf32_bound_ms(
                       B, T, H, want_c),
                   "library_ms": library_ms, "library_input_gemm_ms": gemm_ms,
                   "library_tf32": torch.backends.cudnn.allow_tf32}
            row["bound_ms"], row["bound_by"] = bound(t_bytes, t_ops)
            emit(row)
            assert np.isfinite(err) and err < KERNEL_ATOL, row
            rows["lstm_recurrence", H, T, want_c] = row

        h, c = lr.lstm_recurrence(xw, w_h, want_c=True)
        row, dxw, dxw_ref, dwh_ref = bptt_row(lr, xw, w_h, h, c, dy, base)
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


def reset_launches(lr):
    """Zero the forward's launch counts (total and by width)."""
    lr.lstm_recurrence.launches = 0
    lr.lstm_recurrence.launches_by_width.clear()


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

    reset_launches(lr)
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


@torch.no_grad()
def multitrack_modules(m, dev, xm, xs, spk_ids, sub_ids, lengths,
                       dec_in=None, ar_only=False):
    """The multitrack acoustic model's modules on host (B, T, 86) main and
    sub features: the AR lf0 decoder (dropout masks from a CPU generator
    seeded with ``AR_SEED``, as the engine draws them), the encoder, the
    lf0 encoder and the mgc/vuv/bap decoders on ``dec_in`` (by default
    built from this run's encoder and AR lf0), as float64 CPU tensors."""
    from ensemble_svs_with_interactions_tpu_torch.gen import AR_SEED
    from ensemble_svs_with_interactions_tpu_torch.models.acoustic.util import (
        point_estimate,
    )
    from ensemble_svs_with_interactions_tpu_torch.models.generic import (
        speaker_embeddings,
    )

    dtype = next(m.parameters()).dtype
    xm = torch.from_numpy(xm).to(dev, dtype)
    xs = torch.from_numpy(xs).to(dev, dtype)
    B, T = xm.shape[0], xm.shape[1]
    ln = torch.as_tensor(np.asarray(lengths), device=dev)
    spk_m = speaker_embeddings(m.speaker_embedding,
                               torch.as_tensor(spk_ids, device=dev), B, T)
    spk_s = speaker_embeddings(m.speaker_embedding,
                               torch.as_tensor(sub_ids, device=dev), B, T)
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


def hold_modules(card, cpu, valid, *args) -> dict:
    """``multitrack_modules`` on the card against the CPU (plain
    recurrence) on the same inputs, and the AR lf0 against a float64
    oracle (the CPU model in float64), over the ``valid`` frames: the
    errors by module, the AR lf0's distances and its limit, and whether
    every output is finite (``assert_held`` judges them)."""
    ref, dec_in = multitrack_modules(cpu, torch.device("cpu"), *args)
    got, _ = multitrack_modules(card, next(card.parameters()).device, *args,
                                dec_in=dec_in)
    oracle, _ = multitrack_modules(copy.deepcopy(cpu).double(),
                                   torch.device("cpu"), *args, ar_only=True)

    def dist(a, b):
        return (a - b)[valid].abs().max().item()

    errs = {k: dist(got[k], ref[k]) for k in ref}
    ar = {"card_vs_f64": dist(got["ar_lf0"], oracle["ar_lf0"]),
          "cpu_f32_vs_f64": dist(ref["ar_lf0"], oracle["ar_lf0"])}
    return {"max_abs_err": errs, "atol": MODULE_ATOL, "ar_lf0": ar,
            "ar_lf0_limit": max(AR_ABS_ATOL,
                                AR_HEADROOM * ar["cpu_f32_vs_f64"]),
            "finite": all(bool(torch.isfinite(v).all())
                          for v in got.values())}


def assert_held(held: dict):
    """Modules within MODULE_ATOL; the AR lf0 no farther from the float64
    oracle than AR_HEADROOM times the CPU's own float32 run, or
    AR_ABS_ATOL; every output finite."""
    for k, e in held["max_abs_err"].items():
        if k != "ar_lf0":
            assert np.isfinite(e) and e < MODULE_ATOL, (k, e)
    ar = held["ar_lf0"]["card_vs_f64"]
    assert np.isfinite(ar) and ar <= held["ar_lf0_limit"], held["ar_lf0"]
    assert held["finite"], held


def phase_reference(engine, weights, labels):
    """The card against the CPU (plain recurrence) on the first seconds of
    the fixture: durations exactly; the multitrack encoder (H = 512), the
    lf0 encoder (64) and the mgc/vuv/bap decoders (256/64/62) at
    MODULE_ATOL on the same inputs, and the free-running AR lf0 decoder
    against a float64 oracle (``hold_modules``).  Returns the CPU
    engine."""
    from ensemble_svs_with_interactions_tpu_torch.gen import (
        FRAME_BUCKET,
        _round_up,
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
    valid = torch.from_numpy(np.arange(T)[None, :] < lengths[:, None])
    held = hold_modules(engine.acoustic_model.module,
                        cpu.acoustic_model.module, valid, x, x[pairs],
                        spk_ids, pairs, lengths)
    emit({"phase": "reference", "frames": lengths.tolist(), "T": T, **held,
          "seconds": time.time() - t0})
    assert_held(held)
    return cpu


def phase_single(lr, model_dir, label):
    """Single-singer serving through the normal entry point: the stock
    single-track voice opened by ``SPSVS(model_dir)`` renders the fixture
    with ``svs()`` (a warm-up, then N_CALLS timed calls with the launch
    counts reset just before and read just after, by width
    LAUNCHES_BY_HIDDEN per call), then as float32, with segmented
    synthesis, and as 4 copies through ``svs_ensemble``'s single-track
    branch (its own launch count, LAUNCHES_PER_CALL at B = 4)."""
    from ensemble_svs_with_interactions_tpu_torch.io import hts
    from ensemble_svs_with_interactions_tpu_torch.svs import SPSVS

    t0 = time.time()
    engine = SPSVS(model_dir, device="cuda")
    torch.cuda.synchronize()
    load_s = time.time() - t0
    t0 = time.time()
    engine.svs(label.copy())
    warm_s = time.time() - t0

    torch.cuda.reset_peak_memory_stats()
    reset_launches(lr)
    runs = []
    for _ in range(N_CALLS):
        t0 = time.time()
        wav, sr = engine.svs(label.copy())
        runs.append({"seconds": time.time() - t0, "rtf": engine.last_rtf,
                     "stages": dict(engine.last_stage_times)})
    launches = lr.lstm_recurrence.launches
    by_width = dict(lr.lstm_recurrence.launches_by_width)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    by_kernel = {}
    for H, n in sorted(by_width.items()):
        name = lr.lstm_recurrence_kernel_name(1, H)
        by_kernel[name] = by_kernel.get(name, 0) + n

    t0 = time.time()
    f32, _ = engine.svs(label.copy(), dtype=np.float32)
    f32_s = time.time() - t0
    t0 = time.time()
    seg, _ = engine.svs(label.copy(), segmented_synthesis=True)
    seg_s, seg_stages = time.time() - t0, dict(engine.last_stage_times)
    n_segments = len(hts.segment_labels(engine.predict_timing(label.copy())))
    reset_launches(lr)
    t0 = time.time()
    ens, _ = engine.svs_ensemble([label.copy() for _ in range(N_TRACKS)])
    ens_s = time.time() - t0
    ens_launches = lr.lstm_recurrence.launches
    audio_s = len(wav) / sr
    emit({"phase": "single", "load_s": load_s, "warmup_s": warm_s,
          "runs_s": [r["seconds"] for r in runs],
          "rtf": [r["rtf"] for r in runs],
          "stages": runs[len(runs) // 2]["stages"], "audio_seconds": audio_s,
          "calls": N_CALLS, "launches": launches,
          "launches_by_width": {str(H): n
                                for H, n in sorted(by_width.items())},
          "launches_by_kernel": by_kernel, "peak_mem_gib": peak,
          "float32": {"seconds": f32_s, "dtype": str(f32.dtype),
                      "length": len(f32),
                      "max_abs": float(np.abs(f32).max())},
          "segmented": {"seconds": seg_s, "segments": n_segments,
                        "length": len(seg), "stages": seg_stages},
          "svs_ensemble": {"tracks": N_TRACKS, "seconds": ens_s,
                           "rtf": engine.last_rtf, "launches": ens_launches,
                           "stages": engine.last_stage_times,
                           "wav_lengths": [len(w) for w in ens]}})
    assert by_width == {H: n * N_CALLS for H, n in
                        LAUNCHES_BY_HIDDEN.items()}, by_width
    assert launches == LAUNCHES_PER_CALL * N_CALLS, launches
    assert wav.dtype == np.int16 and len(wav) > 30 * sr, (wav.dtype, len(wav))
    assert np.abs(wav.astype(np.int64)).max() > 0
    assert f32.dtype == np.float32 and f32.shape == wav.shape
    assert np.isfinite(f32).all() and 0 < np.abs(f32).max() <= 1.0
    assert seg.dtype == np.int16 and len(seg) > 30 * sr and n_segments > 1
    assert np.abs(seg.astype(np.int64)).max() > 0
    assert ens_launches == LAUNCHES_PER_CALL, ens_launches
    for w in ens:
        assert w.dtype == np.int16 and len(w) > 30 * sr
        assert np.abs(w.astype(np.int64)).max() > 0
    return engine, {"svs": launches, "svs_ensemble_single": ens_launches}


def phase_single_reference(engine, model_dir, label):
    """The single-track voice on the card against the same pack opened on
    the CPU (plain recurrence), over the first 60 labels of the fixture:
    durations exactly; the encoder (H = 512), the lf0 encoder (64) and the
    mgc/vuv/bap decoders (256/64/62) at MODULE_ATOL on the same inputs;
    the free-running AR lf0 decoder (same dropout masks, a CPU generator
    seeded with ``AR_SEED``) against the float64 oracle under AR_HEADROOM,
    as phase ``reference``; and the postprocessed (mgc, lf0, vuv, bap) of
    ``predict_acoustic`` + ``postprocess_acoustic`` within POST_ATOL on
    valid frames.  Returns the CPU engine and, for phase ``postfilter``,
    each engine's (duration-modified labels, acoustic features) of those
    labels."""
    from ensemble_svs_with_interactions_tpu_torch.gen import (
        AR_SEED,
        FRAME_BUCKET,
        _round_up,
    )
    from ensemble_svs_with_interactions_tpu_torch.models.acoustic.util import (
        point_estimate,
    )
    from ensemble_svs_with_interactions_tpu_torch.svs import SPSVS

    t0 = time.time()
    cpu = SPSVS(model_dir, device="cpu")
    short = label[:60]
    dm, dm_cpu = engine.predict_timing(short), cpu.predict_timing(short)
    assert list(dm.start_times) == list(dm_cpu.start_times)
    assert list(dm.end_times) == list(dm_cpu.end_times)
    feats, _ = engine._frame_features([dm.copy()])
    n = len(feats[0])
    T = _round_up(n, FRAME_BUCKET)
    x = np.zeros((1, T, feats[0].shape[1]), np.float32)
    x[0, :n] = feats[0]
    rest = engine.acoustic_model.module.in_rest_idx

    @torch.no_grad()
    def modules(m, dev, dec_in=None, ar_only=False):
        dtype = next(m.parameters()).dtype
        xm = torch.from_numpy(x).to(dev, dtype)
        ln = torch.as_tensor([n], device=dev)
        out = {"ar_lf0": point_estimate(m.lf0_model(
            xm, ln, generator=torch.Generator().manual_seed(AR_SEED))[0])}
        if not ar_only:
            out["encoder"] = m.encoder(xm, ln)
            out["lf0_encoder"] = m.lf0_model.encode(xm, ln)
            if dec_in is None:
                dec_in = torch.cat([out["encoder"], xm[..., rest: rest + 1],
                                    out["ar_lf0"]], dim=-1).cpu()
            d = dec_in.to(dev)
            for k in ("mgc_model", "vuv_model", "bap_model"):
                out[k] = getattr(m, k)(d, ln)
        return {k: v.cpu().double() for k, v in out.items()}, dec_in

    ref, dec_in = modules(cpu.acoustic_model.module, cpu.device)
    got, _ = modules(engine.acoustic_model.module, engine.device, dec_in)
    oracle, _ = modules(copy.deepcopy(cpu.acoustic_model.module).double(),
                        cpu.device, ar_only=True)

    def dist(a, b):
        return (a - b)[:, :n].abs().max().item()

    errs = {k: dist(got[k], ref[k]) for k in ref}
    ar = {"card_vs_f64": dist(got["ar_lf0"], oracle["ar_lf0"]),
          "cpu_f32_vs_f64": dist(ref["ar_lf0"], oracle["ar_lf0"])}
    ar_limit = max(AR_ABS_ATOL, AR_HEADROOM * ar["cpu_f32_vs_f64"])
    short_run = [(d, e.predict_acoustic(d.copy()))
                 for e, d in ((engine, dm), (cpu, dm_cpu))]
    post = stream_errors((engine, cpu), short_run)
    emit({"phase": "single_reference", "labels": len(short), "frames": n,
          "T": T, "max_abs_err": errs, "atol": MODULE_ATOL, "ar_lf0": ar,
          "ar_lf0_limit": ar_limit, "post_max_abs_err": post,
          "post_atol": POST_ATOL, "seconds": time.time() - t0})
    for k, e in errs.items():
        if k != "ar_lf0":
            assert np.isfinite(e) and e < MODULE_ATOL, (k, e)
    assert np.isfinite(ar["card_vs_f64"]) and ar["card_vs_f64"] <= ar_limit, ar
    for k in ref:
        assert torch.isfinite(got[k]).all(), k
    for k, e in post.items():
        assert np.isfinite(e) and e < POST_ATOL, (k, e)
    return cpu, short_run


def postfilter_flops(module, T: int) -> int:
    """Operations of a ``MultistreamPostFilter`` on T frames: each
    sub-filter's convolutions (2 x Cout x Cin x kh x kw a pixel over T x
    its width) and frame-wise noise projection."""
    from torch import nn

    total = 0
    for pf in (module.mgc_postfilter, module.bap_postfilter,
               module.lf0_postfilter):
        if pf is None:
            continue
        for m in pf.modules():
            if isinstance(m, nn.Conv2d):
                total += 2 * m.weight.numel() * T * pf.in_dim
            elif isinstance(m, nn.Linear):
                total += 2 * m.weight.numel() * T
    return total


def stream_errors(engines, runs, **kw) -> dict:
    """The largest difference of each stream that ``postprocess_acoustic(
    **kw)`` gives ``(card, cpu)`` engines from their ``runs``, (duration-
    modified labels, acoustic features) each."""
    streams = [e.postprocess_acoustic(acoustic, d.copy(), **kw)
               for e, (d, acoustic) in zip(engines, runs)]
    return {k: float(np.abs(a - b).max()) for k, a, b in
            zip(("mgc", "lf0", "vuv", "bap"), *streams)}


def phase_postfilter(lr, engine, cpu, label, short_run):
    """Single-singer serving with the learned postfilter
    (``post_filter_type="nnsvs"``, the pack's merged postfilter): a
    warm-up, then N_CALLS timed ``svs()`` calls with the launch counts
    reset just before and read just after (LAUNCHES_BY_HIDDEN a call);
    the postfilter's device time alone (CUDA events, 5 calls on the input
    the engine gave it, padded as it pads it) beside its bound; the
    module on the card against the CPU on the first POSTFILTER_REF_FRAMES
    frames of that input with the same noise (POSTFILTER_RTOL of the
    output's largest entry); and the postprocessed streams against the CPU
    engine over the first 60 labels (``short_run``, phase
    ``single_reference``'s acoustic features) within POST_ATOL.  Returns
    the launches."""
    from ensemble_svs_with_interactions_tpu_torch.gen import (
        AR_SEED,
        FRAME_BUCKET,
        _round_up,
    )
    from ensemble_svs_with_interactions_tpu_torch.models.postfilters import (
        draw_noise,
    )

    pack = engine.postfilter_model
    inputs = []
    infer = pack.inference
    pack.inference = lambda x, **kw: inputs.append(x) or infer(x, **kw)
    t0 = time.time()
    engine.svs(label.copy(), post_filter_type="nnsvs")
    warm_s = time.time() - t0
    del pack.inference

    torch.cuda.reset_peak_memory_stats()
    reset_launches(lr)
    runs = []
    for _ in range(N_CALLS):
        t0 = time.time()
        wav, sr = engine.svs(label.copy(), post_filter_type="nnsvs")
        runs.append({"seconds": time.time() - t0, "rtf": engine.last_rtf,
                     "stages": dict(engine.last_stage_times)})
    launches = lr.lstm_recurrence.launches
    by_width = dict(lr.lstm_recurrence.launches_by_width)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    n = len(inputs[0])
    T = _round_up(n, FRAME_BUCKET)
    x = np.zeros((1, T, inputs[0].shape[1]), np.float32)
    x[0, :n] = inputs[0]
    x_dev = torch.from_numpy(x).to(engine.device)
    module = pack.module
    with torch.no_grad():
        def call():
            return module.inference(
                x_dev, generator=torch.Generator().manual_seed(AR_SEED))

        call()
        pf_ms = cuda_ms(call, 5)
        g = torch.Generator().manual_seed(AR_SEED)
        m = POSTFILTER_REF_FRAMES
        noise = {"mgc": draw_noise((1, m, 1), g),
                 "bap": draw_noise((1, m, module.stream_sizes[3]), g)}
        got = module.inference(x_dev[:, :m], noise=noise).cpu().double()
        ref = cpu.postfilter_model.module.inference(
            torch.from_numpy(x[:, :m]), noise=noise).double()
    pf_err = ((got - ref).abs().max() / ref.abs().max()).item()
    flops = postfilter_flops(module, T)
    pf_bound = bound(1e3 * 2 * x.nbytes / PEAK_BYTES_PER_S,
                     1e3 * flops / PEAK_FP32_FLOP_PER_S)
    post = stream_errors((engine, cpu), short_run, post_filter_type="nnsvs")
    audio_s = len(wav) / sr
    emit({"phase": "postfilter", "warmup_s": warm_s,
          "runs_s": [r["seconds"] for r in runs],
          "rtf": [r["rtf"] for r in runs],
          "postprocess_acoustic_s": [r["stages"]["postprocess_acoustic"]
                                     for r in runs],
          "stages": runs[len(runs) // 2]["stages"], "audio_seconds": audio_s,
          "calls": N_CALLS, "launches": launches,
          "launches_by_width": {str(H): c
                                for H, c in sorted(by_width.items())},
          "peak_mem_gib": peak,
          "postfilter": {"frames": n, "T": T, "ms": pf_ms,
                         "bound_ms": pf_bound[0], "bound_by": pf_bound[1],
                         "gflop": flops / 1e9,
                         "tflops": flops / pf_ms / 1e9,
                         "card_vs_cpu_rel_err": pf_err,
                         "card_vs_cpu_frames": POSTFILTER_REF_FRAMES,
                         "rtol": POSTFILTER_RTOL},
          "post_max_abs_err": post, "post_atol": POST_ATOL})
    assert by_width == {H: c * N_CALLS for H, c in
                        LAUNCHES_BY_HIDDEN.items()}, by_width
    assert wav.dtype == np.int16 and len(wav) > 30 * sr, (wav.dtype, len(wav))
    assert np.abs(wav.astype(np.int64)).max() > 0
    assert np.isfinite(pf_err) and pf_err < POSTFILTER_RTOL, pf_err
    for k, e in post.items():
        assert np.isfinite(e) and e < POST_ATOL, (k, e)
    return launches


def snr_db(ref, got) -> float:
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    return float(10 * np.log10(np.sum(ref ** 2)
                               / max(np.sum((got - ref) ** 2), 1e-30)))


def held_waveform(engine, streams) -> dict:
    """``predict_waveform`` of host streams on the card against the CPU
    port with the same noise, by SNR."""
    from ensemble_svs_with_interactions_tpu_torch.gen import (
        FRAME_BUCKET,
        _round_up,
        predict_waveform,
        vocoder_noise,
    )

    hop = int(engine.sample_rate * engine.frame_period / 1000)
    noise = vocoder_noise(1, _round_up(len(streams[1]), FRAME_BUCKET) * hop,
                          "cpu")
    kw = {"sample_rate": engine.sample_rate,
          "frame_period": engine.frame_period,
          "use_world_codec": engine.config.get("use_world_codec", True)}
    t0 = time.time()
    card = predict_waveform(streams, device=engine.device,
                            noise=noise.to(engine.device), **kw)
    card_s = time.time() - t0
    cpu = predict_waveform(streams, device="cpu", noise=noise, **kw)
    return {"vocoder_s": card_s, "samples": len(card),
            "finite": bool(np.isfinite(card).all()),
            "snr_db": snr_db(cpu, card)}


def phase_world_params(engine, mcep_dir, label):
    """The merlin postfilter and uncoded WORLD synthesis: one ``svs()`` call
    with ``post_filter_type="merlin"``, one on the same pack with
    ``use_world_codec: false`` (``gen_world_params``' ``mc2sp`` envelope),
    and one on a pack of the voice predicting MCEP_AP_DIM-dim mel-cepstral
    aperiodicity (``mc2sp`` aperiodicity); each call's streams go through
    ``predict_waveform`` on the card and on the CPU with the same noise,
    held at SNR_DB."""
    from ensemble_svs_with_interactions_tpu_torch.svs import SPSVS

    out, streams = {}, {}

    def render(name, e, **kw):
        post = e.postprocess_acoustic

        def capture(*a, **k):
            streams[name] = post(*a, **k)
            return streams[name]

        e.postprocess_acoustic = capture
        t0 = time.time()
        wav, sr = e.svs(label.copy(), **kw)
        del e.postprocess_acoustic
        out[name] = {"seconds": time.time() - t0, "rtf": e.last_rtf,
                     "stages": dict(e.last_stage_times),
                     "length": len(wav),
                     "audible": bool(np.abs(wav.astype(np.int64)).max() > 0),
                     **held_waveform(e, streams[name])}

    render("merlin", engine, post_filter_type="merlin")
    engine.config["use_world_codec"] = False
    try:
        render("uncoded", engine)
    finally:
        engine.config["use_world_codec"] = True
    t0 = time.time()
    mcep = SPSVS(mcep_dir, device=engine.device)
    load_s = time.time() - t0
    render("mcep_aperiodicity", mcep)
    out["mcep_aperiodicity"]["load_s"] = load_s
    emit({"phase": "world_params", **out, "snr_min_db": SNR_DB})
    for name, r in out.items():
        assert r["finite"] and r["audible"], (name, r)
        assert r["length"] > 30 * engine.sample_rate, (name, r)
        assert r["snr_db"] > SNR_DB, (name, r["snr_db"])
    assert streams["mcep_aperiodicity"][3].shape[1] == MCEP_AP_DIM


SURFACE_REF_SEGMENTS = 2   # the fixture's first segments, card vs CPU
SURFACE_STREAMS = 2        # concurrent /stream requests to the server


def surface_scores(engine) -> dict:
    """The port's packaged example scores through ``frontend.load_score``
    (MusicXML and UST, as uploads: bytes) and the NEUTRINO engine on the
    card: timing labels, phraselist, (f0, mgc, bap) and the ``NSF``
    waveform of each."""
    from ensemble_svs_with_interactions_tpu_torch.frontend import load_score
    from ensemble_svs_with_interactions_tpu_torch.utils import misc

    out = {}
    for path in (misc.example_xml_file(), misc.example_ust_file()):
        t0 = time.time()
        full = load_score(Path(path).name, Path(path).read_bytes())
        timing = engine.predict_timing(full)
        phraselist = engine.get_phraselist(full, timing)
        f0, mgc, bap = engine.predict_acoustic_neutrino(
            full, timing_labels=timing)
        wav = engine.predict_waveform_neutrino(f0, mgc, bap)
        out[Path(path).suffix[1:]] = {
            "seconds": time.time() - t0, "labels": len(full),
            "phones": [c.split("-")[1].split("+")[0] for c in full.contexts],
            "phrases": engine.get_num_phrases(full),
            "phraselist_lines": len(phraselist.splitlines()),
            "frames": len(f0), "voiced": float((f0 > 0).mean()),
            "finite": bool(all(np.isfinite(a).all() for a in (f0, mgc, bap))),
            "samples": len(wav), "wav_peak": int(np.abs(
                wav.astype(np.int64)).max())}
    return out


def timed_stream(engine, label, **kw) -> tuple:
    """(chunks, seconds to the first chunk, seconds in all) of one
    ``svs_streaming`` call."""
    t0 = time.time()
    chunks, first = [], None
    for chunk in engine.svs_streaming(label.copy(), **kw):
        if first is None:
            first = time.time() - t0
        chunks.append(chunk)
    return chunks, first, time.time() - t0


def stream_on_cpu(cpu, card, label, n: int) -> list:
    """The first ``n`` chunks of ``cpu.svs_streaming`` (the whole song's
    timing, only the first ``n`` segments rendered), with the card's WORLD
    noise: ``gen.vocoder_noise`` draws on ``card``'s device and moves the
    draw to the CPU."""
    from ensemble_svs_with_interactions_tpu_torch import gen
    from ensemble_svs_with_interactions_tpu_torch.io import hts

    segment, noise = hts.segment_labels, gen.vocoder_noise
    hts.segment_labels = lambda *a, **k: segment(*a, **k)[:n]
    gen.vocoder_noise = lambda N, S, device: noise(N, S, card).to(device)
    try:
        return list(cpu.svs_streaming(label.copy(), pipeline_depth=1))
    finally:
        hts.segment_labels, gen.vocoder_noise = segment, noise


def read_stream(base: str, body: dict) -> tuple:
    """(PCM chunks, seconds to the first PCM chunk) of one POST /stream,
    read off the socket frame by frame (the first frame, the RIFF header,
    is checked and dropped)."""
    import socket

    host, port = base.rsplit("/", 1)[-1].split(":")
    data = json.dumps(body).encode()
    t0 = time.time()
    with socket.create_connection((host, int(port))) as s:
        s.sendall(b"POST /stream HTTP/1.1\r\nHost: localhost\r\n"
                  b"Content-Type: application/json\r\n"
                  + f"Content-Length: {len(data)}\r\n\r\n".encode() + data)
        f = s.makefile("rb")
        status = f.readline()
        assert b" 200 " in status, status
        while f.readline() not in (b"\r\n", b""):
            pass
        frames, first = [], None
        while True:
            n = int(f.readline().strip(), 16)
            frame = f.read(n)
            assert f.read(2) == b"\r\n"
            if n == 0:
                break
            if frames and first is None:
                first = time.time() - t0
            frames.append(frame)
    assert frames[0][:4] == b"RIFF" and frames[0][8:12] == b"WAVE"
    return [np.frombuffer(b, np.int16) for b in frames[1:]], first


def surface_server(lr, model_dir, neutrino, label, score_path) -> dict:
    """``bin/neutrino_server.py`` in a thread on 127.0.0.1 (port 0) over
    ``model_dir``'s parent, its engines on ``neutrino``'s device (the
    card): /healthcheck, /timing
    of the MusicXML score's text, /acoustic by the stored name, /waveform
    of those features, each equal to ``neutrino``'s serial render; then
    one /stream request for ``label`` alone and SURFACE_STREAMS concurrent
    ones, each equal to a serial int16 ``svs_streaming``, with the
    forward's launches reset just before the first and read just after
    the last."""
    import base64
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    from ensemble_svs_with_interactions_tpu_torch.bin import (
        neutrino_server as srv,
    )
    from ensemble_svs_with_interactions_tpu_torch.frontend import load_score

    srv._MODEL_ROOT, srv._DEVICE = Path(model_dir).parent, neutrino.device
    name = Path(model_dir).name
    server = ThreadingHTTPServer(("127.0.0.1", 0), srv.Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"

    def post(path, obj):
        req = urllib.request.Request(f"{base}{path}", json.dumps(obj).encode(),
                                     {"Content-Type": "application/json"})
        with urllib.request.urlopen(req) as r:
            return json.loads(r.read())

    try:
        t0 = time.time()
        with urllib.request.urlopen(f"{base}/healthcheck") as r:
            health = json.loads(r.read())
        xml = Path(score_path).read_text(encoding="utf-8")
        timing = post("/timing", {"model": name, "musicxml": xml,
                                  "name": "score"})
        load_request_s = time.time() - t0
        full = load_score("score.musicxml", xml)
        ref_timing = neutrino.predict_timing(full)
        ac = post("/acoustic", {"model": name, "name": "score"})
        feats = neutrino.predict_acoustic_neutrino(full)
        got = [srv._unb64(ac[k], np.float64, d) for k, d in
               (("f0", 1), ("mgc", ac["mgc_dim"]), ("bap", ac["bap_dim"]))]
        wav = post("/waveform", {"model": name, **{
            k: ac[k] for k in ("f0", "mgc", "bap", "mgc_dim", "bap_dim")}})
        ref_wav = neutrino.predict_waveform_neutrino(*feats)
        body = {"model": name, "labels": str(label)}
        serial = list(neutrino.svs_streaming(label.copy(), dtype=np.int16))
        results = [None] * SURFACE_STREAMS

        def fetch(i):
            results[i] = read_stream(base, body)

        reset_launches(lr)
        t0 = time.time()
        alone = read_stream(base, body)
        alone_s = time.time() - t0
        t0 = time.time()
        threads = [threading.Thread(target=fetch, args=(i,))
                   for i in range(SURFACE_STREAMS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        streams_s = time.time() - t0
        launches = lr.lstm_recurrence.launches
        by_width = dict(lr.lstm_recurrence.launches_by_width)
    finally:
        server.shutdown()
        server.server_close()
        thread.join()
    return {
        "healthcheck": health == {"healthcheck": "OK"},
        "first_requests_s": load_request_s,
        "timing_equal": timing["timing_labels"] == str(ref_timing)
        and timing["phraselist"] == neutrino.get_phraselist(full, ref_timing),
        "acoustic_equal": all(np.array_equal(a, b)
                              for a, b in zip(got, feats)),
        "acoustic_max_abs": max(float(np.abs(a - b).max())
                                for a, b in zip(got, feats)),
        "waveform_equal": np.array_equal(
            np.frombuffer(base64.b64decode(wav["wav"]), np.int16), ref_wav),
        "stream_alone_s": alone_s, "stream_alone_first_chunk_s": alone[1],
        "stream_alone_equal_serial": len(alone[0]) == len(serial) and all(
            np.array_equal(a, b) for a, b in zip(alone[0], serial)),
        "streams": SURFACE_STREAMS, "streams_s": streams_s,
        "stream_first_chunk_s": [r[1] for r in results],
        "streams_equal_serial": [
            len(r[0]) == len(serial)
            and all(np.array_equal(a, b) for a, b in zip(r[0], serial))
            for r in results],
        "chunks": len(serial), "launches": launches,
        "launches_by_width": by_width}


def phase_surface(lr, engine, cpu, model_dir, label):
    """The score-to-audio surface over the stock single-track voice of
    phase ``single`` (``engine``, its ``model_dir``; ``cpu``, the same
    pack on the CPU): the packaged example scores through
    ``frontend.load_score`` and the NEUTRINO engine on the card
    (``surface_scores``); N_CALLS timed ``svs_streaming`` calls on the
    fixture (depth 2) with the forward's launches by width reset just
    before and read just after each (LAUNCHES_BY_HIDDEN per segment),
    seconds to the first chunk and RTF; one call at depth 1, bitwise equal;
    one with the learned postfilter (cuDNN's TF32 switch must end off);
    the first SURFACE_REF_SEGMENTS chunks against the CPU engine with the
    card's noise (durations equal, SNR_DB); the server
    (``surface_server``); ``bin/run_svs.main`` through
    ``pretrained.register_model``.  Returns the launches of the timed
    calls and of the server's concurrent streams."""
    from ensemble_svs_with_interactions_tpu_torch import pretrained
    from ensemble_svs_with_interactions_tpu_torch.bin import run_svs
    from ensemble_svs_with_interactions_tpu_torch.io import hts
    from ensemble_svs_with_interactions_tpu_torch.neutrino import NEUTRINO
    from ensemble_svs_with_interactions_tpu_torch.utils import misc

    t_phase = time.time()
    t0 = time.time()
    neutrino = NEUTRINO(model_dir, device="cuda")
    load_s = time.time() - t0
    scores = surface_scores(neutrino)

    dm = engine.predict_timing(label.copy())
    n_seg = len(hts.segment_labels(dm))
    want = {H: n * n_seg for H, n in LAUNCHES_BY_HIDDEN.items()}
    timed_stream(engine, label)  # warm-up
    runs, by_width, launches = [], [], 0
    for _ in range(N_CALLS):
        reset_launches(lr)
        chunks, first, total = timed_stream(engine, label)
        launches += lr.lstm_recurrence.launches
        by_width.append(dict(lr.lstm_recurrence.launches_by_width))
        audio_s = sum(len(c) for c in chunks) / engine.sample_rate
        runs.append({"first_chunk_s": first, "seconds": total,
                     "rtf": total / audio_s, "chunks": len(chunks)})
    deep = chunks
    shallow, shallow_first, shallow_s = timed_stream(engine, label,
                                                     pipeline_depth=1)
    bitwise = len(shallow) == len(deep) and all(
        np.array_equal(a, b) for a, b in zip(shallow, deep))
    # the learned postfilter's convolutions hold cuDNN's process-wide TF32
    # switch under a lock on every worker thread; it must end as it began
    nnsvs, _, nnsvs_s = timed_stream(engine, label, post_filter_type="nnsvs")
    tf32_after = torch.backends.cudnn.allow_tf32

    t0 = time.time()
    dm_cpu = cpu.predict_timing(label.copy())
    ref = stream_on_cpu(cpu, engine.device, label, SURFACE_REF_SEGMENTS)
    ref_s = time.time() - t0
    same_times = (list(dm.start_times) == list(dm_cpu.start_times)
                  and list(dm.end_times) == list(dm_cpu.end_times))
    ref_snr = [snr_db(r, g) for r, g in zip(ref, deep)]
    ref_lengths = [(len(r), len(g)) for r, g in zip(ref, deep)]

    t0 = time.time()
    server = surface_server(lr, model_dir, neutrino, label,
                            misc.example_xml_file())
    server_s = time.time() - t0
    with tempfile.TemporaryDirectory() as tmp:
        lab = Path(tmp) / "song.lab"
        label.save(lab)
        pretrained.register_model("chip_smoke/stock_voice", model_dir)
        t0 = time.time()
        try:
            rc = run_svs.main(["chip_smoke/stock_voice", str(lab),
                               str(Path(tmp) / "song.wav")])
        finally:
            pretrained.model_registry.pop("chip_smoke/stock_voice")
        run_svs_s = time.time() - t0
        from scipy.io import wavfile

        sr, wav = wavfile.read(Path(tmp) / "song.wav")
    emit({"phase": "surface", "load_s": load_s, "scores": scores,
          "segments": n_seg, "calls": N_CALLS, "runs": runs,
          "launches_per_call_expected": sum(want.values()),
          "launches_by_width": [{str(H): n for H, n in sorted(w.items())}
                                for w in by_width],
          "depth1": {"first_chunk_s": shallow_first, "seconds": shallow_s},
          "depth1_bitwise_equal_depth2": bitwise,
          "nnsvs": {"seconds": nnsvs_s, "chunks": len(nnsvs),
                    "finite": bool(all(np.isfinite(c).all() for c in nnsvs))},
          "cudnn_allow_tf32_after": tf32_after,
          "reference": {"segments": len(ref), "seconds": ref_s,
                        "durations_equal": same_times, "snr_db": ref_snr,
                        "lengths": ref_lengths, "snr_min_db": SNR_DB},
          "server": {**server, "seconds": server_s},
          "run_svs": {"rc": rc, "seconds": run_svs_s, "sample_rate": sr,
                      "samples": len(wav)},
          "seconds": time.time() - t_phase})
    xml, ust = scores["musicxml"], scores["ust"]
    assert xml["phones"] == ust["phones"], (xml["phones"], ust["phones"])
    for s in (xml, ust):
        assert s["finite"] and s["frames"] > 0 and s["wav_peak"] > 0, s
        assert s["phrases"] >= 1 and s["phraselist_lines"] >= 1, s
    assert n_seg > 1, n_seg
    for w in by_width:
        assert w == want, (w, want)
    for r in runs:
        assert r["chunks"] == n_seg, r
    assert bitwise
    assert len(nnsvs) == n_seg and all(np.isfinite(c).all() for c in nnsvs)
    assert tf32_after is False
    assert same_times
    assert len(ref) == SURFACE_REF_SEGMENTS
    assert all(a == b for a, b in ref_lengths), ref_lengths
    assert all(s > SNR_DB for s in ref_snr), ref_snr
    assert server["healthcheck"] and server["timing_equal"], server
    assert server["acoustic_equal"] and server["waveform_equal"], server
    assert server["stream_alone_equal_serial"], server
    assert all(server["streams_equal_serial"]), server
    assert server["chunks"] == n_seg
    assert server["launches_by_width"] == {
        H: n * (1 + SURFACE_STREAMS) for H, n in want.items()}, server
    assert rc == 0 and sr == engine.sample_rate and len(wav) > 30 * sr
    return {"svs_streaming": launches,
            "neutrino_server_stream": server["launches"]}


# ------------------------------------------------------------------
# Phase ``importer``: a reference NNSVS pack converted and served
# ------------------------------------------------------------------

# the published pretrained packs' three phases, at the shipped widths
REFERENCE_CONFIGS = {"timelag": "timelag/timelag_mdn.yaml",
                     "duration": "duration/duration_mdn.yaml",
                     "acoustic": "acoustic/acoustic_resf0convlstm.yaml"}
# the reference's module path of each model class the pack names
REFERENCE_TARGETS = {
    "MDN": "nnsvs.model.MDN", "MDNv2": "nnsvs.model.MDNv2",
    "LSTMRNN": "nnsvs.model.LSTMRNN", "FFConvLSTM": "nnsvs.model.FFConvLSTM",
    "TransformerEncoder": "nnsvs.model.TransformerEncoder",
    "ResSkipF0FFConvLSTM": "nnsvs.acoustic_models.ResSkipF0FFConvLSTM",
    "BiLSTMResF0NonAttentiveDecoder":
        "nnsvs.acoustic_models.BiLSTMResF0NonAttentiveDecoder",
}
# the converted voice's biLSTM launches an svs() call: the acoustic
# model's 256 x 2 layers x 2 directions (the MDN timing models have none)
IMPORTER_LAUNCHES_BY_HIDDEN = {256: 4}
IMPORTER_UNITS = {"timelag": 6, "duration": 6, "acoustic": 14}
MLPG_T, MLPG_D, MLPG_WINDOWS = T_FRAMES, 60, 3  # the device MLPG's shape
MLPG_ATOL = 1e-4   # float32 band Cholesky vs LAPACK in float64, T = 6656
MLPG_CALLS = 2


def _ref_mdn(prefix, port, hidden, out_dim, n_gauss, dim_wise=False):
    """The reference ``MDNLayer``: log_pi, log_sigma, mu."""
    n_pi = n_gauss * out_dim if dim_wise else n_gauss
    return [(f"{prefix}.log_pi", torch.nn.Linear(hidden, n_pi),
             f"{port}.log_pi"),
            (f"{prefix}.log_sigma", torch.nn.Linear(hidden, out_dim * n_gauss),
             f"{port}.log_sigma"),
            (f"{prefix}.mu", torch.nn.Linear(hidden, out_dim * n_gauss),
             f"{port}.mu")]


def _ref_sinsy_encoder(net, port, lf0: bool):
    """The reference FF + conv + biLSTM front (``ff``, ``conv``, ``lstm``):
    3 Linear, 3 x (Conv1d k = 7, BatchNorm1d) behind reflection pads, a
    bidirectional ``nn.LSTM``; the conv input takes the lf0 column too
    where ``lf0``.  ``port`` gives the port's scope names."""
    ff, conv = net["ff_hidden_dim"], net["conv_hidden_dim"]
    dims = [net["in_dim"], ff, ff, ff]
    out = [(f"ff.{2 * i}", torch.nn.Linear(dims[i], dims[i + 1]),
            f"{port['dense']}{i}") for i in range(3)]
    c_in = ff + (1 if lf0 else 0)
    for i in range(3):
        out += [(f"conv.{4 * i + 1}",
                 torch.nn.Conv1d(c_in if i == 0 else conv, conv, 7),
                 f"{port['conv']}{i}.Conv_0"),
                (f"conv.{4 * i + 2}", torch.nn.BatchNorm1d(conv),
                 f"{port['bn']}{i}")]
    out.append(("lstm", torch.nn.LSTM(conv, net["lstm_hidden_dim"],
                                      net.get("num_lstm_layers", 2),
                                      bidirectional=True, batch_first=True),
                port["lstm"]))
    return out


def reference_layers(net: dict) -> list:
    """The layers of the reference NNSVS model that ``net`` (a reference
    ``netG`` config) names, in the reference's definition order: [(state
    dict prefix, torch.nn layer or bare parameter tensor, the port's module
    path of its counterpart)]."""
    name = net["_target_"].rsplit(".", 1)[-1]
    L = torch.nn.Linear
    if name in ("MDN", "MDNv2"):
        step = 3 if name == "MDNv2" else 2   # Linear, ReLU[, Dropout]
        n = net.get("num_layers", 1)
        dims = [net["in_dim"]] + [net["hidden_dim"]] * n
        out = [(f"model.{step * i}", L(dims[i], dims[i + 1]), f"Dense_{i}")
               for i in range(n)]
        return out + _ref_mdn(f"model.{step * n}", "MDNLayer_0",
                              net["hidden_dim"], net["out_dim"],
                              net.get("num_gaussians", 8),
                              net.get("dim_wise", False))
    if name == "LSTMRNN":
        dirs = 2 if net.get("bidirectional", True) else 1
        return [("lstm", torch.nn.LSTM(net["in_dim"], net["hidden_dim"],
                                       net.get("num_layers", 1),
                                       bidirectional=dirs == 2,
                                       batch_first=True), "LSTM_0"),
                ("hidden2out", L(dirs * net["hidden_dim"], net["out_dim"]),
                 "Dense_0")]
    if name in ("FFConvLSTM", "ResSkipF0FFConvLSTM"):
        stack = "_ConvBNReLUStack_0." if name == "FFConvLSTM" else ""
        out = _ref_sinsy_encoder(net, {
            "dense": "Dense_", "conv": f"{stack}ReflectConv1d_",
            "bn": f"{stack}MaskedBatchNorm_", "lstm": "LSTM_0"},
            lf0=name != "FFConvLSTM")
        last = 2 * net["lstm_hidden_dim"] + (
            net["in_dim"] if net.get("skip_inputs") else 0)
        return out + [("fc", L(last, net["out_dim"]), "Dense_3")]
    if name == "BiLSTMResF0NonAttentiveDecoder":
        e = "_SinsyEncoder_0."
        out = _ref_sinsy_encoder(net, {
            "dense": f"{e}Dense_", "conv": f"{e}ReflectConv1d_",
            "bn": f"{e}MaskedBatchNorm_", "lstm": f"{e}LSTM_0"}, lf0=True)
        d_in = 2 * net["lstm_hidden_dim"] + 1
        pre, hid = net["prenet_hidden_dim"], net["decoder_hidden_dim"]
        p_in = net["out_dim"]
        for i in range(net["prenet_layers"]):
            out.append((f"decoder.prenet.prenet.{i}.0", L(p_in, pre),
                        f"ar_core.prenet.fc{i}"))
            p_in = pre
        for i in range(net["decoder_layers"]):
            out.append((f"decoder.lstm.{i}.cell",
                        torch.nn.LSTMCell(d_in + pre if i == 0 else hid, hid),
                        f"ar_core.cell{i}"))
        return out + [("decoder.feat_out",
                       L(d_in + hid, net["out_dim"] * net.get(
                           "reduction_factor", 1), bias=False),
                       "ar_core.feat_out")]
    if name == "TransformerEncoder":
        C, heads = net["hidden_dim"], net.get("num_heads", 2)
        window = net.get("window_size", 4)
        out = [("fc", L(net["in_dim"], C), "Dense_0")]
        for i in range(net.get("num_layers", 2)):
            enc, blk = "encoder.", f"_TransformerBlock_{i}."
            for k in ("k", "v"):
                out.append((f"{enc}attn_layers.{i}.emb_rel_{k}",
                            torch.randn(1, 2 * window + 1, C // heads)
                            * (C // heads) ** -0.5,
                            f"{blk}attn.emb_rel_{k}"))
            for k in ("q", "k", "v", "o"):
                out.append((f"{enc}attn_layers.{i}.conv_{k}",
                            torch.nn.Conv1d(C, C, 1), f"{blk}attn.conv_{k}"))
            for j, (ffn, norm) in enumerate(((None, "norm_layers_1"),
                                             ("ffn_layers", "norm_layers_2"))):
                if ffn:
                    F, k = net["attention_dim"], net.get("kernel_size", 3)
                    out += [(f"{enc}{ffn}.{i}.conv_1",
                             torch.nn.Conv1d(C, F, k), f"{blk}ffn_conv1"),
                            (f"{enc}{ffn}.{i}.conv_2",
                             torch.nn.Conv1d(F, C, k), f"{blk}ffn_conv2")]
                for leaf in ("gamma", "beta"):
                    out.append((f"{enc}{norm}.{i}.{leaf}", torch.randn(C),
                                f"{blk}norm_{j + 1}.{leaf}"))
        return out + [("fc_out", L(C, net["out_dim"]), "Dense_1")]
    raise ValueError(f"no reference layout for {name}")


def reference_state_dict(net: dict, seed: int):
    """(state dict, layers): the reference model of ``net`` built from
    seeded ``torch.nn`` layers (torch's own initialisers; the batch norms'
    affine weights and running statistics drawn too), its state dict in
    the reference's names and order."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        layers = reference_layers(net)
        for _, layer, _ in layers:
            if isinstance(layer, torch.nn.BatchNorm1d):
                with torch.no_grad():
                    layer.weight.uniform_(0.5, 1.5)
                    layer.bias.normal_(0.0, 0.1)
                    layer.running_mean.normal_(0.0, 0.5)
                    layer.running_var.uniform_(0.5, 2.0)
    sd = {}
    for prefix, layer, _ in layers:
        if isinstance(layer, torch.Tensor):
            sd[prefix] = layer.clone()
        else:
            for k, v in layer.state_dict().items():
                sd[f"{prefix}.{k}"] = v.clone()
    return sd, layers


def reference_voice(tiny: bool = False):
    """A reference NNSVS voice as the published packs hold it: (global
    config, {phase: (model yaml with the reference's ``_target_``, in
    scaler, out scaler)}).  The shipped ``timelag_mdn.yaml``,
    ``duration_mdn.yaml`` (MDNv2) and ``acoustic_resf0convlstm.yaml``
    (ResSkipF0FFConvLSTM: FF 2048, conv 1024, biLSTM 256 x 2), the lf0
    fields filled as a recipe fills them from data; ``tiny=True`` narrows
    the widths for the CPU tests."""
    from ensemble_svs_with_interactions_tpu_torch.utils.scalers import (
        MinMaxScaler,
        StandardScaler,
    )

    glob, _ = single_phases()
    phases = {}
    for phase, rel in REFERENCE_CONFIGS.items():
        cfg = shipped_config(rel)
        net = cfg["netG"]
        net["_target_"] = REFERENCE_TARGETS[net["_target_"].rsplit(".")[-1]]
        net.update({k: v for k, v in SINGLE_LF0.items() if net.get(k, 0)
                    is None})
        if tiny:
            w = TINY
            for k, v in (("hidden_dim", w["tl"]), ("ff_hidden_dim", w["ff"]),
                         ("conv_hidden_dim", w["conv"]),
                         ("lstm_hidden_dim", w["lstm"])):
                if k in net:
                    net[k] = v
        out = sum(cfg["stream_sizes"])
        if phase == "acoustic":
            mean, scale = np.zeros(out), np.ones(out) * 0.1
            lf0 = net["out_lf0_idx"]
            mean[lf0], scale[lf0] = SINGLE_LF0["out_lf0_mean"], \
                SINGLE_LF0["out_lf0_scale"]
            sc_out = StandardScaler(mean, scale ** 2, scale)
        else:
            sc_out = StandardScaler(np.ones(1) * (10 if phase == "duration"
                                                  else 0),
                                    np.ones(1) * 4, np.ones(1) * 2)
        n_in = net["in_dim"]
        phases[phase] = (cfg, MinMaxScaler(np.zeros(n_in), np.ones(n_in)),
                         sc_out)
    return glob, phases


def write_reference_pack(root, tiny: bool = False, seed: int = SEED) -> dict:
    """Write a reference NNSVS pack in the published tarballs' layout
    (``config.yaml``, ``qst.hed``, ``{phase}_model.yaml`` and
    ``{phase}_model.pth`` holding ``{"state_dict": ...}``, the scalers as
    ``.npy``) into ``root``; returns {phase: reference layers} for
    ``assert_reference_weights``."""
    from ensemble_svs_with_interactions_tpu_torch.utils import (
        packaged_question_path,
    )
    from ensemble_svs_with_interactions_tpu_torch.utils.config import (
        save_config,
    )
    from ensemble_svs_with_interactions_tpu_torch.utils.scalers import (
        save_scaler,
    )

    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    glob, phases = reference_voice(tiny)
    save_config(glob, root / "config.yaml")
    shutil.copyfile(packaged_question_path(), root / "qst.hed")
    layers = {}
    for phase, (cfg, sc_in, sc_out) in phases.items():
        save_config(cfg, root / f"{phase}_model.yaml")
        sd, layers[phase] = reference_state_dict(
            cfg["netG"], seed + PHASE_SEEDS[phase])
        torch.save({"state_dict": sd}, root / f"{phase}_model.pth")
        save_scaler(sc_in, str(root / f"in_{phase}_scaler"))
        save_scaler(sc_out, str(root / f"out_{phase}_scaler"))
    return layers


@torch.no_grad()
def assert_reference_weights(module, layers) -> int:
    """Every tensor of the reference ``layers`` sits bitwise in the port's
    ``module`` at the counterpart's path, in the port's layout (a Linear or
    Conv1d as it is; an LSTM's gates as ``w_x = weight_ih.T``, ``w_h =
    weight_hh.T``, ``b = bias_ih + bias_hh``; a batch norm's affine weights
    and running statistics; a LayerNorm's gamma and beta); returns the
    number of tensors checked."""
    subs = dict(module.named_modules())
    pairs = []

    def cell(port, w_ih, w_hh, b_ih, b_hh):
        pairs.extend([(subs[port].w_x, w_ih.T), (subs[port].w_h, w_hh.T),
                      (subs[port].b, b_ih + b_hh)])

    for _, layer, port in layers:
        if isinstance(layer, torch.Tensor):
            owner, leaf = port.rsplit(".", 1)
            got = getattr(subs[owner], {"gamma": "weight", "beta": "bias"}
                          .get(leaf, leaf))
            pairs.append((got, layer))
        elif isinstance(layer, torch.nn.LSTM):
            for k in range(layer.num_layers):
                for d, sfx in (("fwd", ""), ("bwd", "_reverse")):
                    if d == "bwd" and not layer.bidirectional:
                        continue
                    cell(f"{port}.l{k}_{d}",
                         *(getattr(layer, f"{w}_l{k}{sfx}") for w in (
                             "weight_ih", "weight_hh", "bias_ih", "bias_hh")))
        elif isinstance(layer, torch.nn.LSTMCell):
            cell(port, layer.weight_ih, layer.weight_hh, layer.bias_ih,
                 layer.bias_hh)
        else:
            mod = subs[port]
            names = ["weight", "bias"] + (
                ["running_mean", "running_var"]
                if isinstance(layer, torch.nn.BatchNorm1d) else [])
            pairs += [(getattr(mod, n), getattr(layer, n)) for n in names
                      if getattr(layer, n, None) is not None]
    for got, want in pairs:
        if not torch.equal(got.detach().cpu(), want.detach()):
            raise AssertionError("converted weights differ from the "
                                 "reference's")
    return len(pairs)


IMPORTER_GEN_FRAMES = (1000, 2000)  # bin/generate.py's two input dumps
PF_SP_CONFIG = "postfilter/postfilter_sp.yaml"
PF_SP_FRAMES = 512        # the sp postfilter's forward, card vs CPU
PF_SP_GAN_FRAMES = 16     # its GAN step, card vs CPU (float64 oracle)
VOCODER_HIFIGAN_CONFIG = "vocoder/vocoder_hifigan.yaml"
HIFIGAN_CROP_FRAMES = 12  # one crop a GAN step, card vs CPU
# The shipped HiFiGAN's float32 step on the card lies farther from the
# float64 step than the CPU's (tools/chip_hifigan_precision.py, 12
# frames, H100): the STFT losses by cuFFT's float32 rounding (the loss
# alone 2.5e-5 from float64 in Loss_STFT_Mag, the CPU 6.7e-6; the step
# 2.5e-5), and G's gradient in the card's float32 backward through the
# generator (the float64 upstream gradient carried back 4.4e-3 from
# float64, the CPU 1.1e-6; the same with cuDNN disabled), while the
# float64 runs agree within 1e-12.  Where ``hold_gan_step``'s rule fails
# for a loss or for G's gradient, it also passes when the float64 runs
# agree (VOCODER_F64_RTOL: the card computes the CPU's function) and the
# card's float32 run lies within HIFIGAN_F32_RTOL of the float64 step:
# 4x the card's 2.1e-5 / 2.5e-5 for the losses, 2.2x its 4.4e-3 / 4.6e-3
# for G's gradient.
HIFIGAN_F32_RTOL = {"loss": 1e-4, "G": 1e-2}


def device_mlpg() -> dict:
    """The device MLPG (``ops/mlpg.mlpg`` on a CUDA tensor, a loop over
    time of small torch ops) at MLPG_T x MLPG_D with MLPG_WINDOWS windows
    against the host LAPACK path (NumPy float64) on the same inputs:
    seconds a call of each (MLPG_CALLS calls, the card's synchronized) and
    the largest difference, which must stay under MLPG_ATOL."""
    from ensemble_svs_with_interactions_tpu_torch.ops import mlpg

    rng = np.random.default_rng(SEED)
    W = MLPG_WINDOWS * MLPG_D
    means = rng.standard_normal((MLPG_T, W)).astype(np.float32)
    var = rng.uniform(0.05, 2.0, (MLPG_T, W)).astype(np.float32)
    host_s, card_s = [], []
    for _ in range(MLPG_CALLS):
        t0 = time.time()
        host = mlpg.mlpg(means.astype(np.float64), var.astype(np.float64),
                         MLPG_WINDOWS)
        host_s.append(time.time() - t0)
    m, v = (torch.from_numpy(a).cuda() for a in (means, var))
    for _ in range(MLPG_CALLS + 1):   # the first call warms up
        torch.cuda.synchronize()
        t0 = time.time()
        card = mlpg.mlpg(m, v, MLPG_WINDOWS)
        torch.cuda.synchronize()
        card_s.append(time.time() - t0)
    err = float(np.abs(card.cpu().numpy() - host).max())
    return {"T": MLPG_T, "D": MLPG_D, "windows": MLPG_WINDOWS,
            "card_s": card_s[1:], "card_warmup_s": card_s[0],
            "host_s": host_s, "max_abs_err": err, "atol": MLPG_ATOL,
            "ok": err <= MLPG_ATOL}


def generate_on_card(lr, voice, root) -> dict:
    """``bin/generate.py`` over the converted voice on the card (launches
    reset just before and read just after) and on the CPU, over two seeded
    input dumps of IMPORTER_GEN_FRAMES frames: the features' largest
    difference over their scale."""
    from ensemble_svs_with_interactions_tpu_torch.bin import generate

    feats = Path(root) / "gen_in"
    feats.mkdir()
    rng = np.random.default_rng(SEED)
    for i, T in enumerate(IMPORTER_GEN_FRAMES):
        np.save(feats / f"u{i}-feats.npy",
                rng.uniform(0, 1, (T, 86)).astype(np.float32))
    out = {}
    for device in ("cuda", "cpu"):
        reset_launches(lr)
        t0 = time.time()
        assert generate.main([str(voice), str(feats),
                              str(Path(root) / f"gen_{device}"),
                              "--device", device]) == 0
        out[device] = (time.time() - t0,
                       dict(lr.lstm_recurrence.launches_by_width))
    err = 0.0
    for p in sorted((Path(root) / "gen_cpu").glob("*.npy")):
        ref = np.load(p)
        got = np.load(Path(root) / "gen_cuda" / p.name)
        assert got.shape == ref.shape and np.isfinite(got).all(), p
        err = max(err, float(np.abs(got - ref).max()
                             / max(np.abs(ref).max(), 1e-12)))
    return {"utterances": len(IMPORTER_GEN_FRAMES),
            "frames": list(IMPORTER_GEN_FRAMES), "card_s": out["cuda"][0],
            "cpu_s": out["cpu"][0],
            "launches_by_width": {str(H): n for H, n in out["cuda"][1].items()},
            "cpu_launches": sum(out["cpu"][1].values()),
            "err_over_scale": err, "rtol": MODULE_ATOL}


def postfilter_sp_on_card(root) -> dict:
    """``postfilter_sp.yaml`` at the shipped widths on the card: the
    model built from its file with the flax schemes' weights, its
    inference on PF_SP_FRAMES frames card against CPU (the noise from one
    CPU generator on both), and one GAN step of stage 9's trainer config
    around it (``run_recipe.postfilter_train_config``) card against CPU
    with a float64 oracle (``hold_pf_gan`` on PF_SP_GAN_FRAMES frames of a
    seeded pair)."""
    from ensemble_svs_with_interactions_tpu_torch.bin import run_recipe
    from ensemble_svs_with_interactions_tpu_torch.train import (
        postfilter_trainer as pt,
    )
    from ensemble_svs_with_interactions_tpu_torch.utils.config import _wrap
    from ensemble_svs_with_interactions_tpu_torch.utils.flax_init import (
        init_module,
    )

    t0 = time.time()
    cfg = shipped_config(PF_SP_CONFIG)
    work = Path(root) / "pf_sp"
    D = sum(cfg["stream_sizes"])
    rng = np.random.default_rng(SEED)
    for kind in ("in_postfilter", "out_postfilter"):
        d = work / "postfilter" / "train_no_dev" / kind
        d.mkdir(parents=True)
        np.save(d / "u0-feats.npy",
                rng.standard_normal((PF_SP_FRAMES, D)).astype(np.float32))
    train_cfg = run_recipe.postfilter_train_config(
        _wrap({"postfilter": {"model": cfg}}), work)
    cpu = init_module(pt.build_postfilter(train_cfg), seed=0).eval()
    card = copy.deepcopy(cpu).cuda()
    x = torch.from_numpy(rng.standard_normal((1, PF_SP_FRAMES, D)).astype(
        np.float32))
    with torch.no_grad():
        ref = cpu.inference(x)
        torch.cuda.synchronize()
        t1 = time.time()
        got = card.inference(x.cuda()).cpu()
        card_ms = 1e3 * (time.time() - t1)
    err = float((got - ref).abs().max() / ref.abs().max())
    held = hold_pf_gan(train_cfg, work, frames=PF_SP_GAN_FRAMES)
    return {"config": PF_SP_CONFIG, "frames": PF_SP_FRAMES,
            "params": sum(p.numel() for p in cpu.parameters()),
            "forward_err_over_scale": err, "rtol": POSTFILTER_RTOL,
            "forward_card_ms": card_ms, "gan_hold": held,
            "seconds": time.time() - t0}


def hifigan_on_card(root) -> dict:
    """``vocoder_hifigan.yaml`` at the shipped widths on the card: the
    generator forward card against CPU (``hold_generator``), and one
    ``train_vocoder`` GAN step on one crop of HIFIGAN_CROP_FRAMES frames
    judged by ``hold_gan_step`` (card against CPU, float32 and float64),
    the losses and G's gradient also by HIFIGAN_F32_RTOL."""
    t0 = time.time()
    corpus = write_vocoder_corpus(Path(root) / "voc_in", n=2, frames=40)
    cfg = vocoder_train_config(corpus, Path(root) / "voc_exp",
                               VOCODER_HIFIGAN_CONFIG,
                               data={"crop_frames": HIFIGAN_CROP_FRAMES},
                               batch_size=1)
    gen = hold_generator(dict(cfg.model.generator), None,
                         torch.device("cuda"), frames=HIFIGAN_CROP_FRAMES)
    held = hold_gan_step(cfg, torch.device("cuda"))

    def ok(r, tol):
        return r["ok"] or (r["f64_rel"] < VOCODER_F64_RTOL
                           and r["card_to_f64"] <= tol)

    gan_ok = (all(ok(r, HIFIGAN_F32_RTOL["loss"])
                  for r in held["losses"].values())
              and ok(held["grads"]["G"], HIFIGAN_F32_RTOL["G"])
              and held["grads"]["D"]["ok"])
    return {"config": VOCODER_HIFIGAN_CONFIG,
            "crop_frames": HIFIGAN_CROP_FRAMES, "generator": gen,
            "gan_hold": held, "f32_rtol": HIFIGAN_F32_RTOL,
            "gan_ok": bool(gan_ok), "seconds": time.time() - t0}


def anasyn_on_card(root, label) -> dict:
    """``bin/anasyn.py`` on 2 s of the fixture's singing stand-in at 48
    kHz: the host WORLD analysis, then synthesis on the card and on the
    CPU from the same CPU-seeded excitation, the waveforms by SNR."""
    from ensemble_svs_with_interactions_tpu_torch.bin import anasyn
    from ensemble_svs_with_interactions_tpu_torch.io import hts
    from ensemble_svs_with_interactions_tpu_torch.utils import (
        packaged_question_path,
    )
    from scipy.io import wavfile

    binary_dict, numeric_dict = hts.load_question_set(
        packaged_question_path())
    x = synth_wav(trim_labels(label, 2.0), binary_dict, numeric_dict,
                  np.random.default_rng(SEED), RECIPE_SR)[: 2 * RECIPE_SR]
    src = Path(root) / "anasyn.wav"
    wavfile.write(src, RECIPE_SR, x)
    out = {}
    for device in ("cuda", "cpu"):
        t0 = time.time()
        assert anasyn.main([str(src), str(Path(root) / f"{device}.wav"),
                            "--device", device]) == 0
        out[device] = (time.time() - t0,
                       wavfile.read(Path(root) / f"{device}.wav")[1])
    ref, got = (out[d][1].astype(np.float64) for d in ("cpu", "cuda"))
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return {"seconds_audio": len(x) / RECIPE_SR, "card_s": out["cuda"][0],
            "cpu_s": out["cpu"][0], "snr_db": snr_db(ref, got)}


def phase_importer(lr, label) -> dict:
    """A published-style NNSVS voice converted and served (phase 12): a
    reference pack (``write_reference_pack``: the shipped MDNv2 timing and
    ResSkipF0FFConvLSTM acoustic configs at full width, reference
    ``_target_`` names and layer names, seeded ``torch.nn`` weights) through
    ``bin/enunu2nnsvs.convert_nnsvs_pack`` (the units counted,
    IMPORTER_UNITS) into ``SPSVS(voice_dir)`` on the card: the converted
    weights bitwise the reference's (``assert_reference_weights``), a
    warm-up then N_CALLS ``svs()`` calls of the fixture with the forward's
    launches reset just before and read just after each
    (IMPORTER_LAUNCHES_BY_HIDDEN a call), the card against the CPU
    (``single_svs_on_cpu``: durations equal, SNR_DB); ``bin/generate.py``
    on the card and the CPU (``generate_on_card``); the device MLPG
    against the host path (``device_mlpg``); ``postfilter_sp.yaml`` and
    ``vocoder_hifigan.yaml`` at the shipped widths
    (``postfilter_sp_on_card``, ``hifigan_on_card``); ``bin/anasyn.py``
    card against CPU.  Returns the launches of the timed ``svs()`` calls
    and of ``generate``, by path."""
    from ensemble_svs_with_interactions_tpu_torch.bin import enunu2nnsvs
    from ensemble_svs_with_interactions_tpu_torch.svs import SPSVS

    t_phase = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.time()
        layers = write_reference_pack(root / "reference")
        write_s = time.time() - t0
        t0 = time.time()
        ported = dict(enunu2nnsvs.convert_nnsvs_pack(root / "reference",
                                                     root / "voice"))
        convert_s = time.time() - t0
        t0 = time.time()
        engine = SPSVS(root / "voice", device="cuda")
        torch.cuda.synchronize()
        load_s = time.time() - t0
        checked = {phase: assert_reference_weights(
            getattr(engine, f"{phase}_model").module, layers[phase])
            for phase in REFERENCE_CONFIGS}
        t0 = time.time()
        engine.svs(label.copy())
        warm_s = time.time() - t0
        runs = []
        for _ in range(N_CALLS):
            reset_launches(lr)
            t0 = time.time()
            wav, sr = engine.svs(label.copy())
            runs.append({"seconds": time.time() - t0,
                         "rtf": engine.last_rtf,
                         "stages": dict(engine.last_stage_times),
                         "launches_by_width": dict(
                             lr.lstm_recurrence.launches_by_width)})
        by_kernel = {lr.lstm_recurrence_kernel_name(1, H): n for H, n in
                     IMPORTER_LAUNCHES_BY_HIDDEN.items()}
        del engine
        reference = single_svs_on_cpu(root / "voice", FIXTURE,
                                      post_filter_type="gv")
        generated = generate_on_card(lr, root / "voice", root)
        mlpg_row = device_mlpg()
        pf_sp = postfilter_sp_on_card(root)
        hifigan = hifigan_on_card(root)
        copy_synthesis = anasyn_on_card(root, label)
    emit({"phase": "importer", "units": ported,
          "weights_checked": checked, "write_s": write_s,
          "convert_s": convert_s, "load_s": load_s, "warmup_s": warm_s,
          "runs_s": [r["seconds"] for r in runs],
          "rtf": [r["rtf"] for r in runs],
          "stages": runs[-1]["stages"], "audio_s": len(wav) / sr,
          "launches_by_width": [{str(H): n for H, n in
                                 r["launches_by_width"].items()}
                                for r in runs],
          "launches_by_kernel_per_call": by_kernel,
          "svs_reference": reference, "generate": generated,
          "mlpg": mlpg_row, "postfilter_sp": pf_sp, "hifigan": hifigan,
          "anasyn": copy_synthesis, "snr_bound_db": SNR_DB,
          "seconds": time.time() - t_phase})
    assert ported == IMPORTER_UNITS, ported
    for r in runs:
        assert r["launches_by_width"] == IMPORTER_LAUNCHES_BY_HIDDEN, r
    assert np.abs(wav).max() > 0 and np.isfinite(wav).all()
    assert reference["durations_equal"], reference
    assert reference["snr_db"] >= SNR_DB, reference
    assert max(reference["stream_err_over_scale"].values()) <= POST_ATOL, \
        reference
    gen_launches = sum(int(v) for v in
                       generated["launches_by_width"].values())
    assert generated["launches_by_width"] == {
        str(H): n * len(IMPORTER_GEN_FRAMES)
        for H, n in IMPORTER_LAUNCHES_BY_HIDDEN.items()}, generated
    assert generated["cpu_launches"] == 0, generated
    assert generated["err_over_scale"] <= MODULE_ATOL, generated
    assert mlpg_row["ok"], mlpg_row
    assert pf_sp["forward_err_over_scale"] <= POSTFILTER_RTOL, pf_sp
    assert pf_sp["gan_hold"]["ok"], pf_sp
    assert hifigan["generator"]["finite"], hifigan
    assert hifigan["generator"]["rel_err"] <= VOCODER_RTOL, hifigan
    assert hifigan["gan_ok"], hifigan
    assert copy_synthesis["snr_db"] >= SNR_DB, copy_synthesis
    return {"importer_svs": sum(sum(r["launches_by_width"].values())
                                for r in runs),
            "generate": gen_launches}


def late_copy(labels, lag: int = SUB_LAG):
    """The labels sung ``lag`` (100 ns units) late: every time but the
    first start."""
    sub = labels.copy()
    sub.start_times = [sub.start_times[0]] + [t + lag for t in
                                              sub.start_times[1:]]
    sub.end_times = [t + lag for t in sub.end_times]
    return sub


def pair_streams(engine, main, sub, spks):
    """One pair's host streams as ``bin/synthesis_multitrack.py``'s
    ``svs_multitrack`` makes them: timing each way, the main track's
    acoustic features, the host postprocess."""
    dm = engine.predict_timing_multitrack([main, sub], spks)[0]
    dm_sub = engine.predict_timing_multitrack([sub, main], spks[::-1])[0]
    acoustic = engine.predict_acoustic_multitrack([dm, dm_sub], spks)
    return engine.postprocess_acoustic(acoustic, dm)


def svs_pair(engine, main, sub, spks, vocoder_type="world"):
    """One pair as ``svs_multitrack`` renders it: ``pair_streams``, the
    vocoder and the waveform's postprocess (int16)."""
    streams = pair_streams(engine, main, sub, spks)
    return engine.postprocess_waveform(
        engine.predict_waveform(streams, vocoder_type=vocoder_type))


def phase_pairwise(lr, engine, cpu, label):
    """The flagship's per-pair path, the recipe's synthesis stage: the
    fixture as the main track of a pair whose sub track is the fixture
    sung SUB_LAG late (``svs_pair``: a warm-up, then N_CALLS timed pairs
    with the launch counts reset just before and read just after,
    LAUNCHES_BY_HIDDEN a pair at B = 1); then, over the first 60 labels,
    the card against the CPU engine: the pair's timing each way exactly,
    and the modules on the pair's acoustic input (both tracks padded to the
    longer, as ``predict_acoustic_multitrack`` gives them) by
    ``hold_modules``.  Returns the launches."""
    from ensemble_svs_with_interactions_tpu_torch.gen import (
        FRAME_BUCKET,
        _round_up,
    )

    spks = [0, 1]
    main, sub = label, late_copy(label)
    t0 = time.time()
    svs_pair(engine, main, sub, spks)
    warm_s = time.time() - t0
    reset_launches(lr)
    runs = []
    for _ in range(N_CALLS):
        t0 = time.time()
        wav = svs_pair(engine, main, sub, spks)
        runs.append(time.time() - t0)
    launches = lr.lstm_recurrence.launches
    by_width = dict(lr.lstm_recurrence.launches_by_width)
    audio_s = len(wav) / engine.sample_rate

    t0 = time.time()
    short = (main[:60], sub[:60])
    timing = {}
    for name, pair, ids in (("main", short, spks),
                            ("sub", short[::-1], spks[::-1])):
        got, ref = (e.predict_timing_multitrack(list(pair), ids)
                    for e in (engine, cpu))
        timing[name] = (list(got[0].start_times) == list(ref[0].start_times)
                        and list(got[0].end_times) == list(ref[0].end_times)
                        and bool(np.array_equal(got[1], ref[1])))
        if name == "main":
            dm = got[0]
        else:
            dm_sub = got[0]
    feats, _ = engine._frame_features([dm.copy(), dm_sub.copy()])
    n = max(len(f) for f in feats)
    T = _round_up(n, FRAME_BUCKET)
    xm, xs = (np.zeros((1, T, f.shape[1]), np.float32) for f in feats)
    xm[0, : len(feats[0])] = feats[0]
    xs[0, : len(feats[1])] = feats[1]
    valid = torch.from_numpy(np.arange(T)[None, :] < len(feats[0]))
    held = hold_modules(engine.acoustic_model.module,
                        cpu.acoustic_model.module, valid, xm, xs, [spks[0]],
                        [spks[1]], [n])
    emit({"phase": "pairwise", "warmup_s": warm_s, "runs_s": runs,
          "rtf": [r / audio_s for r in runs], "audio_seconds": audio_s,
          "calls": N_CALLS, "launches": launches,
          "launches_by_width": {str(H): c
                                for H, c in sorted(by_width.items())},
          "reference": {"labels": 60, "frames": n, "T": T,
                        "timing_equal": timing, **held,
                        "seconds": time.time() - t0}})
    assert by_width == {H: c * N_CALLS for H, c in
                        LAUNCHES_BY_HIDDEN.items()}, by_width
    assert wav.dtype == np.int16 and len(wav) > 30 * engine.sample_rate
    assert np.abs(wav.astype(np.int64)).max() > 0
    assert all(timing.values()), timing
    assert_held(held)
    return launches


# ------------------------------------------------------- diffusion voice
# the diffusion voice's single-direction recurrences per svs_ensemble call
# (B = 4) or pair (B = 1), by width: the mgc chain's encoder at 128; the
# bap chain's encoder, the vuv model and the lf0 model's encoder at 64
# (each 2 layers x 2 directions)
DIFFUSION_LAUNCHES_BY_HIDDEN = {128: 4, 64: 12}
DIFFUSION_LAUNCHES_PER_CALL = sum(DIFFUSION_LAUNCHES_BY_HIDDEN.values())
DIFFUSION_SPK_IDS = [0, 1, 2, 0]     # every id below the config's 3
DIFFUSION_REF_SECONDS = 2.3          # one 512-frame bucket of the fixture
CHAINS = ("mgc_model", "bap_model")


def diffnet_work(net, B: int, T: int, K: int):
    """(FLOPs, bytes) of one chain of K denoiser calls of a ``DiffNet`` on
    B x T frames: the convolutions' and the step MLPs' multiply-adds (the
    loop-invariant ``cond_proj`` included, as the chain computes it); the
    weights, the condition, x_T and K step draws read once and the result
    written once."""
    res = net.res0
    C = net.residual_channels
    E, M = res.cond_proj.in_channels, net.input_proj.in_channels
    per_frame = (M * C + net.residual_layers * (3 * C * 2 * C + E * 2 * C
                                                 + C * 2 * C)
                 + C * C + C * M)
    per_item = C * 4 * C + 4 * C * C + net.residual_layers * C * C
    flops = 2 * K * (B * T * per_frame + B * per_item)
    params = sum(p.numel() for p in net.parameters())
    nbytes = 4 * (params + B * T * E + (K + 2) * B * T * M)
    return flops, nbytes


def chain_bound(module, B: int, T: int) -> dict:
    """The two chains' bound at B x T: {chain: (bytes ms, operations ms)}
    and the sum's bound (float32 FMA rate, memory rate)."""
    out = {}
    for name in CHAINS:
        d = getattr(module, name)
        flops, nbytes = diffnet_work(d.denoise_fn, B, T, d.K_step)
        out[name] = {"tflop": flops / 1e12,
                     "bytes_ms": 1e3 * nbytes / PEAK_BYTES_PER_S,
                     "operations_ms": 1e3 * flops / PEAK_FP32_FLOP_PER_S}
    tb = sum(v["bytes_ms"] for v in out.values())
    to = sum(v["operations_ms"] for v in out.values())
    out["bound_ms"], out["bound_by"] = bound(tb, to)
    return out


def time_chains(module, log: list):
    """Record CUDA events around each chain's ``inference`` (an instance
    attribute over the method) into ``log`` as (chain, start, end)."""
    for name in CHAINS:
        sub = getattr(module, name)

        def timed(*a, _orig=type(sub).inference.__get__(sub), _name=name,
                  **k):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = _orig(*a, **k)
            end.record()
            log.append((_name, start, end))
            return out

        sub.inference = timed


def chain_ms(log: list) -> dict:
    """{chain: device ms} summed over ``log``, which it empties."""
    torch.cuda.synchronize()
    out = {name: 0.0 for name in CHAINS}
    for name, start, end in log:
        out[name] += start.elapsed_time(end)
    log.clear()
    return out


def set_tf32(module, on: bool):
    for name in CHAINS:
        getattr(module, name).allow_tf32 = on


def diffusion_acoustic(engine, labels, spk_ids):
    """The acoustic model's device output of one ``svs_ensemble``'s batch
    (the pairs' ring) and the valid-frame mask."""
    N = len(labels)
    pairs = [(i + 1) % N for i in range(N)]
    dm = engine.predict_timing_multitrack_batch(
        [lab.copy() for lab in labels], spk_ids, pairs)
    feats, _ = engine._frame_features(dm)
    out, lengths = engine.acoustic_model.inference_batch(
        feats, device_out=True, sub_index=pairs, method="inference_main",
        spks=(spk_ids, [spk_ids[p] for p in pairs]))
    valid = np.arange(out.shape[1])[None, :] < lengths[:, None]
    return out, torch.from_numpy(valid).to(out.device)


def phase_diffusion(lr, model_dir, labels):
    """The recipe's diffusion ensemble voice through the normal entry
    point: ``diffusion_phases()`` (the shipped config at full width, seeded
    random weights) packed into ``model_dir`` and opened by
    ``SPSVS(model_dir)``; a warm-up, then N_CALLS timed ``svs_ensemble``
    calls on 4 copies of the fixture (speakers DIFFUSION_SPK_IDS) with the
    launch counts by width reset just before and read just after, each
    chain's device time (CUDA events) beside the chains' float32 bound,
    and the peak memory; a call with blocked stage times; then one call
    with TF32 allowed in the chains' convolutions, and the distance of
    its acoustic output from the float32 one on the same noise.  Returns
    the engine and the launches."""
    from ensemble_svs_with_interactions_tpu_torch.svs import SPSVS

    glob, phases = diffusion_phases()
    t0 = time.time()
    pack_phases(model_dir, glob, phases, random_state_dicts(phases, SEED))
    pack_s = time.time() - t0
    t0 = time.time()
    engine = SPSVS(model_dir)
    torch.cuda.synchronize()
    load_s = time.time() - t0
    module = engine.acoustic_model.module
    log = []
    time_chains(module, log)

    def call(**kw):
        t0 = time.time()
        wavs, sr = engine.svs_ensemble([lab.copy() for lab in labels],
                                       spk_ids=DIFFUSION_SPK_IDS, **kw)
        return wavs, sr, time.time() - t0

    _, _, warm_s = call()
    chain_ms(log)
    torch.cuda.reset_peak_memory_stats()
    reset_launches(lr)
    runs = []
    for _ in range(N_CALLS):
        wavs, sr, sec = call()
        runs.append({"seconds": sec, "rtf": engine.last_rtf,
                     "stages": dict(engine.last_stage_times),
                     "chain_ms": chain_ms(log)})
    launches = lr.lstm_recurrence.launches
    by_width = dict(lr.lstm_recurrence.launches_by_width)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    call(blocked_stage_times=True)
    blocked = dict(engine.last_stage_times)
    blocked_chains = chain_ms(log)

    f32_out, valid = diffusion_acoustic(engine, labels, DIFFUSION_SPK_IDS)
    chain_ms(log)
    set_tf32(module, True)
    try:
        _, _, tf32_s = call()
        tf32 = {"seconds": tf32_s, "rtf": engine.last_rtf,
                "chain_ms": chain_ms(log)}
        tf32_out, _ = diffusion_acoustic(engine, labels, DIFFUSION_SPK_IDS)
        chain_ms(log)
    finally:
        set_tf32(module, False)
    diff = (tf32_out - f32_out).abs()[valid]
    ss = np.cumsum([0] + list(engine.acoustic_model.config.stream_sizes))
    tf32["max_abs_diff"] = diff.max().item()
    tf32["max_abs_diff_by_stream"] = {
        name: (tf32_out - f32_out)[..., ss[i]: ss[i + 1]].abs()[valid]
        .max().item() for i, name in enumerate(("mgc", "lf0", "vuv", "bap"))}
    tf32["f32_max_abs"] = f32_out.abs()[valid].max().item()

    T = int(valid.shape[1])
    cb = chain_bound(module, len(labels), T)
    audio_s = max(len(w) for w in wavs) / sr
    by_kernel = {}
    for H, n in sorted(by_width.items()):
        name = lr.lstm_recurrence_kernel_name(len(labels), H)
        by_kernel[name] = by_kernel.get(name, 0) + n
    chains = [sum(r["chain_ms"].values()) for r in runs]
    emit({"phase": "diffusion", "config": DIFFUSION_CONFIG,
          "pack_s": pack_s, "load_s": load_s, "warmup_s": warm_s,
          "runs_s": [r["seconds"] for r in runs],
          "rtf": [r["rtf"] for r in runs],
          "stages": runs[len(runs) // 2]["stages"],
          "blocked_stages": blocked, "blocked_chain_ms": blocked_chains,
          "chain_ms": [r["chain_ms"] for r in runs],
          "chains_ms": chains, "T_pad": T, "chain_bound": cb,
          "chains_over_bound": [c / cb["bound_ms"] for c in chains],
          "audio_seconds": audio_s, "wav_lengths": [len(w) for w in wavs],
          "calls": N_CALLS, "launches": launches,
          "launches_by_width": {str(H): n
                                for H, n in sorted(by_width.items())},
          "launches_by_kernel": by_kernel, "peak_mem_gib": peak,
          "tf32": tf32})
    assert by_width == {H: n * N_CALLS for H, n in
                        DIFFUSION_LAUNCHES_BY_HIDDEN.items()}, by_width
    assert torch.isfinite(f32_out).all() and torch.isfinite(tf32_out).all()
    for w in wavs:
        assert w.dtype == np.int16 and len(w) > 30 * sr, (w.dtype, len(w))
        assert np.abs(w.astype(np.int64)).max() > 0
    return engine, launches


def diffusion_modules(m, dev, xm, xs, spk_ids, sub_ids, lengths, noise=None,
                      dec_in=None, ar_only=False):
    """The diffusion voice's modules on host (1, T, 86) main and sub
    features: the AR lf0 decoder (its dropout masks from a CPU generator
    seeded with ``AR_SEED``), then on ``dec_in`` = (x, lf0) (by default
    this run's) the mgc and bap chains (their noise recorded, or replayed
    from ``noise``) and the vuv model on (x, mgc, lf0) of the chains'
    outputs; float64 CPU tensors, and the inputs and noise used."""
    from ensemble_svs_with_interactions_tpu_torch.gen import AR_SEED
    from ensemble_svs_with_interactions_tpu_torch.models.diffsinger import (
        chain_noise,
    )
    from ensemble_svs_with_interactions_tpu_torch.models.generic import (
        speaker_embeddings,
    )

    dtype = next(m.parameters()).dtype
    xm = torch.from_numpy(xm).to(dev, dtype)
    xs = torch.from_numpy(xs).to(dev, dtype)
    B, T = xm.shape[0], xm.shape[1]
    ln = torch.as_tensor(np.asarray(lengths), device=dev)
    spk_m = speaker_embeddings(m.speaker_embedding,
                               torch.as_tensor(spk_ids, device=dev), B, T)
    spk_s = speaker_embeddings(m.speaker_embedding,
                               torch.as_tensor(sub_ids, device=dev), B, T)
    with torch.no_grad():
        out = {"ar_lf0": m.lf0_model(
            xm, xs, spk_m, spk_s, ln,
            generator=torch.Generator().manual_seed(AR_SEED))[0]}
        if not ar_only:
            if dec_in is None:
                dec_in = torch.cat([xm, out["ar_lf0"]], dim=-1).cpu()
            d = dec_in.to(dev, dtype)
            gen = torch.Generator(dev).manual_seed(SEED)
            with chain_noise(noise) as drawn:
                for k in CHAINS:
                    out[k] = getattr(m, k).inference(
                        d, ln, spk_embs=spk_m, chain_generator=gen)
            vuv_in = torch.cat([xm, out["mgc_model"], d[..., -1:]], dim=-1)
            out["vuv_model"] = m.vuv_model(vuv_in, ln, spk_embs=spk_m)
            noise = drawn if noise is None else noise
    return {k: v.cpu().double() for k, v in out.items()}, dec_in, noise


def phase_diffusion_reference(engine, model_dir, label):
    """The diffusion voice on the card against the same pack opened on the
    CPU, one track over one 512-frame bucket (the fixture's first
    DIFFUSION_REF_SECONDS, paired with itself sung SUB_LAG late): the
    pair's timing each way exactly; on the pair's acoustic input the AR lf0
    decoder against a float64 oracle under AR_HEADROOM and the mgc and bap
    chains (the card's noise replayed on the CPU) and the vuv model at
    MODULE_ATOL; and the rendered pair (timing, acoustic features, host
    postprocess, WORLD with the same noise on both) at SNR_DB."""
    from ensemble_svs_with_interactions_tpu_torch.gen import (
        FRAME_BUCKET,
        _round_up,
        vocoder_noise,
    )
    from ensemble_svs_with_interactions_tpu_torch.models.diffsinger import (
        chain_noise,
    )
    from ensemble_svs_with_interactions_tpu_torch.svs import SPSVS

    t0 = time.time()
    cpu = SPSVS(model_dir, device="cpu")
    n_labels = next(i for i, e in enumerate(label.end_times)
                    if e > DIFFUSION_REF_SECONDS * 1e7)
    main = label[:n_labels]
    sub = late_copy(main)
    spks = [0, 1]
    timing, dms = {}, {}
    for name, pair, ids in (("main", (main, sub), spks),
                            ("sub", (sub, main), spks[::-1])):
        got, ref = (e.predict_timing_multitrack(list(pair), ids)
                    for e in (engine, cpu))
        timing[name] = (list(got[0].start_times) == list(ref[0].start_times)
                        and list(got[0].end_times) == list(ref[0].end_times)
                        and bool(np.array_equal(got[1], ref[1])))
        dms[name] = got[0]
    feats, _ = engine._frame_features([dms["main"].copy(),
                                       dms["sub"].copy()])
    n = max(len(f) for f in feats)
    T = _round_up(n, FRAME_BUCKET)
    xm, xs = (np.zeros((1, T, f.shape[1]), np.float32) for f in feats)
    xm[0, : len(feats[0])] = feats[0]
    xs[0, : len(feats[1])] = feats[1]
    valid = torch.from_numpy(np.arange(T)[None, :] < len(feats[0]))
    args = (xm, xs, [spks[0]], [spks[1]], [n])
    card_m, cpu_m = engine.acoustic_model.module, cpu.acoustic_model.module
    got, dec_in, noise = diffusion_modules(card_m, engine.device, *args)
    ref, _, _ = diffusion_modules(cpu_m, torch.device("cpu"), *args,
                                  noise=noise, dec_in=dec_in)
    oracle, _, _ = diffusion_modules(copy.deepcopy(cpu_m).double(),
                                     torch.device("cpu"), *args,
                                     ar_only=True)

    def dist(a, b):
        return (a - b)[valid].abs().max().item()

    errs = {k: dist(got[k], ref[k]) for k in ref}
    ar = {"card_vs_f64": dist(got["ar_lf0"], oracle["ar_lf0"]),
          "cpu_f32_vs_f64": dist(ref["ar_lf0"], oracle["ar_lf0"])}
    held = {"max_abs_err": errs, "atol": MODULE_ATOL, "ar_lf0": ar,
            "ar_lf0_limit": max(AR_ABS_ATOL,
                                AR_HEADROOM * ar["cpu_f32_vs_f64"]),
            "chain_max_abs": {k: got[k][valid].abs().max().item()
                              for k in CHAINS},
            "finite": all(bool(torch.isfinite(v).all())
                          for v in got.values())}

    # the whole pair on each side: the card's chain noise replayed on the
    # CPU, one vocoder noise for both
    spk_pair = [spks[0], spks[1]]
    pair = [dms["main"].copy(), dms["sub"].copy()]
    with chain_noise() as drawn:
        ac_card = engine.predict_acoustic_multitrack(pair, spk_pair)
    with chain_noise(drawn):
        ac_cpu = cpu.predict_acoustic_multitrack(
            [dms["main"].copy(), dms["sub"].copy()], spk_pair)
    hop = int(engine.sample_rate * engine.frame_period / 1000)
    vnoise = vocoder_noise(1, T * hop, "cpu")
    wavs = []
    for e, ac in ((engine, ac_card), (cpu, ac_cpu)):
        streams = e.postprocess_acoustic(ac, dms["main"].copy())
        wav = e.predict_waveform(streams, noise=vnoise.to(e.device))
        wavs.append(e.postprocess_waveform(wav, dtype=np.float64))
    snr = snr_db(wavs[1], wavs[0])
    emit({"phase": "diffusion_reference", "labels": n_labels, "frames": n,
          "T": T, "timing_equal": timing, **held,
          "acoustic_max_abs_diff": float(np.abs(ac_card - ac_cpu).max()),
          "waveform": {"samples": len(wavs[0]), "snr_db": snr,
                       "snr_min_db": SNR_DB},
          "seconds": time.time() - t0})
    assert T == FRAME_BUCKET, T
    assert all(timing.values()), timing
    assert_held(held)
    assert np.isfinite(wavs[0]).all() and np.abs(wavs[0]).max() > 0
    assert snr > SNR_DB, snr


# --------------------------------------------------------- neural vocoder
VOCODER_CONFIG = "vocoder/vocoder_parallel_hn_usfgan.yaml"
# the generator's output, card against CPU on the same inputs: the largest
# difference over the output's largest entry (float32 convolutions, TF32
# off, in another summation order, 55 blocks deep)
VOCODER_RTOL = 1e-4
# the waveform through predict_waveform on identical streams, card against
# CPU (the same host excitation on both)
VOCODER_SNR_DB = 60.0
# labels of the fixture the CPU generator renders (about 6.6 s of audio;
# 60 until the multi-speaker phase joined the script, cut to keep it
# near 12 minutes)
VOCODER_REF_LABELS = 30
# the excitation channels of the recipe's generator: [sine, noise]
VOCODER_SIGNALS = 2
VOC = f"{PKG}.models.vocoders"
_TINY_NET = {"blockA": 0, "cycleA": 0, "blockF": 0, "cycleF": 0,
             "cascade_mode": 0}


def vocoder_phase(tiny: bool = False, aux_channels: int = None):
    """The recipe's neural vocoder as a packed phase, (model_config,
    in_scaler, None): VOCODER_CONFIG's ``model.generator`` verbatim (a
    ``ParallelHnUSFGANGenerator``: aux 65 = mgc 60 + coded bap 5, 5 * 4 *
    4 * 3 = 240 = the hop at 48 kHz and 5 ms) with the config's
    ``signal_types``, ``dense_factor``, ``sine_amp`` and ``noise_amp``, and
    an ``in_vocoder`` scaler from a seeded generator (the coded-bap dims
    centred near -30 dB).  ``tiny=True`` narrows the widths and the block
    counts for the CPU tests; the class, the aux layout and the upsampling
    stay.  ``aux_channels`` other than the config's (80: the mel voices')
    replaces its aux width, the in-scaler centred near -2.5 (log10
    mel)."""
    from ensemble_svs_with_interactions_tpu_torch.utils.scalers import (
        StandardScaler,
    )

    model = shipped_config(VOCODER_CONFIG)["model"]
    net = model["generator"]
    mel = aux_channels is not None
    if mel:
        net["aux_channels"] = aux_channels
    if tiny:
        net.update(
            residual_channels=4, gate_channels=8, skip_channels=4,
            harmonic_network_params={**_TINY_NET, "blockA": 4, "cycleA": 2},
            noise_network_params={**_TINY_NET, "blockF": 2, "cycleF": 2},
            filter_network_params={**_TINY_NET, "blockF": 4, "cycleF": 2},
            periodicity_estimator_params={"conv_layers": 2,
                                          "kernel_size": 3, "dilation": 1})
    rng = np.random.default_rng(SEED + PHASE_SEEDS["vocoder"])
    n = net["aux_channels"]
    mean, scale = rng.normal(0.0, 0.1, n), rng.uniform(0.5, 2.0, n)
    if mel:
        mean -= 2.5
    else:
        mean[-5:] -= 30.0
        scale[-5:] *= 10.0
    cfg = {"netG": net, **{k: model[k] for k in (
        "signal_types", "dense_factor", "sine_amp", "noise_amp")}}
    return cfg, StandardScaler(mean, scale ** 2, scale), None


def with_vocoder(voice, tiny: bool = False):
    """A (global config, phases) voice with ``vocoder_phase`` added."""
    glob, phases = voice
    return glob, {**phases, "vocoder": vocoder_phase(tiny)}


def tiny_generators() -> dict:
    """{name: (netG config, excitation channels, or None where the
    excitation is noise or absent)}: the other generators
    ``load_vocoder`` serves, at tiny widths with 240x upsampling: PWG (aux
    67, what the ``pwg`` branch feeds it), SiFiGAN and HiFiGAN (aux 65,
    their configs'); and the recipe's hn-uSFGAN narrowed
    (``vocoder_phase(tiny=True)``)."""
    ups = [5, 4, 4, 3]
    return {
        "pwg": ({"_target_": f"{VOC}.PWGGenerator", "layers": 6,
                 "stacks": 2, "residual_channels": 8, "gate_channels": 16,
                 "skip_channels": 8, "aux_channels": 67,
                 "aux_context_window": 2, "upsample_scales": ups}, None),
        "sifigan": ({"_target_": f"{VOC}.SiFiGANGenerator", "channels": 32,
                     "aux_channels": 65, "upsample_scales": ups,
                     "resblock_kernel_sizes": [3, 5],
                     "resblock_dilations": [[1, 3], [1, 3]]}, 1),
        "hifigan": ({"_target_": f"{VOC}.HiFiGANGenerator", "channels": 32,
                     "aux_channels": 65, "upsample_scales": ups,
                     "resblock_kernel_sizes": [3, 5],
                     "resblock_dilations": [[1, 3], [1, 3]]}, None),
        "parallel_hn_usfgan": (vocoder_phase(tiny=True)[0]["netG"],
                               VOCODER_SIGNALS),
    }


def generator_inputs(net: dict, S, frames: int, seed: int = 0):
    """Seeded host inputs of a generator, {"x", "c", "d"}: x (1, T, S)
    from the excitation of a pitch contour with unvoiced frames (unit
    noise, one channel, where S is None), c (1, frames, aux), d (1, T);
    T = frames * its upsampling."""
    from ensemble_svs_with_interactions_tpu_torch.models.vocoders import (
        SignalGenerator,
        dilated_factor,
    )

    scales = net.get("upsample_scales") or net["upsample_params"][
        "upsample_scales"]
    hop = int(np.prod(scales))
    rng = np.random.default_rng(seed)
    f0 = rng.uniform(80, 800, (frames, 1)) * (rng.uniform(size=(frames, 1))
                                              > 0.2)
    types = ["sine", "noise"][:S] if S else ["noise"]
    x = SignalGenerator(48000, hop, 0.1, 0.003, types)(f0, seed=seed)
    d = np.repeat(dilated_factor(f0, 48000, 4), hop).astype(np.float32)
    c = rng.standard_normal((1, frames, net["aux_channels"])).astype(
        np.float32)
    return {"x": x[None], "c": c, "d": d[None]}


def hold_generator(net: dict, S, device, frames: int = 40, seed: int = 0):
    """One generator at ``net``'s widths with seeded weights on ``device``
    and on the CPU, on the same ``generator_inputs``: {the largest
    difference over the CPU output's largest entry, that largest entry}."""
    from ensemble_svs_with_interactions_tpu_torch.utils.config import (
        instantiate,
    )
    from ensemble_svs_with_interactions_tpu_torch.utils.precision import (
        conv_precision,
    )

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        cpu = instantiate(net).eval()
    card = copy.deepcopy(cpu).to(device)
    inputs = generator_inputs(net, S, frames, seed)
    args = [torch.from_numpy(inputs[name])
            for name in inspect.signature(cpu.forward).parameters]
    outs = []
    with torch.no_grad():
        for m, dev in ((cpu, torch.device("cpu")), (card, device)):
            with conv_precision(dev):
                outs.append(m(*(a.to(dev) for a in args)).cpu())
    ref, got = outs
    peak = ref.abs().max().item()
    return {"rel_err": (got - ref).abs().max().item() / peak,
            "max_abs": peak, "finite": bool(torch.isfinite(got).all())}


def vocoder_work(module, frames: int, S: int, hop: int):
    """(FLOPs, bytes) of one generator call on ``frames`` frames: twice
    the multiply-adds of every convolution the generator runs at this
    call's shapes, counted on a copy on the meta device (the skip
    convolutions it does not run are not counted); the weights, x, c and d
    read once and the waveform written once."""
    meta = copy.deepcopy(module).to("meta")
    for m in meta.modules():  # hooks the copy took along (time_vocoder's)
        m._forward_hooks.clear()
        m._forward_pre_hooks.clear()
    macs = [0]

    def count(conv, _, out):
        macs[0] += (out.numel() * conv.in_channels // conv.groups
                    * conv.kernel_size[0])

    for m in meta.modules():
        if isinstance(m, torch.nn.Conv1d):
            m.register_forward_hook(count)
    T = frames * hop
    aux = module.upsample.Conv_0.in_channels
    with torch.no_grad():
        meta(torch.empty(1, T, S, device="meta"),
             torch.empty(1, frames, aux, device="meta"),
             torch.empty(1, T, device="meta"))
    params = sum(p.numel() for p in module.parameters())
    return 2 * macs[0], 4 * (params + T * S + frames * aux + 2 * T)


def vocoder_bound(module, frame_counts, S: int, hop: int) -> dict:
    """The generator's bound over one call's tracks (``frame_counts``):
    operations at the float32 FMA rate, bytes at the memory rate."""
    work = [vocoder_work(module, n, S, hop) for n in frame_counts]
    flops, nbytes = sum(w[0] for w in work), sum(w[1] for w in work)
    bound_ms, bound_by = bound(1e3 * nbytes / PEAK_BYTES_PER_S,
                               1e3 * flops / PEAK_FP32_FLOP_PER_S)
    return {"tflop": flops / 1e12,
            "mflop_per_sample": flops / (hop * sum(frame_counts)) / 1e6,
            "bytes_ms": 1e3 * nbytes / PEAK_BYTES_PER_S,
            "operations_ms": 1e3 * flops / PEAK_FP32_FLOP_PER_S,
            "bound_ms": bound_ms, "bound_by": bound_by}


def time_vocoder(module, log: list):
    """Record CUDA events around each call of the generator ``module``
    into ``log`` as [start, end]."""
    def start(*_):
        log.append([torch.cuda.Event(enable_timing=True), None])
        log[-1][0].record()

    def end(*_):
        log[-1][1] = torch.cuda.Event(enable_timing=True)
        log[-1][1].record()

    module.register_forward_pre_hook(start)
    module.register_forward_hook(end)


def vocoder_ms(log: list) -> float:
    """The generator's device ms summed over ``log``, which it empties."""
    torch.cuda.synchronize()
    out = sum(a.elapsed_time(b) for a, b in log)
    log.clear()
    return out


def phase_vocoder(lr, model_dir, single_dir, labels):
    """The recipe's neural vocoder through the normal entry point: the
    flagship with ``vocoder_phase()`` (seeded random weights) packed into
    ``model_dir`` by ``pack_model`` and opened by ``SPSVS(model_dir)``,
    whose default vocoder type must be ``usfgan``; a warm-up, then N_CALLS
    timed ``svs_ensemble(vocoder_type="auto")`` calls on 4 copies of the
    fixture, the launch counts reset just before each and read just
    after; the generator's device time a call (CUDA events) beside its
    float32 bound (``vocoder_bound``), the stages and the peak memory; one
    ``svs()`` of the single-track voice packed with the same vocoder into
    ``single_dir``, and one flagship pair (``svs_pair``), both with
    ``"auto"``.  Returns the engine and the launches by path."""
    from ensemble_svs_with_interactions_tpu_torch.svs import SPSVS

    glob, phases = with_vocoder(flagship_phases())
    t0 = time.time()
    pack_phases(model_dir, glob, phases, random_state_dicts(phases, SEED))
    pack_s = time.time() - t0
    t0 = time.time()
    engine = SPSVS(model_dir)
    torch.cuda.synchronize()
    load_s = time.time() - t0
    assert engine.default_vocoder_type == "usfgan", engine
    module = engine.vocoder.module
    hop = engine.vocoder.hop_size
    log = []
    time_vocoder(module, log)

    def call(**kw):
        t0 = time.time()
        wavs, sr = engine.svs_ensemble([lab.copy() for lab in labels],
                                       vocoder_type="auto",
                                       spk_ids=list(range(N_TRACKS)), **kw)
        return wavs, sr, time.time() - t0

    _, _, warm_s = call()
    vocoder_ms(log)
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for _ in range(N_CALLS):
        reset_launches(lr)
        wavs, sr, sec = call()
        runs.append({"seconds": sec, "rtf": engine.last_rtf,
                     "launches": lr.lstm_recurrence.launches,
                     "stages": dict(engine.last_stage_times),
                     "vocoder_ms": vocoder_ms(log)})
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    vb = vocoder_bound(module, [len(w) // hop for w in wavs],
                       VOCODER_SIGNALS, hop)

    sglob, sphases = with_vocoder(single_phases())
    pack_phases(single_dir, sglob, sphases,
                random_state_dicts(sphases, SEED))
    single = SPSVS(single_dir)
    time_vocoder(single.vocoder.module, log)
    reset_launches(lr)
    t0 = time.time()
    wav, _ = single.svs(labels[0].copy(), vocoder_type="auto")
    svs = {"seconds": time.time() - t0, "rtf": single.last_rtf,
           "launches": lr.lstm_recurrence.launches,
           "stages": dict(single.last_stage_times),
           "vocoder_ms": vocoder_ms(log), "length": len(wav),
           "audible": bool(np.abs(wav.astype(np.int64)).max() > 0)}
    del single
    reset_launches(lr)
    t0 = time.time()
    pwav = svs_pair(engine, labels[0].copy(), late_copy(labels[0]), [0, 1],
                    vocoder_type="auto")
    pair = {"seconds": time.time() - t0,
            "launches": lr.lstm_recurrence.launches,
            "vocoder_ms": vocoder_ms(log), "length": len(pwav),
            "audible": bool(np.abs(pwav.astype(np.int64)).max() > 0)}
    pair["rtf"] = pair["seconds"] / (len(pwav) / sr)
    voc = [r["vocoder_ms"] for r in runs]
    emit({"phase": "vocoder", "config": VOCODER_CONFIG,
          "params": sum(p.numel() for p in module.parameters()),
          "pack_s": pack_s, "load_s": load_s, "warmup_s": warm_s,
          "runs_s": [r["seconds"] for r in runs],
          "rtf": [r["rtf"] for r in runs],
          "stages": runs[len(runs) // 2]["stages"],
          "launches": [r["launches"] for r in runs],
          "vocoder_ms": voc, "vocoder_bound": vb,
          "vocoder_over_bound": [v / vb["bound_ms"] for v in voc],
          "audio_seconds": max(len(w) for w in wavs) / sr,
          "wav_lengths": [len(w) for w in wavs], "peak_mem_gib": peak,
          "svs": svs, "pair": pair})
    for r in runs:
        assert r["launches"] == LAUNCHES_PER_CALL, r["launches"]
        assert r["vocoder_ms"] > 0
    assert svs["launches"] == LAUNCHES_PER_CALL, svs
    assert pair["launches"] == LAUNCHES_PER_CALL, pair
    for w in list(wavs) + [wav, pwav]:
        assert w.dtype == np.int16 and len(w) > 30 * sr, (w.dtype, len(w))
        assert np.abs(w.astype(np.int64)).max() > 0
    return engine, {"svs_ensemble_usfgan": sum(r["launches"] for r in runs),
                    "svs_usfgan": svs["launches"],
                    "pairwise_usfgan": pair["launches"]}


def phase_vocoder_reference(engine, model_dir, label):
    """The same pack on the CPU against the card, over the first
    VOCODER_REF_LABELS labels of the fixture as a pair's main track (its
    sub track sung SUB_LAG late): the card's pair streams fed to both
    engines' ``predict_waveform("auto")``, the generator's output within
    VOCODER_RTOL of its largest entry and the waveform at
    VOCODER_SNR_DB; then the PWG, SiFiGAN and HiFiGAN generators and the
    narrowed hn-uSFGAN (``tiny_generators``), card against CPU on the same
    inputs, within VOCODER_RTOL."""
    from ensemble_svs_with_interactions_tpu_torch.svs import SPSVS

    t0 = time.time()
    cpu = SPSVS(model_dir, device="cpu")
    main = label[:VOCODER_REF_LABELS]
    streams = pair_streams(engine, main, late_copy(main), [0, 1])
    kept = [np.array(a, copy=True) for a in streams]
    outs = []
    for e in (engine, cpu):
        hook = e.vocoder.module.register_forward_hook(
            lambda _m, _a, out: outs.append(out.detach().cpu()))
        outs.append(e.predict_waveform(streams, vocoder_type="auto"))
        hook.remove()
    card_g, card_w, cpu_g, cpu_w = outs
    peak = cpu_g.abs().max().item()
    gen_err = (card_g - cpu_g).abs().max().item() / peak
    snr = snr_db(cpu_w, card_w)
    tiny = {name: hold_generator(net, S, engine.device)
            for name, (net, S) in tiny_generators().items()}
    emit({"phase": "vocoder_reference", "labels": VOCODER_REF_LABELS,
          "frames": len(streams[1]), "samples": len(card_w),
          "streams_identical": all(np.array_equal(a, b)
                                   for a, b in zip(kept, streams)),
          "generator_rel_err": gen_err, "generator_max_abs": peak,
          "rtol": VOCODER_RTOL, "snr_db": snr, "snr_min_db": VOCODER_SNR_DB,
          "tiny_generators": tiny, "seconds": time.time() - t0})
    assert all(np.array_equal(a, b) for a, b in zip(kept, streams))
    assert np.isfinite(card_w).all() and np.abs(card_w).max() > 0
    assert gen_err < VOCODER_RTOL, gen_err
    assert snr > VOCODER_SNR_DB, snr
    for name, r in tiny.items():
        assert r["finite"] and r["rel_err"] < VOCODER_RTOL, (name, r)


# ------------------------------------------------ neural vocoder training
VOCODER_SIFIGAN_CONFIG = "vocoder/vocoder_sifigan.yaml"
VOCODER_PWG_CONFIG = "vocoder/vocoder_pwg.yaml"
# the full-width step's batch is the config's: 8 crops of 64 frames at 48
# kHz, hop 240 (15,360 samples a crop)
VOCODER_TRAIN_WARMUP = 2
VOCODER_TRAIN_STEPS = 5
# the synthetic corpus, written on the host: utterances x frames
VOCODER_TRAIN_CORPUS = dict(n=4, frames=400)
# the CLI's run: 1 epoch of 3 steps
VOCODER_CLI_STEPS = 3
# one GAN step card against CPU at tiny widths: the losses within 1e-5
# relative, each network's gradient within 1e-4 of its L2 norm, or, where
# the float32 runs differ by more, the card no farther from the float64
# step than AR_HEADROOM times the CPU
VOCODER_TRAIN_LOSS_RTOL = 1e-5
VOCODER_TRAIN_GRAD_RTOL = 1e-4
# the log-spectral losses are float32-conditioned at ~1e-5 (the mel L1:
# the CPU's float32 step 9e-6 from its float64 one), and the residual
# source loss of a pure-sine target worse (CheapTrick's log envelope of a
# sine reads bins on the float32 FFT's noise floor: the CPU 4.4e-5 from
# float64, the card 1.67e-4, 3.8x), so a float32 run is also held by its
# distance from the float64 step, within VOCODER_HEADROOM times the
# CPU's; the float64 runs, card and CPU, agree within VOCODER_F64_RTOL
VOCODER_HEADROOM = 4.0
VOCODER_F64_RTOL = 1e-9
VOCODER_REF_B, VOCODER_REF_FRAMES = 2, 32


def write_vocoder_corpus(root, n: int, frames: int, sr: int = 48000,
                         hop: int = 240, stream_sizes=(60, 1, 1, 5),
                         seed: int = SEED):
    """``n`` utterances of ``frames`` frames as ``bin/prepare_voc_features``
    writes them: ``{utt}-feats.npy`` (mgc, lf0, vuv, bap: small seeded
    noise, a gliding lf0, voiced throughout) and ``{utt}-wave.npy`` (the
    glide's sine at 0.3), as the JAX package's vocoder CLI test builds its
    corpus (tests/test_vocoders.py:260-275), here at ``sr``."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    mgc = stream_sizes[0]
    for i in range(n):
        feats = (rng.normal(size=(frames, sum(stream_sizes))) * 0.1).astype(
            np.float32)
        lf0 = np.log(200 + 20 * np.sin(np.arange(frames) / 10 + i))
        feats[:, mgc] = lf0
        feats[:, mgc + 1] = 1.0
        phase = 2 * np.pi * np.cumsum(np.repeat(np.exp(lf0), hop)) / sr
        np.save(root / f"u{i}-feats.npy", feats)
        np.save(root / f"u{i}-wave.npy",
                (0.3 * np.sin(phase)).astype(np.float32))
    return root


def vocoder_train_config(in_dir, out_dir, rel: str = VOCODER_CONFIG,
                         model=None, data=None, **train):
    """A shipped vocoder config (``configs/vocoder/*.yaml``) verbatim with
    its corpus and output directories set; ``model``, ``data`` and
    ``train`` replace parts of their sections."""
    from ensemble_svs_with_interactions_tpu_torch.utils.config import (
        _wrap,
        merge,
    )

    cfg = shipped_config(rel)
    cfg["data"]["train_no_dev"]["in_dir"] = str(in_dir)
    cfg["train"]["out_dir"] = str(out_dir)
    return merge(_wrap(cfg), {"model": model or {}, "data": data or {},
                              "train": train})


def tiny_vocoder_trainings(in_dir, out_dir) -> dict:
    """{family: config} of one GAN step each, from the shipped configs'
    data and train sections with tiny networks (48 kHz, 240x upsampling,
    B = VOCODER_REF_B crops of VOCODER_REF_FRAMES frames): the recipe's
    hn-uSFGAN (``vocoder_phase(tiny=True)``) with a UnivNet
    multi-resolution multi-period discriminator and both of its losses;
    SiFiGAN with a HiFiGAN multi-scale multi-period discriminator, the mel
    loss and feature matching; PWG with its discriminator and the
    multi-resolution STFT loss, its adversarial gate open."""
    period = {"channels": 4, "max_downsample_channels": 16}
    gens = tiny_generators()
    families = {
        "hn_usfgan": (VOCODER_CONFIG, gens["parallel_hn_usfgan"][0], {
            "spectral_discriminator_params": {"channels": 4},
            "period_discriminator_params": period}, {}),
        "sifigan": (VOCODER_SIFIGAN_CONFIG, gens["sifigan"][0], {
            "scales": 2, "scale_discriminator_params": {
                "channels": 8, "max_downsample_channels": 32,
                "max_groups": 4},
            "period_discriminator_params": period}, {}),
        "pwg": (VOCODER_PWG_CONFIG, {**gens["pwg"][0], "aux_channels": 65},
                {"layers": 4, "conv_channels": 8},
                {"discriminator_train_start_steps": 0}),
    }
    return {family: vocoder_train_config(
        in_dir, out_dir, rel, {"generator": gen, "discriminator": dis},
        {"crop_frames": VOCODER_REF_FRAMES}, batch_size=VOCODER_REF_B,
        **extra) for family, (rel, gen, dis, extra) in families.items()}


def build_gan(cfg, device, dtype=torch.float32, seed: int = 0):
    """``train_vocoder``'s networks and step for ``cfg`` on ``device``:
    the generator and discriminator with the flax schemes' weights (seeds
    ``seed`` and ``seed + 1``), in ``dtype``; (step, G, D)."""
    from ensemble_svs_with_interactions_tpu_torch.train.vocoder_trainer import (  # noqa: E501
        build_generator,
        gan_step,
    )
    from ensemble_svs_with_interactions_tpu_torch.utils.config import (
        instantiate,
    )
    from ensemble_svs_with_interactions_tpu_torch.utils.flax_init import (
        init_module,
    )

    gen = init_module(build_generator(cfg), seed=seed).to(dtype)
    dis = init_module(instantiate(cfg.model.discriminator),
                      seed=seed + 1).to(dtype)
    return gan_step(cfg, gen, dis, device), gen, dis


def vocoder_batches(cfg, n: int, device, dtype=torch.float32):
    """``n`` batches of ``cfg``'s crops (``train_vocoder``'s, from numpy
    seed SEED), on ``device``."""
    from ensemble_svs_with_interactions_tpu_torch.train.vocoder_trainer import (  # noqa: E501
        vocoder_crops,
    )

    crops, rng = vocoder_crops(cfg), np.random.default_rng(SEED)
    B = int(cfg.train.batch_size)
    return [{k: torch.from_numpy(v).to(device, dtype)
             for k, v in crops.batch(rng, B).items()} for _ in range(n)]


def vocoder_train_bound(cfg, step, batch) -> dict:
    """The step's bound: the convolutions' and matmuls' operations of one
    step, forward and backward (``FlopCounterMode``; the FFTs and the
    elementwise work are left out), at the float32 FMA rate, against the
    bytes it must move, each weight, gradient and Adam moment read and
    written once and the batch read once, at the memory rate."""
    from torch.utils.flop_counter import FlopCounterMode

    n_params = sum(p.numel() for opt in step.optimizers
                   for g in opt.param_groups for p in g["params"])
    counter = FlopCounterMode(display=False)
    with counter:
        step(batch)
    flops = counter.get_total_flops()
    nbytes = 4 * (7 * n_params + sum(v.numel() for v in batch.values()))
    bound_ms, bound_by = bound(1e3 * nbytes / PEAK_BYTES_PER_S,
                               1e3 * flops / PEAK_FP32_FLOP_PER_S)
    return {"tflop": flops / 1e12, "params": n_params,
            "bytes_ms": 1e3 * nbytes / PEAK_BYTES_PER_S,
            "operations_ms": 1e3 * flops / PEAK_FP32_FLOP_PER_S,
            "bound_ms": bound_ms, "bound_by": bound_by}


def vocoder_train_bench(cfg, device, warmup: int = VOCODER_TRAIN_WARMUP,
                        steps: int = VOCODER_TRAIN_STEPS) -> dict:
    """``cfg``'s GAN step on ``device``: ``warmup`` steps, ``steps`` timed
    ones (CUDA events around each; each step ends in the host read of its
    two finite flags), the peak memory of the timed ones, one step under
    ``torch.profiler`` (``profile_step``: the device's busy share of that
    step's wall, which the profiler's own host work lengthens, and its
    kernel time, also given over the median timed step) and one under
    ``FlopCounterMode`` (``vocoder_train_bound``).  On the CPU
    (the bench's test) the host clock times the steps and the device
    numbers are None."""
    card = device.type == "cuda"
    step, gen, dis = build_gan(cfg, device)
    batches = vocoder_batches(cfg, warmup + steps, device)
    samples = batches[0]["y"].numel()
    for b in batches[:warmup]:
        step(b)
    if card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    ms = []
    for b in batches[warmup:]:
        if card:
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            metrics = step(b)
            end.record()
            ms.append((start, end))
        else:
            t0 = time.perf_counter()
            metrics = step(b)
            ms.append(1e3 * (time.perf_counter() - t0))
    if card:
        torch.cuda.synchronize()
        ms = [a.elapsed_time(b) for a, b in ms]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if card else None
    prof = profile_step(lambda: step(batches[-1])) if card else {}
    vb = vocoder_train_bound(cfg, step, batches[-1])
    median = float(np.median(ms))
    values = {k: float(v) for k, v in metrics.items()}
    return {"batch": int(cfg.train.batch_size),
            "samples_per_step": samples, "step_ms": ms,
            "median_step_ms": median,
            "samples_per_sec": samples / (median / 1e3),
            "peak_mem_gib": peak,
            "params": {"G": sum(p.numel() for p in gen.parameters()),
                       "D": sum(p.numel() for p in dis.parameters())},
            "vocoder_train_bound": vb,
            "over_bound": median / vb["bound_ms"],
            "device_busy_share": prof.get("device_busy_share"),
            "device_kernel_ms": prof.get("device_kernel_ms"),
            "kernel_ms_over_median_step": (
                prof["device_kernel_ms"] / median if card else None),
            "top_kernels": prof.get("top_kernels", [])[:8],
            "metrics": values,
            "finite": all(np.isfinite(v) for v in values.values())}


def phase_vocoder_train(lr, label):
    """The recipe's vocoder training at full width: the shipped
    ``vocoder_parallel_hn_usfgan.yaml`` (the 2,527,018-weight generator,
    the UnivNet multi-resolution multi-period discriminator, the mel and
    source losses, Adam) on a synthetic corpus (``write_vocoder_corpus``),
    its step timed (``vocoder_train_bench``); then ``bin/train_vocoder.py``
    for 1 epoch of VOCODER_CLI_STEPS steps, the stage-10 pack
    (``train/vocoder_trainer.pack_vocoder``) into the single-track voice's
    pack, ``SPSVS(model_dir)`` (its ``"auto"`` vocoder must be
    ``usfgan``) and one ``svs()`` of the first VOCODER_REF_LABELS labels
    with the launch counts reset just before and read just after.
    Returns the render's launches by path."""
    from ensemble_svs_with_interactions_tpu_torch.bin import (
        train_vocoder as cli,
    )
    from ensemble_svs_with_interactions_tpu_torch.svs import SPSVS
    from ensemble_svs_with_interactions_tpu_torch.train.vocoder_trainer import (  # noqa: E501
        pack_vocoder,
    )
    from ensemble_svs_with_interactions_tpu_torch.utils.config import (
        save_config,
    )

    device = torch.device("cuda")
    t0 = time.time()
    with tempfile.TemporaryDirectory() as root:
        root = Path(root)
        corpus = write_vocoder_corpus(root / "in", **VOCODER_TRAIN_CORPUS)
        cfg = vocoder_train_config(corpus, root / "exp")
        bench = vocoder_train_bench(cfg, device)
        save_config(cfg, root / "config.yaml")
        t1 = time.time()
        rc = cli.main([str(root / "config.yaml"), "train.nepochs=1",
                       f"train.steps_per_epoch={VOCODER_CLI_STEPS}"])
        cli_s = time.time() - t1
        logged = json.loads((root / "exp" / "metrics.jsonl").read_text()
                            .splitlines()[-1])
        glob, phases = single_phases()
        pack_phases(root / "pack", glob, phases,
                    random_state_dicts(phases, SEED))
        pack_vocoder(cfg, root / "exp", root / "pack")
        engine = SPSVS(root / "pack")
        kind = engine.default_vocoder_type
        reset_launches(lr)
        wav, sr = engine.svs(label[:VOCODER_REF_LABELS].copy(),
                             vocoder_type="auto", dtype=np.float32)
        launches = lr.lstm_recurrence.launches
        best = (root / "exp" / "best_loss.ckpt").exists()
    emit({"phase": "vocoder_train", "config": VOCODER_CONFIG,
          "corpus": VOCODER_TRAIN_CORPUS, **bench,
          "cli": {"rc": rc, "seconds": cli_s, "steps": VOCODER_CLI_STEPS,
                  "metrics": logged, "best_loss_ckpt": best},
          "svs": {"vocoder_type": kind, "labels": VOCODER_REF_LABELS,
                  "samples": len(wav), "sample_rate": sr,
                  "finite": bool(np.isfinite(wav).all()),
                  "max_abs": float(np.abs(wav).max()),
                  "launches": launches},
          "seconds": time.time() - t0})
    assert bench["finite"], bench["metrics"]
    assert bench["params"]["G"] == 2527018, bench["params"]
    assert rc == 0 and best and logged["step"] == 1, logged
    assert all(np.isfinite(v) for v in logged.values()), logged
    assert kind == "usfgan", kind
    assert np.isfinite(wav).all() and np.abs(wav).max() > 0
    assert launches > 0, launches
    return {"svs_trained_vocoder": launches}


def reference_gan_step(cfg, device, dtype=torch.float32) -> tuple:
    """One GAN step of ``cfg`` on ``device`` in ``dtype`` from the flax
    schemes' weights and the first crop batch: (metrics, G's gradient, D's
    gradient), the gradients flat, float64 on the host and unclipped
    (each network's optimizer stepped on them scaled by min(1, clip /
    norm))."""
    step, gen, dis = build_gan(cfg, device, dtype)
    metrics = {k: float(v) for k, v in step(
        vocoder_batches(cfg, 1, device, dtype)[0]).items()}

    def grad(module, norm):
        flat = torch.cat([p.grad.reshape(-1) for p in module.parameters()])
        clip = min(1.0, 10.0 / max(norm, 1e-12))
        return flat.double().cpu() / clip

    return (metrics, grad(gen, metrics["GradNorm_G"]),
            grad(dis, metrics["GradNorm_D"]))


def hold_gan_step(cfg, device) -> dict:
    """``reference_gan_step`` of ``cfg`` on ``device`` against the CPU,
    in float32 and in float64.  Each loss (relative to its value) and
    each network's gradient (L2, relative to its norm) holds when the
    float32 runs agree within VOCODER_TRAIN_LOSS_RTOL /
    VOCODER_TRAIN_GRAD_RTOL, or when the card's float32 run is no farther
    from the float64 step than VOCODER_HEADROOM times the CPU's; and, in
    every case, when the float64 runs agree within VOCODER_F64_RTOL (the
    card computes the CPU's function)."""
    cpu = torch.device("cpu")
    return hold_runs({(side, dtype): reference_gan_step(cfg, dev, dtype)
                      for side, dev in (("card", device), ("cpu", cpu))
                      for dtype in (torch.float32, torch.float64)})


def hold_runs(runs) -> dict:
    """``hold_gan_step``'s verdict on its four ``reference_gan_step``
    runs, keyed (``"card"`` or ``"cpu"``, dtype)."""
    card, ref = runs[("card", torch.float32)], runs[("cpu", torch.float32)]
    card64, f64 = (runs[("card", torch.float64)],
                   runs[("cpu", torch.float64)])

    def judge(got, want, got64, oracle, dist, tol):
        rel, rel64 = dist(got, want), dist(got64, oracle)
        to_oracle, ref_to_oracle = dist(got, oracle), dist(want, oracle)
        return {"rel": rel, "card_to_f64": to_oracle,
                "cpu_to_f64": ref_to_oracle, "f64_rel": rel64,
                "ok": (rel < tol or to_oracle <= VOCODER_HEADROOM
                       * ref_to_oracle) and rel64 < VOCODER_F64_RTOL}

    def scalar(a, b):
        return abs(a - b) / max(abs(b), 1e-12)

    def l2(a, b):
        return float((a - b).norm() / b.norm())

    losses = {k: judge(card[0][k], ref[0][k], card64[0][k], f64[0][k],
                       scalar, VOCODER_TRAIN_LOSS_RTOL)
              for k in ref[0] if k.startswith("Loss") and f64[0][k] != 0}
    grads = {net: judge(card[i], ref[i], card64[i], f64[i], l2,
                        VOCODER_TRAIN_GRAD_RTOL)
             for i, net in ((1, "G"), (2, "D"))}
    return {"losses": losses, "grads": grads, "metrics_card": card[0],
            "ok": all(r["ok"] for r in (*losses.values(),
                                        *grads.values()))}


def phase_vocoder_train_reference():
    """One GAN step of each family (``tiny_vocoder_trainings``) on the card
    against the same step on the CPU, in float32 and float64
    (``hold_gan_step``)."""
    t0 = time.time()
    with tempfile.TemporaryDirectory() as root:
        corpus = write_vocoder_corpus(Path(root) / "in", n=2, frames=80)
        out = {family: hold_gan_step(cfg, torch.device("cuda"))
               for family, cfg in tiny_vocoder_trainings(
                   corpus, Path(root) / "exp").items()}
    emit({"phase": "vocoder_train_reference",
          "loss_rtol": VOCODER_TRAIN_LOSS_RTOL,
          "grad_rtol": VOCODER_TRAIN_GRAD_RTOL, "families": out,
          "seconds": time.time() - t0})
    for family, r in out.items():
        assert r["ok"], (family, r)

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


def build_trainer(cfg, ss, state_dict, device, dtype=torch.float32,
                  use_amp=False, optimizer=None):
    """(module, train_step) of the flagship acoustic model: Adam at 1e-3
    (or ``optimizer``), pitch_reg_weight 1, sub_require_grad True, clip
    1.0 (bench_train.py), float32 or the bf16 AMP arm."""
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
    opt, sched = build_optimizer(module.parameters(), optimizer or
                                 {"name": "Adam", "params": {"lr": 1e-3}})
    step, _ = create_multitrack_acoustic_train_step(
        module, opt, {"stream_sizes": list(ss)}, scheduler=sched,
        clip_norm=1.0, pitch_reg_weight=1.0, sub_require_grad=True,
        use_amp=use_amp, device=device)
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
HAND_WRITTEN = ("lstm_recurrence_mma_kernel", "lstm_recurrence_small_kernel",
                "lstm_recurrence_group_kernel", "lstm_gates_kernel",
                "lstm_bptt_small_kernel", "lstm_gates_mma_kernel",
                "lstm_bptt_group_kernel", "lstm_bptt_mma_kernel",
                "lstm_dwh_kernel", "lstm_dwh_reduce_kernel")


def train_lstm_shapes(netg, T: int) -> dict:
    """{(H, sequence length): single-direction LSTM runs per train step} of
    the multitrack acoustic model: each of the two track passes (main and
    sub) runs the encoder's and the decoders' (bi)LSTM layers over T frames
    and the AR lf0 decoder's cell over T / reduction_factor."""
    enc, lf0 = netg["encoder"], netg["lf0_model"]
    runs = {}

    def add(H, t, n):
        runs[(H, t)] = runs.get((H, t), 0) + 2 * n

    add(enc["hidden_dim"], T,
        enc["num_layers"] * (2 if enc.get("bidirectional", True) else 1))
    add(lf0["lstm_hidden_dim"], T, lf0["num_lstm_layers"] * 2)
    add(lf0["decoder_hidden_dim"], T // lf0["reduction_factor"],
        lf0["decoder_layers"])
    for name in ("mgc_model", "vuv_model", "bap_model"):
        dec = netg[name]
        add(dec["lstm_hidden_dim"], T,
            dec["num_lstm_layers"]
            * (2 if dec.get("bidirectional", True) else 1))
    return runs


def lstm_kernel_flops(shapes: dict, B: int) -> int:
    """Operations of the hand-written LSTM kernels in one train step: per
    run the forward recurrence, the BPTT's gate pre-pass and reverse loop,
    and dW_h."""
    return sum(n * (recurrence_ops(B, T, H) + gates_ops(B, T, H)
                    + bptt_loop_ops(B, T, H) + dwh_flops(B, T, H))
               for (H, T), n in shapes.items())


def device_us(evt) -> float:
    """A profiler event's own device time in microseconds."""
    return float(getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0)))


def profile_step(run_step) -> dict:
    """One call of ``run_step`` under ``torch.profiler``: wall seconds, the
    summed device kernel time and its share of the wall (one stream, so
    kernels do not overlap), the hand-written kernels' device time, the
    kernels with the most device time, and every other kernel whose name
    says LSTM or RNN (a library recurrence on the path would show there).
    The device ranges of user annotations (``Optimizer.step#...``) span
    kernels already counted and are left out."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_step()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and device_us(e) > 0
               and not getattr(e, "is_user_annotation", False)]
    busy_us = sum(device_us(e) for e in kernels)
    top = sorted(kernels, key=device_us, reverse=True)[:12]
    return {
        "wall_s": wall_s, "device_kernel_ms": busy_us / 1e3,
        "device_busy_share": busy_us / 1e6 / wall_s,
        "device_kernels_launched": sum(e.count for e in kernels),
        "hand_written_ms": {
            name: sum(device_us(e) for e in kernels if name in e.key) / 1e3
            for name in HAND_WRITTEN},
        "other_recurrence_kernels": sorted(
            e.key[:90] for e in kernels
            if any(w in e.key.lower() for w in ("lstm", "rnn"))
            and not any(name in e.key for name in HAND_WRITTEN)),
        "top_kernels": [{"name": e.key[:90], "count": e.count,
                         "device_ms": device_us(e) / 1e3} for e in top],
    }


def train_bench(lr, device, B=TRAIN_B, T=TRAIN_T, tiny=False,
                use_amp=False):
    """bench_train.py's flagship step on ``device``: 2 warm-up steps (none
    with ``tiny``, the CPU test's), TRAIN_STEPS timed ones (host clock around a step that ends in a host
    copy of its metrics) with the kernel launch counts reset just before
    and read just after, one step synchronized after each phase (the
    split) and one under ``FlopCounterMode`` (the operation count).
    Returns (the results, a function that runs one more step)."""
    from torch.utils.flop_counter import FlopCounterMode

    ac, ss = flagship_acoustic_config(4, tiny=tiny)
    _, step = build_trainer(ac["netG"], ss,
                            seeded_state_dict(ac["netG"], SEED), device,
                            use_amp=use_amp)
    batch = {k: torch.as_tensor(v, device=device) for k, v in
             train_batch(B, T, sum(ss)).items()}
    gen = torch.Generator(device=device).manual_seed(SEED)
    losses = []
    warmup = 0 if tiny else 2
    t0 = time.perf_counter()
    for _ in range(warmup):
        losses.append(step(batch, TRAIN_WEIGHTS, gen)["Loss"])
    warm_s = time.perf_counter() - t0

    for name in TRAIN_COUNTERS:
        getattr(lr, name).launches = 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    step_s = []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(step(batch, TRAIN_WEIGHTS, gen)["Loss"])
        step_s.append(time.perf_counter() - t0)
    launches = {n: getattr(lr, n).launches for n in TRAIN_COUNTERS}
    peak = (torch.cuda.max_memory_allocated(device) / 2 ** 30
            if device.type == "cuda" else None)
    losses.append(step(batch, TRAIN_WEIGHTS, gen,
                       blocked_phase_times=True)["Loss"])
    split = dict(step.last_phase_times)

    counter = FlopCounterMode(display=False)
    with counter:
        losses.append(step(batch, TRAIN_WEIGHTS, gen)["Loss"])
    torch_flops = counter.get_total_flops()
    shapes = train_lstm_shapes(ac["netG"], T)
    kernel_flops = lstm_kernel_flops(shapes, B)
    flops = torch_flops + kernel_flops
    median = float(np.median(step_s))
    on_card = device.type == "cuda"
    peak_rate, peak_name = ((PEAK_BF16_FLOP_PER_S, "989e12: the H100 SXM "
                             "dense bf16 tensor-core peak") if use_amp else
                            (PEAK_FP32_FLOP_PER_S, "67e12: the H100 SXM "
                             "dense float32 peak outside the tensor cores"))
    out = {
        "frames_per_sec": B * T / median, "median_step_sec": median,
        "all_step_sec": step_s, "steps": TRAIN_STEPS, "warmup_steps": warmup,
        "warmup_sec": warm_s, "batch_pairs": B, "frames": T,
        "frames_per_batch": B * T, "geometry": f"{B}x{T}",
        "split_sec": split, "peak_mem_gib": peak,
        "flops_per_step": flops, "flops_torch_ops": torch_flops,
        "flops_lstm_kernels": kernel_flops,
        "lstm_runs_per_step": {f"H={H} T={t}": n
                               for (H, t), n in shapes.items()},
        "flops_convention": (
            "torch ops as torch.utils.flop_counter.FlopCounterMode counts "
            "them (matmuls and convolutions, forward and backward) plus the "
            "hand-written LSTM kernels it cannot see, per run the forward, "
            "the BPTT pre-pass and loop and dW_h as chip_smoke.py's "
            "recurrence_ops, gates_ops, bptt_loop_ops and dwh_flops count "
            "them (multiply-adds as 2, plus their elementwise operations)"),
        "tflops_per_sec": flops / median / 1e12 if on_card else None,
        "mfu": flops / median / peak_rate if on_card else None,
        "peak_flop_per_s": peak_rate,
        "peak_convention": (
            "dense bf16 tensor cores, 989 TFLOP/s (torch's GEMMs and "
            "convolutions run bf16; the LSTM kernels float32)" if use_amp
            else "dense float32, 67 TFLOP/s (the port computes in float32 "
            "with TF32 off)"),
        "mfu_convention": (
            f"flops_per_step / median_step_sec / {peak_name} (NVIDIA data "
            "sheet, 700 W)"),
        "launches": launches,
        "launches_per_step": {k: v / TRAIN_STEPS
                              for k, v in launches.items()},
        "losses": losses, "final_loss": losses[-1], "use_amp": use_amp,
        "optimizer": "Adam 1e-3",
    }
    return out, lambda: step(batch, TRAIN_WEIGHTS, gen)


def _assert_train_run(r):
    assert all(np.isfinite(x) for x in r["losses"]), r["losses"]
    for name, n in r["launches"].items():
        assert n == TRAIN_LAUNCHES_PER_STEP * r["steps"], (name, n)


def phase_train(lr):
    """bench_train.py's flagship step in float32 (:func:`train_bench`),
    with 46 launches per step of each kernel."""
    r, _ = train_bench(lr, torch.device("cuda"))
    emit({"phase": "train", **r,
          "expected_per_step": TRAIN_LAUNCHES_PER_STEP})
    _assert_train_run(r)
    return r["launches"]


def phase_train_amp(lr):
    """The same step in the bf16 AMP arm: torch's GEMMs and convolutions in
    bf16, every LSTM recurrence through the same hand-written kernels in
    float32, 46 launches per step of each; one more step profiled, where
    no other recurrence kernel may appear."""
    r, run_step = train_bench(lr, torch.device("cuda"), use_amp=True)
    r["profile"] = profile_step(run_step)
    emit({"phase": "train_amp", **r,
          "expected_per_step": TRAIN_LAUNCHES_PER_STEP})
    _assert_train_run(r)
    assert not r["profile"]["other_recurrence_kernels"], r["profile"]
    assert all(r["profile"]["hand_written_ms"][k] > 0 for k in (
        "lstm_recurrence_group_kernel", "lstm_recurrence_small_kernel",
        "lstm_bptt_group_kernel", "lstm_bptt_small_kernel",
        "lstm_dwh_kernel")), r["profile"]["hand_written_ms"]
    return r["launches"]


def reference_step(cfg, ss, state, batch, device, dtype=torch.float32,
                   use_amp=False):
    """One flagship step: (metrics, {name: gradient}, {name: buffer}), the
    tensors copied to the CPU in float64."""
    module, step = build_trainer(cfg, ss, state, device, dtype, use_amp)
    metrics = step(batch, TRAIN_WEIGHTS,
                   torch.Generator(device=device).manual_seed(SEED))
    return (metrics,
            {n: p.grad.detach().cpu().double()
             for n, p in module.named_parameters()},
            {n: b.detach().cpu().double() for n, b in module.named_buffers()})


def reference_config():
    """The flagship at full width without dropout, its seeded weights and
    the REF_B x TRAIN_T batch."""
    ac, ss = flagship_acoustic_config(4)
    cfg = copy.deepcopy(ac["netG"])
    cfg["mgc_model"]["dropout"] = cfg["vuv_model"]["dropout"] = 0.0
    cfg["lf0_model"]["prenet_dropout"] = 0.0
    return cfg, ss, seeded_state_dict(cfg, SEED), train_batch(
        REF_B, TRAIN_T, sum(ss))


def phase_train_reference():
    """One step at full width with dropout off, B = REF_B, on the card
    against the same step on the CPU (plain recurrence and BPTT loops) in
    float32 and in float64: the loss, each parameter's (clipped) gradient,
    and the running statistics after the step (see TRAIN_GRAD_RTOL).
    Returns the runs, keyed by (device, dtype)."""
    cfg, ss, state, batch = reference_config()
    t0 = time.time()
    runs = {(dev, dtype): reference_step(cfg, ss, state, batch, dev, dtype)
            for dev, dtype in (("cuda", torch.float32),
                               ("cpu", torch.float32),
                               ("cpu", torch.float64))}
    m_gpu, g_gpu, s_gpu = runs["cuda", torch.float32]
    m_cpu, g_cpu, s_cpu = runs["cpu", torch.float32]
    _, g_64, _ = runs["cpu", torch.float64]
    loss_rel = abs(m_gpu["Loss"] - m_cpu["Loss"]) / abs(m_cpu["Loss"])
    grads = judge_f32(g_gpu, g_cpu, g_64)
    floor = GRAD_SCALE_FLOOR * max(g.abs().max().item() for g in g_64.values())
    stats_err = max((s_gpu[n] - v).abs().max().item()
                    for n, v in s_cpu.items())
    worst = max(grads, key=lambda n: grads[n]["rel_of_scale"])
    by_oracle = {n: v for n, v in grads.items()
                 if v["rel_of_scale"] >= TRAIN_GRAD_RTOL}
    emit({"phase": "train_reference", "B": REF_B, "T": TRAIN_T,
          "loss": [m_gpu["Loss"], m_cpu["Loss"]], "loss_rel_err": loss_rel,
          "grad_norm": [m_gpu["GradNorm"], m_cpu["GradNorm"]],
          "params": len(grads),
          "max_grad_rel_err": grads[worst]["rel_of_scale"],
          "worst_grad": worst, "judged_by_f64_oracle": by_oracle,
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
    return runs


def judge_f32(got, ref, oracle, rtol=TRAIN_GRAD_RTOL, nudged=None,
              also=()):
    """{name: {...}} of float32 tensors ``got`` against ``ref``, with the
    same step in float64 as the ``oracle``: each passes within ``rtol`` of
    its scale, max(its largest oracle entry, GRAD_SCALE_FLOOR x the
    largest of any), or where ``got`` is no farther from the oracle than
    AR_HEADROOM times ``ref`` (the train step's rule above).  With
    ``nudged`` (``ref``'s step from weights moved by NUDGE_RTOL, a
    measure of how the step's kinks, ReLUs near zero before training-mode
    batch norms, answer a change far below the kernels' tolerance), the
    last clause takes the larger of ``ref``'s distance from the oracle and
    its distance from ``nudged``.  ``also`` are other float32 runs of the
    same step (another decomposition of the batch, another device): the
    last clause takes the largest of their distances and ``ref``'s from
    the oracle, since float32 resolves a gradient that is a small
    difference of large terms only as far as the order of its sums, and
    one run's order may cancel exactly where another's does not."""
    floor = GRAD_SCALE_FLOOR * max(v.abs().max().item()
                                   for v in oracle.values())
    out = {}
    for n, o in oracle.items():
        err = (got[n] - ref[n]).abs().max().item()
        to_oracle = (got[n] - o).abs().max().item()
        ref_to_oracle = max((r[n] - o).abs().max().item()
                            for r in (ref, *also))
        spread = (0.0 if nudged is None
                  else (nudged[n] - ref[n]).abs().max().item())
        rel = err / max(o.abs().max().item(), floor)
        out[n] = {"rel_of_scale": rel, "to_oracle": to_oracle,
                  "ref_to_oracle": ref_to_oracle,
                  **({} if nudged is None else {"nudge_spread": spread}),
                  "ok": rel < rtol or to_oracle <= AR_HEADROOM * max(
                      ref_to_oracle, spread)}
    return out


def judge_amp(got, ref, oracle, rtol, cos_min, l2_max):
    """{name: {...}} of tensors ``got`` against ``ref``, two AMP runs of
    one step, with the same step in float32 as the ``oracle``.  Each
    passes by the first of these that holds, named under ``clause``:

    * ``rtol``: within ``rtol`` of its scale, max(its largest ``ref``
      entry, AMP_GRAD_SCALE_FLOOR x the largest entry of any);
    * ``vanishes``: the oracle is under AMP_VANISH of that largest entry
      (zero in exact arithmetic), and ``got`` is within the floor of
      ``ref`` or no farther from the oracle than the next clause allows;
    * ``unresolved`` (two bf16 runs differ by more than ``rtol`` there):
      ``got`` points where ``ref`` points and is as long, cosine at least
      ``cos_min`` and L2 distance at most ``l2_max`` of ``ref``'s norm,
      and is no farther from the oracle than AR_HEADROOM times ``ref``
      (or than AR_HEADROOM x ``rtol`` of the scale, where ``ref`` happens
      to lie closer to the oracle than that).

    A zero or inverted tensor passes none of them for ``cos_min`` > 0;
    a halved one none for ``l2_max`` < 0.5."""
    largest = max(v.abs().max().item() for v in ref.values())
    floor = AMP_GRAD_SCALE_FLOOR * largest
    out = {}
    for n, r in ref.items():
        g, r, o = got[n].double(), r.double(), oracle[n].double()
        scale = max(r.abs().max().item(), floor)
        err = (g - r).abs().max().item()
        ref_to_oracle = (r - o).abs().max().item()
        followed = (g - o).abs().max().item() <= AR_HEADROOM * max(
            ref_to_oracle, rtol * scale)
        norms = g.norm().item() * r.norm().item()
        cos = (g.flatten() @ r.flatten()).item() / norms if norms else 0.0
        l2 = (g - r).norm().item() / max(r.norm().item(), 1e-300)
        if err <= rtol * scale:
            clause = "rtol"
        elif o.abs().max().item() < AMP_VANISH * largest:
            clause = "vanishes" if err <= floor or followed else None
        elif cos >= cos_min and l2 <= l2_max and followed:
            clause = "unresolved"
        else:
            clause = None
        out[n] = {"rel_of_scale": err / scale,
                  "ref_vs_oracle_of_scale": ref_to_oracle / scale,
                  "cos": cos, "l2_rel": l2, "clause": clause,
                  "ok": clause is not None}
    return out


def amp_summary(judged):
    """What ``judge_amp`` saw: tensors by clause, the worst error, how far
    bf16 moved ``ref`` from the oracle at most, and the worst cosine and
    L2 distance among the ``unresolved`` tensors."""
    by = {c: sorted(n for n, v in judged.items() if v["clause"] == c)
          for c in ("rtol", "vanishes", "unresolved", None)}
    worst = max(judged, key=lambda n: judged[n]["rel_of_scale"])
    loose = [judged[n] for n in by["unresolved"]]
    return {"tensors": len(judged),
            "by_clause": {str(c): len(v) for c, v in by.items()},
            "failed": {n: judged[n] for n in by[None]},
            "max_rel_of_scale": judged[worst]["rel_of_scale"],
            "worst": worst,
            "max_ref_vs_oracle_of_scale": max(
                v["ref_vs_oracle_of_scale"] for v in judged.values()),
            "unresolved_min_cos": min((v["cos"] for v in loose),
                                      default=None),
            "unresolved_max_l2_rel": max((v["l2_rel"] for v in loose),
                                         default=None),
            "unresolved": {n: judged[n] for n in by["unresolved"]},
            "vanishes": {n: judged[n] for n in by["vanishes"]}}


def phase_train_amp_reference(f32_runs):
    """One AMP step at full width with dropout off, B = REF_B, on the card
    against the same step on the CPU (``judge_amp`` at AMP_GRAD_RTOL, with
    the CPU float32 step of ``phase_train_reference`` as the oracle), and
    the card's AMP loss against its float32 loss."""
    cfg, ss, state, batch = reference_config()
    t0 = time.time()
    m_gpu, g_gpu, s_gpu = reference_step(cfg, ss, state, batch, "cuda",
                                         use_amp=True)
    m_cpu, g_cpu, s_cpu = reference_step(cfg, ss, state, batch, "cpu",
                                         use_amp=True)
    m_f32, g_f32, _ = f32_runs["cpu", torch.float32]
    m_gpu_f32 = f32_runs["cuda", torch.float32][0]
    loss_rel = abs(m_gpu["Loss"] - m_cpu["Loss"]) / abs(m_cpu["Loss"])
    vs_f32 = abs(m_gpu["Loss"] - m_gpu_f32["Loss"]) / abs(m_gpu_f32["Loss"])
    grads = judge_amp(g_gpu, g_cpu, g_f32, AMP_GRAD_RTOL, AMP_COS_MIN,
                      AMP_L2_MAX)
    stats_rel = {n: (s_gpu[n] - v).abs().max().item()
                 / max(v.abs().max().item(), 1e-30) for n, v in s_cpu.items()}
    worst_stat = max(stats_rel, key=stats_rel.get)
    emit({"phase": "train_amp_reference", "B": REF_B, "T": TRAIN_T,
          "loss": [m_gpu["Loss"], m_cpu["Loss"]], "loss_rel_err": loss_rel,
          "loss_f32": [m_gpu_f32["Loss"], m_f32["Loss"]],
          "amp_vs_f32_loss_rel": vs_f32,
          "grad_norm": [m_gpu["GradNorm"], m_cpu["GradNorm"]],
          "grads": amp_summary(grads),
          "stats_max_err_of_scale": stats_rel[worst_stat],
          "worst_stat": worst_stat,
          "limits": {"loss_rtol": AMP_LOSS_RTOL,
                     "grad_rtol_of_scale": AMP_GRAD_RTOL,
                     "grad_scale_floor": AMP_GRAD_SCALE_FLOOR,
                     "unresolved_cos_min": AMP_COS_MIN,
                     "unresolved_l2_max": AMP_L2_MAX,
                     "grad_f32_headroom": AR_HEADROOM,
                     "amp_vs_f32_loss_rtol": AMP_VS_F32_RTOL},
          "seconds": time.time() - t0})
    assert np.isfinite(m_gpu["Loss"]) and loss_rel < AMP_LOSS_RTOL, loss_rel
    assert vs_f32 < AMP_VS_F32_RTOL, vs_f32
    bad = {n: v for n, v in grads.items() if not v["ok"]}
    assert not bad, bad


def timing_batch(B: int, out_dim: int, notes, seed: int = 0, T=None):
    """B note-merged track pairs as ``MultiTrackBatchIterator`` packs them
    for the timing models: each track a random note sequence of
    ``notes[0]`` to ``notes[1] - 1`` notes (end times cumulative sums of
    1-3 frames), merged by ``data/multitrack.merge_tracks_by_notes``
    (``mask0`` False where only the sub track has a note), padded to T
    positions, or without T to the next multiple of 8 past the longest."""
    from ensemble_svs_with_interactions_tpu_torch.data.multitrack import (
        merge_tracks_by_notes,
    )

    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(B):
        tracks = []
        for _ in range(2):
            n = int(rng.integers(*notes))
            tracks += [rng.uniform(0, 1, (n, 82)).astype(np.float32),
                       rng.normal(size=(n, out_dim)).astype(np.float32),
                       np.cumsum(rng.integers(1, 4, n))]
        rows.append(merge_tracks_by_notes(*tracks))
    lengths = np.array([len(r[0]) for r in rows], np.int32)
    if T is None:
        T = -(-int(lengths.max()) // 8) * 8
    batch = {"in_feats0": np.zeros((B, T, 82), np.float32),
             "in_feats1": np.zeros((B, T, 82), np.float32),
             "out_feats0": np.zeros((B, T, out_dim), np.float32),
             "mask0": np.zeros((B, T), bool),
             "spks0": rng.integers(0, 4, B).astype(np.int32),
             "spks1": rng.integers(0, 4, B).astype(np.int32),
             "lengths": lengths}
    for i, (mx0, my0, m0, mx1, _, _) in enumerate(rows):
        n = lengths[i]
        batch["in_feats0"][i, :n], batch["in_feats1"][i, :n] = mx0, mx1
        batch["out_feats0"][i, :n], batch["mask0"][i, :n] = my0, m0
    return batch


def build_timing_trainer(cfg, state_dict, device, dtype=torch.float32,
                         use_amp=True):
    """(module, train_step) of a timing model with the recipe's optimizer
    (Adam at 1e-4, clip 1.0)."""
    from ensemble_svs_with_interactions_tpu_torch.train.loop import (
        build_optimizer,
    )
    from ensemble_svs_with_interactions_tpu_torch.train.multitrack import (
        create_multitrack_timing_train_step,
    )
    from ensemble_svs_with_interactions_tpu_torch.utils.config import (
        instantiate,
    )

    module = instantiate(cfg)
    module.load_state_dict(state_dict)
    module.to(dtype)
    opt, sched = build_optimizer(module.parameters(),
                                 {"name": "Adam", "params": {"lr": 1e-4}})
    step, _ = create_multitrack_timing_train_step(
        module, opt, scheduler=sched, clip_norm=1.0, use_amp=use_amp,
        device=device)
    return module, step


def phase_timing_train():
    """The duration model at bench.py's widths (hidden 256, 5 layers,
    kernel 5, MDN of 4) in the AMP arm at TIMING_B x TIMING_T note
    positions: 2 warm-up and TRAIN_STEPS timed steps.  Then one step on a
    TIMING_REF_B x TIMING_REF_T batch without dropout, card against CPU:
    in float32 (the loss at TRAIN_LOSS_RTOL, each gradient by
    ``judge_f32`` with the CPU's float64 step as the oracle), and in the
    AMP arm (the loss at TIMING_RTOL, each gradient by ``judge_amp`` at
    TIMING_RTOL with the CPU's float32 step as the oracle)."""
    du = flagship_phases()[1]["duration"][0]["netG"]
    state = seeded_state_dict(du, SEED + 1)
    _, step = build_timing_trainer(du, state, "cuda")
    notes = (TIMING_T // 2 - TIMING_T // 8, TIMING_T // 2 + 1)
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in
             timing_batch(TIMING_B, du["out_dim"], notes,
                          T=TIMING_T).items()}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    losses = [step(batch, gen)["Loss"] for _ in range(2)]
    torch.cuda.reset_peak_memory_stats()
    step_s = []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(step(batch, gen)["Loss"])
        step_s.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    median = float(np.median(step_s))

    t0 = time.time()
    cfg = {**du, "dropout": 0.0}
    notes = (TIMING_REF_T // 2 - TIMING_REF_T // 8, TIMING_REF_T // 2 + 1)
    small = timing_batch(TIMING_REF_B, du["out_dim"], notes, seed=1,
                         T=TIMING_REF_T)
    runs = {}
    for name, dev, dtype, use_amp in (
            ("card_amp", "cuda", torch.float32, True),
            ("cpu_amp", "cpu", torch.float32, True),
            ("card_f32", "cuda", torch.float32, False),
            ("cpu_f32", "cpu", torch.float32, False),
            ("cpu_f64", "cpu", torch.float64, False)):
        module, ref_step = build_timing_trainer(cfg, state, dev, dtype,
                                                use_amp=use_amp)
        metrics = ref_step(small, torch.Generator(device=dev).manual_seed(0))
        runs[name] = (metrics, {n: p.grad.detach().cpu().double()
                                for n, p in module.named_parameters()})
    (m_gpu, g_gpu), (m_cpu, g_cpu) = runs["card_amp"], runs["cpu_amp"]
    (mf_gpu, gf_gpu), (mf_cpu, gf_cpu) = runs["card_f32"], runs["cpu_f32"]
    loss_rel = abs(m_gpu["Loss"] - m_cpu["Loss"]) / abs(m_cpu["Loss"])
    f32_loss_rel = abs(mf_gpu["Loss"] - mf_cpu["Loss"]) / abs(mf_cpu["Loss"])
    grads = judge_amp(g_gpu, g_cpu, gf_cpu, TIMING_RTOL, TIMING_COS_MIN,
                      TIMING_L2_MAX)
    f32_grads = judge_f32(gf_gpu, gf_cpu, runs["cpu_f64"][1])
    emit({"phase": "timing_train", "model": "duration", "use_amp": True,
          "B": TIMING_B, "T": TIMING_T,
          "positions": int(batch["lengths"].sum()),
          "main_track_positions": int(batch["mask0"].sum()),
          "steps_s": step_s, "median_step_s": median,
          "positions_per_s": TIMING_B * TIMING_T / median,
          "losses": losses, "peak_mem_gib": peak, "steps": TRAIN_STEPS,
          "reference": {
              "B": TIMING_REF_B, "T": TIMING_REF_T,
              "f32": {"loss": [mf_gpu["Loss"], mf_cpu["Loss"]],
                      "loss_rel_err": f32_loss_rel,
                      "max_grad_rel_err": max(
                          v["rel_of_scale"] for v in f32_grads.values()),
                      "judged_by_f64_oracle": {
                          n: v for n, v in f32_grads.items()
                          if v["rel_of_scale"] >= TRAIN_GRAD_RTOL},
                      "loss_rtol": TRAIN_LOSS_RTOL,
                      "grad_rtol": TRAIN_GRAD_RTOL},
              "amp": {"loss": [m_gpu["Loss"], m_cpu["Loss"]],
                      "loss_rel_err": loss_rel,
                      "grads": amp_summary(grads),
                      "limits": {"rtol": TIMING_RTOL,
                                 "unresolved_cos_min": TIMING_COS_MIN,
                                 "unresolved_l2_max": TIMING_L2_MAX}},
              "seconds": time.time() - t0}})
    assert all(np.isfinite(x) for x in losses), losses
    assert np.isfinite(mf_gpu["Loss"]) and f32_loss_rel < TRAIN_LOSS_RTOL, \
        f32_loss_rel
    bad = {n: v for n, v in f32_grads.items() if not v["ok"]}
    assert not bad, bad
    assert np.isfinite(m_gpu["Loss"]) and loss_rel < TIMING_RTOL, loss_rel
    bad = {n: v for n, v in grads.items() if not v["ok"]}
    assert not bad, bad


# ------------------------------------------------------------------ trainer
RECIPE = REPO / PKG / "recipes" / "jaCappella_dev_48k_world_multitrack" / \
    "config.yaml"
CORPUS_SPKS = ("Vo1", "S1", "ritsu")  # the recipe's spk_names
# the recipe's note-level features a track (jp_dev_latest.hed); the shipped
# multitrack timing configs say in_dim 164, both tracks' width in the
# reference, which the JAX model doubles again (recipe_phase_config)
TIMING_DIM = 82
FRAME_PERIOD_100NS = 50000
TRAINER_EPOCHS = 2       # the recipe's nepochs (100), cut
# phase trainer's own runs: 1 epoch, so the script stays near 12 minutes
# with the mel voice (bench_train_cuda.py --trainer keeps TRAINER_EPOCHS)
SMOKE_TRAINER_EPOCHS = 1
TRAINER_CORPUS = dict(n_train=48, n_dev=4, frames=(1000, 3001))
SHORT_DEV_FRAMES = (200, 257)


def _segment_notes(T: int, rng):
    """Note start frames of one segment's score: notes of 8-60 frames."""
    starts = [0]
    while starts[-1] < T:
        starts.append(starts[-1] + int(rng.integers(8, 61)))
    return np.asarray(starts[:-1])


def _track_frames(T, onsets, rng):
    """(in (T, 86), out (T, 67)) normalized frame features of one singer
    from its note onsets: a rest flag (dim 0), a phoneme one-hot (dims
    3-49), the score lf0 scaled to [0, 1] (dim 51, held through rests),
    uniform context elsewhere; out: mgc, lf0 near the score, vuv off in
    rests, bap."""
    x = rng.uniform(0, 0.5, (T, 86)).astype(np.float32)
    y = rng.normal(0, 1, (T, 67)).astype(np.float32)
    x[:, 3:50] = 0.0
    bounds = list(onsets) + [T]
    pitch = 0.5
    for s, e in zip(bounds[:-1], bounds[1:]):
        rest = rng.uniform() < 0.15
        pitch = pitch if rest else float(rng.uniform(0.2, 0.8))
        x[s:e, 0] = float(rest)
        x[s:e, 51] = pitch
        x[s:e, 3 + int(rng.integers(47))] = 1.0
        y[s:e, 60] = (pitch - 0.5) * 2 + 0.05 * y[s:e, 60]
        y[s:e, 61] = 0.0 if rest else 1.0
    return x, y


def write_corpus(root, n_train: int, n_dev: int, frames, seed: int = 0,
                 timing_dim: int = TIMING_DIM):
    """Synthetic normalized feature dumps of a 3-singer multitrack corpus
    as the recipe's stage 2 leaves them, under ``root``:
    ``{split}/{in,out}_{acoustic,timelag,duration}/{spk}_seg{k}-feats.npy``
    for ``train_no_dev`` (``n_train`` segments) and ``dev`` (``n_dev``),
    every singer of a segment ``frames[0]`` to ``frames[1] - 1`` frames
    long; each singer sings its own subset (70%) of the segment's note
    starts, so tracks share some onsets and differ at others.  Timing
    dumps are note level (``timing_dim`` features in, one target out)
    with ``-times.npy`` note end times in 100 ns units (what
    ``merge_tracks_by_notes`` merges by).  Also the out scalers
    ``scalers/out_{phase}_scaler_{mean,var,scale}.npy`` (the acoustic one
    the flagship's, whose lf0 mean and scale ``SINGLE_LF0`` names).
    Returns ``root``."""
    root = Path(root)
    rng = np.random.default_rng(seed)
    for split, n in (("train_no_dev", n_train), ("dev", n_dev)):
        for d in ("in_acoustic", "out_acoustic", "in_timelag", "out_timelag",
                  "in_duration", "out_duration"):
            (root / split / d).mkdir(parents=True, exist_ok=True)
        for k in range(n):
            T = int(rng.integers(*frames))
            grid = _segment_notes(T, rng)
            for spk in CORPUS_SPKS:
                keep = rng.uniform(size=len(grid)) < 0.7
                keep[0] = True
                onsets = grid[keep]
                name = f"{spk}_seg{k:03d}-feats.npy"
                x, y = _track_frames(T, onsets, rng)
                np.save(root / split / "in_acoustic" / name, x)
                np.save(root / split / "out_acoustic" / name, y)
                ends = np.append(onsets[1:], T)
                times = (ends * FRAME_PERIOD_100NS).astype(np.int64)
                for phase in ("timelag", "duration"):
                    np.save(root / split / f"in_{phase}" / name,
                            rng.uniform(0, 1, (len(onsets), timing_dim))
                            .astype(np.float32))
                    np.save(root / split / f"out_{phase}" / name,
                            rng.normal(0, 1, (len(onsets), 1))
                            .astype(np.float32))
                    np.save(root / split / f"in_{phase}" /
                            name.replace("-feats", "-times"), times)
    (root / "scalers").mkdir(exist_ok=True)
    _, phases = flagship_phases()
    for phase, (_, _, sc_out) in phases.items():
        dims = 67 if phase == "acoustic" else 1
        for attr in ("mean", "var", "scale"):
            np.save(root / "scalers" / f"out_{phase}_scaler_{attr}.npy",
                    np.asarray(getattr(sc_out, attr + "_"),
                               np.float64)[:dims])
    return root


def recipe_phase_config(phase: str, corpus, out_dir, multitrack=True,
                        **overrides):
    """The config ``bin/run_recipe.py``'s ``_train_cfg`` hands the trainer
    for ``phase`` of the shipped multitrack recipe (``RECIPE``, read as a
    file): the phase's model config verbatim (the lf0 fields the recipe
    fills from the scalers set to SINGLE_LF0; ``multitrack=False`` takes
    the single-track voice's ``acoustic_multistream_ar_f0.yaml``, the
    timing phases' ``*_vp_mdn.yaml``; the multitrack timing models'
    ``in_dim`` set to TIMING_DIM), the corpus's dump directories and
    out scaler, the recipe's data and train sections, ``train.out_dir``,
    and ``overrides`` (dotted keys, as the CLIs take them) over it all."""
    from ensemble_svs_with_interactions_tpu_torch.utils import yaml_io
    from ensemble_svs_with_interactions_tpu_torch.utils.config import (
        merge,
        parse_overrides,
    )

    recipe = yaml_io.load(RECIPE.read_text())[phase]
    rel = Path(recipe["model_config"]).relative_to("../../configs")
    if not multitrack:
        rel = {"acoustic": "acoustic/acoustic_multistream_ar_f0.yaml",
               "timelag": "timelag/timelag_vp_mdn.yaml",
               "duration": "duration/duration_vp_mdn.yaml"}[phase]
    model = shipped_config(str(rel))
    if multitrack and phase != "acoustic":
        # in_dim is a track's width in the JAX model (it takes both tracks,
        # 2 * in_dim): the recipe's 82 note features, not the config's 164
        model["netG"]["in_dim"] = TIMING_DIM

    def fill(node):
        for k, v in node.items():
            if k in SINGLE_LF0 and v is None:
                node[k] = SINGLE_LF0[k]
            elif isinstance(v, dict):
                fill(v)

    fill(model["netG"])
    corpus = Path(corpus)
    data = {split: {"in_dir": str(corpus / split / f"in_{phase}"),
                    "out_dir": str(corpus / split / f"out_{phase}")}
            for split in ("train_no_dev", "dev")}
    data["out_scaler_prefix"] = str(corpus / "scalers" /
                                    f"out_{phase}_scaler")
    data.update(recipe.get("data", {}))
    if not multitrack:
        data.pop("spk_names")
    cfg = merge({"seed": 1234, "verbose": 0},
                {"model": model, "data": data,
                 "train": {**recipe["train"], "out_dir": str(out_dir)}})
    args = [f"{k}={v}" for k, v in overrides.items()]
    return merge(cfg, parse_overrides(args)) if args else cfg


class TrainerClock:
    """The ``observe`` hook of the port's trainers (``trainer.run_epochs``):
    the host seconds and batches of the train and dev splits, the frames
    trained (valid main-track frames, from the host arrays), each split's
    batch shapes (B, T), and the first dev batch's lengths and
    prediction."""

    def __init__(self):
        self.seconds = {"train": 0.0, "dev": 0.0}
        self.calls = {"train": 0, "dev": 0}
        self.frames = 0
        self.shapes = {"train": set(), "dev": set()}
        self.first_dev = None

    def __call__(self, split, seconds, batch, pred):
        key = "train" if split == "train_no_dev" else "dev"
        self.seconds[key] += seconds
        self.calls[key] += 1
        x = batch.get("in_feats0", batch.get("in_feats"))
        self.shapes[key].add(tuple(x.shape[:2]))
        if key == "train":
            self.frames += int(batch["lengths"].sum())
        elif self.first_dev is None:
            self.first_dev = (batch["lengths"], pred)


def hold_trainer_kernels(lr, netg, train_shapes, dev_shapes) -> dict:
    """Each LSTM kernel at the shapes a trainer run gave it, against its
    plain version on seeded random inputs: the forward without c at each
    dev batch's (B, T) and at B = 3 for the longest T (the group kernel's
    R choice at an odd B); the forward with c, the BPTT and dW_h at each
    train batch's; each at every (H, T') the model runs over T frames
    (``train_lstm_shapes``).  Returns the worst errors (dW_h relative to
    its largest entry) and the kernel chosen at each dev (B, H)."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    err = {"lstm_recurrence": 0.0, "lstm_recurrence_c": 0.0,
           "lstm_bptt": 0.0, "lstm_dwh_rel": 0.0}
    longest = max(T for _, T in dev_shapes)
    dev = sorted(set(dev_shapes) | {(3, longest)})
    cases = [(B, T, False) for B, T in dev] + [
        (B, T, True) for B, T in sorted(train_shapes)]
    kernels = {}
    for B, T, train in cases:
        for H, t in sorted(train_lstm_shapes(netg, T)):
            xw = torch.randn(B, t, 4 * H, device="cuda", generator=g)
            w_h = torch.randn(H, 4 * H, device="cuda", generator=g) / H ** 0.5
            if not train:
                kernels[f"B={B} H={H}"] = lr.lstm_recurrence_kernel_name(B, H)
                e = (lr.lstm_recurrence(xw, w_h) - lr.lstm_recurrence_reference(
                    xw, w_h)).abs().max().item()
                err["lstm_recurrence"] = max(err["lstm_recurrence"], e)
                continue
            dy = torch.randn(B, t, H, device="cuda", generator=g)
            h, c = lr.lstm_recurrence(xw, w_h, want_c=True)
            h_ref, c_ref = lr.lstm_recurrence_reference(xw, w_h, want_c=True)
            e = max((h - h_ref).abs().max().item(),
                    (c - c_ref).abs().max().item())
            err["lstm_recurrence_c"] = max(err["lstm_recurrence_c"], e)
            dxw = lr.lstm_bptt(xw, w_h, h, c, dy)
            dxw_ref, dwh_ref = lr.lstm_recurrence_bwd_reference(xw, w_h, h, c,
                                                                dy)
            err["lstm_bptt"] = max(err["lstm_bptt"],
                                   (dxw - dxw_ref).abs().max().item())
            e = ((lr.lstm_dwh(h, dxw) - dwh_ref).abs().max().item()
                 / dwh_ref.abs().max().item())
            err["lstm_dwh_rel"] = max(err["lstm_dwh_rel"], e)
    return {"shapes_held": [list(c) for c in cases], "max_err": err,
            "atol": KERNEL_ATOL, "dwh_rtol_of_max": DWH_RTOL,
            "kernel_by_dev_shape": kernels}


def assert_trainer_kernels(held):
    e = held["max_err"]
    assert all(np.isfinite(v) for v in e.values()), held
    assert max(e["lstm_recurrence"], e["lstm_recurrence_c"],
               e["lstm_bptt"]) < KERNEL_ATOL, held
    assert e["lstm_dwh_rel"] <= DWH_RTOL, held


def run_trainer(lr, cfg, acoustic: bool, multitrack: bool = True,
                device="cuda") -> dict:
    """One trainer run on ``device`` (``train_multitrack_model`` or the
    single-track ``train_model``) with the kernel launch counts reset just
    before and read just after; its wall seconds, the seconds in train
    and dev batches (``TrainerClock``), the frames trained (valid
    main-track frames), the trainer's frames/s (over its wall time) and
    the train batches' alone, peak memory, each epoch's dev ``Loss``,
    each split's batch shapes (B, T), the files it wrote."""
    from ensemble_svs_with_interactions_tpu_torch.train import (
        multitrack_trainer,
        trainer,
    )

    device = torch.device(device)
    fn = (multitrack_trainer.train_multitrack_model if multitrack
          else trainer.train_model)
    for name in TRAIN_COUNTERS:
        getattr(lr, name).launches = 0
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    clock = TrainerClock()
    t0 = time.perf_counter()
    fn(cfg, acoustic, device=device, observe=clock)
    wall = time.perf_counter() - t0
    launches = {n: getattr(lr, n).launches for n in TRAIN_COUNTERS}
    out_dir = Path(cfg["train"]["out_dir"])
    records = [json.loads(line) for line in
               (out_dir / "metrics.jsonl").read_text().splitlines()]
    dev = [r["dev/Loss"] for r in records if "dev/Loss" in r]
    train = [r["train_no_dev/Loss"] for r in records
             if "train_no_dev/Loss" in r]
    return {
        "wall_s": wall, "train_steps_s": clock.seconds["train"],
        "dev_steps_s": clock.seconds["dev"],
        "other_s": wall - sum(clock.seconds.values()),
        "steps": clock.calls["train"], "dev_batches": clock.calls["dev"],
        "train_frames": clock.frames,
        "frames_per_s": clock.frames / wall,
        "steps_frames_per_s": (clock.frames / clock.seconds["train"]
                               if clock.seconds["train"] else None),
        "peak_mem_gib": (torch.cuda.max_memory_allocated(device) / 2 ** 30
                         if on_card else None),
        "train_loss": train, "dev_loss": dev,
        "train_shapes": sorted(clock.shapes["train"]),
        "dev_shapes": sorted(clock.shapes["dev"]),
        "launches": launches,
        "files": sorted(p.name for p in out_dir.iterdir()),
    }


def assert_trainer_run(r, nepochs, acoustic):
    """Every file the JAX trainer writes, finite losses, and (acoustic
    models) every LSTM kernel launched and held at the run's shapes."""
    for f in ("latest.ckpt", "best_loss.ckpt", "metrics.jsonl",
              "dev_metrics.json"):
        assert f in r["files"], (f, r["files"])
    assert len(r["dev_loss"]) == nepochs == len(r["train_loss"]), r
    assert all(np.isfinite(x) for x in r["dev_loss"] + r["train_loss"]), r
    if acoustic:
        assert all(n > 0 for n in r["launches"].values()), r["launches"]
        assert_trainer_kernels(r["kernels_held"])


TRAINER_RUNS = (
    # name, recipe phase, acoustic, multitrack, overrides
    ("timelag", "timelag", False, True, {}),
    ("duration", "duration", False, True, {}),
    ("acoustic", "acoustic", True, True, {}),
    ("acoustic_interaction", "acoustic", True, True, {
        "train.pitch_reg_weight": 1.0, "train.logf0_diff_weight": 1.0,
        "train.mgc_diff_weight": 1.0}),
    ("single_acoustic", "acoustic", True, False, {}),
)


def pack_trained(model_dir, corpus, configs):
    """The trained phases' ``best_loss.ckpt`` packed with the port's
    ``pack_model`` as the recipe's stage 6 packs them (identity input
    scalers; the corpus's out scalers)."""
    from ensemble_svs_with_interactions_tpu_torch.train.loop import (
        load_checkpoint,
    )
    from ensemble_svs_with_interactions_tpu_torch.train.trainer import (
        load_out_scaler,
    )
    from ensemble_svs_with_interactions_tpu_torch.utils import (
        packaged_question_path,
    )
    from ensemble_svs_with_interactions_tpu_torch.utils.config import (
        instantiate,
    )
    from ensemble_svs_with_interactions_tpu_torch.utils.packing import (
        pack_model,
    )
    from ensemble_svs_with_interactions_tpu_torch.utils.scalers import (
        MinMaxScaler,
    )

    glob, _ = flagship_phases()
    glob = {**glob, "spk_list": list(CORPUS_SPKS)}
    parts = {}
    for phase, cfg in configs.items():
        module = instantiate(cfg["model"]["netG"])
        load_checkpoint(Path(cfg["train"]["out_dir"]) /
                        "best_loss.ckpt").restore(module)
        dim = 86 if phase == "acoustic" else TIMING_DIM
        parts[phase] = {
            "model_config": json.loads(json.dumps(cfg["model"])),
            "module": module,
            "in_scaler": MinMaxScaler(np.zeros(dim), np.ones(dim)),
            "out_scaler": load_out_scaler(
                Path(corpus) / "scalers" / f"out_{phase}_scaler")}
    return pack_model(model_dir, glob, packaged_question_path(), parts)


def first_dev_pass(root, corpus, start, device):
    """The acoustic trainer's dev ``Loss`` at the weights of ``start`` on
    ``corpus``, whose training split is empty (one epoch, float32, dropout
    and prenet dropout 0), and its first dev batch's main-track prediction
    on the valid frames (host float64)."""
    from ensemble_svs_with_interactions_tpu_torch.train import (
        multitrack_trainer,
    )

    out = Path(root) / f"first_dev_{device}"
    cfg = recipe_phase_config("acoustic", corpus, out, **{
        "train.nepochs": 1, "train.use_amp": False,
        "train.resume.checkpoint": str(start)})
    net = cfg["model"]["netG"]
    net["lf0_model"]["prenet_dropout"] = 0.0
    for k in ("mgc_model", "vuv_model", "bap_model"):
        net[k]["dropout"] = 0.0
    clock = TrainerClock()
    multitrack_trainer.train_multitrack_model(cfg, True, device=device,
                                              observe=clock)
    line = (out / "metrics.jsonl").read_text().splitlines()[-1]
    lengths, pred = clock.first_dev
    valid = (torch.arange(pred.shape[1])[None, :]
             < torch.from_numpy(lengths)[:, None])
    return json.loads(line)["dev/Loss"], pred.cpu().double()[valid]


def phase_trainer(lr, label):
    """The recipe's three phases through the port's trainers at full width
    on a synthetic corpus (TRAINER_CORPUS, ``write_corpus``),
    SMOKE_TRAINER_EPOCHS epochs each (TRAINER_RUNS: timelag, duration, acoustic as shipped and
    with the interaction weights at 1, and the single-track voice's
    acoustic model through ``train_model`` on the same dumps), one line
    each (``run_trainer``, with ``hold_trainer_kernels`` at the acoustic
    runs' shapes); then the acoustic and timing checkpoints
    packed (``pack_trained``) and one pair rendered through
    ``SPSVS(model_dir)`` (``svs_pair``); then the first dev ``Loss`` from a
    shared start checkpoint, card against CPU on one short dev segment,
    with the dev pass's prediction (``first_dev_pass``: 3 singers x
    SHORT_DEV_FRAMES, 6 pairs).  Returns the launches summed over the
    runs and the worst kernel errors of the holds."""
    from ensemble_svs_with_interactions_tpu_torch.svs import SPSVS
    from ensemble_svs_with_interactions_tpu_torch.train.loop import (
        TrainState,
        save_checkpoint,
    )
    from ensemble_svs_with_interactions_tpu_torch.utils.config import (
        instantiate,
    )
    from ensemble_svs_with_interactions_tpu_torch.utils.flax_init import (
        init_module,
    )

    launches = {n: 0 for n in TRAIN_COUNTERS}
    with tempfile.TemporaryDirectory() as root:
        root = Path(root)
        t0 = time.time()
        corpus = write_corpus(root / "dump", **TRAINER_CORPUS, seed=SEED)
        corpus_s = time.time() - t0
        configs, holds = {}, {}
        for name, phase, acoustic, multitrack, over in TRAINER_RUNS:
            cfg = recipe_phase_config(
                phase, corpus, root / "exp" / name, multitrack=multitrack,
                **{"train.nepochs": SMOKE_TRAINER_EPOCHS, **over})
            r = run_trainer(lr, cfg, acoustic, multitrack)
            if acoustic:  # the kernels at this run's shapes
                netg = cfg["model"]["netG"]
                key = (json.dumps(netg, sort_keys=True),
                       tuple(r["train_shapes"]), tuple(r["dev_shapes"]))
                if key not in holds:
                    t0 = time.time()
                    holds[key] = hold_trainer_kernels(
                        lr, netg, r["train_shapes"], r["dev_shapes"])
                    holds[key]["hold_s"] = time.time() - t0
                r["kernels_held"] = holds[key]
            emit({"phase": "trainer", "run": name, "device": "cuda",
                  "corpus_s": corpus_s, "epochs": SMOKE_TRAINER_EPOCHS,
                  "use_amp": bool(cfg["train"]["use_amp"]), **r})
            assert_trainer_run(r, SMOKE_TRAINER_EPOCHS, acoustic)
            for n, c in r["launches"].items():
                launches[n] += c
            if multitrack and name in ("timelag", "duration", "acoustic"):
                configs[name] = cfg

        t0 = time.time()
        model_dir = pack_trained(root / "packed", corpus, configs)
        pack_s = time.time() - t0
        engine = SPSVS(model_dir, verbose=0, device="cuda")
        t0 = time.time()
        wav = svs_pair(engine, label, late_copy(label), [0, 1])
        pair_s = time.time() - t0
        del engine

        t0 = time.time()
        short = write_corpus(root / "short", n_train=0, n_dev=1,
                             frames=SHORT_DEV_FRAMES, seed=SEED + 1)
        module = init_module(instantiate(configs["acoustic"]["model"][
            "netG"]), SEED)
        save_checkpoint(root / "start", TrainState.capture(module), 0)
        held = {dev: first_dev_pass(root, short,
                                    root / "start" / "latest.ckpt", dev)
                for dev in ("cuda", "cpu")}
        loss = {dev: v[0] for dev, v in held.items()}
        rel = abs(loss["cuda"] - loss["cpu"]) / abs(loss["cpu"])
        pred_err = (held["cuda"][1] - held["cpu"][1]).abs().max().item()
        emit({"phase": "trainer_render", "pack_s": pack_s, "pair_s": pair_s,
              "audio_s": len(wav) / 48000,
              "first_dev_loss": loss, "first_dev_loss_rel_err": rel,
              "rtol": TRAIN_LOSS_RTOL,
              "first_dev_pred_max_abs_err": pred_err,
              "first_dev_pred_scale": held["cpu"][1].abs().max().item(),
              "pred_atol": MODULE_ATOL, "reference_s": time.time() - t0})
        assert wav.dtype == np.int16 and np.abs(wav.astype(np.int64)).max() > 0
        assert np.isfinite(loss["cuda"]) and rel < TRAIN_LOSS_RTOL, loss
        assert pred_err < MODULE_ATOL, pred_err
    worst = {k: max(h["max_err"][k] for h in holds.values())
             for k in next(iter(holds.values()))["max_err"]}
    return launches, worst


# ------------------------------------------------------------ recipe data
JACAPPELLA_LABS = (
    FIXTURE,
    REPO / "tests" / "data" / "nit_song070" / "label_phone_align" /
    "nitech_jp_song070_f001_007.lab",
    REPO / "tests" / "data" / "nit_song070" / "label_phone_align" /
    "nitech_jp_song070_f001_010.lab",
)
RECIPE_SR = 48000        # the recipe's sample_rate
RECIPE_SONG_S = 20.0     # each song's score, the fixtures trimmed
RECIPE_DEV_SONG, RECIPE_EVAL_SONG = "song1", "song2"
# tests/test_native.py's tolerances on the native WORLD analysis against
# NumPy, carried into the dumps: CheapTrick's rtol 1e-6 is an absolute 1e-6
# of the log envelope (the postfilter's target) and, through the codec's
# linear map, of the coded mgc; F0's 1e-7 is below it for lf0; D4C's rtol
# 1e-6 is 20 / ln 10 * 1e-6 dB of the coded aperiodicity; vuv is exact.
# Between the pure harmonics of the synthetic corpus the envelope falls 9
# to 12 decades under its frame's peak, and there the two float64 paths
# part by their roundoff: CheapTrick's smoothing takes differences of a
# cumulative sum over the fft_size / 2 + 1 bins, good to about that many
# eps of the running total, which the peak dominates (on the CPU, 48 kHz:
# up to 7.7e-5 relative at 2e-11, 1.1e-14 of the peak beyond rtol 1e-6).
# So the envelope's bound is rtol 1e-6 plus (fft_size / 2 + 1) eps of the
# frame's peak (2.3e-13 at 48 kHz).  Both
# values are float32: two ulps of the larger come on top.  Dumps that no
# analysis touches are bitwise.
LOG_TOL = 1e-6
BAP_TOL = 20.0 / np.log(10.0) * 1e-6


def trim_labels(labels, seconds: float):
    """The first ``seconds`` of an HTS label sequence (at least 10
    entries), as ``tests/util.trim_labels``."""
    n = len(labels)
    for i, e in enumerate(labels.end_times):
        if e > seconds * 1e7:
            n = i
            break
    return labels[: max(n, 10)]


def synth_wav(labels, binary_dict, numeric_dict, rng, sr: int,
              tail_seconds: float = 0.0):
    """A singing stand-in, as ``tests/util.synth_wav_from_labels``:
    three harmonics following the score pitch on voiced phones, low noise
    elsewhere, int16."""
    from ensemble_svs_with_interactions_tpu_torch.frontend import merlin
    from ensemble_svs_with_interactions_tpu_torch.io import hts

    feats = merlin.linguistic_features(
        labels, binary_dict, numeric_dict, add_frame_features=True,
        subphone_features="coarse_coding")
    midi = feats[:, hts.get_pitch_index(binary_dict, numeric_dict)]
    f0 = np.where(midi > 0, 440.0 * 2 ** ((midi - 69) / 12), 0.0)
    f0_samples = np.repeat(f0, sr * 5 // 1000)
    phase = 2 * np.pi * np.cumsum(f0_samples) / sr
    x = (0.25 * np.sin(phase) + 0.12 * np.sin(2 * phase)
         + 0.05 * np.sin(3 * phase))
    x = np.where(f0_samples > 0, x,
                 0.003 * rng.standard_normal(len(x)))
    if tail_seconds:
        x = np.concatenate([x, np.zeros(int(tail_seconds * sr))])
    return (x * 32767).astype(np.int16)


def write_jacappella_corpus(root, spks=CORPUS_SPKS, sr: int = RECIPE_SR,
                            seconds: float = RECIPE_SONG_S,
                            seed: int = SEED):
    """A jaCappella-layout corpus, ``<root>/<spk>/<song>_{aligned,score}.lab``
    and ``<song>.wav``, as ``tests/util.build_synthetic_jacappella_corpus``
    writes it without JAX: each singer sings 3 songs (the fixtures'
    scores trimmed to ``seconds``), aligned one frame later per singer
    index; the second singer's wavs are 24-bit PCM.  Returns (root, the
    songs' audio seconds)."""
    from scipy.io import wavfile

    from ensemble_svs_with_interactions_tpu_torch.io import hts
    from ensemble_svs_with_interactions_tpu_torch.utils import (
        packaged_question_path,
    )

    root = Path(root)
    binary_dict, numeric_dict = hts.load_question_set(
        packaged_question_path())
    rng = np.random.default_rng(seed)
    audio_s = 0.0
    for si, spk in enumerate(spks):
        (root / spk).mkdir(parents=True, exist_ok=True)
        for fi, path in enumerate(JACAPPELLA_LABS):
            song = f"song{fi}"
            score = trim_labels(hts.load(path), seconds)
            aligned = hts.full_to_mono(score.copy())
            shift = FRAME_PERIOD_100NS * (si + 1)
            aligned.start_times = [t + shift for t in aligned.start_times]
            aligned.end_times = [t + shift for t in aligned.end_times]
            aligned.start_times[0] = score.start_times[0]
            score.save(root / spk / f"{song}_score.lab")
            aligned.save(root / spk / f"{song}_aligned.lab")
            wav = synth_wav(score, binary_dict, numeric_dict, rng, sr,
                            tail_seconds=0.3)
            if si == 1:
                wav = (wav.astype(np.int64) << 16).astype(np.int32)
            wavfile.write(root / spk / f"{song}.wav", sr, wav)
            audio_s += len(wav) / sr
    return root, audio_s


def recipe_data_overrides(corpus, work) -> list:
    """``key=value`` overrides that point the shipped recipe at ``corpus``
    and ``work``: the corpus root, the data, list and feature directories,
    the port's question set, and the dev and eval songs; nothing else."""
    from ensemble_svs_with_interactions_tpu_torch.utils import (
        packaged_question_path,
    )

    data = Path(work) / "data_multitrack"
    return [
        f"work_dir={work}", f"question_path={packaged_question_path()}",
        f"data_prep.corpus_root={corpus}", f"data_prep.out_dir={data}",
        f"data_prep.dev_songs=[{RECIPE_DEV_SONG}]",
        f"data_prep.eval_songs=[{RECIPE_EVAL_SONG}]",
        f"data.lists_dir={data / 'lists'}",
        "features.timelag.label_phone_score_dir="
        f"{data / 'timelag/label_phone_score'}",
        "features.timelag.label_phone_align_dir="
        f"{data / 'timelag/label_phone_align'}",
        f"features.duration.label_dir={data / 'duration/label_phone_align'}",
        f"features.acoustic.wav_dir={data / 'acoustic/wav'}",
        f"features.acoustic.label_dir={data / 'acoustic/label_phone_align'}",
    ]


def run_recipe_stages(first: int, last: int, overrides, numpy: bool = False,
                      recipe: Path = RECIPE) -> dict:
    """``bin/run_recipe.main`` on ``recipe`` (the shipped one by default)
    from stage ``first`` to ``last`` with ``overrides``; with ``numpy``
    under ``ESVS_DISABLE_NATIVE=1`` (the feature workers take the caller's
    environment).  Returns each stage's wall seconds."""
    import os

    from ensemble_svs_with_interactions_tpu_torch.bin import run_recipe

    seconds = {}
    stages = dict(run_recipe.STAGES)

    def timed(k, fn):
        def run(cfg, work):
            t0 = time.perf_counter()
            fn(cfg, work)
            seconds[k] = time.perf_counter() - t0
        return run

    old = os.environ.get("ESVS_DISABLE_NATIVE")
    os.environ["ESVS_DISABLE_NATIVE"] = "1" if numpy else "0"
    try:
        run_recipe.STAGES.update({k: timed(k, fn) for k, fn in stages.items()})
        assert run_recipe.main([str(recipe), "--stage", str(first),
                                "--stop-stage", str(last), *overrides]) == 0
    finally:
        run_recipe.STAGES.update(stages)
        if old is None:
            del os.environ["ESVS_DISABLE_NATIVE"]
        else:
            os.environ["ESVS_DISABLE_NATIVE"] = old
    return seconds


def codec_matrix(fs: int, fft_size: int, dims: int) -> np.ndarray:
    """(dims, fft_size // 2 + 1) matrix M of the WORLD spectral codec,
    ``code_spectral_envelope(sp) == log(sp) @ M.T``: the mel-grid
    interpolation then the scaled DCT."""
    from ensemble_svs_with_interactions_tpu_torch.ops.world import codec

    (i0, w1), _, code_dct, _ = codec._world_codec_tables(fs, fft_size)
    interp = np.zeros((len(i0), fft_size // 2 + 1))
    rows = np.arange(len(i0))
    interp[rows, i0] = 1.0 - w1
    interp[rows, i0 + 1] += w1
    return code_dct[:dims] @ interp


def dump_bounds(kind, want, log_sp, stream_sizes, code) -> np.ndarray:
    """The bound on |native - NumPy| of each entry of an analysis dump
    ``want`` (out_acoustic or out_postfilter features): the envelope's
    ``LOG_TOL + floor * peak / sp`` per bin of its log envelope ``log_sp``
    (from the postfilter dump; floor = (bins) eps), through ``code`` (the
    codec's matrix, summed in absolute value) for mgc; LOG_TOL on lf0, 0
    on vuv, BAP_TOL on bap; plus two float32 ulps of the entry."""
    floor = log_sp.shape[1] * np.finfo(np.float64).eps
    env = LOG_TOL + floor * np.exp(
        log_sp.max(axis=1, keepdims=True) - log_sp)
    first = env if kind == "out_postfilter-feats" else env @ np.abs(code).T
    d = first.shape[1]
    tol = np.zeros(want.shape)
    tol[:, :d] = first
    tol[:, d] = LOG_TOL                                   # lf0
    tol[:, d + 2: d + 2 + stream_sizes[3]] = BAP_TOL      # bap
    return tol + 2 * np.spacing(np.abs(want).astype(np.float32)) * (tol > 0)


def native_vs_numpy(native_work, numpy_work, stream_sizes, fs: int) -> dict:
    """Each ``dump/*/org`` kind (directory and suffix) of a native run
    against a NumPy run of the same lists: the file count, the largest
    difference, and its largest ratio to the bound (``dump_bounds`` on the
    analysis's dumps; 0, bitwise, on those no analysis touches)."""
    from ensemble_svs_with_interactions_tpu_torch.ops.world.codec import (
        get_cheaptrick_fft_size,
    )

    code = codec_matrix(fs, get_cheaptrick_fft_size(fs), stream_sizes[0])
    out = {}
    native_work, numpy_work = Path(native_work), Path(numpy_work)
    for f in sorted(native_work.glob("dump/*/org/*/*.npy")):
        kind = f"{f.parent.name}{f.name[f.name.rindex('-'):-4]}"
        rel = f.relative_to(native_work)
        got = np.load(numpy_work / rel).astype(np.float64)
        want = np.load(f)
        assert got.shape == want.shape, f
        diff = np.abs(got - want.astype(np.float64))
        if kind in ("out_acoustic-feats", "out_postfilter-feats"):
            pf = np.load(str(f).replace("out_acoustic", "out_postfilter"))
            log_sp = pf[:, :pf.shape[1] - sum(stream_sizes[1:])].astype(
                np.float64)
            tol = dump_bounds(kind, want, log_sp, stream_sizes, code)
        else:
            tol = np.zeros(want.shape)
        ratio = np.where(diff > 0, diff / np.maximum(tol, 1e-300), 0.0)
        r = out.setdefault(kind, {"files": 0, "max_abs_diff": 0.0,
                                  "max_ratio_to_bound": 0.0})
        r["files"] += 1
        r["max_abs_diff"] = max(r["max_abs_diff"], float(diff.max()))
        r["max_ratio_to_bound"] = max(r["max_ratio_to_bound"],
                                      float(ratio.max()))
    return out


def phase_recipe_data(root) -> Path:
    """The recipe's data stages on the port, on the host (phase 11b):
    ``write_jacappella_corpus`` at 48 kHz, ``bin/run_recipe.main
    --stage -1 --stop-stage 2`` with the native WORLD analysis, then
    stages 0 and 1 again under NumPy on the same lists into another work
    directory, each dump kind held native against NumPy
    (``native_vs_numpy``).  Returns the native work directory."""
    from ensemble_svs_with_interactions_tpu_torch import native
    from ensemble_svs_with_interactions_tpu_torch.ops.world.codec import (
        get_num_aperiodicities,
    )
    from ensemble_svs_with_interactions_tpu_torch.utils import yaml_io

    features = yaml_io.load(RECIPE.read_text())["features"]
    params = features["acoustic"]["params"]
    fs = int(params["sample_rate"])
    stream_sizes = [int(params["mgc_order"]) + 1, 1, 1,
                    get_num_aperiodicities(fs)]
    root = Path(root)
    t0 = time.time()
    corpus, song_s = write_jacappella_corpus(root / "corpus")
    corpus_s = time.time() - t0
    t0 = time.time()
    built = native.available()
    build_s = time.time() - t0
    work = root / "work"
    over = recipe_data_overrides(corpus, work)
    stage_s = run_recipe_stages(-1, 2, over)
    numpy_work = root / "work_numpy"
    numpy_over = [o for o in over if not o.startswith("work_dir=")] + [
        f"work_dir={numpy_work}"]
    numpy_s = run_recipe_stages(0, 1, numpy_over, numpy=True)[1]
    held = native_vs_numpy(work, numpy_work, stream_sizes, fs)
    seg_s = sum(len(np.load(p)) for p in work.glob(
        "dump/*/org/out_acoustic/*-wave.npy")) / fs
    lists = work / "data_multitrack" / "lists"
    segments = len((lists / "utt_list.txt").read_text().split())
    split_counts = {s: len((lists / f"{s}.list").read_text().split())
                    for s in ("train_no_dev", "dev", "eval")}
    dumps = len(list(work.glob("dump/*/*/*/*.npy")))
    scalers = len(list((work / "scalers").glob("*.npy")))
    widths = {d.name: int(np.load(next(d.glob("*-feats.npy"))).shape[1])
              for d in sorted((work / "dump" / "dev" / "org").iterdir())}
    emit({"phase": "recipe_data", "native": built, "native_build_s": build_s,
          "corpus_s": corpus_s, "songs_audio_s": song_s,
          "segments_audio_s": seg_s, "sample_rate": fs,
          "stage_s": {str(k): v for k, v in stage_s.items()},
          "stage1_numpy_s": numpy_s,
          "stage1_s_per_audio_s": {"native": stage_s[1] / seg_s,
                                   "numpy": numpy_s / seg_s},
          "n_jobs": int(features["n_jobs"]),
          "segments": segments, "split_segments": split_counts,
          "dumps": dumps, "scaler_files": scalers, "dump_widths": widths,
          "native_vs_numpy": held, "log_tol": LOG_TOL, "bap_tol": BAP_TOL})
    assert built, "the native WORLD library did not build"
    assert all(r["max_ratio_to_bound"] <= 1.0 for r in held.values()), held
    assert widths["out_acoustic"] == sum(stream_sizes) == 67, widths
    assert scalers == 15 and all(n > 0 for n in split_counts.values())
    return work


class StepLosses:
    """Records each train step's ``Loss`` of the multitrack acoustic phase:
    while entered, ``train/multitrack_trainer`` builds its step through a
    wrapper of ``create_multitrack_acoustic_train_step`` whose train step
    appends its metrics' ``Loss`` to ``self.losses``."""

    def __init__(self):
        self.losses = []

    def __enter__(self):
        from ensemble_svs_with_interactions_tpu_torch.train import (
            multitrack_trainer as mt,
        )

        self.create = create = mt.create_multitrack_acoustic_train_step

        def wrapped(*args, **kwargs):
            train_step, eval_step = create(*args, **kwargs)

            def step(*a, **k):
                metrics = train_step(*a, **k)
                self.losses.append(float(metrics["Loss"]))
                return metrics
            return step, eval_step

        mt.create_multitrack_acoustic_train_step = wrapped
        return self

    def __exit__(self, *exc):
        from ensemble_svs_with_interactions_tpu_torch.train import (
            multitrack_trainer as mt,
        )

        mt.create_multitrack_acoustic_train_step = self.create


RECIPE_SEGMENTS = 2       # eval-song segments stage 7 and 11 read
RECIPE_EPOCHS = 1         # stages 3-5, of the recipe's 100
RECIPE_VOCODER_STEPS = 3  # stage 10: one epoch of 3 steps (600 x 1000)


def recipe_overrides(corpus, work, conf, labels) -> list:
    """``recipe_data_overrides`` and the cuts of stages 3-11: the timing
    phases' model configs from ``conf`` (the shipped ones with ``in_dim``
    TIMING_DIM), RECIPE_EPOCHS epochs a phase, stage 7's and 11's score
    labels from ``labels``, stage 10's epoch of RECIPE_VOCODER_STEPS
    steps; the device is the recipe's default, the card."""
    data = Path(work) / "data_multitrack"
    return recipe_data_overrides(corpus, work) + [
        f"timelag.model_config={conf / 'timelag.yaml'}",
        f"duration.model_config={conf / 'duration.yaml'}",
        *(f"{phase}.train.nepochs={RECIPE_EPOCHS}"
          for phase in ("timelag", "duration", "acoustic")),
        f"synthesis.label_dir={labels}",
        f"timing_eval.score_label_dir={labels}",
        f"timing_eval.align_label_dir={data / 'acoustic/label_phone_align'}",
        "vocoder.train.nepochs=1",
        f"vocoder.train.steps_per_epoch={RECIPE_VOCODER_STEPS}",
    ]


def recipe_timing_configs(conf: Path) -> Path:
    """The recipe's multitrack timing model configs with ``in_dim`` set to
    TIMING_DIM (the shipped 164 cannot take the 82 note features a track:
    ROADMAP Queue 3), written to ``conf``."""
    from ensemble_svs_with_interactions_tpu_torch.utils.config import (
        save_config,
    )

    conf.mkdir(parents=True, exist_ok=True)
    for phase in ("timelag", "duration"):
        cfg = shipped_config(f"{phase}/multitrack_{phase}_vp_mdn.yaml")
        cfg["netG"]["in_dim"] = TIMING_DIM
        save_config(cfg, conf / f"{phase}.yaml")
    return conf


def eval_segments(work, out: Path, n: int = RECIPE_SEGMENTS) -> Path:
    """The score labels of the eval song's first ``n`` segments, every
    singer's, copied to ``out`` from stage -1's corpus."""
    src = Path(work) / "data_multitrack" / "acoustic" / "label_phone_score"
    out.mkdir(parents=True, exist_ok=True)
    segs = sorted({p.stem.split("_", 1)[1] for p in
                   src.glob(f"*_{RECIPE_EVAL_SONG}_seg*.lab")},
                  key=lambda seg: int(seg.rsplit("seg", 1)[1]))[:n]
    for seg in segs:
        for f in src.glob(f"*_{seg}.lab"):
            shutil.copyfile(f, out / f.name)
    return out


def count_launches(lr, run) -> dict:
    """Run ``run()`` with every kernel's launch count set to 0 just before;
    the counts just after."""
    for name in TRAIN_COUNTERS:
        getattr(lr, name).launches = 0
    run()
    return {name: getattr(lr, name).launches for name in TRAIN_COUNTERS}


class RecipeObserver:
    """While entered, the multitrack trainer the runner calls takes a
    ``TrainerClock`` per phase (by its ``train.out_dir``) as its ``observe``
    hook, ``bin/synthesis_multitrack``'s ``svs_multitrack`` is timed call
    by call, and the acoustic phase's train steps' losses are kept
    (``StepLosses``)."""

    def __init__(self):
        self.clocks = {}
        self.pairs = []
        self.steps = StepLosses()

    def __enter__(self):
        from ensemble_svs_with_interactions_tpu_torch.bin import (
            synthesis_multitrack as sm,
        )
        from ensemble_svs_with_interactions_tpu_torch.train import (
            multitrack_trainer as mt,
        )

        self.train, self.svs = mt.train_multitrack_model, \
            sm.MultiTrackSPSVS.svs_multitrack
        train, svs = self.train, self.svs

        def observed(cfg, is_acoustic, device="cuda", observe=None):
            clock = self.clocks.setdefault(Path(cfg.train.out_dir).name,
                                           TrainerClock())
            return train(cfg, is_acoustic, device=device, observe=clock)

        def timed(engine, *args, **kw):
            t0 = time.perf_counter()
            out = svs(engine, *args, **kw)
            self.pairs.append((time.perf_counter() - t0, len(out[0]) /
                               out[1]))
            return out

        mt.train_multitrack_model = observed
        sm.MultiTrackSPSVS.svs_multitrack = timed
        self.steps.__enter__()
        return self

    def __exit__(self, *exc):
        from ensemble_svs_with_interactions_tpu_torch.bin import (
            synthesis_multitrack as sm,
        )
        from ensemble_svs_with_interactions_tpu_torch.train import (
            multitrack_trainer as mt,
        )

        self.steps.__exit__(*exc)
        mt.train_multitrack_model = self.train
        sm.MultiTrackSPSVS.svs_multitrack = self.svs


def phase_losses(work) -> dict:
    """Each trained phase's train and dev ``Loss`` by epoch
    (``metrics.jsonl``)."""
    out = {}
    for phase in ("timelag", "duration", "acoustic"):
        lines = [json.loads(line) for line in (
            Path(work) / "exp" / phase / "metrics.jsonl").read_text(
            ).splitlines()]
        out[phase] = {k: [r[f"{k}/Loss"] for r in lines if f"{k}/Loss" in r]
                      for k in ("train_no_dev", "dev")}
    return out


def recipe_pair_on_cpu(packed, labels) -> dict:
    """The first pair of stage 7's labels rendered as
    ``bin/synthesis_multitrack.py`` renders it, by an engine on the card
    and one on the CPU over the same pack: the durations each way, the
    streams' largest difference over each stream's scale, and the
    waveforms from the same noise by SNR (``held_waveform``'s way)."""
    from ensemble_svs_with_interactions_tpu_torch.bin import (
        synthesis_multitrack as sm,
    )
    from ensemble_svs_with_interactions_tpu_torch.gen import (
        FRAME_BUCKET,
        _round_up,
        predict_waveform,
        vocoder_noise,
    )
    from ensemble_svs_with_interactions_tpu_torch.io import hts

    by_segment = sm.group_by_segment(sorted(Path(labels).glob("*.lab")),
                                     list(CORPUS_SPKS))
    seg, (spk_m, path_m), (spk_s, path_s) = next(sm.ordered_pairs(
        by_segment))
    spks = [CORPUS_SPKS.index(spk_m), CORPUS_SPKS.index(spk_s)]
    out = {}
    for device in ("cuda", "cpu"):
        t0 = time.time()
        engine = sm.MultiTrackSPSVS(packed, verbose=0, device=device)
        main, sub = hts.load(path_m), hts.load(path_s)
        with torch.no_grad():
            dm = engine.predict_timing_multitrack([main, sub], spks)
            dm_sub = engine.predict_timing_multitrack([sub, main],
                                                      spks[::-1])
            acoustic = engine.predict_acoustic_multitrack([dm, dm_sub], spks)
        streams = engine.postprocess_acoustic(acoustic, dm)
        out[device] = (engine, [dm, dm_sub], streams, time.time() - t0)
    (engine, card_dm, card_streams, card_s), (_, cpu_dm, cpu_streams,
                                              cpu_s) = out["cuda"], out["cpu"]
    hop = int(engine.sample_rate * engine.frame_period / 1000)
    noise = vocoder_noise(1, _round_up(len(card_streams[1]), FRAME_BUCKET)
                          * hop, "cpu")
    kw = {"sample_rate": engine.sample_rate,
          "frame_period": engine.frame_period,
          "use_world_codec": engine.config.get("use_world_codec", True)}
    wav = [predict_waveform(streams, device=dev, noise=noise.to(dev), **kw)
           for dev, streams in (("cuda", card_streams),
                                ("cpu", cpu_streams))]
    same = all(list(a.start_times) == list(b.start_times)
               and list(a.end_times) == list(b.end_times)
               for a, b in zip(card_dm, cpu_dm))
    rel = {name: float(np.abs(np.asarray(a, np.float64) - b).max()
                       / max(np.abs(b).max(), 1e-12))
           for name, a, b in zip(("mgc", "lf0", "vuv", "bap"), card_streams,
                                 cpu_streams)}
    return {"pair": f"{spk_m}_{seg}_with_{spk_s}",
            "frames": len(card_streams[1]), "durations_equal": same,
            "stream_err_over_scale": rel, "snr_db": snr_db(wav[1], wav[0]),
            "card_s": card_s, "cpu_s": cpu_s}


def phase_recipe(lr, work) -> tuple:
    """The recipe end to end on the port (phase 11c), on the work directory
    ``phase_recipe_data`` built (stages -1 to 2): ``bin/run_recipe.main``
    on the shipped recipe with ``recipe_overrides`` for stages 3-6 (the
    shipped models at full width: the multitrack VP-MDN timing models,
    ``multitrack_acoustic_multistream_ar_f0.yaml``; RECIPE_EPOCHS epochs
    each), then 7 (the eval song's first RECIPE_SEGMENTS segments, every
    ordered pair), 10 (the shipped hn-uSFGAN, RECIPE_VOCODER_STEPS steps)
    and 11, each stage timed; the kernels' launches counted over stages
    3-5 and over stages 7 + 11, and held against their plain versions at
    the acoustic phase's batch shapes (``hold_trainer_kernels``); one pair
    of stage 7 rendered on the CPU too (``recipe_pair_on_cpu``); the
    stage-10 pack opened with ``vocoder_type="auto"``.  Returns the
    launches of both runs summed and the holds' worst errors."""
    from ensemble_svs_with_interactions_tpu_torch.svs import SPSVS
    from ensemble_svs_with_interactions_tpu_torch.utils.config import (
        load_config,
    )

    work = Path(work)
    conf = recipe_timing_configs(work / "conf")
    labels = eval_segments(work, work / "eval_segments")
    over = recipe_overrides(work.parent / "corpus", work, conf, labels)
    seconds = {}
    with RecipeObserver() as seen:
        train = count_launches(
            lr, lambda: seconds.update(run_recipe_stages(3, 6, over)))
        synth = count_launches(
            lr, lambda: seconds.update(run_recipe_stages(7, 7, over)))
        seconds.update(run_recipe_stages(10, 10, over))
        evals = count_launches(
            lr, lambda: seconds.update(run_recipe_stages(11, 11, over)))
    synth = {k: synth[k] + evals[k] for k in synth}
    acoustic = seen.clocks["acoustic"]
    netg = load_config(work / "packed_model" / "acoustic_model.yaml")[
        "netG"]
    t0 = time.time()
    held = hold_trainer_kernels(lr, netg, sorted(acoustic.shapes["train"]),
                                sorted(acoustic.shapes["dev"]))
    held["hold_s"] = time.time() - t0
    losses = phase_losses(work)
    render_s = sum(t for t, _ in seen.pairs)
    audio_s = sum(a for _, a in seen.pairs)
    quality = json.loads((work / "QUALITY.json").read_text())
    cuts = {"epochs": f"{RECIPE_EPOCHS} of 100 in stages 3-5",
            "vocoder": f"{RECIPE_VOCODER_STEPS} steps of 600 x 1000",
            "synthesis": f"the eval song's first {RECIPE_SEGMENTS} "
                         "segments (stage 7 and 11)",
            "timing in_dim": f"{TIMING_DIM}, not the shipped 164",
            "corpus": "3 singers x 3 synthetic songs of "
                      f"{RECIPE_SONG_S:g} s"}
    emit({"phase": "recipe", "device": "cuda", "cuts": cuts,
          "stage_s": {str(k): v for k, v in sorted(seconds.items())},
          "losses": losses,
          "acoustic_step_losses": seen.steps.losses,
          "train_shapes": {k: sorted(c.shapes["train"])
                           for k, c in seen.clocks.items()},
          "dev_shapes": {k: sorted(c.shapes["dev"])
                         for k, c in seen.clocks.items()},
          "launches_stages_3_5": train, "launches_stages_7_11": synth,
          "kernels_held": held, "pairs": len(seen.pairs),
          "pairs_render_s": render_s, "pairs_audio_s": audio_s,
          "pairs_rtf": render_s / audio_s if audio_s else None,
          "stage7_rtf": seconds.get(7, 0.0) / audio_s if audio_s else None,
          "quality": {phase: q["best"] for phase, q in quality.items()}})
    t0 = time.time()
    engine = SPSVS(work / "packed_model", verbose=0, device="cuda")
    auto = engine._validate_synthesis_args("auto", "gv")
    emit({"phase": "recipe_vocoder_pack", "load_s": time.time() - t0,
          "default_vocoder_type": engine.default_vocoder_type,
          "auto_resolves_to": auto})
    del engine
    ref = recipe_pair_on_cpu(work / "packed_model", labels)
    emit({"phase": "recipe_reference", **ref, "snr_bound_db": SNR_DB})
    for phase, r in losses.items():
        values = r["train_no_dev"] + r["dev"]
        assert len(r["dev"]) == RECIPE_EPOCHS and all(
            np.isfinite(values)), (phase, r)
    assert seen.steps.losses and all(np.isfinite(seen.steps.losses))
    assert all(n > 0 for n in train.values()), train
    assert synth["lstm_recurrence"] > 0, synth
    assert_trainer_kernels(held)
    n_wavs = len(list((work / "synthesis" / "wav").glob("*_with_*.wav")))
    assert len(seen.pairs) == n_wavs >= 2, (len(seen.pairs), n_wavs)
    assert all(np.isfinite(v) for q in quality.values()
               for v in q["best"].values()), quality
    assert auto == "usfgan", auto
    assert ref["durations_equal"] and ref["snr_db"] >= SNR_DB, ref
    launches = {k: train[k] + synth[k] for k in train}
    return launches, held["max_err"]


# ------------------------------------------------ the single-track recipe
SINGLE_UTTS_PER_SONG = 2  # score windows of each fixture song: 6 in all
SINGLE_SONG_S = 20.0      # each window's length
SINGLE_EPOCHS = 1         # stages 3-5, of the recipe's 100
PF_EPOCHS = 1             # each stage-9 run, of the recipe's 50
PF_CONFIGS = ("postfilter_mgc", "postfilter_bap")
PF_GAN_WARMUP, PF_GAN_STEPS = 2, 5
# the GAN step, card against CPU, on this many frames of the first batch
# (the CPU's float32 convolutions over a whole batch would take a minute)
PF_HOLD_FRAMES = 512
# ... in float32 with TF32 off, from the same weights, batch and noise:
# each loss within PF_GAN_RTOL of its value, each network's gradient
# within PF_GAN_RTOL of its norm (L2), before clipping; or, where the two
# float32 runs part by more, the card no farther from the same step in
# float64 on the CPU than PF_GAN_HEADROOM times the CPU's float32 run
# (a conv stack's gradient sums thousands of products per weight: the
# probe of this phase read 3.8e-5 and 6.9e-5 of the norms for G and D)
PF_GAN_RTOL = 1e-4
PF_GAN_HEADROOM = AR_HEADROOM


def label_window(labels, start_s: float, seconds: float):
    """The labels lying within [start_s, start_s + seconds), retimed to
    start at 0."""
    t0, t1 = start_s * 1e7, (start_s + seconds) * 1e7
    idx = [i for i, (a, b) in enumerate(zip(labels.start_times,
                                            labels.end_times))
           if a >= t0 and b <= t1]
    w = labels[idx[0]: idx[-1] + 1]
    shift = w.start_times[0]
    w.start_times = [t - shift for t in w.start_times]
    w.end_times = [t - shift for t in w.end_times]
    return w


def write_single_corpus(root, sr: int = RECIPE_SR,
                        seconds: float = SINGLE_SONG_S, seed: int = SEED):
    """A single-singer corpus, ``<root>/lab/<utt>.lab``, ``<root>/wav/
    <utt>.wav`` and ``<root>/utt_list.txt``: the first and the last
    ``seconds`` of each fixture song's score (six utterances), sung by
    ``synth_wav``, and the first (the recipe's eval utterance) in
    ``<root>/eval_lab``.  Returns (the utterance ids, their audio
    seconds)."""
    from scipy.io import wavfile

    from ensemble_svs_with_interactions_tpu_torch.io import hts
    from ensemble_svs_with_interactions_tpu_torch.utils import (
        packaged_question_path,
    )

    root = Path(root)
    (root / "lab").mkdir(parents=True, exist_ok=True)
    (root / "wav").mkdir(exist_ok=True)
    binary_dict, numeric_dict = hts.load_question_set(
        packaged_question_path())
    rng = np.random.default_rng(seed)
    utts, audio_s = [], 0.0
    for fi, path in enumerate(JACAPPELLA_LABS):
        labels = hts.load(path)
        end_s = labels.end_times[-1] / 1e7
        for k, start in enumerate((0.0, max(end_s - seconds, 0.0))):
            utt = f"song{fi}_{k}"
            w = label_window(labels, start, seconds)
            w.save(root / "lab" / f"{utt}.lab")
            wav = synth_wav(w, binary_dict, numeric_dict, rng, sr,
                            tail_seconds=0.3)
            wavfile.write(root / "wav" / f"{utt}.wav", sr, wav)
            audio_s += len(wav) / sr
            utts.append(utt)
    (root / "utt_list.txt").write_text("\n".join(utts) + "\n")
    (root / "eval_lab").mkdir(exist_ok=True)
    shutil.copyfile(root / "lab" / f"{utts[0]}.lab",
                    root / "eval_lab" / f"{utts[0]}.lab")
    return utts, audio_s


def single_recipe(corpus, work) -> dict:
    """A single-track recipe over ``corpus``: the shipped models verbatim
    (``timelag_mdn.yaml``, ``duration_mdn.yaml``,
    ``acoustic_resf0convlstm.yaml`` with its lf0 statistics from the
    scalers, ``postfilter_mgc.yaml``), the packaged recipe's acoustic
    features and its phases' train and data sections (``spk_names``
    dropped: one singer; the acoustic phase's ``pitch_reg_weight`` 1, as
    the JAX package's single-track e2e recipe sets it), one dev and one
    eval utterance (stage 7 renders the eval one, ``eval_lab``), on the
    card; cut: SINGLE_EPOCHS epochs a phase and PF_EPOCHS a
    postfilter."""
    from ensemble_svs_with_interactions_tpu_torch.utils import (
        packaged_question_path,
        yaml_io,
    )

    packaged = yaml_io.load(RECIPE.read_text())
    corpus, work = Path(corpus), Path(work)
    models = {"timelag": "timelag/timelag_mdn.yaml",
              "duration": "duration/duration_mdn.yaml",
              "acoustic": "acoustic/acoustic_resf0convlstm.yaml"}
    recipe = {
        "seed": 1234, "verbose": 1, "work_dir": str(work),
        "question_path": str(packaged_question_path()),
        "data": {"utt_list": str(corpus / "utt_list.txt"), "n_dev": 1,
                 "n_eval": 1},
        "features": {
            "n_jobs": packaged["features"]["n_jobs"],
            "timelag": {"label_phone_score_dir": str(corpus / "lab"),
                        "label_phone_align_dir": str(corpus / "lab")},
            "duration": {"label_dir": str(corpus / "lab")},
            "acoustic": {"wav_dir": str(corpus / "wav"),
                         "label_dir": str(corpus / "lab"),
                         "params": packaged["features"]["acoustic"][
                             "params"]}},
        "synthesis": {"label_dir": str(corpus / "eval_lab")},
        "postfilter": {
            "model_config": str(CONFIGS / "postfilter/postfilter_mgc.yaml"),
            "train": {**packaged["postfilter"]["train"],
                      "nepochs": PF_EPOCHS}},
    }
    for phase, rel in models.items():
        section = packaged[phase]
        train = {**section["train"], "nepochs": SINGLE_EPOCHS}
        if phase == "acoustic":
            train["pitch_reg_weight"] = 1.0
        data = {k: v for k, v in section["data"].items()
                if k != "spk_names"}
        recipe[phase] = {"model_config": str(CONFIGS / rel), "train": train,
                         "data": data}
    return recipe


class SingleTrainerClocks:
    """While entered, the single-track trainer the runner calls takes a
    ``TrainerClock`` per phase (by its ``train.out_dir``)."""

    def __init__(self):
        self.clocks = {}

    def __enter__(self):
        from ensemble_svs_with_interactions_tpu_torch.train import trainer

        self.train = train = trainer.train_model

        def observed(cfg, is_acoustic=False, device="cuda", observe=None):
            clock = self.clocks.setdefault(Path(cfg.train.out_dir).name,
                                           TrainerClock())
            return train(cfg, is_acoustic, device=device, observe=clock)

        trainer.train_model = observed
        return self

    def __exit__(self, *exc):
        from ensemble_svs_with_interactions_tpu_torch.train import trainer

        trainer.train_model = self.train


def gan_conv_flops(netG, netD, B: int, T: int, D: int, D_adv: int) -> int:
    """Operations of one GAN step's convolutions (and G's frame-wise noise
    projection): G's forward, its input and weight gradients (3 x its
    forward); D's forward on the fake and the real input, the fake's input
    gradient for G's loss and both weight gradients for D's (5 x one
    forward); 2 x Cout x Cin x kh x kw an output pixel."""
    from torch import nn

    g = 0
    for pf in (netG.mgc_postfilter, netG.bap_postfilter,
               netG.lf0_postfilter):
        if pf is None:
            continue
        for m in pf.modules():
            if isinstance(m, nn.Conv2d):
                g += 2 * m.weight.numel() * B * T * pf.in_dim
            elif isinstance(m, nn.Linear):
                g += 2 * m.weight.numel() * B * T
    d = 0
    with torch.no_grad():
        maps = netD.to("meta")(torch.empty(B, T, D_adv, device="meta"))
    convs = [netD.Conv_0, netD.Conv_1, netD.Conv_2, netD.Conv_3,
             netD.Conv_4]
    for conv, fmap in zip(convs, maps):
        d += 2 * conv.weight.numel() * fmap.shape[1] * fmap.shape[2] * B
    return 3 * g + 5 * d


def pf_batch(work, device, frames=None, dtype=torch.float32) -> dict:
    """The first batch of stage 8's training pairs as stage 9's trainer
    builds it (``batch_max_frames`` 8000), optionally its first
    ``frames`` frames, on ``device``, the features in ``dtype``."""
    from ensemble_svs_with_interactions_tpu_torch.data.dataset import (
        BucketedBatchIterator,
        FeatsDataset,
    )

    d = Path(work) / "postfilter" / "train_no_dev"
    batch = next(iter(BucketedBatchIterator(
        FeatsDataset(d / "in_postfilter", d / "out_postfilter"),
        max_tokens=8000, time_multiple=32, shuffle=False)))
    if frames is not None:
        batch = {"in_feats": batch["in_feats"][:, :frames],
                 "out_feats": batch["out_feats"][:, :frames],
                 "lengths": np.minimum(batch["lengths"], frames)}
    out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
           for k, v in batch.items()}
    for k in ("in_feats", "out_feats"):
        out[k] = out[k].to(dtype)
    return out


def pf_gan_run(train_cfg, work, device, frames=None, steps=1,
               dtype=torch.float32) -> tuple:
    """Stage 9's GAN step (``train/postfilter_trainer.gan_step`` on the
    flax schemes' weights, G at seed 0 and D at seed 2, as the trainer
    draws them) over ``steps`` steps of one batch (``pf_batch``) on
    ``device`` in ``dtype``, G's noise from a CPU generator seeded SEED:
    (the last step's metrics, each step's (G, D) gradients before
    clipping as flat float64 host vectors, the step function, G, D, the
    batch)."""
    from ensemble_svs_with_interactions_tpu_torch.train import (
        gan,
        postfilter_trainer as pt,
    )
    from ensemble_svs_with_interactions_tpu_torch.utils.config import (
        instantiate,
    )
    from ensemble_svs_with_interactions_tpu_torch.utils.flax_init import (
        init_module,
    )

    netG = init_module(pt.build_postfilter(train_cfg), seed=0).to(dtype)
    netD = init_module(instantiate(train_cfg.model.netD), seed=2).to(dtype)
    step = pt.gan_step(train_cfg, netG, netD, device)
    batch = pf_batch(work, device, frames, dtype)
    grads, clip = [], gan._clip

    def kept(g, clip_norm):
        grads.append(torch.cat([x.reshape(-1) for x in g]).double().cpu())
        return clip(g, clip_norm)

    gan._clip = kept
    try:
        for _ in range(steps):
            metrics = step(batch, torch.Generator().manual_seed(SEED))
    finally:
        gan._clip = clip
    return ({k: float(v) for k, v in metrics.items()},
            list(zip(grads[::2], grads[1::2])), step, netG, netD, batch)


def hold_pf_gan(train_cfg, work, frames: int = PF_HOLD_FRAMES) -> dict:
    """One full-width GAN step of ``train_cfg``'s pair on the card against
    the same step on the CPU, on ``frames`` frames of the first batch,
    both float32, and the CPU's in float64 as the oracle: each loss
    relative to its value, each network's gradient (L2) relative to its
    norm; each holds within PF_GAN_RTOL, or where the card is no farther
    from the oracle than PF_GAN_HEADROOM times the CPU's float32 run."""
    runs = {(dev, dt): pf_gan_run(train_cfg, work, dev, frames,
                                  dtype=dt)[:2]
            for dev, dt in (("cuda", torch.float32), ("cpu", torch.float32),
                            ("cpu", torch.float64))}
    card, cpu, f64 = (runs[k] for k in (
        ("cuda", torch.float32), ("cpu", torch.float32),
        ("cpu", torch.float64)))

    def judge(got, want, oracle, dist):
        rel = dist(got, want)
        to_oracle, ref_to_oracle = dist(got, oracle), dist(want, oracle)
        return {"rel": rel, "card_to_f64": to_oracle,
                "cpu_to_f64": ref_to_oracle,
                "ok": bool(rel < PF_GAN_RTOL or to_oracle
                           <= PF_GAN_HEADROOM * ref_to_oracle)}

    def scalar(a, b):
        return abs(a - b) / max(abs(b), 1e-12)

    def l2(a, b):
        return float((a - b).norm() / b.norm())

    losses = {k: judge(card[0][k], cpu[0][k], f64[0][k], scalar)
              for k in cpu[0] if k.startswith("Loss")}
    grads = {net: judge(card[1][0][i], cpu[1][0][i], f64[1][0][i], l2)
             for i, net in enumerate(("G", "D"))}
    return {"frames": frames, "losses": losses, "grads": grads,
            "rtol": PF_GAN_RTOL, "headroom": PF_GAN_HEADROOM,
            "ok": all(r["ok"] for r in (*losses.values(),
                                        *grads.values()))}


def time_pf_gan(train_cfg, work) -> dict:
    """The GAN step on the card at the first real batch: PF_GAN_WARMUP
    warm-up steps, then PF_GAN_STEPS steps each timed by CUDA events, the
    median beside the float32 bound of its convolutions
    (``gan_conv_flops`` over PEAK_FP32_FLOP_PER_S; the batch and the
    weights, their gradients and Adam moments over the memory rate), and
    the peak memory."""
    torch.cuda.reset_peak_memory_stats()
    _, _, step, netG, netD, batch = pf_gan_run(train_cfg, work, "cuda",
                                               steps=PF_GAN_WARMUP)
    gen = torch.Generator().manual_seed(SEED)
    times = []
    for _ in range(PF_GAN_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step(batch, gen)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    B, T, D = batch["in_feats"].shape
    flops = gan_conv_flops(copy.deepcopy(netG), copy.deepcopy(netD), B, T,
                           D, D)
    n_params = sum(p.numel() for m in (netG, netD) for p in m.parameters())
    t_bytes = 1e3 * 4 * (2 * B * T * D + 6 * n_params) / PEAK_BYTES_PER_S
    t_ops = 1e3 * flops / PEAK_FP32_FLOP_PER_S
    bound_ms, bound_by = bound(t_bytes, t_ops)
    return {"B": B, "T": T, "D": D, "steps_ms": times,
            "median_ms": float(np.median(times)), "conv_gflop": flops / 1e9,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes_ms": t_bytes, "operations_ms": t_ops,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def single_svs_on_cpu(packed, label_path, post_filter_type="nnsvs") -> dict:
    """``svs(post_filter_type=...)``'s stages on one utterance by an
    engine on the card and one on the CPU over the same pack: the
    durations, the postprocessed streams' largest difference over each
    stream's scale, and the waveforms from the same noise by SNR; then one
    whole ``svs()`` on the card, timed."""
    from ensemble_svs_with_interactions_tpu_torch.gen import (
        FRAME_BUCKET,
        _round_up,
        predict_waveform,
        vocoder_noise,
    )
    from ensemble_svs_with_interactions_tpu_torch.io import hts
    from ensemble_svs_with_interactions_tpu_torch.svs import SPSVS

    out = {}
    for device in ("cuda", "cpu"):
        t0 = time.time()
        engine = SPSVS(packed, verbose=0, device=device)
        with torch.no_grad():
            dm = engine.predict_timing(hts.load(label_path))
            acoustic = engine.predict_acoustic(dm)
        streams = engine.postprocess_acoustic(
            acoustic, dm, post_filter_type=post_filter_type)
        out[device] = (engine, dm, streams, time.time() - t0)
    (engine, dm, streams, card_s), (_, cpu_dm, cpu_streams, cpu_s) = \
        out["cuda"], out["cpu"]
    hop = int(engine.sample_rate * engine.frame_period / 1000)
    noise = vocoder_noise(1, _round_up(len(streams[1]), FRAME_BUCKET) * hop,
                          "cpu")
    kw = {"sample_rate": engine.sample_rate,
          "frame_period": engine.frame_period,
          "use_world_codec": engine.config.get("use_world_codec", True)}
    wav = [predict_waveform(s, device=dev, noise=noise.to(dev), **kw)
           for dev, s in (("cuda", streams), ("cpu", cpu_streams))]
    rel = {name: float(np.abs(np.asarray(a, np.float64) - b).max()
                       / max(np.abs(b).max(), 1e-12))
           for name, a, b in zip(("mgc", "lf0", "vuv", "bap"), streams,
                                 cpu_streams)}
    t0 = time.time()
    audio, sr = engine.svs(hts.load(label_path),
                           post_filter_type=post_filter_type)
    svs_s = time.time() - t0
    return {"utterance": Path(label_path).stem, "frames": len(streams[1]),
            "durations_equal": list(dm.start_times) == list(
                cpu_dm.start_times) and list(dm.end_times) == list(
                cpu_dm.end_times),
            "stream_err_over_scale": rel, "stream_rtol": POST_ATOL,
            "snr_db": snr_db(wav[1], wav[0]), "card_s": card_s,
            "cpu_s": cpu_s, "svs_s": svs_s,
            "svs_rtf": svs_s / (len(audio) / sr),
            "svs_finite_nonzero": bool(np.abs(audio).max() > 0)}


def phase_recipe_single(lr, root) -> dict:
    """The single-track recipe with its learned postfilter (phase 11d):
    ``write_single_corpus`` at 48 kHz, ``single_recipe`` through
    ``bin/run_recipe.main`` on the card: stages 0-2 on the host, 3-6
    (``MDNv2`` timing, ``ResSkipF0FFConvLSTM`` acoustic, the pack), 7, 8
    (the postfilter pairs), then stage 9 once with each of the shipped
    ``postfilter_mgc.yaml`` and ``postfilter_bap.yaml`` into its own
    ``train.out_dir``, and ``bin/merge_postfilters.py`` on the two
    checkpoints into the pack; each stage timed; the kernels' launches
    counted over stages 3-5, over 7, over 8 and over 9, and each kernel
    timed and held against its plain version at the shapes the stages
    gave it; the mgc pair's GAN step timed at full width and held card
    against CPU; ``svs(post_filter_type="nnsvs")`` of the eval utterance
    held card against CPU.  Returns the launches summed and the kernel
    rows by shape."""
    from ensemble_svs_with_interactions_tpu_torch.bin import (
        merge_postfilters,
        run_recipe,
    )
    from ensemble_svs_with_interactions_tpu_torch.gen import FRAME_BUCKET
    from ensemble_svs_with_interactions_tpu_torch.utils.config import (
        load_config,
        save_config,
    )

    root = Path(root)
    t0 = time.time()
    utts, audio_s = write_single_corpus(root / "corpus")
    corpus_s = time.time() - t0
    work = root / "work"
    recipe = root / "recipe.yaml"
    save_config(single_recipe(root / "corpus", work), recipe)
    seconds = {}

    def stages(first, last, overrides=(), key=None):
        got = run_recipe_stages(first, last, list(overrides), recipe=recipe)
        seconds.update({key or k: v for k, v in got.items()})

    stages(0, 2)
    launches = {}
    with SingleTrainerClocks() as seen:
        launches["stages_3_5"] = count_launches(lr, lambda: stages(3, 6))
    launches["stage_7"] = count_launches(lr, lambda: stages(7, 7))
    launches["stage_8"] = count_launches(lr, lambda: stages(8, 8))
    ckpts = {}
    for name in PF_CONFIGS:
        out = work / "exp" / name
        over = [f"postfilter.model_config={CONFIGS / 'postfilter' / name}"
                ".yaml", f"postfilter.train.out_dir={out}"]
        launches[f"stage_9 {name}"] = count_launches(
            lr, lambda: stages(9, 9, over, key=f"9 {name}"))
        ckpts[name] = out / "best_loss.ckpt"
    t0 = time.time()
    assert merge_postfilters.main([
        str(work / "packed_model"),
        "--mgc-config", str(CONFIGS / "postfilter/postfilter_mgc.yaml"),
        "--mgc-ckpt", str(ckpts["postfilter_mgc"]),
        "--bap-config", str(CONFIGS / "postfilter/postfilter_bap.yaml"),
        "--bap-ckpt", str(ckpts["postfilter_bap"]),
        "--stream-sizes", "60,1,1,5"]) == 0
    seconds["merge"] = time.time() - t0

    netg = load_config(work / "packed_model" / "acoustic_model.yaml")["netG"]
    H = int(netg["lstm_hidden_dim"])
    per_forward = int(netg["num_lstm_layers"]) * (
        2 if netg.get("bidirectional", True) else 1)
    frames = [len(np.load(f, mmap_mode="r")) for f in sorted(
        (work / "dump").glob("*/norm/in_acoustic/*-feats.npy"))]
    T_pad = -(-max(frames) // FRAME_BUCKET) * FRAME_BUCKET
    clock = seen.clocks["acoustic"]
    rows = {"svs B=1": phase_kernels(
        lr, B=1, modes=(False,), phase="recipe_single_kernel", shapes=[H],
        T=T_pad)[(H, False)]}
    for B, T in sorted(clock.shapes["dev"]):
        rows[f"dev B={B} T={T}"] = phase_kernels(
            lr, B=B, modes=(False,), phase="recipe_single_kernel",
            shapes=[H], T=T)[(H, False)]
    for B, T in sorted(clock.shapes["train"]):
        for k, row in phase_train_kernels(
                lr, B=B, shapes={(H, T): per_forward},
                phase="recipe_single_train_kernel").items():
            rows[f"train {k[0]}{'_c' if k[3] else ''} B={B} T={T}"] = row

    train_cfg = run_recipe.postfilter_train_config(
        run_recipe._materialize_packaged_configs(load_config(recipe),
                                                 root),
        work)
    t0 = time.time()
    gan_held = hold_pf_gan(train_cfg, work)
    gan_time = time_pf_gan(train_cfg, work)
    gan_s = time.time() - t0
    ref = single_svs_on_cpu(work / "packed_model",
                            root / "corpus" / "lab" / f"{utts[0]}.lab")
    losses = {}
    for name in ("timelag", "duration", "acoustic", *PF_CONFIGS):
        lines = [json.loads(ln) for ln in (work / "exp" / name /
                 "metrics.jsonl").read_text().splitlines()]
        losses[name] = lines
    merged = load_config(work / "packed_model" / "postfilter_model.yaml")
    cuts = {"epochs": f"{SINGLE_EPOCHS} of 100 in stages 3-5",
            "postfilter": f"{PF_EPOCHS} of 50 epochs a stage-9 run",
            "corpus": f"{len(utts)} synthetic utterances of "
                      f"{SINGLE_SONG_S:g} s (1 dev, 1 eval), one singer",
            "gan_hold": f"the card-vs-CPU GAN step on {PF_HOLD_FRAMES} "
                        "frames of the first batch"}
    emit({"phase": "recipe_single", "device": "cuda", "cuts": cuts,
          "corpus_s": corpus_s, "audio_s": audio_s,
          "stage_s": {str(k): v for k, v in seconds.items()},
          "launches": launches, "lstm_hidden": H,
          "launches_per_forward": per_forward,
          "train_shapes": sorted(clock.shapes["train"]),
          "dev_shapes": sorted(clock.shapes["dev"]),
          "stage8_frames": frames, "stage8_T": T_pad,
          "kernel_rows": {k: {f: r[f] for f in (
              "kernel", "B", "T", "H", "max_abs_err", "ms", "plain_ms",
              "bound_ms", "bound_by", "library_ms") if f in r}
              for k, r in rows.items()},
          "losses": losses,
          "merged_postfilter": {
              k: v.get("_target_") if isinstance(v, dict) else v
              for k, v in merged["netG"].items()},
          "gan_hold": gan_held, "gan_step": gan_time, "gan_s": gan_s,
          "svs_reference": ref, "snr_bound_db": SNR_DB})
    for name, lines in losses.items():
        vals = [v for ln in lines for k, v in ln.items()
                if k.endswith("Loss") or k.endswith("Loss_Recon")]
        assert vals and all(np.isfinite(vals)), (name, lines)
    assert all(n > 0 for n in launches["stages_3_5"].values()), launches
    for k in ("stage_7", "stage_8"):
        assert launches[k]["lstm_recurrence"] > 0, launches
    assert all(r["max_abs_err"] < KERNEL_ATOL for k, r in rows.items()
               if "dwh" not in k), rows
    assert gan_held["ok"], gan_held
    assert ref["durations_equal"] and ref["snr_db"] >= SNR_DB, ref
    assert max(ref["stream_err_over_scale"].values()) <= POST_ATOL, ref
    assert ref["svs_finite_nonzero"], ref
    assert merged["netG"]["mgc_postfilter"] and \
        merged["netG"]["bap_postfilter"], merged
    total = {k: sum(v[k] for v in launches.values())
             for k in TRAIN_COUNTERS}
    return total, rows


# the NPSS voices (phase 11e): the shipped configs the recipe's acoustic
# phase takes in their turn, on recipe_single's corpus, dump, scalers and
# timing models
NPSS_CONFIGS = {"npss_ar": "acoustic/acoustic_npss_ar_mgcf0bap.yaml",
                "npss_mdn": "acoustic/acoustic_npss_mdn.yaml"}
# the AR cascade's LSTM layers a train step (forward, BPTT and dW_h each)
# or a teacher-forced dev batch runs (the forward), by (H, layers): the
# 6 + 6 encoder directions of the mgc and bap decoders, the lf0 decoder's
# one cell and the bap decoder's two at H = 256; the lf0 and vuv
# encoders' 4 + 4 at H = 64; the mgc decoder's two cells at H = 1024
NPSS_LAYERS = {256: 15, 64: 8, 1024: 2}
NPSS_STEP_LAUNCHES = sum(NPSS_LAYERS.values())  # 25
# a free-running svs() call: the encoders' 12 + 8 on the kernel; the three
# AR decoders step by step in PyTorch
NPSS_SVS_LAUNCHES = 20
NPSS_H = 1024                       # the mgc decoder's cells
NPSS_R = 2                          # its reduction factor
NPSS_FULL_B, NPSS_FULL_FRAMES = 64, 256  # the recipe's batch: 64 crops
# a batch past what the earlier H > 512 forward kernel took (128 rows at
# H = 1024), held against the plain loop in both modes
NPSS_WIDE_B, NPSS_WIDE_T = 200, 33
# a batch the earlier H > 512 BPTT loop refused (its dc carry of every row
# outgrew shared memory past 3040 rows at H = 1024), held against the
# plain loop
NPSS_BPTT_WIDE_B, NPSS_BPTT_WIDE_T = 3072, 2
# the card-vs-CPU train step: NPSS_REF_B utterances of NPSS_REF_T frames,
# dropout off (card and CPU draw masks from other generators)
NPSS_REF_B, NPSS_REF_T = 2, 64


# the AR decoder options' voices (phase 11h): acoustic_npss_ar_mgcf0bap.yaml
# with ar_option_netg's overrides, trained, packed and served like
# NPSS_CONFIGS on the same corpus, dump, scalers and timing models
AR_OPTION_VOICES = ("npss_ar_tacotron", "npss_mdn_ar")
AR_DECODERS = ("lf0_model", "mgc_model", "bap_model")
AR_GAUSSIANS = 4
AR_ZONEOUT = 0.1     # the decoder classes' default
AR_PRENET_LAYERS = 2  # the decoder classes' default


def ar_option_netg(net: dict, name: str) -> dict:
    """A copy of ``net`` (the netG of ``acoustic_npss_ar_mgcf0bap.yaml``,
    or a config of its shape) as the voice ``name``: ``npss_ar_tacotron``
    gives every AR decoder (lf0, mgc, bap) AR_PRENET_LAYERS pre-net
    layers (each keeps its ``prenet_hidden_dim``) and zoneout AR_ZONEOUT;
    ``npss_mdn_ar`` makes it the MDN cascade: the lf0 decoder's MDN head,
    mgc and bap ``BiLSTMMDNNonAttentiveDecoder``s without Post-Nets,
    AR_GAUSSIANS components each, the pre-nets on and zoneout 0."""
    if name not in AR_OPTION_VOICES:
        raise ValueError(f"unknown voice {name}")
    net = json.loads(json.dumps(net))
    mdn = name == "npss_mdn_ar"
    for k in AR_DECODERS:
        net[k].update(prenet_layers=AR_PRENET_LAYERS,
                      zoneout=0.0 if mdn else AR_ZONEOUT)
    if mdn:
        acoustic = f"{PKG}.models.acoustic"
        net["_target_"] = f"{acoustic}.NPSSMDNMultistreamParametricModel"
        net["lf0_model"].update(use_mdn=True, num_gaussians=AR_GAUSSIANS)
        for k in ("mgc_model", "bap_model"):
            net[k].update(_target_=f"{acoustic}.BiLSTMMDNNonAttentiveDecoder",
                          num_gaussians=AR_GAUSSIANS, postnet_layers=0)
    return net


def npss_recipe(root, name, model_config=None):
    """(work directory, recipe path) of ``single_recipe`` with the
    acoustic phase's model ``model_config`` (by default the shipped
    ``NPSS_CONFIGS[name]``), its own
    ``exp`` and ``packed_model`` under ``<root>/<name>``, and the dump,
    the scalers (links) and the timing models' checkpoints (copies) of
    phase ``recipe_single``'s ``<root>/work``, so stages 0-4 need not run
    again and that phase's pack stays as it was."""
    from ensemble_svs_with_interactions_tpu_torch.utils.config import (
        save_config,
    )

    root = Path(root)
    single, work = root / "work", root / name
    (work / "exp").mkdir(parents=True)
    for d in ("dump", "scalers"):
        (work / d).symlink_to(single / d, target_is_directory=True)
    for phase in ("timelag", "duration"):
        shutil.copytree(single / "exp" / phase, work / "exp" / phase)
    recipe = single_recipe(root / "corpus", work)
    recipe["acoustic"]["model_config"] = str(
        model_config or CONFIGS / NPSS_CONFIGS[name])
    path = root / f"{name}.yaml"
    save_config(recipe, path)
    return work, path


def npss_batch(B: int, T: int, seed: int = SEED) -> dict:
    """A single-track acoustic batch (86 inputs, 67 outputs with a 0/1
    vuv column at 61), B utterances of T frames, the last shorter; the
    pitch regularization's weights."""
    rng = np.random.default_rng(seed)
    out = rng.normal(size=(B, T, 67)).astype(np.float32)
    out[..., 61] = rng.uniform(size=(B, T)) > 0.3
    return {"in_feats": rng.uniform(0, 1, (B, T, 86)).astype(np.float32),
            "out_feats": out,
            "lengths": np.array([T] * (B - 1) + [T - T // 4], np.int64),
            "pitch_reg_dyn_ws": rng.uniform(0, 1, (B, T, 1)).astype(
                np.float32)}


def npss_step(net, ss, variables, batch, device, dtype=torch.float32,
              use_amp=False):
    """One ``train/loop.create_train_step`` step of the single-track
    model ``net`` from flax ``variables`` (SGD at rate 0, clipping at 1 as
    the recipe's, the pitch regularization at 1): (metrics, {name:
    clipped gradient}, {name: buffer}), the tensors on the CPU in
    float64.  The random masks come from a CPU generator seeded SEED, so
    that the card and the CPU draw the same."""
    from ensemble_svs_with_interactions_tpu_torch.train import loop
    from ensemble_svs_with_interactions_tpu_torch.utils.config import (
        instantiate,
    )
    from ensemble_svs_with_interactions_tpu_torch.utils.flax_port import (
        flax_to_torch,
    )

    module = flax_to_torch(instantiate(net), variables).to(dtype)
    opt, sched = loop.build_optimizer(module.parameters(),
                                      {"name": "SGD", "params": {"lr": 0.0}})
    step, _ = loop.create_train_step(module, opt, {"stream_sizes": ss},
                                     scheduler=sched, pitch_reg_weight=1.0,
                                     use_amp=use_amp, device=device)
    metrics = step(batch, torch.Generator().manual_seed(SEED))
    return (metrics,
            {n: p.grad.detach().cpu().double()
             for n, p in module.named_parameters()},
            {n: b.detach().cpu().double() for n, b in module.named_buffers()})


def npss_net(name, work, masks: bool = False) -> dict:
    """The netG of the voice in ``work`` as stage 6 packed it (its lf0
    statistics from the scalers), every dropout at 0 unless ``masks``."""
    from ensemble_svs_with_interactions_tpu_torch.utils.config import (
        load_config,
    )

    net = json.loads(json.dumps(dict(load_config(
        Path(work) / "packed_model" / "acoustic_model.yaml")["netG"])))
    for k in ("lf0_model", "mgc_model", "bap_model", "vuv_model"):
        for key in ("dropout", "prenet_dropout"):
            if key in net[k] and not masks:
                net[k][key] = 0.0
    return net


def hold_npss_step(name, work, masks: bool = False) -> dict:
    """One full-width train step of the voice, NPSS_REF_B x NPSS_REF_T,
    dropout off (with ``masks`` every dropout, pre-net and zoneout mask
    on, drawn from one CPU generator seeded SEED on both sides), on
    the card against the same step on the CPU, each
    clipped gradient by ``judge_amp``: in float32 with the CPU's float64
    step as the oracle, in the AMP arm with the CPU's float32 step; the
    losses within TRAIN_LOSS_RTOL and AMP_LOSS_RTOL.  cuDNN's float32
    convolutions round about 10x more than the CPU's (phase
    ``recipe_single``'s GAN step), and the encoders' training-mode batch
    norms cancel most of the gradient in front of them, so float32 card
    and CPU part there by more than rounding elsewhere; the same float32
    step with cuDNN off (the port's kernels, cuBLAS and PyTorch's own
    convolutions) must pass the strict ``judge_f32``."""
    from ensemble_svs_with_interactions_tpu_torch.utils.config import (
        instantiate,
    )
    from ensemble_svs_with_interactions_tpu_torch.utils.flax_init import (
        init_variables,
    )

    t0 = time.time()
    net = npss_net(name, work, masks)
    ss = [60, 1, 1, 5]
    variables = init_variables(instantiate(net), seed=SEED)
    batch = npss_batch(NPSS_REF_B, NPSS_REF_T)

    def step(dev, dtype=torch.float32, amp=False):
        return npss_step(net, ss, variables, batch, dev, dtype, amp)

    m_gpu, g_gpu, _ = step("cuda")
    with torch.backends.cudnn.flags(enabled=False):
        m_raw, g_raw, _ = step("cuda")
    m_cpu, g_cpu, _ = step("cpu")
    g_64 = step("cpu", torch.float64)[1]
    a_gpu, ga_gpu, _ = step("cuda", amp=True)
    a_cpu, ga_cpu, _ = step("cpu", amp=True)
    judged = {"f32": judge_amp(g_gpu, g_cpu, g_64, AMP_GRAD_RTOL,
                               AMP_COS_MIN, AMP_L2_MAX),
              "amp": judge_amp(ga_gpu, ga_cpu, g_cpu, AMP_GRAD_RTOL,
                               AMP_COS_MIN, AMP_L2_MAX)}
    strict = judge_f32(g_raw, g_cpu, g_64)
    strict_cudnn = judge_f32(g_gpu, g_cpu, g_64)
    rel = lambda a, b: abs(a["Loss"] - b["Loss"]) / abs(b["Loss"])  # noqa
    worst = max(strict, key=lambda n: strict[n]["rel_of_scale"])
    out = {"B": NPSS_REF_B, "T": NPSS_REF_T, "params": len(strict),
           "masks": "one CPU generator" if masks else "dropout off",
           "loss": [m_gpu["Loss"], m_cpu["Loss"]],
           "loss_rel_err": rel(m_gpu, m_cpu),
           "f32": amp_summary(judged["f32"]),
           "f32_cudnn_off": {
               "loss_rel_err": rel(m_raw, m_cpu),
               "max_grad_rel_err": strict[worst]["rel_of_scale"],
               "worst_grad": worst,
               "failed": {n: v for n, v in strict.items() if not v["ok"]}},
           "f32_strict_with_cudnn_failed": sorted(
               n for n, v in strict_cudnn.items() if not v["ok"]),
           "amp_loss": [a_gpu["Loss"], a_cpu["Loss"]],
           "amp_loss_rel_err": rel(a_gpu, a_cpu),
           "amp": amp_summary(judged["amp"]),
           "seconds": time.time() - t0}
    out["ok"] = bool(
        np.isfinite(m_gpu["Loss"]) and out["loss_rel_err"] < TRAIN_LOSS_RTOL
        and out["f32_cudnn_off"]["loss_rel_err"] < TRAIN_LOSS_RTOL
        and not out["f32_cudnn_off"]["failed"]
        and np.isfinite(a_gpu["Loss"])
        and out["amp_loss_rel_err"] < AMP_LOSS_RTOL
        and all(v["ok"] for j in judged.values() for v in j.values()))
    return out


def npss_voice(lr, root, name) -> dict:
    """Stages 5-7 of ``npss_recipe(root, name)`` through
    ``bin/run_recipe.main`` on the card (each timed; the launches counted
    over 5 and over 7), the train step held card against CPU
    (``hold_npss_step``) and ``svs()`` of the eval utterance card against
    CPU (``single_svs_on_cpu``).  Returns the stages' seconds, launches,
    trainer clock, holds and work directory."""
    work, recipe = npss_recipe(root, name)
    seconds = {}

    def stages(first, last):
        seconds.update(run_recipe_stages(first, last, [], recipe=recipe))

    with SingleTrainerClocks() as seen:
        launches = {"stage_5": count_launches(lr, lambda: stages(5, 5))}
    stages(6, 6)
    launches["stage_7"] = count_launches(lr, lambda: stages(7, 7))
    eval_lab = next((Path(root) / "corpus" / "eval_lab").glob("*.lab"))
    return {"work": work, "seconds": seconds, "launches": launches,
            "clock": seen.clocks["acoustic"],
            "step_hold": hold_npss_step(name, work),
            "svs_reference": single_svs_on_cpu(
                work / "packed_model", eval_lab, post_filter_type="gv")}


def phase_recipe_npss(lr, root) -> tuple:
    """The NPSS voices on the single-track recipe (phase 11e), after phase
    ``recipe_single`` in the same ``root``: stages 5-7 of the shipped
    ``acoustic_npss_ar_mgcf0bap.yaml`` (the deterministic AR cascade: the
    mgc decoder's cells at H = 1024 train on the 512 < H <= 1024 BPTT
    kernel) and of ``acoustic_npss_mdn.yaml`` (no LSTM) at their widths,
    each in its own work directory (``npss_voice``); the AR voice's
    launches against NPSS_STEP_LAUNCHES a train step and dev batch and
    NPSS_SVS_LAUNCHES an ``svs()`` call; the H = 1024 forward (both
    modes), BPTT (pre-pass and loop) and dW_h timed and held against
    their plain versions at the shapes stage 5 gave them and at the
    recipe's full batch (NPSS_FULL_B crops of NPSS_FULL_FRAMES frames, T =
    128 decoder steps), with their bounds and cuDNN's times, the forward
    at NPSS_WIDE_B x NPSS_WIDE_T and the BPTT at NPSS_BPTT_WIDE_B x
    NPSS_BPTT_WIDE_T (batches the earlier H > 512 kernels refused).
    Returns the
    AR voice's launches summed and the kernel rows by shape."""
    t0 = time.time()
    voices = {name: npss_voice(lr, root, name) for name in NPSS_CONFIGS}
    ar = voices["npss_ar"]
    clock = ar["clock"]
    rows = {}
    for B, T in sorted(clock.shapes["dev"]):
        rows[f"dev B={B} T={T // NPSS_R}"] = phase_kernels(
            lr, B=B, modes=(False,), phase="recipe_npss_kernel",
            shapes=[NPSS_H], T=-(-T // NPSS_R))[(NPSS_H, False)]
    for (_, want_c), row in phase_kernels(
            lr, B=NPSS_WIDE_B, phase="recipe_npss_kernel", shapes=[NPSS_H],
            T=NPSS_WIDE_T).items():
        rows[f"check{'_c' if want_c else ''} B={NPSS_WIDE_B} "
             f"T={NPSS_WIDE_T}"] = row
    B, T = NPSS_BPTT_WIDE_B, NPSS_BPTT_WIDE_T
    g = torch.Generator(device="cuda").manual_seed(SEED + B)
    xw = torch.randn(B, T, 4 * NPSS_H, device="cuda", generator=g)
    w_h = (torch.randn(NPSS_H, 4 * NPSS_H, device="cuda", generator=g)
           / NPSS_H ** 0.5)
    dy = torch.randn(B, T, NPSS_H, device="cuda", generator=g)
    h, c = lr.lstm_recurrence(xw, w_h, want_c=True)
    rows[f"check_bptt B={B} T={T}"] = bptt_row(
        lr, xw, w_h, h, c, dy, {"phase": "recipe_npss_kernel", "B": B,
                                "T": T, "H": NPSS_H})[0]
    train = sorted(clock.shapes["train"]) + [(NPSS_FULL_B,
                                              NPSS_FULL_FRAMES)]
    for B, T in train:
        Td = -(-T // NPSS_R)
        for k, row in phase_train_kernels(
                lr, B=B, shapes={(NPSS_H, Td): NPSS_LAYERS[NPSS_H]},
                phase="recipe_npss_train_kernel").items():
            rows[f"train {k[0]}{'_c' if k[3] else ''} B={B} T={Td}"] = row
    steps, dev = clock.calls["train"], clock.calls["dev"]
    want = {"stage_5": {
        "lstm_recurrence": NPSS_STEP_LAUNCHES * (steps + dev),
        "lstm_bptt": NPSS_STEP_LAUNCHES * steps,
        "lstm_dwh": NPSS_STEP_LAUNCHES * steps},
        "stage_7": {"lstm_recurrence": NPSS_SVS_LAUNCHES, "lstm_bptt": 0,
                    "lstm_dwh": 0}}
    emit({"phase": "recipe_npss", "device": "cuda",
          "configs": NPSS_CONFIGS,
          "cuts": {"epochs": f"{SINGLE_EPOCHS} of 100 in stage 5",
                   "step_hold": f"{NPSS_REF_B} x {NPSS_REF_T} frames, "
                                "dropout off"},
          **{name: {"stage_s": {str(k): v for k, v in v["seconds"].items()},
                    "launches": v["launches"],
                    "train_steps": v["clock"].calls["train"],
                    "dev_batches": v["clock"].calls["dev"],
                    "train_shapes": sorted(v["clock"].shapes["train"]),
                    "dev_shapes": sorted(v["clock"].shapes["dev"]),
                    "step_hold": v["step_hold"],
                    "svs_reference": v["svs_reference"]}
             for name, v in voices.items()},
          "want_launches": want, "snr_bound_db": SNR_DB,
          "kernel_rows": {k: {f: r[f] for f in (
              "kernel", "B", "T", "H", "max_abs_err", "ms", "us_per_step",
              "plain_ms", "bound_ms", "bound_by", "bound_fma_ms",
              "bound_3xtf32_ms", "library_ms", "library_input_gemm_ms",
              "library_tf32", "loop_mma_rows", "loop_bound_ms",
              "loop_bound_fma_ms", "loop_bound_3xtf32_ms", "prepass_ms",
              "prepass_bound_ms", "prepass_library_ms") if f in r}
              for k, r in rows.items()},
          "seconds": time.time() - t0})
    assert ar["launches"] == want, (ar["launches"], want)
    mdn = voices["npss_mdn"]["launches"]
    assert all(n == 0 for v in mdn.values() for n in v.values()), mdn
    for name, v in voices.items():
        ref = v["svs_reference"]
        assert v["step_hold"]["ok"], (name, v["step_hold"])
        assert ref["durations_equal"] and ref["snr_db"] >= SNR_DB, (name,
                                                                    ref)
        assert ref["svs_finite_nonzero"], (name, ref)
    assert all(r["max_abs_err"] < KERNEL_ATOL for k, r in rows.items()
               if "dwh" not in k), rows
    total = {k: sum(v[k] for v in ar["launches"].values())
             for k in TRAIN_COUNTERS}
    return total, rows


def ar_option_launches(module) -> dict:
    """The kernel launches of the cascade ``module``, derived from its
    layers: a teacher-forced train step (each of forward, BPTT and dW_h)
    or dev batch (the forward) runs every masked LSTM direction
    (``_MaskedLSTMLayer``) once and each AR decoder's cells once where
    its zoneout is 0 (they step in PyTorch where it is not); a
    free-running ``svs()`` call runs the directions only (the decoders
    step in PyTorch).  Returns {"step": n, "svs": n, "by_hidden": {H:
    n a step}}."""
    from ensemble_svs_with_interactions_tpu_torch.models.layers import (
        _MaskedLSTMLayer,
    )
    from ensemble_svs_with_interactions_tpu_torch.models.tacotron import (
        _ARDecoderCore,
    )

    by_hidden = {}
    directions = 0
    for m in module.modules():
        runs = 0
        if isinstance(m, _MaskedLSTMLayer):
            runs, H = 1, m.w_h.shape[0]
            directions += 1
        elif isinstance(m, _ARDecoderCore) and m.zoneout <= 0:
            runs, H = m.layers, m.hidden_dim
        if runs:
            by_hidden[H] = by_hidden.get(H, 0) + runs
    return {"step": sum(by_hidden.values()), "svs": directions,
            "by_hidden": dict(sorted(by_hidden.items()))}


def ar_option_voice(lr, root, name) -> dict:
    """Stages 5-7 of the voice ``name`` (``ar_option_netg`` of
    ``acoustic_npss_ar_mgcf0bap.yaml``, its model config written into
    ``root``) through ``bin/run_recipe.main`` on the card, as
    ``npss_voice`` runs them, in its own work directory
    (``npss_recipe``): each stage timed, the launches counted over 5 and
    over 7 and derived from the packed model (``ar_option_launches``),
    the train step held card against CPU with every mask on, drawn from
    one CPU generator (``hold_npss_step``), ``svs()`` of the eval
    utterance card against CPU (``single_svs_on_cpu``)."""
    from ensemble_svs_with_interactions_tpu_torch.utils.config import (
        instantiate,
        load_config,
        save_config,
    )

    cfg = shipped_config(NPSS_CONFIGS["npss_ar"])
    cfg["netG"] = ar_option_netg(cfg["netG"], name)
    model_config = Path(root) / f"{name}_model.yaml"
    save_config(cfg, model_config)
    work, recipe = npss_recipe(root, name, model_config)
    seconds = {}

    def stages(first, last):
        seconds.update(run_recipe_stages(first, last, [], recipe=recipe))

    with SingleTrainerClocks() as seen:
        launches = {"stage_5": count_launches(lr, lambda: stages(5, 5))}
    stages(6, 6)
    launches["stage_7"] = count_launches(lr, lambda: stages(7, 7))
    packed = load_config(work / "packed_model" / "acoustic_model.yaml")
    derived = ar_option_launches(instantiate(dict(packed["netG"])))
    clock = seen.clocks["acoustic"]
    steps, dev = clock.calls["train"], clock.calls["dev"]
    want = {"stage_5": {"lstm_recurrence": derived["step"] * (steps + dev),
                        "lstm_bptt": derived["step"] * steps,
                        "lstm_dwh": derived["step"] * steps},
            "stage_7": {"lstm_recurrence": derived["svs"], "lstm_bptt": 0,
                        "lstm_dwh": 0}}
    eval_lab = next((Path(root) / "corpus" / "eval_lab").glob("*.lab"))
    return {"seconds": seconds, "launches": launches, "derived": derived,
            "want_launches": want, "train_steps": steps, "dev_batches": dev,
            "train_shapes": sorted(clock.shapes["train"]),
            "step_hold": hold_npss_step(name, work, masks=True),
            "svs_reference": single_svs_on_cpu(
                work / "packed_model", eval_lab, post_filter_type="gv")}


def phase_ar_options(lr, root) -> dict:
    """The AR decoder options (phase 11h), after phase ``recipe_npss`` in
    the same ``root``: the voices AR_OPTION_VOICES, built from
    ``acoustic_npss_ar_mgcf0bap.yaml`` by ``ar_option_netg``, each through
    stages 5-7 on the card (``ar_option_voice``): ``npss_ar_tacotron``'s
    decoders with the pre-net and zoneout (their teacher-forced cells
    step in PyTorch), ``npss_mdn_ar``'s with the pre-net and the MDN
    heads (its cells on the kernels, the mgc decoder's at H = 1024).  The
    launches must equal what ``ar_option_launches`` derives; the train
    steps and ``svs()`` calls must hold card against CPU as phase
    ``recipe_npss``'s do.  The kernels run at that phase's shapes and
    are not timed again.  Returns the launches summed over both
    voices."""
    t0 = time.time()
    voices = {name: ar_option_voice(lr, root, name)
              for name in AR_OPTION_VOICES}
    emit({"phase": "ar_options", "device": "cuda",
          "base_config": NPSS_CONFIGS["npss_ar"],
          "overrides": {name: "chip_smoke.ar_option_netg"
                        for name in AR_OPTION_VOICES},
          "cuts": {"epochs": f"{SINGLE_EPOCHS} of 100 in stage 5",
                   "step_hold": f"{NPSS_REF_B} x {NPSS_REF_T} frames, "
                                "every mask on, one CPU generator"},
          **{name: {"stage_s": {str(k): t for k, t in v["seconds"].items()},
                    **{k: v[k] for k in (
                        "launches", "want_launches", "derived",
                        "train_steps", "dev_batches", "train_shapes",
                        "step_hold", "svs_reference")}}
             for name, v in voices.items()},
          "snr_bound_db": SNR_DB, "seconds": time.time() - t0})
    for name, v in voices.items():
        ref = v["svs_reference"]
        assert v["launches"] == v["want_launches"], (name, v["launches"],
                                                     v["want_launches"])
        assert v["step_hold"]["ok"], (name, v["step_hold"])
        assert ref["durations_equal"] and ref["snr_db"] >= SNR_DB, (name,
                                                                    ref)
        assert ref["svs_finite_nonzero"], (name, ref)
    return {k: sum(n[k] for v in voices.values()
                   for n in v["launches"].values())
            for k in TRAIN_COUNTERS}


# the mel voice (phase 11f): single-direction LSTM recurrences a svs()
# call runs at B = 1, by width: the lf0 decoder's Sinsy encoder and the
# vuv decoder (biLSTM 64 x 2 each), the DDPM's condition encoder (biLSTM
# 128 x 2); the AR lf0 cell steps in PyTorch
MEL_LAUNCHES_BY_HIDDEN = {64: 8, 128: 4}
MEL_R = 4                                # the lf0 decoder's reduction
MEL_TRAIN_B, MEL_TRAIN_T = 4, 256        # the recipe's crops, 4 a batch
# a train step's (or teacher-forced dev batch's) runs by (H, T): the same
# encoders over T and the AR lf0 cell (256) over T / 4
MEL_TRAIN_LAYERS = {(64, MEL_TRAIN_T): 8, (128, MEL_TRAIN_T): 4,
                    (256, MEL_TRAIN_T // MEL_R): 1}
MEL_STEP_LAUNCHES = sum(MEL_TRAIN_LAYERS.values())   # 13
MEL_REF_SECONDS = DIFFUSION_REF_SECONDS  # one 512-frame bucket
MEL_CORPUS = dict(n_train=8, n_dev=2, frames=(520, 900))
MEL_TRAINER_EPOCHS = 1


def write_mel_corpus(root, n_train: int, n_dev: int, frames,
                     seed: int = SEED):
    """Synthetic normalized dumps of a single-singer mel corpus as the
    recipe's stage 2 would leave them, under ``root``:
    ``{train_no_dev,dev}/{in,out}_acoustic/utt{k}-feats.npy``, 86 inputs
    (the pitch column's score lf0 held per 40-frame note, rests between)
    and 82 outputs (mel, lf0, a 0/1 vuv), ``frames[0]`` to ``frames[1] -
    1`` frames each; and ``mel_phases``' acoustic out scaler under
    ``scalers/``.  Returns ``root``."""
    root = Path(root)
    rng = np.random.default_rng(seed)
    lf0_idx = mel_acoustic_config()["netG"]["in_lf0_idx"]
    for split, n in (("train_no_dev", n_train), ("dev", n_dev)):
        for d in ("in_acoustic", "out_acoustic"):
            (root / split / d).mkdir(parents=True, exist_ok=True)
        for k in range(n):
            T = int(rng.integers(*frames))
            x = rng.uniform(0, 1, (T, 86)).astype(np.float32)
            notes = np.repeat(rng.uniform(0.3, 0.7, T // 40 + 1), 40)[:T]
            rest = np.repeat(rng.uniform(size=T // 40 + 1) < 0.2, 40)[:T]
            x[:, lf0_idx] = np.where(rest, 0.0, notes)
            x[:, 0] = rest
            y = rng.normal(size=(T, MEL_DIMS + 2)).astype(np.float32)
            y[:, -1] = ~rest
            np.save(root / split / "in_acoustic" / f"utt{k}-feats.npy", x)
            np.save(root / split / "out_acoustic" / f"utt{k}-feats.npy", y)
    (root / "scalers").mkdir(exist_ok=True)
    sc = mel_phases()[1]["acoustic"][2]
    for attr in ("mean", "var", "scale"):
        np.save(root / "scalers" / f"out_acoustic_scaler_{attr}.npy",
                np.asarray(getattr(sc, attr + "_"), np.float64))
    return root


def mel_trainer_config(corpus, out_dir):
    """The single-track trainer's config for the mel voice: the model of
    ``mel_acoustic_config`` at its widths, the packaged recipe's acoustic
    data and train sections (random 256-frame crops, l1, Adam, the AMP
    arm; ``spk_names`` dropped, the pitch regularization at 1 as the
    single-track recipe sets it), MEL_TRAIN_B crops a batch and
    MEL_TRAINER_EPOCHS epochs."""
    from ensemble_svs_with_interactions_tpu_torch.utils import yaml_io
    from ensemble_svs_with_interactions_tpu_torch.utils.config import merge

    section = yaml_io.load(RECIPE.read_text())["acoustic"]
    corpus = Path(corpus)
    data = {k: v for k, v in section["data"].items() if k != "spk_names"}
    data.update({split: {"in_dir": str(corpus / split / "in_acoustic"),
                         "out_dir": str(corpus / split / "out_acoustic")}
                 for split in ("train_no_dev", "dev")})
    data.update(out_scaler_prefix=str(corpus / "scalers" /
                                      "out_acoustic_scaler"),
                batch_max_frames=MEL_TRAIN_B * MEL_TRAIN_T,
                in_lf0_idx=mel_acoustic_config()["netG"]["in_lf0_idx"],
                in_lf0_min=SINGLE_LF0["in_lf0_min"],
                in_lf0_max=SINGLE_LF0["in_lf0_max"])
    train = {**section["train"], "nepochs": MEL_TRAINER_EPOCHS,
             "pitch_reg_weight": 1.0, "out_dir": str(out_dir)}
    return merge({"seed": 1234, "verbose": 0},
                 {"model": mel_acoustic_config(), "data": data,
                  "train": train})


def mel_batch(out_dim: int, seed: int = SEED) -> dict:
    """A single-track acoustic batch of MEL_TRAIN_B crops of MEL_TRAIN_T
    frames (86 inputs, ``out_dim`` outputs; with lf0 and vuv a 0/1 vuv),
    the last shorter, and the pitch regularization's weights."""
    rng = np.random.default_rng(seed)
    B, T = MEL_TRAIN_B, MEL_TRAIN_T
    out = rng.normal(size=(B, T, out_dim)).astype(np.float32)
    if out_dim > MEL_DIMS:
        out[..., -1] = rng.uniform(size=(B, T)) > 0.3
    return {"in_feats": rng.uniform(0, 1, (B, T, 86)).astype(np.float32),
            "out_feats": out,
            "lengths": np.array([T] * (B - 1) + [T - T // 4], np.int64),
            "pitch_reg_dyn_ws": rng.uniform(0, 1, (B, T, 1)).astype(
                np.float32)}


def mel_step(cfg, variables, batch, device, dtype=torch.float32,
             use_amp=False):
    """One ``train/loop.create_train_step`` step of ``cfg``'s netG from
    flax ``variables`` (SGD at rate 0, clipping at 1, the pitch
    regularization at 1), its dropout masks and diffusion draws from a
    CPU generator seeded SEED, so the card and the CPU draw alike:
    (metrics, {name: clipped gradient}) on the CPU in float64."""
    from ensemble_svs_with_interactions_tpu_torch.train import loop
    from ensemble_svs_with_interactions_tpu_torch.utils.config import (
        instantiate,
    )
    from ensemble_svs_with_interactions_tpu_torch.utils.flax_port import (
        flax_to_torch,
    )

    module = flax_to_torch(instantiate(cfg["netG"]), variables).to(dtype)
    opt, sched = loop.build_optimizer(module.parameters(),
                                      {"name": "SGD", "params": {"lr": 0.0}})
    step, _ = loop.create_train_step(
        module, opt, {"stream_sizes": cfg["stream_sizes"]}, scheduler=sched,
        pitch_reg_weight=1.0, use_amp=use_amp, device=device)
    metrics = step(batch, torch.Generator().manual_seed(SEED))
    return metrics, {n: p.grad.detach().cpu().double()
                     for n, p in module.named_parameters()}


def nudged_variables(variables, seed: int = SEED):
    """``variables`` with every parameter scaled by 1 + NUDGE_RTOL x a
    seeded standard normal draw (batch statistics kept)."""
    rng = np.random.default_rng(seed)

    def nudge(tree):
        if isinstance(tree, dict):
            return {k: nudge(v) for k, v in sorted(tree.items())}
        a = np.asarray(tree)
        return (a * (1 + NUDGE_RTOL * rng.standard_normal(a.shape))).astype(
            a.dtype)

    return {**variables, "params": nudge(variables["params"])}


def hold_mel_step(cfg, amp: bool = True, batch=None,
                  nudge: bool = False) -> dict:
    """One full-width train step of ``cfg`` at MEL_TRAIN_B x MEL_TRAIN_T
    on the card against the same step on the CPU, as ``hold_npss_step``
    judges its steps: the float32 gradients by ``judge_amp`` with the
    CPU's float64 step as the oracle and, with cuDNN off, by the strict
    ``judge_f32``; with ``amp`` the AMP arm by ``judge_amp`` against the
    CPU's AMP step with its float32 step as the oracle; the losses within
    TRAIN_LOSS_RTOL and AMP_LOSS_RTOL.  Dropout stays as configured: both
    sides draw from one CPU generator.  ``batch`` (``mel_batch`` of the
    config's streams by default) may carry the speaker ids ``spks``.
    ``nudge`` also runs the CPU's float32 step from ``nudged_variables``
    and lets the strict judge measure the step's kinks by it
    (``judge_f32``'s ``nudged``)."""
    from ensemble_svs_with_interactions_tpu_torch.utils.config import (
        instantiate,
    )
    from ensemble_svs_with_interactions_tpu_torch.utils.flax_init import (
        init_variables,
    )

    t0 = time.time()
    variables = init_variables(instantiate(cfg["netG"]), seed=SEED)
    if batch is None:
        batch = mel_batch(sum(cfg["stream_sizes"]))

    def step(dev, dtype=torch.float32, use_amp=False, v=variables):
        return mel_step(cfg, v, batch, dev, dtype, use_amp)

    m_gpu, g_gpu = step("cuda")
    with torch.backends.cudnn.flags(enabled=False):
        m_raw, g_raw = step("cuda")
    m_cpu, g_cpu = step("cpu")
    g_64 = step("cpu", torch.float64)[1]
    g_nudged = step("cpu", v=nudged_variables(variables))[1] if nudge \
        else None
    rel = lambda a, b: abs(a["Loss"] - b["Loss"]) / abs(b["Loss"])  # noqa
    judged = {"f32": judge_amp(g_gpu, g_cpu, g_64, AMP_GRAD_RTOL,
                               AMP_COS_MIN, AMP_L2_MAX)}
    strict = judge_f32(g_raw, g_cpu, g_64, nudged=g_nudged)
    worst = max(strict, key=lambda n: strict[n]["rel_of_scale"])
    out = {"B": MEL_TRAIN_B, "T": MEL_TRAIN_T, "params": len(strict),
           "loss": [m_gpu["Loss"], m_cpu["Loss"]],
           "loss_rel_err": rel(m_gpu, m_cpu),
           "f32": amp_summary(judged["f32"]),
           "f32_cudnn_off": {
               "loss_rel_err": rel(m_raw, m_cpu),
               "max_grad_rel_err": strict[worst]["rel_of_scale"],
               "worst_grad": worst,
               "by_nudge": {n: v for n, v in strict.items() if v["ok"] and
                            v["rel_of_scale"] >= TRAIN_GRAD_RTOL and
                            v["to_oracle"] > AR_HEADROOM
                            * v["ref_to_oracle"]},
               "failed": {n: v for n, v in strict.items() if not v["ok"]}}}
    ok = (np.isfinite(m_gpu["Loss"]) and out["loss_rel_err"] < TRAIN_LOSS_RTOL
          and out["f32_cudnn_off"]["loss_rel_err"] < TRAIN_LOSS_RTOL
          and not out["f32_cudnn_off"]["failed"])
    if amp:
        a_gpu, ga_gpu = step("cuda", use_amp=True)
        a_cpu, ga_cpu = step("cpu", use_amp=True)
        judged["amp"] = judge_amp(ga_gpu, ga_cpu, g_cpu, AMP_GRAD_RTOL,
                                  AMP_COS_MIN, AMP_L2_MAX)
        out.update(amp_loss=[a_gpu["Loss"], a_cpu["Loss"]],
                   amp_loss_rel_err=rel(a_gpu, a_cpu),
                   amp=amp_summary(judged["amp"]))
        ok = (ok and np.isfinite(a_gpu["Loss"])
              and out["amp_loss_rel_err"] < AMP_LOSS_RTOL)
    out["ok"] = bool(ok and all(v["ok"] for j in judged.values()
                                for v in j.values()))
    out["seconds"] = time.time() - t0
    return out


def mel_svs_reference(engine, cpu, labels) -> dict:
    """``svs()`` of ``labels`` on the card under each postfilter type
    against the CPU engine over the same pack: the card's chain noise
    recorded and replayed into the CPU's (``diffsinger.chain_noise``; the
    AR decoder's prenet masks, the postfilter's noise and the vocoder's
    excitation are CPU draws on both), the CPU's stages as ``svs()`` runs
    them with its acoustic features computed once; durations exactly, the
    streams' largest difference over each stream's scale, the float32
    waveforms by SNR, and the card's whole ``svs()`` (the same noise)
    against its stages by SNR."""
    from ensemble_svs_with_interactions_tpu_torch.models import diffsinger

    t0 = time.time()
    out = {}
    dm = engine.predict_timing(labels.copy())
    cpu_dm = cpu.predict_timing(labels.copy())
    with diffsinger.chain_noise() as draws:
        acoustic = engine.predict_acoustic(dm)
    with diffsinger.chain_noise(draws):
        cpu_acoustic = cpu.predict_acoustic(cpu_dm)
    for pft in ("gv", "nnsvs"):
        streams = engine.postprocess_acoustic(acoustic, dm,
                                              post_filter_type=pft)
        cpu_streams = cpu.postprocess_acoustic(cpu_acoustic, cpu_dm,
                                               post_filter_type=pft)
        wav = [e.postprocess_waveform(e.predict_waveform(
            s, vocoder_type="usfgan"), dtype=np.float32)
            for e, s in ((engine, streams), (cpu, cpu_streams))]
        with diffsinger.chain_noise(draws):
            whole, _ = engine.svs(labels.copy(), post_filter_type=pft,
                                  vocoder_type="auto", dtype=np.float32)
        # the whole svs() on the card against its stages above
        out[pft] = {
            "stream_err_over_scale": {
                name: float(np.abs(np.asarray(a, np.float64) - b).max()
                            / max(np.abs(b).max(), 1e-12))
                for name, a, b in zip(("mel", "lf0", "vuv"), streams,
                                      cpu_streams)},
            "snr_db": snr_db(wav[1], wav[0]),
            "svs_vs_stages_snr_db": snr_db(wav[0], whole),
            "finite_nonzero": bool(np.isfinite(wav[0]).all()
                                   and np.abs(wav[0]).max() > 0)}
    return {"frames": len(acoustic),
            "durations_equal": list(dm.end_times) == list(cpu_dm.end_times),
            "acoustic_err": float(np.abs(acoustic - cpu_acoustic).max()),
            **out, "seconds": time.time() - t0}


def phase_mel_voice(lr, label) -> tuple:
    """The mel voice (phase 11f): ``mel_phases()`` at full width packed
    by ``pack_model`` and opened by ``SPSVS(model_dir)``; a warm-up, then
    one ``svs()`` of the fixture under ``gv`` and one under ``nnsvs``
    (the mel postfilter), both with ``vocoder_type="auto"`` (the
    hn-uSFGAN on the mel), the launch counts by width reset just before
    and read just after each (MEL_LAUNCHES_BY_HIDDEN); the card against
    the CPU on the first MEL_REF_SECONDS (``mel_svs_reference``); the
    recurrence held at B = 1 over the fixture's T_FRAMES at H = 64 and
    128; the voice through ``train/trainer.train_model`` on a synthetic
    corpus (``write_mel_corpus``, ``mel_trainer_config``) with the
    launches counted (MEL_STEP_LAUNCHES a train step for each kernel and
    a dev batch for the forward) and each kernel held at
    MEL_TRAIN_LAYERS at B = MEL_TRAIN_B; one train step of the voice and
    one of each mel-only config (``MEL_ONLY_CONFIGS``, no LSTM) card
    against CPU (``hold_mel_step``).  Returns the launches summed over
    the svs calls and the trainer run, and the kernel rows."""
    from ensemble_svs_with_interactions_tpu_torch.svs import SPSVS

    t0 = time.time()
    glob, phases = mel_phases()
    launches = {n: 0 for n in TRAIN_COUNTERS}
    calls = {}
    with tempfile.TemporaryDirectory() as model_dir:
        t1 = time.time()
        pack_phases(model_dir, glob, phases,
                    random_state_dicts(phases, SEED))
        pack_s = time.time() - t1
        engine = SPSVS(model_dir)
        engine.svs(trim_labels(label, MEL_REF_SECONDS), vocoder_type="auto")
        for pft in ("gv", "nnsvs"):
            for name in TRAIN_COUNTERS:
                getattr(lr, name).launches = 0
            reset_launches(lr)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            wav, sr = engine.svs(label.copy(), vocoder_type="auto",
                                 post_filter_type=pft)
            seconds = time.perf_counter() - t1
            calls[pft] = {
                "seconds": seconds, "rtf": seconds / (len(wav) / sr),
                "stage_s": dict(engine.last_stage_times),
                "launches_by_width": dict(
                    lr.lstm_recurrence.launches_by_width),
                "launches": {n: getattr(lr, n).launches
                             for n in TRAIN_COUNTERS},
                "finite_nonzero": bool(np.abs(wav).max() > 0)}
            for n in TRAIN_COUNTERS:
                launches[n] += calls[pft]["launches"][n]
        reference = mel_svs_reference(
            engine, SPSVS(model_dir, device="cpu"),
            trim_labels(label, MEL_REF_SECONDS))
    del engine
    rows = {f"svs B=1 H={H}": row for (H, _), row in phase_kernels(
        lr, B=1, modes=(False,), phase="mel_voice_kernel",
        shapes=sorted(MEL_LAUNCHES_BY_HIDDEN)).items()}
    for (name, H, T, want_c), row in phase_train_kernels(
            lr, B=MEL_TRAIN_B, shapes=MEL_TRAIN_LAYERS,
            phase="mel_voice_train_kernel").items():
        rows[f"train {name}{'_c' if want_c else ''} H={H} T={T}"] = row
    with tempfile.TemporaryDirectory() as root:
        corpus = write_mel_corpus(Path(root) / "corpus", **MEL_CORPUS)
        run = run_trainer(lr, mel_trainer_config(corpus, Path(root) / "exp"),
                          acoustic=True, multitrack=False)
    for n in TRAIN_COUNTERS:
        launches[n] += run["launches"][n]
    steps, dev = run["steps"], run["dev_batches"]
    want = {"lstm_recurrence": MEL_STEP_LAUNCHES * (steps + dev),
            "lstm_bptt": MEL_STEP_LAUNCHES * steps,
            "lstm_dwh": MEL_STEP_LAUNCHES * steps}
    holds = {"mel_cascade": hold_mel_step(mel_acoustic_config()),
             **{name: hold_mel_step(mel_only_config(name), amp=False)
                for name in MEL_ONLY_CONFIGS}}
    emit({"phase": "mel_voice", "device": "cuda", "config": MEL_CONFIG,
          "postfilter": MEL_POSTFILTER, "mel_only": MEL_ONLY_CONFIGS,
          "vocoder": f"{VOCODER_CONFIG} (aux_channels {MEL_DIMS})",
          "pack_s": pack_s, "svs": calls,
          "want_launches_by_width": MEL_LAUNCHES_BY_HIDDEN,
          "reference": reference, "snr_bound_db": SNR_DB,
          "trainer": {k: run[k] for k in (
              "wall_s", "steps", "dev_batches", "train_loss", "dev_loss",
              "train_shapes", "dev_shapes", "launches", "peak_mem_gib")},
          "trainer_want_launches": want, "step_holds": holds,
          "kernel_rows": {k: {f: r[f] for f in (
              "kernel", "B", "T", "H", "max_abs_err", "ms", "us_per_step",
              "plain_ms", "bound_ms", "bound_by", "library_ms",
              "loop_bound_ms", "prepass_ms", "prepass_bound_ms",
              "prepass_library_ms") if f in r} for k, r in rows.items()},
          "seconds": time.time() - t0})
    for pft, c in calls.items():
        assert c["launches_by_width"] == MEL_LAUNCHES_BY_HIDDEN, (pft, c)
        assert c["launches"]["lstm_bptt"] == c["launches"]["lstm_dwh"] == 0
        assert c["finite_nonzero"], (pft, c)
    assert reference["durations_equal"], reference
    for pft in ("gv", "nnsvs"):
        r = reference[pft]
        assert r["snr_db"] >= SNR_DB and r["finite_nonzero"], (pft, r)
        assert r["svs_vs_stages_snr_db"] >= SNR_DB, (pft, r)
    assert run["launches"] == want, (run["launches"], want)
    assert all(np.isfinite(x) for x in run["train_loss"] + run["dev_loss"])
    for name, h in holds.items():
        assert h["ok"], (name, h)
    assert all(r["max_abs_err"] < KERNEL_ATOL for k, r in rows.items()
               if "dwh" not in k), rows
    return launches, rows


# the multi-speaker voice (phase 11g): single-direction LSTM recurrences
# of a gen.predict_acoustic call at B = 1, by width: the encoder (biLSTM
# 512 x 3), mgc (biLSTM 256 x 2), the lf0 decoder's Sinsy encoder, vuv and
# bap (biLSTM 64 x 2 each); the AR lf0 cell steps in PyTorch
MULTI_SPEAKER_LAUNCHES_BY_HIDDEN = {512: 6, 256: 4, 64: 12}
# a train step's (or teacher-forced dev batch's) runs by (H, T): the same
# layers over the recipe's 256-frame crops, the AR cell (256) over T / 4
MULTI_SPEAKER_TRAIN_LAYERS = {(512, MEL_TRAIN_T): 6, (256, MEL_TRAIN_T): 4,
                              (64, MEL_TRAIN_T): 12,
                              (256, MEL_TRAIN_T // MEL_R): 1}
MULTI_SPEAKER_STEP_LAUNCHES = sum(MULTI_SPEAKER_TRAIN_LAYERS.values())  # 23
# the train shapes no earlier phase holds the kernels at (B = 4)
MULTI_SPEAKER_NEW_SHAPES = {(512, MEL_TRAIN_T): 6, (64, MEL_TRAIN_T): 12}
# 3 singers x 3 segments to train on (3 steps of 4 crops), 3 to evaluate
MULTI_SPEAKER_CORPUS = dict(n_train=3, n_dev=1, frames=(520, 900))
MULTI_SPEAKER_EPOCHS = 1
MULTI_SPEAKER_SERVED = (0, 2)   # the speakers rendered (Vo1, ritsu)
# the rest of the zoo, one train step each at H = 256 card against CPU
ZOO_STEP_CONFIGS = {
    "LSTMRNN": {"_target_": f"{PKG}.models.LSTMRNN", "in_dim": 86,
                "hidden_dim": 256, "out_dim": 67, "num_layers": 2},
    "RMDN": {"_target_": f"{PKG}.models.RMDN", "in_dim": 86,
             "hidden_dim": 256, "out_dim": 67, "num_layers": 1,
             "num_gaussians": 4, "dim_wise": True},
    "LSTMRNNSAR": {"_target_": f"{PKG}.models.LSTMRNNSAR", "in_dim": 86,
                   "hidden_dim": 256, "out_dim": 67, "num_layers": 2,
                   "stream_sizes": [60, 1, 1, 5],
                   "ar_orders": [20, 200, 20, 20]},
    "MultiSpeakerFFConvLSTM": {
        "_target_": f"{PKG}.models.MultiSpeakerFFConvLSTM", "in_dim": 86,
        "embed_dim": 256, "in_ph_start_idx": 3, "in_ph_end_idx": 50,
        "ff_hidden_dim": 1024, "conv_hidden_dim": 512,
        "lstm_hidden_dim": 256, "out_dim": 67, "dropout": 0.1,
        "speaker_embedding": {"_target_": f"{PKG}.models.SpeakerEmbedding",
                              "num_embeddings": 17, "embedding_dim": 256}},
}


def speaker_batch(out_dim: int) -> dict:
    """``mel_batch`` with a speaker id per crop (the trainer's ``spks``)."""
    return {**mel_batch(out_dim),
            "spks": np.arange(MEL_TRAIN_B, dtype=np.int64) % len(CORPUS_SPKS)}


def write_start(path, cfg):
    """The flax-scheme initial weights of ``cfg``'s netG (seed SEED) as a
    trainer checkpoint, ``path / "latest.ckpt"``: a fixed start."""
    from ensemble_svs_with_interactions_tpu_torch.train.loop import (
        TrainState,
        save_checkpoint,
    )
    from ensemble_svs_with_interactions_tpu_torch.utils.config import (
        instantiate,
    )
    from ensemble_svs_with_interactions_tpu_torch.utils.flax_init import (
        init_variables,
    )

    v = init_variables(instantiate(cfg["model"]["netG"]), seed=SEED)
    save_checkpoint(path, TrainState(v["params"], v.get("batch_stats", {}),
                                     {}, 0), 0)
    return Path(path) / "latest.ckpt"


def speaker_render(engine, labels, spk) -> tuple:
    """One speaker of a single-track multi-speaker pack as ``svs()``'s
    stages run: ``gen.predict_acoustic(spk=...)`` on the timed ``labels``,
    the host postprocess and WORLD with the excitation of a CPU generator
    seeded 0 (the same on every device): (features, streams, waveform,
    seconds of the acoustic stage)."""
    from ensemble_svs_with_interactions_tpu_torch import gen

    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    feats = speaker_acoustic(gen, engine, labels, spk)
    acoustic_s = time.perf_counter() - t0
    streams = engine.postprocess_acoustic(feats, labels)
    hop = int(engine.sample_rate * engine.frame_period / 1000)
    noise = gen.vocoder_noise(
        1, gen._round_up(len(streams[1]), gen.FRAME_BUCKET) * hop, "cpu")
    wav = gen.predict_waveform(
        streams, sample_rate=engine.sample_rate,
        frame_period=engine.frame_period, device=engine.device,
        noise=noise.to(engine.device),
        use_world_codec=engine.config.get("use_world_codec", True))
    return feats, streams, wav, acoustic_s


def phase_multi_speaker(lr, label) -> tuple:
    """The multi-speaker voice (phase 11g): the shipped
    ``MULTI_SPEAKER_CONFIG`` at full width trained by
    ``bin/train_acoustic_multi.main`` on the card from a fixed start
    (``write_start``) on a synthetic three-singer corpus (``write_corpus``,
    ``multi_speaker_trainer_config``: the recipe's ``spk_names``, 4 crops
    of 256 a batch, the AMP arm as the recipe sets it), the launches
    counted (MULTI_SPEAKER_STEP_LAUNCHES a train step for each kernel and
    a dev batch for the forward); one train step of the voice at that
    batch card against CPU (``hold_mel_step``: float32 and AMP); the
    kernels held at the new train shapes (MULTI_SPEAKER_NEW_SHAPES); the
    trained checkpoint packed with the stock timing models and served for
    MULTI_SPEAKER_SERVED through ``gen.predict_acoustic(spk=k)``, the host
    postprocess and WORLD over the whole fixture (B = 1), the launches by
    width counted around each call, each speaker's waveform against the
    CPU engine's with the same excitation; one step of each of
    ZOO_STEP_CONFIGS card against CPU (float32).  Returns the launches
    summed over the trainer run and the calls, and the kernel rows."""
    from ensemble_svs_with_interactions_tpu_torch.bin import (
        train_acoustic_multi,
    )
    from ensemble_svs_with_interactions_tpu_torch.svs import SPSVS
    from ensemble_svs_with_interactions_tpu_torch.train.loop import (
        load_checkpoint,
    )
    from ensemble_svs_with_interactions_tpu_torch.train.trainer import (
        load_out_scaler,
    )
    from ensemble_svs_with_interactions_tpu_torch.utils.config import (
        instantiate,
        save_config,
    )

    t0 = time.time()
    launches = {n: 0 for n in TRAIN_COUNTERS}
    rows = {}
    for (name, H, T, want_c), row in phase_train_kernels(
            lr, B=MEL_TRAIN_B, shapes=MULTI_SPEAKER_NEW_SHAPES,
            phase="multi_speaker_train_kernel").items():
        rows[f"train {name}{'_c' if want_c else ''} H={H} T={T}"] = row
    voice = multi_speaker_acoustic_config()
    hold = hold_mel_step(voice, batch=speaker_batch(
        sum(voice["stream_sizes"])), nudge=True)
    zoo = {name: hold_mel_step({"netG": net, "stream_sizes": [67]},
                               amp=False, batch=speaker_batch(67))
           for name, net in ZOO_STEP_CONFIGS.items()}
    calls, served = {}, {}
    with tempfile.TemporaryDirectory() as root:
        root = Path(root)
        corpus = write_corpus(root / "corpus", **MULTI_SPEAKER_CORPUS)
        cfg = multi_speaker_trainer_config(corpus, root / "exp", **{
            "train.nepochs": MULTI_SPEAKER_EPOCHS,
            "data.batch_max_frames": MEL_TRAIN_B * MEL_TRAIN_T})
        start = write_start(root / "start", cfg)
        save_config(json.loads(json.dumps(cfg)), root / "train.yaml")
        for n in TRAIN_COUNTERS:
            getattr(lr, n).launches = 0
        t1 = time.perf_counter()
        rc = train_acoustic_multi.main([
            str(root / "train.yaml"), f"train.resume.checkpoint={start}"])
        train_s = time.perf_counter() - t1
        trained = {n: getattr(lr, n).launches for n in TRAIN_COUNTERS}
        records = [json.loads(line) for line in
                   (root / "exp" / "metrics.jsonl").read_text().splitlines()]
        glob, phases = multi_speaker_phases()
        weights = random_state_dicts(phases, SEED)
        module = instantiate(cfg["model"]["netG"])
        load_checkpoint(root / "exp" / "best_loss.ckpt").restore(module)
        weights["acoustic"] = module.state_dict()
        _, sc_in, _ = phases["acoustic"]
        phases["acoustic"] = (
            json.loads(json.dumps(cfg["model"])), sc_in,
            load_out_scaler(corpus / "scalers" / "out_acoustic_scaler"))
        pack_phases(root / "pack", {**glob, "spk_list": list(CORPUS_SPKS)},
                    phases, weights)
        engine = SPSVS(root / "pack")
        cpu = SPSVS(root / "pack", device="cpu")
        dm = engine.predict_timing(label.copy())
        cpu_dm = cpu.predict_timing(label.copy())
        speaker_render(engine, trim_labels(dm, 2.0), 0)   # warm-up
        for spk in MULTI_SPEAKER_SERVED:
            reset_launches(lr)
            for n in TRAIN_COUNTERS:
                getattr(lr, n).launches = 0
            feats, streams, wav, acoustic_s = speaker_render(engine, dm,
                                                             spk)
            calls[spk] = {
                "acoustic_s": acoustic_s, "frames": len(feats),
                "audio_s": len(wav) / engine.sample_rate,
                "launches_by_width": dict(
                    lr.lstm_recurrence.launches_by_width),
                "launches": {n: getattr(lr, n).launches
                             for n in TRAIN_COUNTERS}}
            for n in TRAIN_COUNTERS:
                launches[n] += calls[spk]["launches"][n]
            t1 = time.time()
            ref = speaker_render(cpu, cpu_dm, spk)
            served[spk] = (feats, streams)
            calls[spk].update(
                cpu_s=time.time() - t1,
                acoustic_err=float(np.abs(feats - ref[0]).max()),
                stream_err_over_scale={
                    name: float(np.abs(np.asarray(a, np.float64) - b).max()
                                / max(np.abs(b).max(), 1e-12))
                    for name, a, b in zip(("mgc", "lf0", "vuv", "bap"),
                                          streams, ref[1])},
                snr_db=snr_db(ref[2], wav),
                finite_nonzero=bool(np.isfinite(wav).all()
                                    and np.abs(wav).max() > 0))
        durations_equal = list(dm.end_times) == list(cpu_dm.end_times)
        a, b = (served[k][0] for k in MULTI_SPEAKER_SERVED)
        speakers_differ = float(np.abs(a - b).max())
        files = sorted(p.name for p in (root / "exp").iterdir())
    del engine, cpu
    for n in TRAIN_COUNTERS:
        launches[n] += trained[n]
    steps = trained["lstm_bptt"] // MULTI_SPEAKER_STEP_LAUNCHES
    dev_batches = (trained["lstm_recurrence"] // MULTI_SPEAKER_STEP_LAUNCHES
                   - steps)
    emit({"phase": "multi_speaker", "device": "cuda",
          "config": MULTI_SPEAKER_CONFIG, "spk_names": list(CORPUS_SPKS),
          "trainer": {"rc": rc, "wall_s": train_s, "steps": steps,
                      "dev_batches": dev_batches, "launches": trained,
                      "files": files, "metrics": records},
          "step_hold": hold, "zoo_step_holds": zoo,
          "served": calls, "durations_equal": durations_equal,
          "speakers_max_abs_diff": speakers_differ,
          "want_launches_by_width": MULTI_SPEAKER_LAUNCHES_BY_HIDDEN,
          "snr_bound_db": SNR_DB,
          "kernel_rows": {k: {f: r[f] for f in (
              "kernel", "B", "T", "H", "max_abs_err", "ms", "us_per_step",
              "plain_ms", "bound_ms", "bound_by", "library_ms",
              "loop_bound_ms", "prepass_ms", "prepass_bound_ms",
              "prepass_library_ms") if f in r} for k, r in rows.items()},
          "seconds": time.time() - t0})
    assert rc == 0 and "best_loss.ckpt" in files, (rc, files)
    assert all(np.isfinite(r.get("train_no_dev/Loss", 0.0))
               and np.isfinite(r.get("dev/Loss", 0.0)) for r in records)
    assert trained == {
        "lstm_recurrence": MULTI_SPEAKER_STEP_LAUNCHES * (steps + dev_batches),
        "lstm_bptt": MULTI_SPEAKER_STEP_LAUNCHES * steps,
        "lstm_dwh": MULTI_SPEAKER_STEP_LAUNCHES * steps}, trained
    assert steps > 0 and dev_batches > 0, (steps, dev_batches)
    assert hold["ok"], hold
    for name, h in zoo.items():
        assert h["ok"], (name, h)
    assert durations_equal
    for spk, c in calls.items():
        assert c["launches_by_width"] == MULTI_SPEAKER_LAUNCHES_BY_HIDDEN, c
        assert c["launches"]["lstm_bptt"] == c["launches"]["lstm_dwh"] == 0
        assert c["snr_db"] >= SNR_DB and c["finite_nonzero"], (spk, c)
    # the speakers part by far more than the card and the CPU do
    assert speakers_differ > 10 * max(c["acoustic_err"]
                                      for c in calls.values()), (
        speakers_differ, calls)
    assert all(r["max_abs_err"] < KERNEL_ATOL for k, r in rows.items()
               if "dwh" not in k), rows
    return launches, rows


# ---------------------------------------------------------------- parallel
# phase ``parallel``: the flagship's train step on PAR_WORLD ranks sharing
# the card over gloo (one global batch of PAR_B x TRAIN_T, mixed lengths,
# the last row a length-0 padding row), PAR_STEPS SGD steps against one
# process on the whole batch; the multitrack trainer under an NCCL group
# of one rank against the same run with no group; the ensemble under
# set_mesh; time-sharded WORLD synthesis over PAR_WORLD shards of cuda:0
PAR_WORLD = 2
PAR_B = 8
PAR_STEPS = 3
PAR_LENGTHS = (256, 256, 203, 160, 256, 131, 96, 0)
PAR_SGD = {"name": "SGD", "params": {"lr": 1e-2}}
PAR_PARAM_ULPS = 4
# the ranks in float64 on the CPU against one process in float64: the
# data-parallel decomposition is the global step up to float64 rounding
# (6e-13 of the scale at tiny widths on the CPU)
PAR_F64_RTOL = 1e-9


def par_threads() -> int:
    """Threads of each of the 2 x PAR_WORLD + 2 processes that run the CPU
    references of ``parallel_step_held`` at once (two groups of ranks, one
    process in float32 and in float64)."""
    import os

    return max(1, (os.cpu_count() or 1) // (2 * PAR_WORLD + 2))
PAR_CORPUS = dict(n_train=3, n_dev=1, frames=(300, 420))
PAR_STREAM_ATOL = 1e-4
PAR_WAV_RMS = 1e-4       # of full scale, tests/test_svs_ensemble.py's
PAR_WAV_CORR = 0.9999


def parallel_step_config(tiny: bool = False):
    """The flagship at full width (or ``tiny``), dropout off (the ranks'
    masks would differ from one process's), its seeded weights, the
    global batch."""
    ac, ss = flagship_acoustic_config(4, tiny=tiny)
    cfg = copy.deepcopy(ac["netG"])
    cfg["mgc_model"]["dropout"] = cfg["vuv_model"]["dropout"] = 0.0
    cfg["lf0_model"]["prenet_dropout"] = 0.0
    state = seeded_state_dict(cfg, SEED)
    batch = train_batch(PAR_B, TRAIN_T, sum(ss))
    lengths = np.asarray(PAR_LENGTHS, np.int32)
    valid = (np.arange(TRAIN_T)[None, :] < lengths[:, None])[:, :, None]
    for k in ("in_feats0", "in_feats1", "out_feats0", "out_feats1"):
        batch[k] = (batch[k] * valid).astype(np.float32)
    batch["lengths"] = lengths
    batch["spks0"] = np.arange(PAR_B, dtype=np.int32) % 4
    batch["spks1"] = (np.arange(PAR_B, dtype=np.int32) + 1) % 4
    return cfg, ss, state, batch


def parallel_steps(lr, rows, cfg, ss, state, device,
                   dtype=torch.float32) -> dict:
    """PAR_STEPS SGD steps of the flagship on ``rows`` in ``dtype``: the
    metrics, each step's host seconds, the launches of each kernel, the
    sum of the steps' (reduced, clipped) gradients and the parameters
    after them (on the CPU, float64)."""
    module, step = build_trainer(cfg, ss, state, device, dtype,
                                 optimizer=PAR_SGD)
    grads = {n: 0.0 for n, _ in module.named_parameters()}
    gen = torch.Generator(device=device).manual_seed(SEED)
    for name in TRAIN_COUNTERS:
        getattr(lr, name).launches = 0
    metrics, seconds = [], []
    for _ in range(PAR_STEPS):
        t0 = time.perf_counter()
        metrics.append(step(rows, TRAIN_WEIGHTS, gen))
        seconds.append(time.perf_counter() - t0)
        for n, p in module.named_parameters():
            grads[n] = grads[n] + p.grad.detach().cpu().double()
    return {"metrics": metrics, "step_s": seconds,
            "launches": {n: getattr(lr, n).launches for n in TRAIN_COUNTERS},
            "grads": grads,
            "params": {n: p.detach().cpu().double()
                       for n, p in module.named_parameters()}}


def parallel_rank(rank: int, port: int, out: str, runs,
                  tiny: bool = False) -> int:
    """One rank of the phase's data-parallel step, in its own process:
    joins the gloo group (on the card when a run is there), then for each
    (name, device, dtype, unsynced_bn) of ``runs`` takes its rows of the
    global batch (``parallel.shard_batch``) on that device, starts from
    rank 0's weights (``replicate_tree``) and runs ``parallel_steps`` in
    that dtype; saves {name: result}.  ``unsynced_bn`` plants a naive
    port's fault, the control the hold must refuse: batch norm takes this
    rank's statistics, not the group's."""
    from ensemble_svs_with_interactions_tpu_torch.models import layers
    from ensemble_svs_with_interactions_tpu_torch.ops import (
        lstm_recurrence as lr,
    )
    from ensemble_svs_with_interactions_tpu_torch.parallel import mesh as M

    torch.set_num_threads(par_threads())
    cuda = [d for _, d, _, _ in runs if d == "cuda"]
    M.maybe_initialize_distributed(f"127.0.0.1:{port}", PAR_WORLD, rank,
                                   device=cuda[0] if cuda else "cpu",
                                   backend="gloo")
    cfg, ss, state, batch = parallel_step_config(tiny)
    synced = layers.all_reduce_sum, layers.all_reduce_sum_autograd
    results = {}
    for name, device, dtype, unsynced_bn in runs:
        mesh = M.make_mesh(device=[torch.device(device, 0)
                                   if device == "cuda"
                                   else torch.device(device)])
        M.replicate_tree(state, mesh)
        rows, = M.shard_batch(batch, mesh)
        if unsynced_bn:
            layers.all_reduce_sum = layers.all_reduce_sum_autograd = (
                lambda t: t)
        try:
            results[name] = parallel_steps(lr, rows, cfg, ss, state,
                                           mesh.devices[0],
                                           getattr(torch, dtype))
        finally:
            layers.all_reduce_sum, layers.all_reduce_sum_autograd = synced
    torch.save({"runs": results, "world_size": mesh.world_size,
                "rank": mesh.rank,
                "backend": torch.distributed.get_backend()}, out)
    M.barrier()
    torch.distributed.destroy_process_group()
    return 0


def parallel_one(out: str, device: str, dtype: str,
                 tiny: bool = False) -> int:
    """``parallel_steps`` of one process on the whole global batch in its
    own process, saved to ``out``."""
    from ensemble_svs_with_interactions_tpu_torch.ops import (
        lstm_recurrence as lr,
    )

    torch.set_num_threads(par_threads())
    cfg, ss, state, batch = parallel_step_config(tiny)
    rows = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    torch.save(parallel_steps(lr, rows, cfg, ss, state, torch.device(device),
                              getattr(torch, dtype)), out)
    return 0


def parallel_trainer(config_json: str, port: int, device: str = "cuda",
                     deterministic: bool = True) -> int:
    """The multitrack acoustic trainer in its own process: with ``port``,
    one rank of a group of world size 1 (NCCL on the card) joined from the
    config's ``distributed`` section; else no group.  ``deterministic``
    runs torch's deterministic algorithms (cuBLAS with a fixed workspace):
    the card's default ones do not repeat a training run bitwise."""
    import os

    from ensemble_svs_with_interactions_tpu_torch.train import (
        multitrack_trainer,
    )
    from ensemble_svs_with_interactions_tpu_torch.utils.config import Config

    if deterministic:
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        torch.use_deterministic_algorithms(True)

    cfg = json.loads(Path(config_json).read_text())
    if port:
        cfg["distributed"] = {"coordinator": f"127.0.0.1:{port}",
                              "num_processes": 1, "process_id": 0}
    multitrack_trainer.train_multitrack_model(Config(cfg), True,
                                              device=device)
    if port:
        assert torch.distributed.get_backend() == (
            "nccl" if device == "cuda" else "gloo")
        torch.distributed.destroy_process_group()
    return 0


def _spawn(code: str) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _wait(procs, timeout: float = 300.0) -> list:
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-6000:]
    return logs


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def parallel_ranks(root, tag, runs, tiny) -> tuple:
    """Start PAR_WORLD ``parallel_rank`` processes of ``runs`` in a group
    of their own: (their result files, the processes)."""
    port = _free_port()
    outs = [Path(root) / f"{tag}{r}.pt" for r in range(PAR_WORLD)]
    return outs, [_spawn(f"import chip_smoke; chip_smoke.parallel_rank({r}, "
                         f"{port}, {str(outs[r])!r}, {runs!r}, {tiny})")
                  for r in range(PAR_WORLD)]


def _scaled_err(got, want, floor) -> float:
    """The largest of max|got - want| / max(max|want|, floor) over a
    {name: tensor} tree."""
    return max((got[n] - w).abs().max().item()
               / max(w.abs().max().item(), floor) for n, w in want.items())


def parallel_params_held(got, refs, oracle, floor) -> dict:
    """{name: error} of the parameters ``got`` after PAR_STEPS SGD steps
    that break the train step's rule (``judge_f32``) against the float32
    runs ``refs`` (the first the one compared) and the float64 ``oracle``:
    within lr x TRAIN_GRAD_RTOL of the gradient scale of ``refs[0]``, or
    no farther from the oracle than AR_HEADROOM times the farthest of
    ``refs``, each plus PAR_PARAM_ULPS float32 roundings of the
    parameter's own scale."""
    lr_sgd = PAR_SGD["params"]["lr"]
    eps = float(np.finfo(np.float32).eps)
    bad = {}
    for n, v in refs[0]["params"].items():
        ulps = PAR_PARAM_ULPS * eps * v.abs().max().item()
        p64 = oracle["params"][n]
        err = (got[n] - v).abs().max().item()
        room = lr_sgd * TRAIN_GRAD_RTOL * max(
            oracle["grads"][n].abs().max().item(), floor)
        resolution = max((r["params"][n] - p64).abs().max().item()
                         for r in refs)
        if (err > room + ulps and (got[n] - p64).abs().max().item()
                > AR_HEADROOM * resolution + ulps):
            bad[n] = err
    return bad


def parallel_step_held(lr, root, device: str = "cuda",
                       tiny: bool = False, check: bool = True,
                       meanwhile=None) -> dict:
    """Part 1 of phase ``parallel``: PAR_STEPS steps of the flagship, one
    process on the whole batch on the device (timed), then PAR_WORLD ranks
    over gloo sharing the device, each in its own process (timed); then,
    at once, each in processes of its own: the one-process steps on the
    CPU in float32 and in float64 (the oracle), ranks in float32 on the
    CPU, and ranks that run the steps with batch norm unsynced on the
    device (the planted control), then in float64 on the CPU.

    The checks: the float64 ranks hold the float64 one process within
    PAR_F64_RTOL (the decomposition is the global step, so the CPU's
    float32 ranks are a float32 run of it); the device's ranks hold the
    device's one process by the train step's rule (``judge_f32``, the
    float64 one process the oracle, the CPU's float32 one process and
    ranks ``also``: each float32 run cancels some gradients in front of
    training-mode batch norms exactly by the order of its sums, where
    another does not); the losses within
    TRAIN_LOSS_RTOL; both ranks end bitwise alike, each launching each
    LSTM kernel ``expected_per_step`` times a step; the planted control
    breaks the rule.  ``readings`` gives each float32 run's distance from
    the oracle on the tensors where the runs disagree most, and
    ``one_run_rule`` the judgement with the device's one process alone as
    the float32 run.  ``meanwhile``, a callable, runs while the references
    do (its result under ``meanwhile``).  Raises on a failed check
    (``check``); ``tiny`` and ``device="cpu"`` rehearse it on the CPU."""
    cfg, ss, state, batch = parallel_step_config(tiny)
    dev = torch.device(device)
    rows = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    one = parallel_steps(lr, rows, cfg, ss, state, dev)
    t0 = time.time()
    outs, procs = parallel_ranks(root, "rank", [("card", device, "float32",
                                                 False)], tiny)
    _wait(procs)
    ranks_s = time.time() - t0
    ranks = [torch.load(o, weights_only=False) for o in outs]
    card = [r["runs"]["card"] for r in ranks]
    t0 = time.time()
    outs, procs = parallel_ranks(root, "reference", [
        ("planted", device, "float32", True),
        ("cpu_f64", "cpu", "float64", False)], tiny)
    outs_f32, procs_f32 = parallel_ranks(root, "cpu_f32", [
        ("cpu_f32", "cpu", "float32", False)], tiny)
    one_outs = {dtype: Path(root) / f"one_{dtype}.pt"
                for dtype in ("float32", "float64")}
    procs += procs_f32 + [_spawn(
        f"import chip_smoke; chip_smoke.parallel_one({str(out)!r}, 'cpu', "
        f"{dtype!r}, {tiny})") for dtype, out in one_outs.items()]
    try:
        meanwhile_result = meanwhile() if meanwhile else None
    finally:
        _wait(procs, timeout=900.0)
    reference_s = time.time() - t0
    ref = {**torch.load(outs[0], weights_only=False)["runs"],
           **torch.load(outs_f32[0], weights_only=False)["runs"]}
    cpu_one, oracle = (torch.load(one_outs[d], weights_only=False)
                       for d in ("float32", "float64"))

    g64 = oracle["grads"]
    floor = GRAD_SCALE_FLOOR * max(g.abs().max().item() for g in g64.values())
    decomposition = {
        "grads": _scaled_err(ref["cpu_f64"]["grads"], g64, floor),
        "params": _scaled_err(ref["cpu_f64"]["params"], oracle["params"],
                              0.0)}
    refs = [one, cpu_one, ref["cpu_f32"]]
    also = [r["grads"] for r in refs[1:]]
    judged = judge_f32(card[0]["grads"], one["grads"], g64, also=also)
    worst = max(judged, key=lambda n: judged[n]["rel_of_scale"])
    by_oracle = sorted((n for n, v in judged.items()
                        if v["rel_of_scale"] >= TRAIN_GRAD_RTOL),
                       key=lambda n: -judged[n]["rel_of_scale"])
    param_bad = parallel_params_held(card[0]["params"], refs, oracle, floor)
    planted = judge_f32(ref["planted"]["grads"], one["grads"], g64,
                        also=also)
    planted_bad = sorted((n for n, v in planted.items() if not v["ok"]),
                         key=lambda n: -planted[n]["rel_of_scale"])
    one_run = judge_f32(card[0]["grads"], one["grads"], g64)
    runs = {"card_ranks": card[0], "card_one_process": one,
            "cpu_one_process": cpu_one, "cpu_ranks": ref["cpu_f32"]}
    readings = {n: {k: (r["grads"][n] - g64[n]).abs().max().item()
                    for k, r in runs.items()} for n in by_oracle[:6]}
    loss_rel = lambda got, want: max(  # noqa: E731
        abs(r["Loss"] - o["Loss"]) / abs(o["Loss"])
        for r, o in zip(got["metrics"], want["metrics"]))
    per_step = {n: [c["launches"][n] / PAR_STEPS for c in card]
                for n in TRAIN_COUNTERS}
    result = {
        "world": PAR_WORLD, "backend": ranks[0]["backend"], "tiny": tiny,
        "global_batch": [PAR_B, TRAIN_T], "lengths": list(PAR_LENGTHS),
        "steps": PAR_STEPS, "optimizer": PAR_SGD,
        "loss": [[m["Loss"] for m in c["metrics"]] for c in card],
        "loss_one_process": [m["Loss"] for m in one["metrics"]],
        "loss_float64": [m["Loss"] for m in oracle["metrics"]],
        "loss_rel_err": loss_rel(card[0], one),
        "float64_ranks_vs_one_process": decomposition,
        "grad_sum_max_rel_err": judged[worst]["rel_of_scale"],
        "worst_grad": worst, "params": len(judged),
        "judged_by_oracle": len(by_oracle),
        "failed": {n: v for n, v in judged.items() if not v["ok"]},
        "params_out_of_rule": param_bad,
        "readings": readings,
        "one_run_rule_failed": sorted(n for n, v in one_run.items()
                                      if not v["ok"]),
        "ranks_agree": all(torch.equal(card[0]["params"][n],
                                       card[1]["params"][n])
                           for n in judged),
        "planted_unsynced_bn": {
            "loss_rel_err": loss_rel(ref["planted"], one),
            "grads_failed": len(planted_bad),
            "worst": {n: planted[n] for n in planted_bad[:3]},
            "params_out_of_rule": len(parallel_params_held(
                ref["planted"]["params"], refs, oracle, floor))},
        "launches_per_step_by_rank": per_step,
        "expected_per_step": sum(train_lstm_shapes(cfg, TRAIN_T).values()),
        "one_process_launches_per_step": {
            n: v / PAR_STEPS for n, v in one["launches"].items()},
        "step_s_by_rank": [c["step_s"] for c in card],
        "one_process_step_s": one["step_s"], "ranks_wall_s": ranks_s,
        "references_wall_s": reference_s,
        "reference_step_s": {
            "cpu_one_process_f32": sum(cpu_one["step_s"]),
            "cpu_one_process_f64": sum(oracle["step_s"]),
            **{f"ranks_{k}": sum(ref[k]["step_s"]) for k in ref}},
        "meanwhile": meanwhile_result,
        "limits": {"loss_rtol": TRAIN_LOSS_RTOL,
                   "grad_rtol_of_max": TRAIN_GRAD_RTOL,
                   "grad_oracle_headroom": AR_HEADROOM,
                   "param_ulps": PAR_PARAM_ULPS,
                   "float64_rtol": PAR_F64_RTOL}}
    if not check:
        return result
    assert all(r["world_size"] == PAR_WORLD for r in ranks)
    assert max(decomposition.values()) < PAR_F64_RTOL, decomposition
    assert result["loss_rel_err"] < TRAIN_LOSS_RTOL, result["loss_rel_err"]
    assert not result["failed"], result["failed"]
    assert not param_bad, param_bad
    assert result["ranks_agree"]
    assert planted_bad, result["planted_unsynced_bn"]
    if dev.type == "cuda":
        for n in TRAIN_COUNTERS:
            assert per_step[n] == [result["expected_per_step"]] * PAR_WORLD, \
                per_step
    return result


def parallel_trainers(root, runs, device: str = "cuda",
                      tiny: bool = False) -> dict:
    """``train_multitrack_model`` for one epoch on PAR_CORPUS, ``runs``
    {name: (under a group of one rank, deterministic)}, each in its own
    process, all at once: {name: {file: bytes}} of their checkpoints and
    metrics, and the wall seconds."""
    corpus = write_corpus(Path(root) / "corpus", **PAR_CORPUS)
    procs = []
    for name, (group, deterministic) in runs.items():
        cfg_t = recipe_phase_config(
            "acoustic", corpus, Path(root) / name,
            **{"train.nepochs": 1, "train.use_amp": False})
        if tiny:
            cfg_t["model"] = flagship_acoustic_config(3, tiny=True)[0]
        path = Path(root) / f"{name}.json"
        path.write_text(json.dumps(cfg_t))
        port = _free_port() if group else 0
        procs.append(_spawn(
            f"import chip_smoke; chip_smoke.parallel_trainer({str(path)!r}, "
            f"{port}, {device!r}, {bool(deterministic)})"))
    t0 = time.time()
    _wait(procs)
    return {name: {f: (Path(root) / name / f).read_bytes()
                   for f in ("latest.ckpt", "metrics.jsonl")}
            for name in runs}, time.time() - t0


def parallel_trainers_held(root, device: str = "cuda",
                           tiny: bool = False) -> dict:
    """Part 2 of phase ``parallel``: the trainer with no group and under a
    group of one rank (NCCL on the card), both on torch's deterministic
    algorithms (``parallel_trainer``); their checkpoints and metrics must
    be bitwise equal."""
    files, wall = parallel_trainers(
        root, {"no_group": (False, True), "group": (True, True)}, device,
        tiny)
    result = {"backend": "nccl" if device == "cuda" else "gloo",
              "world": 1, "corpus": PAR_CORPUS, "deterministic": True,
              "bitwise": {f: files["group"][f] == files["no_group"][f]
                          for f in ("latest.ckpt", "metrics.jsonl")},
              "wall_s": wall}
    assert all(result["bitwise"].values()), result
    return result


def mesh_streams(engine, labels, mesh):
    """The flagship ensemble's fused (mgc, lf0, vuv, bap) under
    ``set_mesh(mesh)`` as host arrays, the lengths, and the forward's
    launches."""
    from ensemble_svs_with_interactions_tpu_torch.ops import (
        lstm_recurrence as lr,
    )

    N = len(labels)
    spk_ids, pairs = list(range(N)), [(i + 1) % N for i in range(N)]
    engine.set_mesh(mesh)
    try:
        dm = engine.predict_timing_multitrack_batch(
            [lab.copy() for lab in labels], spk_ids, pairs)
        feats, raw = engine._frame_features(dm)
        reset_launches(lr)
        out, lengths = engine.acoustic_model.inference_batch(
            feats, spks=(spk_ids, [spk_ids[p] for p in pairs]),
            sub_index=pairs, method="inference_main", device_out=True)
        launches = lr.lstm_recurrence.launches
        streams = engine._fused_postprocess(out, lengths, raw, "gv")
        host = [s.cpu().numpy() for s in streams]
    finally:
        engine.set_mesh(None)
    return host, list(lengths), launches


def parallel_serve(engine, labels, device: str = "cuda") -> dict:
    """Part 3 and 4 of phase ``parallel``: the 4-part ensemble under
    ``set_mesh(make_mesh())`` (every card; bitwise the one-device render
    on one) and over an explicit PAR_WORLD-entry mesh of cuda:0, the
    streams and int16 waveforms against ``set_mesh(None)``, launches per
    shard; one track's coded streams through
    ``synthesize_from_streams_time_sharded`` over PAR_WORLD shards of
    cuda:0 against the one-device synthesis with the same noise."""
    from ensemble_svs_with_interactions_tpu_torch.ops.world import (
        synthesize_from_streams,
        synthesize_from_streams_time_sharded,
    )
    from ensemble_svs_with_interactions_tpu_torch.parallel import make_mesh

    first = torch.device(device, 0) if device == "cuda" else \
        torch.device(device)
    meshes = {"none": None, "cards": make_mesh(device=device),
              "cuda0_x2": make_mesh(device=[first] * PAR_WORLD)}
    N = len(labels)
    streams, wavs, seconds, launches = {}, {}, {}, {}
    for name, mesh in meshes.items():
        streams[name], lengths, launches[name] = mesh_streams(engine, labels,
                                                              mesh)
        engine.set_mesh(mesh)
        try:
            engine.svs_ensemble([lab.copy() for lab in labels],
                                spk_ids=list(range(N)))   # warm
            t0 = time.perf_counter()
            wavs[name], _ = engine.svs_ensemble(
                [lab.copy() for lab in labels], spk_ids=list(range(N)))
            seconds[name] = time.perf_counter() - t0
        finally:
            engine.set_mesh(None)

    def stream_err(name):
        return max(float(np.abs(g[i, :n] - r[i, :n]).max())
                   for g, r in zip(streams[name], streams["none"])
                   for i, n in enumerate(lengths))

    def wav_held(name):
        out = []
        for g, r in zip(wavs[name], wavs["none"]):
            a, b = g.astype(np.float64) / 32767, r.astype(np.float64) / 32767
            out.append({"rms": float(np.sqrt(((a - b) ** 2).mean())),
                        "corr": float(np.corrcoef(a, b)[0, 1]),
                        "same_length": len(g) == len(r)})
        return out

    # one track's coded streams, time-sharded against one device
    n0 = lengths[0]
    track = [torch.from_numpy(s[0, :n0]).to(first)
             for s in streams["none"]]
    sr, fp = engine.sample_rate, engine.frame_period
    hop = int(sr * fp / 1000)
    syn = {}
    def sync():
        if first.type == "cuda":
            torch.cuda.synchronize(first)

    for name in ("one_device", "sharded", "one_device_2", "sharded_2"):
        sync()
        t0 = time.perf_counter()
        if name.startswith("one"):
            from ensemble_svs_with_interactions_tpu_torch import gen

            out = synthesize_from_streams(
                *(t[None] for t in track),
                gen.vocoder_noise(1, n0 * hop, first), sr, fp,
                highpass_cutoff=70.0)[0]
        else:
            out = synthesize_from_streams_time_sharded(
                *track, sr, fp, highpass_cutoff=70.0,
                mesh=meshes["cuda0_x2"])
        sync()
        syn[name] = (time.perf_counter() - t0, out.cpu().numpy())
    snr = snr_db(syn["one_device"][1], syn["sharded"][1])
    result = {
        "tracks": N, "meshes": {k: None if m is None else
                                [str(d) for d in m.devices]
                                for k, m in meshes.items()},
        "stream_max_abs_err": {k: stream_err(k) for k in ("cards",
                                                          "cuda0_x2")},
        "forward_launches": launches,
        "launches_per_shard": {k: launches[k] / (1 if m is None
                                                 else len(m.devices))
                               for k, m in meshes.items()},
        "svs_ensemble_s": seconds,
        "wav_bitwise_cards": all(np.array_equal(a, b) for a, b in
                                 zip(wavs["cards"], wavs["none"])),
        "wav_cuda0_x2": wav_held("cuda0_x2"),
        "sharded_synthesis": {
            "frames": int(n0), "seconds": int(n0) * fp / 1000, "snr_db": snr,
            "one_device_s": [syn["one_device"][0], syn["one_device_2"][0]],
            "sharded_s": [syn["sharded"][0], syn["sharded_2"][0]]},
        "limits": {"stream_atol": PAR_STREAM_ATOL, "wav_rms": PAR_WAV_RMS,
                   "wav_corr": PAR_WAV_CORR, "snr_db": SNR_DB}}
    if len(meshes["cards"].devices) == 1:
        assert result["stream_max_abs_err"]["cards"] == 0.0
        assert result["wav_bitwise_cards"]
    assert result["stream_max_abs_err"]["cuda0_x2"] < PAR_STREAM_ATOL, result
    for w in result["wav_cuda0_x2"]:
        assert w["same_length"] and w["rms"] < PAR_WAV_RMS, w
        assert w["corr"] > PAR_WAV_CORR, w
    # the acoustic forward's launches (all of an svs_ensemble call's),
    # once a shard
    assert launches["none"] == LAUNCHES_PER_CALL, launches
    assert launches["cuda0_x2"] == PAR_WORLD * LAUNCHES_PER_CALL, launches
    assert snr > SNR_DB, snr
    return result


def phase_parallel(lr, engine, labels) -> dict:
    """Phase ``parallel``: ``parallel_serve`` on ``engine`` (the flagship),
    then ``parallel_step_held`` with ``parallel_trainers_held`` run while
    its CPU references compute; a JSON line each.  Returns the launches
    of each kernel on the phase's paths."""
    t0 = time.time()
    with tempfile.TemporaryDirectory() as root:
        serve = parallel_serve(engine, labels)
        emit({"phase": "parallel_serve", **serve})
        train = parallel_step_held(
            lr, root, meanwhile=lambda: parallel_trainers_held(root))
        trainer = train.pop("meanwhile")
        emit({"phase": "parallel_step", **train})
    emit({"phase": "parallel", "trainer": trainer,
          "seconds": time.time() - t0})
    launches = {n: sum(train["launches_per_step_by_rank"][n]) * PAR_STEPS
                for n in TRAIN_COUNTERS}
    launches["lstm_recurrence"] += sum(serve["forward_launches"].values())
    return launches


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


def kernels_line(kernel_rows, single_rows, train_rows, slice_launches,
                 path_launches, train_launches, amp_launches,
                 trainer_launches, trainer_errs, recipe_launches,
                 single_recipe_launches, single_recipe_rows,
                 npss_launches, npss_rows, ar_launches, mel_launches,
                 mel_rows, multi_speaker_launches, multi_speaker_rows,
                 parallel_launches):
    """One entry per kernel.  ``launches`` counts the kernel's launches in
    the paths' runs (N_CALLS svs_ensemble calls; of the single-track voice
    N_CALLS svs calls, one svs_ensemble call and N_CALLS svs calls with the
    learned postfilter; N_CALLS flagship pairs; N_CALLS svs_ensemble calls
    of the diffusion voice; N_CALLS svs_ensemble calls, one svs call and
    one pair with the neural vocoder; one svs call of VOCODER_REF_LABELS
    labels with the vocoder ``vocoder_train`` trained; TRAIN_STEPS train
    steps of each
    train arm, float32 and AMP), by path under ``launches_by_path``
    (``path_launches`` gives the serving paths' besides svs_ensemble).  The recurrence's
    times, bound and yardstick are summed over one svs_ensemble call's
    launches (LAUNCHES_BY_HIDDEN at B = 4), with the same sums over one
    diffusion-voice call (DIFFUSION_LAUNCHES_BY_HIDDEN at B = 4) under
    ``diffusion_call``, over one single-track svs call (the same widths
    at B = 1) under ``svs_call`` and over one train step
    (TRAIN_LAUNCHES_BY_SHAPE, the want_c mode) under ``train_step``; the
    BPTT and dW_h kernels' are summed over one train
    step, the BPTT's with the part its gate pre-pass takes (``prepass_ms``,
    with its bound and its ``torch.addmm`` yardstick) and the bound of its
    reverse loop alone (``loop_bound_ms``).  All come from the kernel
    phases' rows; the recurrence's training-shape yardstick is cuDNN's
    forward, which gives no cell sequence.  The errors are the worst of
    the kernel phases' and of the trainer phases' holds at the trainers'
    shapes (``trainer_errs``, ``hold_trainer_kernels``).  The trainer
    phase's launches are under ``trainer``, the recipe's stages 3-5 and 7 +
    11 on its own corpus under ``recipe`` (``recipe_launches``), the
    single-track recipe's stages 3-9 under ``recipe_single``
    (``single_recipe_launches``), with each kernel's rows at that
    recipe's shapes under ``recipe_single_rows`` (``phase_recipe_single``;
    the errors of those rows count in ``max_abs_err``), and the NPSS AR
    voice's stages 5 and 7 under ``recipe_npss`` (``npss_launches``), with
    the H = 1024 rows at its shapes and the recipe's full batch under
    ``recipe_npss_rows`` (``phase_recipe_npss``; their errors count
    too), the AR option voices' stages 5 and 7 under ``ar_options``
    (``ar_launches``, ``phase_ar_options``), and the mel voice's svs calls and trainer run under
    ``mel_voice`` (``mel_launches``), with its rows (the forward at B = 1
    over the fixture at H = 64 and 128, the train step's shapes at B =
    4) under ``mel_voice_rows`` (``phase_mel_voice``; their errors count
    too), and the multi-speaker voice's trainer run and calls under
    ``multi_speaker`` (``multi_speaker_launches``), with its rows (the
    train step's new shapes at B = 4: H = 512 and 64) under
    ``multi_speaker_rows`` (``phase_multi_speaker``; their errors count
    too), and phase ``parallel``'s (its ranks' train steps, summed over
    the ranks, and for the forward also its sharded ensembles) under
    ``parallel``."""
    serving = {H: kernel_rows[(H, False)] for H in RECURRENCE_SHAPES}
    serve = _sum_rows(serving, LAUNCHES_BY_HIDDEN,
                      TIMES + ("library_input_gemm_ms",))
    single = {H: single_rows[(H, False)] for H in RECURRENCE_SHAPES}
    one = _sum_rows(single, LAUNCHES_BY_HIDDEN,
                    TIMES + ("library_input_gemm_ms",))
    one_bound = bound(one["bytes_ms"], one["operations_ms"])
    diff = _sum_rows({H: kernel_rows[(H, False)]
                      for H in DIFFUSION_LAUNCHES_BY_HIDDEN},
                     DIFFUSION_LAUNCHES_BY_HIDDEN,
                     TIMES + ("library_input_gemm_ms",))
    diff_bound = bound(diff["bytes_ms"], diff["operations_ms"])

    def train_sums(name, want_c=None, keys=TIMES):
        rows = {s: train_rows[name, *s, want_c]
                for s in TRAIN_LAUNCHES_BY_SHAPE}
        return _sum_rows(rows, TRAIN_LAUNCHES_BY_SHAPE, keys), rows

    def recipe_rows(name, rows=single_recipe_rows):
        keep = ("B", "T", "H", "kernel", "ms", "plain_ms", "bound_ms",
                "bound_by", "bound_fma_ms", "bound_3xtf32_ms", "library_ms",
                "library_input_gemm_ms", "library_tf32", "max_abs_err",
                "max_rel_err", "loop_mma_rows", "loop_bound_ms",
                "loop_bound_fma_ms", "loop_bound_3xtf32_ms", "prepass_ms",
                "prepass_bound_ms", "prepass_library_ms")
        return {k: {f: r[f] for f in keep if f in r}
                for k, r in rows.items() if r["name"] == name}

    def worst(name, key="max_abs_err"):
        return max([0.0] + [r[key] for r in [*single_recipe_rows.values(),
                                             *npss_rows.values(),
                                             *mel_rows.values(),
                                             *multi_speaker_rows.values()]
                            if r["name"] == name])

    fwd, _ = train_sums("lstm_recurrence", True)
    fwd_bound = bound(fwd["bytes_ms"], fwd["operations_ms"])
    bptt, bptt_rows = train_sums("lstm_bptt", keys=TIMES + (
        "library_input_gemm_ms", "loop_bound_ms") + PREPASS)
    dwh, dwh_rows = train_sums("lstm_dwh")
    rec_err = max(r["max_abs_err"] for r in list(kernel_rows.values())
                  + list(single_rows.values())
                  + [r for k, r in train_rows.items()
                     if k[0] == "lstm_recurrence"]
                  + [{"max_abs_err": trainer_errs[k]} for k in (
                      "lstm_recurrence", "lstm_recurrence_c")]
                  + [{"max_abs_err": worst("lstm_recurrence")}])
    per_step = TRAIN_LAUNCHES_PER_STEP
    paths = {name: {"train": train_launches[name],
                    "train_amp": amp_launches[name],
                    "trainer": trainer_launches[name],
                    "recipe": recipe_launches[name],
                    "recipe_single": single_recipe_launches[name],
                    "recipe_npss": npss_launches[name],
                    "ar_options": ar_launches[name],
                    "mel_voice": mel_launches[name],
                    "multi_speaker": multi_speaker_launches[name],
                    "parallel": parallel_launches[name]}
             for name in TRAIN_COUNTERS}
    paths["lstm_recurrence"]["svs_ensemble"] = slice_launches
    paths["lstm_recurrence"].update(path_launches)
    return {"kernels": [
        _entry("lstm_recurrence", "lstm_recurrence.cu", serve,
               replaces="ensemble_svs_with_interactions_tpu/ops/pallas_lstm.py:30",
               launches=sum(paths["lstm_recurrence"].values()),
               launches_by_path=paths["lstm_recurrence"],
               calls=N_CALLS, launches_per_call=slice_launches // N_CALLS,
               train_steps=TRAIN_STEPS, launches_per_step=per_step,
               max_abs_err=rec_err,
               kernel_by_shape={
                   **{f"svs_ensemble H={H}": serving[H]["kernel"]
                      for H in RECURRENCE_SHAPES},
                   **{f"svs B=1 H={H}": single[H]["kernel"]
                      for H in RECURRENCE_SHAPES},
                   **{f"svs_ensemble diffusion H={H}":
                      kernel_rows[(H, False)]["kernel"]
                      for H in DIFFUSION_LAUNCHES_BY_HIDDEN},
                   **{f"train H={H} T={T}":
                      train_rows["lstm_recurrence", H, T, True]["kernel"]
                      for H, T in TRAIN_LAUNCHES_BY_SHAPE}},
               library_input_gemm_ms=serve["library_input_gemm_ms"],
               diffusion_call={
                   "B": N_TRACKS, "ms": diff["ms"],
                   "plain_ms": diff["plain_ms"], "bound_ms": diff_bound[0],
                   "bound_by": diff_bound[1],
                   "library_ms": diff["library_ms"],
                   "library_input_gemm_ms": diff["library_input_gemm_ms"],
                   "launches_per_call": DIFFUSION_LAUNCHES_PER_CALL},
               svs_call={"B": 1, "ms": one["ms"], "plain_ms": one["plain_ms"],
                         "bound_ms": one_bound[0], "bound_by": one_bound[1],
                         "library_ms": one["library_ms"],
                         "library_input_gemm_ms":
                             one["library_input_gemm_ms"],
                         "launches_per_call": LAUNCHES_PER_CALL},
               train_step={"ms": fwd["ms"], "plain_ms": fwd["plain_ms"],
                           "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1],
                           "library_ms": fwd["library_ms"]},
               recipe_single_rows=recipe_rows("lstm_recurrence"),
               recipe_npss_rows=recipe_rows("lstm_recurrence", npss_rows),
               mel_voice_rows=recipe_rows("lstm_recurrence", mel_rows),
               multi_speaker_rows=recipe_rows("lstm_recurrence",
                                              multi_speaker_rows)),
        _entry("lstm_bptt", "lstm_bptt.cu", bptt,
               replaces="ensemble_svs_with_interactions_tpu/ops/pallas_lstm.py:139",
               launches=sum(paths["lstm_bptt"].values()),
               launches_by_path=paths["lstm_bptt"],
               calls=2 * TRAIN_STEPS,
               launches_per_step=per_step,
               max_abs_err=max([r["max_abs_err"] for r in bptt_rows.values()]
                               + [trainer_errs["lstm_bptt"],
                                  worst("lstm_bptt")]),
               library_input_gemm_ms=bptt["library_input_gemm_ms"],
               loop_bound_ms=bptt["loop_bound_ms"],
               recipe_single_rows=recipe_rows("lstm_bptt"),
               recipe_npss_rows=recipe_rows("lstm_bptt", npss_rows),
               mel_voice_rows=recipe_rows("lstm_bptt", mel_rows),
               multi_speaker_rows=recipe_rows("lstm_bptt",
                                              multi_speaker_rows),
               **{k: bptt[k] for k in PREPASS}),
        _entry("lstm_dwh", "lstm_bptt.cu", dwh,
               replaces="ensemble_svs_with_interactions_tpu/ops/pallas_lstm.py:139",
               launches=sum(paths["lstm_dwh"].values()),
               launches_by_path=paths["lstm_dwh"],
               calls=2 * TRAIN_STEPS,
               launches_per_step=per_step,
               max_abs_err=max(r["max_abs_err"] for r in dwh_rows.values()),
               max_rel_err=max([r["max_rel_err"] for r in dwh_rows.values()]
                               + [trainer_errs["lstm_dwh_rel"],
                                  worst("lstm_dwh", "max_rel_err")]),
               recipe_single_rows=recipe_rows("lstm_dwh"),
               recipe_npss_rows=recipe_rows("lstm_dwh", npss_rows),
               mel_voice_rows=recipe_rows("lstm_dwh", mel_rows),
               multi_speaker_rows=recipe_rows("lstm_dwh",
                                              multi_speaker_rows)),
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
    kernel_rows = phase_kernels(lr, shapes=sorted(
        set(RECURRENCE_SHAPES) | set(DIFFUSION_LAUNCHES_BY_HIDDEN)))
    train_rows = phase_train_kernels(lr)

    single_rows = phase_kernels(lr, B=1, modes=(False,), phase="kernel_b1")

    weights = random_state_dicts(flagship_phases()[1], SEED)
    labels = [hts.load(FIXTURE) for _ in range(N_TRACKS)]
    engine, launches = phase_slice(lr, weights, labels)
    phase_packed(engine, weights, labels)
    cpu = phase_reference(engine, weights, labels)
    pair_launches = phase_pairwise(lr, engine, cpu, labels[0])
    del cpu
    parallel_launches = phase_parallel(lr, engine, labels)
    del engine
    glob, phases = single_phases(postfilter=True)
    glob_mcep, phases_mcep = single_phases(bap_dim=MCEP_AP_DIM)
    with tempfile.TemporaryDirectory() as model_dir, \
            tempfile.TemporaryDirectory() as mcep_dir:
        t0 = time.time()
        pack_phases(model_dir, glob, phases,
                    random_state_dicts(phases, SEED))
        emit({"phase": "single_pack", "pack_s": time.time() - t0})
        engine, path_launches = phase_single(lr, model_dir, labels[0])
        cpu, short_run = phase_single_reference(engine, model_dir, labels[0])
        path_launches["svs_postfilter"] = phase_postfilter(
            lr, engine, cpu, labels[0], short_run)
        pack_phases(mcep_dir, glob_mcep, phases_mcep,
                    random_state_dicts(phases_mcep, SEED))
        phase_world_params(engine, mcep_dir, labels[0])
        path_launches.update(phase_surface(lr, engine, cpu, model_dir,
                                           labels[0]))
    del engine, cpu
    path_launches["pairwise"] = pair_launches
    path_launches.update(phase_importer(lr, labels[0]))
    with tempfile.TemporaryDirectory() as model_dir:
        engine, path_launches["svs_ensemble_diffusion"] = phase_diffusion(
            lr, model_dir, labels)
        phase_diffusion_reference(engine, model_dir, labels[0])
    del engine
    with tempfile.TemporaryDirectory() as model_dir, \
            tempfile.TemporaryDirectory() as single_dir:
        engine, voc_launches = phase_vocoder(lr, model_dir, single_dir,
                                             labels)
        path_launches.update(voc_launches)
        phase_vocoder_reference(engine, model_dir, labels[0])
    del engine
    path_launches.update(phase_vocoder_train(lr, labels[0]))
    phase_vocoder_train_reference()
    train_launches = phase_train(lr)
    f32_runs = phase_train_reference()
    amp_launches = phase_train_amp(lr)
    phase_train_amp_reference(f32_runs)
    phase_timing_train()
    trainer_launches, trainer_errs = phase_trainer(lr, labels[0])
    with tempfile.TemporaryDirectory() as root:
        work = phase_recipe_data(root)
        recipe_launches, recipe_errs = phase_recipe(lr, work)
    with tempfile.TemporaryDirectory() as root:
        single_launches, single_recipe_rows = phase_recipe_single(lr, root)
        npss_launches, npss_rows = phase_recipe_npss(lr, root)
        ar_launches = phase_ar_options(lr, root)
    mel_launches, mel_rows = phase_mel_voice(lr, labels[0])
    ms_launches, ms_rows = phase_multi_speaker(lr, labels[0])
    trainer_errs = {k: max(v, recipe_errs[k]) for k, v in trainer_errs.items()}
    emit(kernels_line(kernel_rows, single_rows, train_rows, launches,
                      path_launches, train_launches, amp_launches,
                      trainer_launches, trainer_errs, recipe_launches,
                      single_launches, single_recipe_rows, npss_launches,
                      npss_rows, ar_launches, mel_launches, mel_rows,
                      ms_launches, ms_rows, parallel_launches))
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
