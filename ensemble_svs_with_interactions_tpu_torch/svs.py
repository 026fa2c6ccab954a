"""The SVS engine: the counterpart of ``SPSVS`` in
``ensemble_svs_with_interactions_tpu/svs.py``.  ``svs`` renders one singer
with a single-track model: timing and acoustic models on the device, the
host postprocess (GV, merlin or the packed learned postfilter, stream
reconstruction, trajectory smoothing), the WORLD vocoder or the packed
neural vocoder on the device and the host's band-pass and normalization.
``svs_ensemble`` renders an N-part ensemble, over a multitrack
(cross-conditioned) model, the paper's flagship, or over a single-track
one, with the device-resident postprocess and WORLD vocoder where the
configuration allows, else the host postprocess.
``svs_streaming`` renders one singer phrase by phrase, yielding each
segment's waveform as soon as it is ready.
``predict_timing_multitrack`` and ``predict_acoustic_multitrack`` run one
pair of a multitrack model, as the recipe's synthesis stage
(``bin/synthesis_multitrack.py``) calls them.

``SPSVS(model_dir)`` opens a packed model directory, as written by the
JAX package's ``utils/packing.pack_model`` or the port's own
(``utils/packing.py``): ``config.yaml``, ``qst.hed``, per phase
``{phase}_model.yaml`` and flax-msgpack ``{phase}_model.params``, and the
scalers' ``.npy`` files; a learned postfilter as ``postfilter_model.*``
with ``out_postfilter_scaler_*``; a neural vocoder as ``vocoder_model.*``
with ``in_vocoder_scaler_*`` (:func:`load_vocoder`).  It reads them with
the port's own YAML and msgpack subsets (``utils/yaml_io.py``,
``utils/flax_msgpack.py``), so it needs neither ``yaml`` nor ``msgpack``,
and carries the flax variables into the port's modules with
``utils/flax_port.flax_to_torch``.

``SPSVS.from_parts`` builds the same engine in memory from the things
``pack_model`` takes, with the weights as torch state dicts.
"""

from __future__ import annotations

import inspect
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from ensemble_svs_with_interactions_tpu_torch import gen, gen_multitrack
from ensemble_svs_with_interactions_tpu_torch.io import hts
from ensemble_svs_with_interactions_tpu_torch.models.vocoders.usfgan import (
    USFGANWrapper,
    VocoderPack,
)
from ensemble_svs_with_interactions_tpu_torch.ops import device_post
from ensemble_svs_with_interactions_tpu_torch.ops.pitch import bandpass_filter
from ensemble_svs_with_interactions_tpu_torch.ops.world.synthesis import (
    quantize_peak_norm_int16,
    synthesize_from_streams,
)
from ensemble_svs_with_interactions_tpu_torch.utils import flax_msgpack
from ensemble_svs_with_interactions_tpu_torch.utils.config import (
    Config,
    instantiate,
    load_config,
    resolve_target,
)
from ensemble_svs_with_interactions_tpu_torch.utils.flax_port import (
    flax_to_torch,
)
from ensemble_svs_with_interactions_tpu_torch.utils.logger import getLogger
from ensemble_svs_with_interactions_tpu_torch.utils.scalers import (
    extract_static_scaler,
    load_minmax_scaler,
    load_standard_scaler,
)

# (phase, bucket) of the three models every engine holds
_PHASES = (("timelag", gen.PHONE_BUCKET), ("duration", gen.PHONE_BUCKET),
           ("acoustic", gen.FRAME_BUCKET))
_STAGES = ("timing", "acoustic", "postprocess_acoustic", "vocoder",
           "postprocess_waveform")
_VOCODER_TYPES = ("world", "pwg", "usfgan", "auto")
_POST_FILTER_TYPES = ("merlin", "nnsvs", "gv", "none", "off", None)


def build_model(phase: Dict, device, bucket: int) -> gen.ModelPack:
    """One phase's model: config -> module -> weights -> device."""
    cfg = Config(phase["model_config"])
    module = instantiate(dict(cfg["netG"]))
    module.load_state_dict(phase["state_dict"])
    return gen.ModelPack(module, cfg, bucket=bucket, device=device)


def build_vocoder(model_config: Dict, weights, in_scaler, sample_rate: int,
                  frame_period: float, device):
    """A neural vocoder from its packed config (``netG`` and, for the
    source-filter family, ``signal_types``, ``sine_amp``, ``noise_amp``,
    ``dense_factor``, ``sine_f0_type``) and ``weights``, a state dict or
    flax variables: (vocoder, in_scaler, vocoder type), as the JAX
    package's ``svs.load_vocoder`` returns them.  uSFGAN and SiFiGAN
    generators go into a :class:`USFGANWrapper` (type ``"usfgan"``), any
    other generator, which takes frame features alone (PWG, HiFiGAN), into
    a :class:`VocoderPack` (type ``"pwg"``)."""
    cfg = Config(model_config)
    net = dict(cfg["netG"])
    name = resolve_target(net["_target_"]).__name__
    hop = int(sample_rate * frame_period / 1000.0)
    source_filter = "USFGAN" in name or "SiFiGAN" in name
    if source_filter:
        signal_types = tuple(cfg.get(
            "signal_types", ["sine", "noise"] if "Hn" in name else ["sine"]))
        # the JAX generators take their excitation width from x: the
        # hn-uSFGAN pair splits it into [sine, noise]
        net["in_channels"] = len(signal_types) // (2 if "Hn" in name else 1)
    module = instantiate(net)
    if isinstance(weights, dict) and "params" in weights:
        flax_to_torch(module, weights)
    else:
        module.load_state_dict(weights)
    if not source_filter:
        return VocoderPack(module, device), in_scaler, "pwg"
    return USFGANWrapper(
        module, sample_rate=sample_rate, hop_size=hop,
        sine_amp=float(cfg.get("sine_amp", 0.1)),
        noise_amp=float(cfg.get("noise_amp", 0.003)),
        signal_types=signal_types,
        dense_factor=int(cfg.get("dense_factor", 4)),
        sine_f0_type=str(cfg.get("sine_f0_type", "contf0")),
        device=device), in_scaler, "usfgan"


def load_vocoder(model_dir, sample_rate: int, frame_period: float = 5.0,
                 device="cuda"):
    """The packed neural vocoder of ``model_dir`` (``vocoder_model.yaml``,
    ``vocoder_model.params`` and, where present,
    ``in_vocoder_scaler_{mean,var,scale}.npy``): :func:`build_vocoder`'s
    (vocoder, in_scaler, vocoder type)."""
    model_dir = Path(model_dir)
    in_scaler = None
    if (model_dir / "in_vocoder_scaler_mean.npy").exists():
        in_scaler = load_standard_scaler(model_dir / "in_vocoder_scaler")
    variables = flax_msgpack.from_bytes(
        (model_dir / "vocoder_model.params").read_bytes())
    return build_vocoder(load_config(model_dir / "vocoder_model.yaml"),
                         variables, in_scaler, sample_rate, frame_period,
                         device)


def _torch_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("SPSVS(device='cuda'): no CUDA device; pass "
                           "device='cpu' to run on the CPU")
    return device


class SPSVS:
    """Statistical-parametric SVS engine over a packed model directory.

    Args:
        model_dir: the packed directory (see the module docstring).
        verbose: logging level, as the JAX package's (``utils/logger``).
        device: where the models run; ``"cuda"`` unless asked otherwise.
    """

    def __init__(self, model_dir, verbose: int = 0, device="cuda"):
        device = _torch_device(device)
        self.model_dir = Path(model_dir)
        self._setup(load_config(self.model_dir / "config.yaml"),
                    self.model_dir / "qst.hed", device, verbose)
        for phase, bucket in _PHASES:
            setattr(self, f"{phase}_model", self._load_model(phase, bucket))
            setattr(self, f"in_{phase}_scaler",
                    self._load_minmax(f"in_{phase}"))
            setattr(self, f"out_{phase}_scaler",
                    self._load_standard(f"out_{phase}"))
        self.postfilter_model = self.postfilter_out_scaler = None
        if (self.model_dir / "postfilter_model.yaml").exists():
            self.postfilter_model = self._load_model("postfilter")
            self.postfilter_out_scaler = self._load_standard("out_postfilter")
        self._no_vocoder()
        if (self.model_dir / "vocoder_model.yaml").exists():
            (self.vocoder, self.vocoder_in_scaler,
             self.default_vocoder_type) = load_vocoder(
                self.model_dir, self.sample_rate, self.frame_period, device)
        self._finish()

    @classmethod
    def from_parts(cls, config: Dict, qst_path, phases: Dict[str, Dict],
                   device="cuda") -> "SPSVS":
        """The engine from in-memory parts: the global config (as
        ``pack_model``'s ``global_config``), the question set, and
        ``phases``: ``{"timelag" | "duration" | "acoustic":
        {"model_config", "state_dict", "in_scaler", "out_scaler"}}``, and
        optionally ``"postfilter"``: ``{"model_config", "state_dict",
        "out_scaler"}`` and ``"vocoder"``: ``{"model_config", "state_dict",
        "in_scaler"}``."""
        self = cls.__new__(cls)
        self.model_dir = None
        self._setup(Config(config), qst_path, _torch_device(device), 0)
        for phase, bucket in _PHASES:
            setattr(self, f"{phase}_model",
                    build_model(phases[phase], self.device, bucket))
            setattr(self, f"in_{phase}_scaler", phases[phase]["in_scaler"])
            setattr(self, f"out_{phase}_scaler", phases[phase]["out_scaler"])
        self.postfilter_model = self.postfilter_out_scaler = None
        if "postfilter" in phases:
            self.postfilter_model = build_model(
                phases["postfilter"], self.device, gen.FRAME_BUCKET)
            self.postfilter_out_scaler = phases["postfilter"]["out_scaler"]
        self._no_vocoder()
        if "vocoder" in phases:
            voc = phases["vocoder"]
            (self.vocoder, self.vocoder_in_scaler,
             self.default_vocoder_type) = build_vocoder(
                voc["model_config"], voc["state_dict"], voc.get("in_scaler"),
                self.sample_rate, self.frame_period, self.device)
        self._finish()
        return self

    def _no_vocoder(self):
        self.vocoder = self.vocoder_in_scaler = None
        self.default_vocoder_type = "world"

    def _setup(self, config: Config, qst_path, device: torch.device,
               verbose: int):
        self.logger = getLogger(verbose=verbose)
        self.device = device
        self.config = config
        self.feature_type = self.config.get("feature_type", "world")
        self.sample_rate = int(self.config.get("sample_rate", 48000))
        self.frame_period = float(self.config.get("frame_period", 5))
        self.spk_list = list(self.config.get("spk_list", []) or [])
        self.binary_dict, self.numeric_dict = hts.load_question_set(qst_path)
        self.pitch_idx = hts.get_pitch_index(self.binary_dict,
                                             self.numeric_dict)
        self.pitch_indices = hts.get_pitch_indices(self.binary_dict,
                                                   self.numeric_dict)

    def _finish(self):
        cfg = self.acoustic_model.config
        self.acoustic_out_static_scaler = extract_static_scaler(
            self.out_acoustic_scaler, cfg.stream_sizes,
            cfg.has_dynamic_features, cfg.num_windows)
        # a multitrack (cross-conditioned) acoustic netG takes x_main, as
        # the JAX package decides it
        self.is_multitrack = "x_main" in inspect.signature(
            self.acoustic_model.module.forward).parameters
        self._fused_cache = None
        self.last_stage_times = {}
        self.last_rtf = None

    # ------------------------------------------------------------- loading
    def _load_model(self, phase: str,
                    bucket: int = gen.FRAME_BUCKET) -> gen.ModelPack:
        """``{phase}_model.yaml`` -> module; ``{phase}_model.params`` (flax
        msgpack) -> its weights; then onto the device."""
        cfg = load_config(self.model_dir / f"{phase}_model.yaml")
        module = instantiate(dict(cfg["netG"]))
        variables = flax_msgpack.from_bytes(
            (self.model_dir / f"{phase}_model.params").read_bytes())
        flax_to_torch(module, variables)
        return gen.ModelPack(module, cfg, bucket=bucket, device=self.device)

    def _load_minmax(self, prefix: str):
        return load_minmax_scaler(self.model_dir / f"{prefix}_scaler")

    def _load_standard(self, prefix: str):
        return load_standard_scaler(self.model_dir / f"{prefix}_scaler")

    def set_device(self, device):
        """Move every model to ``device``; later calls run there.  (The
        JAX engine's ``set_device`` is a no-op: XLA places its arrays.)"""
        self.device = _torch_device(device)
        for pack in (self.timelag_model, self.duration_model,
                     self.acoustic_model, self.postfilter_model,
                     self.vocoder):
            if pack is not None:
                pack.to(self.device)
        self._fused_cache = None
        self.logger.info("set_device(%s)", self.device)
        return self

    def set_mesh(self, mesh):
        """Shard the batched timing, acoustic and postfilter calls (the
        ensemble's tracks or pairs) over the devices of ``mesh``
        (``parallel.make_mesh``), each model replicated on each device
        (``gen.ModelPack.set_mesh``); the postprocess and the vocoder run
        on the engine's device on the gathered rows.  ``None`` returns to
        the engine's one device."""
        for pack in (self.timelag_model, self.duration_model,
                     self.acoustic_model, self.postfilter_model):
            if pack is not None:
                pack.set_mesh(mesh)
        return self

    def __repr__(self):
        return (f"{type(self).__name__}(model_dir="
                f"{str(self.model_dir) if self.model_dir else None!r}, "
                f"sample_rate={self.sample_rate}, "
                f"feature_type={self.feature_type!r}, "
                f"vocoder={self.default_vocoder_type!r}, "
                f"device={str(self.device)!r})")

    # ------------------------------------------------------ config lookups
    def _force_clip(self, phase: str) -> bool:
        section = self.config.get(phase, {}) or {}
        return bool(section.get("force_clip_input_features", True))

    def _subphone_features(self) -> str:
        section = self.config.get("acoustic", {}) or {}
        return str(section.get("subphone_features", "coarse_coding"))

    def _log_f0_conditioning(self) -> bool:
        return bool(self.config.get("log_f0_conditioning", True))

    def _timelag_ranges(self):
        section = self.config.get("timelag", {}) or {}
        return (tuple(section.get("allowed_range", (-20, 20))),
                tuple(section.get("allowed_range_rest", (-40, 40))))

    def _validate_synthesis_args(self, vocoder_type, post_filter_type) -> str:
        """The lower-cased vocoder type, "auto" resolved to the pack's
        (``default_vocoder_type``); unknown names raise ValueError."""
        vocoder_type = str(vocoder_type).lower()
        if vocoder_type not in _VOCODER_TYPES:
            raise ValueError(f"Unknown vocoder type: {vocoder_type}")
        if post_filter_type not in _POST_FILTER_TYPES:
            raise ValueError(f"Unknown post-filter type: {post_filter_type}")
        if vocoder_type == "auto":
            return self.default_vocoder_type
        return vocoder_type

    # ------------------------------------------------------------- stages
    def predict_timelag(self, labels):
        """Note-onset time-lags: (in 100 ns units, in frames)."""
        return gen.predict_timelag(
            labels.copy(), self.timelag_model, self.in_timelag_scaler,
            self.out_timelag_scaler, self.binary_dict, self.numeric_dict,
            pitch_indices=self.pitch_indices,
            log_f0_conditioning=self._log_f0_conditioning(),
            allowed_range=self._timelag_ranges()[0],
            allowed_range_rest=self._timelag_ranges()[1],
            force_clip_input_features=self._force_clip("timelag"),
            frame_period=self.frame_period)

    def predict_duration(self, labels):
        """Per-phone durations in frames (``(mu, sigma_sq)`` for MDN)."""
        return gen.predict_duration(
            labels.copy(), self.duration_model, self.in_duration_scaler,
            self.out_duration_scaler, self.binary_dict, self.numeric_dict,
            pitch_indices=self.pitch_indices,
            log_f0_conditioning=self._log_f0_conditioning(),
            force_clip_input_features=self._force_clip("duration"))

    def postprocess_duration(self, labels, pred_durations, lag):
        """The duration-modified labels (note-level normalization)."""
        return gen.postprocess_duration(labels, pred_durations, lag,
                                        frame_period=self.frame_period)[0]

    def _timing_kw(self):
        return dict(
            log_f0_conditioning=self._log_f0_conditioning(),
            allowed_range=self._timelag_ranges()[0],
            allowed_range_rest=self._timelag_ranges()[1],
            force_clip_input_features=self._force_clip("timelag"),
            force_clip_input_features_duration=self._force_clip("duration"),
            frame_period=self.frame_period)

    def _timing_models(self):
        return (self.binary_dict, self.numeric_dict, self.timelag_model,
                self.in_timelag_scaler, self.out_timelag_scaler,
                self.duration_model, self.in_duration_scaler,
                self.out_duration_scaler)

    def predict_timing(self, labels):
        """The duration-modified labels of one track."""
        return gen.predict_timing(labels.copy(), *self._timing_models(),
                                  **self._timing_kw())[0]

    def predict_timing_batch(self, labels_list):
        """Duration-modified labels of N independent tracks (each timing
        model runs once over the batch)."""
        return gen.predict_timing_batch([lab.copy() for lab in labels_list],
                                        *self._timing_models(),
                                        **self._timing_kw())

    def predict_timing_multitrack_batch(self, labels_list, spk_ids, pairs):
        """Duration-modified labels of every track (pairwise timing)."""
        return gen_multitrack.predict_timing_multitrack_batch(
            [lab.copy() for lab in labels_list], spk_ids, pairs,
            *self._timing_models(), **self._timing_kw())

    def predict_timing_multitrack(self, labels_list, spks_list, **kw):
        """One pair's timing, the main track (``labels_list[0]``)
        conditioned on the sub track: (duration-modified labels, lag in
        frames, cumulative normalized durations, the main track's note
        mask).  The caller's labels are left as they are."""
        return gen_multitrack.predict_timing_multitrack(
            [lab.copy() for lab in labels_list], spks_list,
            *self._timing_models(), **{**self._timing_kw(), **kw})

    def predict_acoustic_multitrack(self, labels_list, spks_list,
                                    f0_shift_in_cent: float = 0):
        """Denormalized acoustic features (T, D) of one pair's main track
        (``labels_list[0]``, duration-modified), conditioned on the sub
        track."""
        return gen_multitrack.predict_acoustic_multitrack(
            labels_list, spks_list, self.acoustic_model,
            self.in_acoustic_scaler, self.out_acoustic_scaler,
            self.binary_dict, self.numeric_dict,
            subphone_features=self._subphone_features(),
            log_f0_conditioning=self._log_f0_conditioning(),
            force_clip_input_features=self._force_clip("acoustic"),
            frame_period=self.frame_period, f0_shift_in_cent=f0_shift_in_cent)

    def predict_acoustic(self, duration_modified_labels,
                         f0_shift_in_cent: float = 0):
        """Denormalized acoustic features (T, D) on the host."""
        return gen.predict_acoustic(
            duration_modified_labels, self.acoustic_model,
            self.in_acoustic_scaler, self.out_acoustic_scaler,
            self.binary_dict, self.numeric_dict,
            subphone_features=self._subphone_features(),
            log_f0_conditioning=self._log_f0_conditioning(),
            force_clip_input_features=self._force_clip("acoustic"),
            frame_period=self.frame_period, f0_shift_in_cent=f0_shift_in_cent)

    def postprocess_acoustic(self, acoustic_features,
                             duration_modified_labels, **kw):
        """Host (mgc, lf0, vuv, bap); ``kw`` as
        ``gen.postprocess_acoustic``'s."""
        return gen.postprocess_acoustic(
            acoustic_features, duration_modified_labels, self.binary_dict,
            self.numeric_dict, self.acoustic_model.config,
            self.acoustic_out_static_scaler,
            postfilter_model=self.postfilter_model,
            postfilter_out_scaler=self.postfilter_out_scaler,
            sample_rate=self.sample_rate,
            frame_period=self.frame_period,
            relative_f0=self.config.get("relative_f0", False),
            feature_type=self.feature_type, **kw)

    def predict_waveform(self, multistream_features, vocoder_type="world",
                         **kw):
        """A float waveform from host streams, synthesized on the engine's
        device: WORLD, or the packed neural vocoder (``"pwg"``,
        ``"usfgan"``; ``"auto"`` is the pack's type)."""
        if vocoder_type == "auto":
            vocoder_type = self.default_vocoder_type
        if vocoder_type in ("pwg", "usfgan"):
            kw.setdefault("vocoder", self.vocoder)
            kw.setdefault("vocoder_in_scaler", self.vocoder_in_scaler)
        return gen.predict_waveform(
            multistream_features, sample_rate=self.sample_rate,
            frame_period=self.frame_period,
            use_world_codec=self.config.get("use_world_codec", True),
            feature_type=self.feature_type, vocoder_type=vocoder_type,
            device=self.device, **kw)

    def postprocess_waveform(self, wav, **kw):
        return gen.postprocess_waveform(wav, self.sample_rate, **kw)

    @torch.no_grad()
    def svs(self, labels, vocoder_type: str = "world",
            post_filter_type: str = "gv", trajectory_smoothing: bool = True,
            trajectory_smoothing_cutoff: float = 50,
            trajectory_smoothing_cutoff_f0: float = 20,
            vuv_threshold: float = 0.5, style_shift: float = 0,
            force_fix_vuv: bool = False, fill_silence_to_rest: bool = False,
            dtype=np.int16, peak_norm: bool = False,
            loudness_norm: bool = False, target_loudness: float = -20,
            segmented_synthesis: bool = False):
        """Score labels to waveform with a single-track model: (wav,
        sample_rate).  The signature and defaults are the JAX package's.
        ``segmented_synthesis`` renders each segment of the timed labels
        (split at rests, ``io/hts.segment_labels``) on its own and joins
        them.  ``last_rtf`` gets the call's real-time factor and
        ``last_stage_times`` its seconds by stage (summed over segments;
        each stage ends on a host copy, so each is a blocked time).  A
        multitrack pack raises ValueError: it renders through
        :meth:`svs_ensemble`."""
        vocoder_type = self._validate_synthesis_args(vocoder_type,
                                                     post_filter_type)
        if self.is_multitrack:
            raise ValueError(
                "this pack holds a multitrack (cross-conditioned) model; "
                "use svs_ensemble(labels_list, spk_ids=...) instead")
        times = dict.fromkeys(_STAGES, 0.0)
        start = time.time()
        duration_modified_labels = self.predict_timing(labels)
        times["timing"] = time.time() - start
        segments = (hts.segment_labels(duration_modified_labels)
                    if segmented_synthesis else [duration_modified_labels])
        hts_frame_shift = int(self.frame_period * 1e4)
        wavs = []
        for seg in segments:
            seg.frame_shift = hts_frame_shift
            t0 = time.time()
            acoustic = self.predict_acoustic(
                seg, f0_shift_in_cent=style_shift * 100)
            t1 = time.time()
            streams = self.postprocess_acoustic(
                acoustic, seg, post_filter_type=post_filter_type,
                trajectory_smoothing=trajectory_smoothing,
                trajectory_smoothing_cutoff=trajectory_smoothing_cutoff,
                trajectory_smoothing_cutoff_f0=trajectory_smoothing_cutoff_f0,
                force_fix_vuv=force_fix_vuv,
                fill_silence_to_rest=fill_silence_to_rest,
                f0_shift_in_cent=-style_shift * 100)
            t2 = time.time()
            wavs.append(self.predict_waveform(
                streams, vocoder_type=vocoder_type,
                vuv_threshold=vuv_threshold))
            t3 = time.time()
            times["acoustic"] += t1 - t0
            times["postprocess_acoustic"] += t2 - t1
            times["vocoder"] += t3 - t2
        t0 = time.time()
        wav = self.postprocess_waveform(
            np.concatenate(wavs).reshape(-1), dtype=dtype,
            peak_norm=peak_norm, loudness_norm=loudness_norm,
            target_loudness=target_loudness)
        end = time.time()
        times["postprocess_waveform"] = end - t0
        self.last_stage_times = times
        self.last_rtf = (end - start) / (len(wav) / self.sample_rate)
        self.logger.info("svs: %d segment(s), total %.3f s, RTF %.4f (%s)",
                         len(segments), end - start, self.last_rtf,
                         ", ".join(f"{k} {v:.3f}s" for k, v in times.items()))
        return wav, self.sample_rate

    def svs_streaming(self, labels, vocoder_type: str = "world",
                      post_filter_type: str = "gv",
                      trajectory_smoothing: bool = True,
                      trajectory_smoothing_cutoff: float = 50,
                      trajectory_smoothing_cutoff_f0: float = 20,
                      vuv_threshold: float = 0.5, style_shift: float = 0,
                      force_fix_vuv: bool = False,
                      fill_silence_to_rest: bool = False,
                      dtype=np.float32, gain: float = 1.0,
                      pipeline_depth: int = 2):
        """Phrase-streamed synthesis: a generator yielding one waveform
        chunk per rest-delimited segment of the timed labels
        (``io/hts.segment_labels``), in order, as soon as it is rendered.
        The signature and defaults are the JAX package's.

        Each segment goes through ``svs(segmented_synthesis=True)``'s chain
        (acoustic, host postprocess, vocoder), then its own 70 Hz
        band-pass, times ``gain``; ``dtype=np.int16`` clips at full scale.
        There is no whole-song peak or loudness normalization: use
        ``svs()`` for mastered output.  Segments render ``pipeline_depth``
        deep on worker threads; every draw comes from a generator made per
        call, so the chunks do not depend on the depth.  The threads share
        the card's current stream, so their kernels run one after another:
        the pipeline overlaps host work only.  A multitrack pack raises
        ValueError, as in JAX."""
        vocoder_type = self._validate_synthesis_args(vocoder_type,
                                                     post_filter_type)
        if self.is_multitrack:
            raise ValueError(
                "this pack holds a multitrack (cross-conditioned) model; "
                "streaming is single-track (use svs_ensemble for pairs)")
        duration_modified_labels = self.predict_timing(labels)
        segments = hts.segment_labels(duration_modified_labels)
        hts_frame_shift = int(self.frame_period * 1e4)

        def _render(seg):
            seg.frame_shift = hts_frame_shift
            acoustic = self.predict_acoustic(
                seg, f0_shift_in_cent=style_shift * 100)
            streams = self.postprocess_acoustic(
                acoustic, seg, post_filter_type=post_filter_type,
                trajectory_smoothing=trajectory_smoothing,
                trajectory_smoothing_cutoff=trajectory_smoothing_cutoff,
                trajectory_smoothing_cutoff_f0=trajectory_smoothing_cutoff_f0,
                force_fix_vuv=force_fix_vuv,
                fill_silence_to_rest=fill_silence_to_rest,
                f0_shift_in_cent=-style_shift * 100)
            wav = self.predict_waveform(streams, vocoder_type=vocoder_type,
                                        vuv_threshold=vuv_threshold)
            chunk = np.asarray(bandpass_filter(
                np.asarray(wav, np.float64).reshape(-1),
                self.sample_rate)) * gain
            if dtype in (np.int16, "int16"):
                return (np.clip(chunk, -1.0, 1.0) * 32767.0).astype(np.int16)
            return chunk.astype(dtype) if dtype is not None else chunk

        depth = max(pipeline_depth, 1)
        with ThreadPoolExecutor(max_workers=depth) as ex:
            pending = deque(ex.submit(_render, seg)
                            for seg in segments[:depth])
            for seg in segments[depth:]:
                done = pending.popleft()
                pending.append(ex.submit(_render, seg))
                yield done.result()
            while pending:
                yield pending.popleft().result()

    def _frame_features(self, duration_modified):
        """Per-track frame-level features (threaded host work): (normalized
        model inputs, raw features reused by the postprocess)."""
        hts_frame_shift = int(self.frame_period * 1e4)
        for lab in duration_modified:
            lab.frame_shift = hts_frame_shift
        force_clip = self._force_clip("acoustic")
        subphone = self._subphone_features()
        log_f0 = self._log_f0_conditioning()

        def _feat(lab):
            return gen._prepare_linguistic_features(
                lab, self.binary_dict, self.numeric_dict,
                self.in_acoustic_scaler, self.pitch_indices, True, subphone,
                log_f0, force_clip, hts_frame_shift, return_raw=True)

        with ThreadPoolExecutor(max_workers=len(duration_modified)) as ex:
            pairs = list(ex.map(_feat, duration_modified))
        return [p[0] for p in pairs], [p[1] for p in pairs]

    def _fused_post_ok(self, post_filter_type, lengths) -> bool:
        """The device postprocess covers static WORLD streams with coded
        band aperiodicity, GV or no postfilter, absolute F0, and tracks
        longer than the filtfilt padding; other configurations take the
        host postprocess."""
        cfg = self.acoustic_model.config
        ss = list(cfg.stream_sizes)
        return (
            self.config.get("use_world_codec", True)
            and self.feature_type == "world"
            and post_filter_type in ("gv", "off", "none", None)
            and len(ss) == 4 and int(ss[3]) <= 5
            and not any(cfg.has_dynamic_features)
            and not self.config.get("relative_f0", False)
            and min(lengths) > 18
        )

    def _fused_assets(self):
        if self._fused_cache is None:
            cfg = self.acoustic_model.config
            ss = [int(s) for s in cfg.stream_sizes]
            a, b = device_post.scaler_affine(self.out_acoustic_scaler,
                                             sum(ss))
            gv = np.asarray(self.acoustic_out_static_scaler.var_).reshape(
                -1)[: ss[0]].astype(np.float32)
            modfs = int(1 / (self.frame_period * 0.001))
            fb, fa, fzi = device_post.filtfilt_coeffs(
                [50.0] * ss[0] + [50.0] * ss[3] + [20.0], modfs)
            self._fused_cache = tuple(
                torch.from_numpy(v).to(self.device)
                for v in (a, b, gv, fb, fa, fzi))
        return self._fused_cache

    def _fused_postprocess(self, out_dev, lengths, raw_feats,
                           post_filter_type):
        """(N, T_pad, D) normalized predictions -> device (mgc, lf0, vuv,
        bap) streams."""
        a, b, gv, fb, fa, fzi = self._fused_assets()
        N, T_pad = out_dev.shape[0], out_dev.shape[1]
        note_mask = np.zeros((N, T_pad), bool)
        for i, raw in enumerate(raw_feats):
            idx = hts.get_note_frame_indices(self.binary_dict,
                                             self.numeric_dict, raw)
            note_mask[i, idx[idx < lengths[i]]] = True
        return device_post.fused_world_postprocess(
            out_dev, torch.as_tensor(np.asarray(lengths, np.int64),
                                     device=self.device),
            torch.from_numpy(note_mask).to(self.device), a, b, gv, fb, fa,
            fzi,
            stream_sizes=tuple(int(s) for s in
                               self.acoustic_model.config.stream_sizes),
            apply_gv=post_filter_type == "gv")

    def _postprocess_batch(self, duration_modified, acoustics,
                           post_filter_type, raw_feats):
        """The host postprocess of each track (threaded; a learned
        postfilter draws each call's noise from a generator of its own, so
        the result does not depend on the threads' order)."""
        def _post(item):
            lab, acoustic, raw = item
            return self.postprocess_acoustic(
                acoustic, lab, post_filter_type=post_filter_type,
                linguistic_features=raw)

        with ThreadPoolExecutor(max_workers=len(duration_modified)) as ex:
            return list(ex.map(_post, zip(duration_modified, acoustics,
                                          raw_feats)))

    def _coded(self, streams_list) -> bool:
        """Coded WORLD streams (the codec on, band aperiodicity), which the
        batched coded-stream vocoder takes."""
        return (self.feature_type == "world"
                and self.config.get("use_world_codec", True)
                and streams_list[0][3].shape[-1] <= 5)

    def _stream_batch(self, streams_list):
        """Host coded (mgc, lf0, vuv, bap) per track -> device (N, T_pad, D)
        stream batch, each padded as ``gen.predict_waveform`` pads, and the
        lengths."""
        lengths = [len(s[1]) for s in streams_list]
        T_pad = gen._round_up(max(lengths), gen.FRAME_BUCKET)
        padded = [gen.pad_streams(s, T_pad) for s in streams_list]
        return [torch.from_numpy(np.stack([p[k] for p in padded])).to(
            self.device) for k in range(4)], lengths

    def _vocoder(self, streams_dev, lengths, vuv_threshold, dtype):
        """Coded streams -> per-track waveforms on the host, with the 70 Hz
        high-pass in the synthesis: int16 peak-normalized and quantized on
        the device, other dtypes through ``postprocess_waveform`` with the
        band-pass skipped.  The noise is :func:`gen.vocoder_noise`."""
        hop = int(self.sample_rate * self.frame_period / 1000)
        mgc, lf0, vuv, bap = streams_dev
        N, T_pad = lf0.shape[0], lf0.shape[1]
        sample_lengths = np.asarray(lengths, np.int64) * hop
        wav = synthesize_from_streams(
            mgc, lf0, vuv, bap, gen.vocoder_noise(N, T_pad * hop, self.device),
            self.sample_rate, self.frame_period,
            vuv_threshold=vuv_threshold, highpass_cutoff=70.0)
        wav = wav[:, : int(sample_lengths.max())]
        want_int16 = dtype in (np.int16, "int16")
        if want_int16:
            wav = quantize_peak_norm_int16(
                wav, torch.as_tensor(sample_lengths, device=self.device))
        self._sync()
        self._t_vocoder_device_done = time.time()
        host = wav.cpu().numpy()
        if want_int16:
            return [host[i, : sample_lengths[i]] for i in range(N)]
        return [self.postprocess_waveform(host[i, : sample_lengths[i]],
                                          dtype=dtype, skip_bandpass=True)
                for i in range(N)]

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.no_grad()
    def svs_ensemble(self, labels_list, vocoder_type: str = "world",
                     post_filter_type: str = "gv",
                     vuv_threshold: float = 0.5, dtype=np.int16,
                     spk_ids=None, pairs=None,
                     blocked_stage_times: bool = False):
        """Synthesize an N-part ensemble.  Over a multitrack pack every
        track is the MAIN track of one pair, conditioned on a sub track
        (``pairs[i]``, default the next track in a ring), and all N pairs
        run through the joint timing and acoustic models as single
        (N, T, D) batches.  Over a single-track pack the N independent
        tracks run as such batches (``spk_ids`` and ``pairs`` unused).

        The signature is the JAX package's.  The postprocess runs on the
        device where ``_fused_post_ok`` allows, else on the host.  A neural
        vocoder (``vocoder_type`` ``"pwg"`` or ``"usfgan"``, or ``"auto"``
        over a pack with one) renders each track on its own after the host
        postprocess, then ``postprocess_waveform``, as the JAX engine
        does.
        ``last_stage_times`` gets its keys; ``*_dispatch`` stages are
        enqueue times on the device path (the device wait lands in the
        vocoder), and ``blocked_stage_times=True`` synchronizes after its
        acoustic and postprocess stages to add ``*_blocked`` attributions.
        int16 is peak-normalized and quantized on the device; other dtypes
        go through ``postprocess_waveform`` with the band-pass skipped (the
        vocoder applied its high-pass).  Returns (list of wavs,
        sample_rate).
        """
        vocoder_type = self._validate_synthesis_args(vocoder_type,
                                                     post_filter_type)
        start = time.time()
        N = len(labels_list)
        if self.is_multitrack:
            if spk_ids is None:
                spk_ids = list(range(N))
            if pairs is None:
                pairs = [(i + 1) % N for i in range(N)]
            duration_modified = self.predict_timing_multitrack_batch(
                labels_list, spk_ids, pairs)
            infer = {"spks": ([spk_ids[i] for i in range(N)],
                              [spk_ids[pairs[i]] for i in range(N)]),
                     "sub_index": pairs, "method": "inference_main"}
        else:
            duration_modified = self.predict_timing_batch(labels_list)
            infer = {}
        t_timing_device = time.time()
        feats, raw_feats = self._frame_features(duration_modified)
        t_timing = time.time()
        lengths = [len(f) for f in feats]
        blocked = {}
        # the device postprocess feeds WORLD only
        if (vocoder_type == "world"
                and self._fused_post_ok(post_filter_type, lengths)):
            out_dev, lengths = self.acoustic_model.inference_batch(
                feats, device_out=True, **infer)
            t_acoustic = time.time()
            if blocked_stage_times:
                self._sync()
                t_acoustic_blocked = time.time()
            streams_dev = self._fused_postprocess(out_dev, lengths, raw_feats,
                                                  post_filter_type)
            t_post = time.time()
            if blocked_stage_times:
                self._sync()
                t_post_blocked = time.time()
                blocked = {
                    "acoustic_blocked": t_acoustic_blocked - t_timing,
                    "postproc_dispatch": t_post - t_acoustic_blocked,
                    "postproc_blocked": t_post_blocked - t_acoustic_blocked,
                }
        else:
            preds = self.acoustic_model.inference_batch(feats, **infer)
            t_acoustic = time.time()
            acoustics = [gen._denorm_and_mlpg(
                p, self.out_acoustic_scaler, self.acoustic_model.config,
                gen._is_probabilistic(self.acoustic_model)) for p in preds]
            streams_list = self._postprocess_batch(
                duration_modified, acoustics, post_filter_type, raw_feats)
            t_post = time.time()
            streams_dev = None
            if vocoder_type == "world" and self._coded(streams_list):
                streams_dev, lengths = self._stream_batch(streams_list)
        t_voc = t_post_blocked if blocked else t_post
        if streams_dev is not None:
            outs = self._vocoder(streams_dev, lengths, vuv_threshold, dtype)
        else:
            # a neural vocoder, or uncoded WORLD features (through
            # gen_world_params and synthesize): each track on its own, then
            # the band-pass, as the JAX engine renders them
            outs = [self.postprocess_waveform(
                self.predict_waveform(s, vocoder_type=vocoder_type,
                                      vuv_threshold=vuv_threshold),
                dtype=dtype) for s in streams_list]
            self._t_vocoder_device_done = time.time()
        t_end = time.time()

        self.last_stage_times = {
            "timing_feats": t_timing - start,
            "acoustic_dispatch": t_acoustic - t_timing,
            "postproc_dispatch": t_post - t_acoustic,
            "vocoder": t_end - t_voc,
            "timing_models": t_timing_device - start,
            "frame_feats": t_timing - t_timing_device,
            "vocoder_device": self._t_vocoder_device_done - t_voc,
            "vocoder_d2h": t_end - self._t_vocoder_device_done,
            **blocked,
        }
        audio_s = max(len(w) for w in outs) / self.sample_rate
        self.last_rtf = (t_end - start) / audio_s
        self.logger.info(
            "ensemble: %d parts, %.2f s audio, total %.3f s, RTF %.4f (%s)",
            N, audio_s, t_end - start, self.last_rtf,
            ", ".join(f"{k} {v:.3f}s" for k, v in
                      self.last_stage_times.items()))
        return outs, self.sample_rate
