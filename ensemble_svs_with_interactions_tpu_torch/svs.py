"""The ensemble SVS engine: the counterpart of ``SPSVS`` in
``ensemble_svs_with_interactions_tpu/svs.py`` for the paper's flagship
path, ``svs_ensemble`` over a multitrack (cross-conditioned) model with the
device-resident postprocess and WORLD vocoder.

``SPSVS(model_dir)`` opens a packed model directory, as written by the
JAX package's ``utils/packing.pack_model`` or the port's own
(``utils/packing.py``): ``config.yaml``, ``qst.hed``, per phase
``{phase}_model.yaml`` and flax-msgpack ``{phase}_model.params``, and the
scalers' ``.npy`` files.  It reads them with the port's own YAML and
msgpack subsets (``utils/yaml_io.py``, ``utils/flax_msgpack.py``), so it
needs neither ``yaml`` nor ``msgpack``, and carries the flax variables
into the port's modules with ``utils/flax_port.flax_to_torch``.

``SPSVS.from_parts`` builds the same engine in memory from the things
``pack_model`` takes, with the weights as torch state dicts.
"""

from __future__ import annotations

import inspect
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from ensemble_svs_with_interactions_tpu_torch import gen, gen_multitrack
from ensemble_svs_with_interactions_tpu_torch.io import hts
from ensemble_svs_with_interactions_tpu_torch.ops import device_post
from ensemble_svs_with_interactions_tpu_torch.ops.world.synthesis import (
    quantize_peak_norm_int16,
    synthesize_from_streams,
)
from ensemble_svs_with_interactions_tpu_torch.utils import flax_msgpack
from ensemble_svs_with_interactions_tpu_torch.utils.config import (
    Config,
    instantiate,
    load_config,
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
# packed parts the JAX package loads and the port does not have yet
_UNPORTED = {"postfilter": "ensemble_svs_with_interactions_tpu/models/"
                           "postfilters.py",
             "vocoder": "ensemble_svs_with_interactions_tpu/models/vocoders/"}
_VOCODER_TYPES = ("world", "pwg", "usfgan", "auto")
_POST_FILTER_TYPES = ("merlin", "nnsvs", "gv", "none", "off", None)


def build_model(phase: Dict, device, bucket: int) -> gen.ModelPack:
    """One phase's model: config -> module -> weights -> device."""
    cfg = Config(phase["model_config"])
    module = instantiate(dict(cfg["netG"]))
    module.load_state_dict(phase["state_dict"])
    return gen.ModelPack(module, cfg, bucket=bucket, device=device)


def _torch_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("SPSVS(device='cuda'): no CUDA device; pass "
                           "device='cpu' to run on the CPU")
    return device


class SPSVS:
    """Statistical-parametric SVS engine (multitrack ensemble path) over a
    packed model directory.

    Args:
        model_dir: the packed directory (see the module docstring).  A
            ``postfilter_model.yaml`` or ``vocoder_model.yaml`` in it raises
            ``NotImplementedError``: those models are not ported.
        verbose: logging level, as the JAX package's (``utils/logger``).
        device: where the models run; ``"cuda"`` unless asked otherwise.
    """

    def __init__(self, model_dir, verbose: int = 0, device="cuda"):
        device = _torch_device(device)
        self.model_dir = Path(model_dir)
        for part, module in _UNPORTED.items():
            if (self.model_dir / f"{part}_model.yaml").exists():
                raise NotImplementedError(
                    f"{self.model_dir}: a packed {part} model needs "
                    f"{module}, which the port has not ported")
        self._setup(load_config(self.model_dir / "config.yaml"),
                    self.model_dir / "qst.hed", device, verbose)
        for phase, bucket in _PHASES:
            setattr(self, f"{phase}_model", self._load_model(phase, bucket))
            setattr(self, f"in_{phase}_scaler",
                    self._load_minmax(f"in_{phase}"))
            setattr(self, f"out_{phase}_scaler",
                    self._load_standard(f"out_{phase}"))
        self._finish()

    @classmethod
    def from_parts(cls, config: Dict, qst_path, phases: Dict[str, Dict],
                   device="cuda") -> "SPSVS":
        """The engine from in-memory parts: the global config (as
        ``pack_model``'s ``global_config``), the question set, and
        ``phases``: ``{"timelag" | "duration" | "acoustic":
        {"model_config", "state_dict", "in_scaler", "out_scaler"}}``."""
        self = cls.__new__(cls)
        self.model_dir = None
        self._setup(Config(config), qst_path, _torch_device(device), 0)
        for phase, bucket in _PHASES:
            setattr(self, f"{phase}_model",
                    build_model(phases[phase], self.device, bucket))
            setattr(self, f"in_{phase}_scaler", phases[phase]["in_scaler"])
            setattr(self, f"out_{phase}_scaler", phases[phase]["out_scaler"])
        self._finish()
        return self

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

    def __repr__(self):
        return (f"{type(self).__name__}(model_dir="
                f"{str(self.model_dir) if self.model_dir else None!r}, "
                f"sample_rate={self.sample_rate}, "
                f"feature_type={self.feature_type!r}, vocoder='world', "
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

    # ------------------------------------------------------------- stages
    def predict_timing_multitrack_batch(self, labels_list, spk_ids, pairs):
        """Duration-modified labels of every track (pairwise timing)."""
        return gen_multitrack.predict_timing_multitrack_batch(
            [lab.copy() for lab in labels_list], spk_ids, pairs,
            self.binary_dict, self.numeric_dict,
            self.timelag_model, self.in_timelag_scaler,
            self.out_timelag_scaler, self.duration_model,
            self.in_duration_scaler, self.out_duration_scaler,
            log_f0_conditioning=self._log_f0_conditioning(),
            allowed_range=self._timelag_ranges()[0],
            allowed_range_rest=self._timelag_ranges()[1],
            force_clip_input_features=self._force_clip("timelag"),
            force_clip_input_features_duration=self._force_clip("duration"),
            frame_period=self.frame_period,
        )

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
        """The ported postprocess covers the flagship configuration: static
        WORLD streams with coded band aperiodicity, GV or no postfilter,
        absolute F0, and tracks longer than the filtfilt padding."""
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

    def _vocoder(self, streams_dev, lengths, vuv_threshold):
        """Coded streams -> per-track int16 waveforms on the host.  The
        noise is drawn from a generator seeded afresh on each call."""
        hop = int(self.sample_rate * self.frame_period / 1000)
        mgc, lf0, vuv, bap = streams_dev
        N, T_pad = lf0.shape[0], lf0.shape[1]
        sample_lengths = np.asarray(lengths, np.int64) * hop
        g = torch.Generator(self.device).manual_seed(0)
        noise = torch.randn((N, T_pad * hop), generator=g,
                            device=self.device)
        wav = synthesize_from_streams(
            mgc, lf0, vuv, bap, noise, self.sample_rate, self.frame_period,
            vuv_threshold=vuv_threshold, highpass_cutoff=70.0)
        keep = int(sample_lengths.max())
        q = quantize_peak_norm_int16(
            wav[:, :keep], torch.as_tensor(sample_lengths,
                                           device=self.device))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._t_vocoder_device_done = time.time()
        host = q.cpu().numpy()
        return [host[i, : sample_lengths[i]] for i in range(N)]

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.no_grad()
    def svs_ensemble(self, labels_list, vocoder_type: str = "world",
                     post_filter_type: str = "gv",
                     vuv_threshold: float = 0.5, dtype=np.int16,
                     spk_ids=None, pairs=None,
                     blocked_stage_times: bool = False):
        """Synthesize an N-part ensemble: every track is the MAIN track of
        one pair, conditioned on a sub track (``pairs[i]``, default the next
        track in a ring), and all N pairs run through the joint timing and
        acoustic models as single (N, T, D) batches.

        The signature is the JAX package's.  ``last_stage_times`` gets its
        keys; ``*_dispatch`` stages are enqueue times (the device wait
        lands in the vocoder), and ``blocked_stage_times=True``
        synchronizes after the acoustic and postprocess stages to add
        ``*_blocked`` attributions.

        The port renders through the WORLD vocoder to int16: another
        ``vocoder_type`` (``"auto"`` is WORLD, the port packs no neural
        vocoder) or ``dtype`` raises ``NotImplementedError``.  Returns
        (list of int16 wavs, sample_rate).
        """
        vocoder_type = str(vocoder_type).lower()
        if vocoder_type not in _VOCODER_TYPES:
            raise ValueError(f"Unknown vocoder type: {vocoder_type}")
        if post_filter_type not in _POST_FILTER_TYPES:
            raise ValueError(f"Unknown post-filter type: {post_filter_type}")
        if vocoder_type not in ("world", "auto"):
            raise NotImplementedError(
                f"vocoder_type={vocoder_type!r} needs the neural vocoders of "
                f"{_UNPORTED['vocoder']}, which the port has not ported")
        if np.dtype(dtype) != np.int16:
            raise NotImplementedError(
                f"dtype={np.dtype(dtype)}: the port renders int16 only; other "
                "output types need the JAX package's "
                "SPSVS.postprocess_waveform, which the port has not ported")
        if not self.is_multitrack:
            raise NotImplementedError("the port's svs_ensemble covers "
                                      "multitrack (cross-conditioned) models")
        start = time.time()
        N = len(labels_list)
        if spk_ids is None:
            spk_ids = list(range(N))
        if pairs is None:
            pairs = [(i + 1) % N for i in range(N)]
        duration_modified = self.predict_timing_multitrack_batch(
            labels_list, spk_ids, pairs)
        t_timing_device = time.time()
        feats, raw_feats = self._frame_features(duration_modified)
        t_timing = time.time()
        lengths = [len(f) for f in feats]
        if not self._fused_post_ok(post_filter_type, lengths):
            raise NotImplementedError(
                "only the device postprocess path (static WORLD streams, "
                "gv/off postfilter) is ported")
        spks = ([spk_ids[i] for i in range(N)],
                [spk_ids[pairs[i]] for i in range(N)])
        out_dev, lengths = self.acoustic_model.inference_batch(
            feats, spks=spks, sub_index=pairs, method="inference_main",
            device_out=True)
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
        outs = self._vocoder(streams_dev, lengths, vuv_threshold)
        t_end = time.time()

        self.last_stage_times = {
            "timing_feats": t_timing - start,
            "acoustic_dispatch": t_acoustic - t_timing,
            "postproc_dispatch": t_post - t_acoustic,
            "vocoder": t_end - t_post,
            "timing_models": t_timing_device - start,
            "frame_feats": t_timing - t_timing_device,
            "vocoder_device": self._t_vocoder_device_done - t_post,
            "vocoder_d2h": t_end - self._t_vocoder_device_done,
        }
        if blocked_stage_times:
            self.last_stage_times.update({
                "acoustic_blocked": t_acoustic_blocked - t_timing,
                "postproc_dispatch": t_post - t_acoustic_blocked,
                "postproc_blocked": t_post_blocked - t_acoustic_blocked,
                "vocoder": t_end - t_post_blocked,
            })
        audio_s = max(len(w) for w in outs) / self.sample_rate
        self.logger.info(
            "ensemble: %d parts, %.2f s audio, total %.3f s, RTF %.4f (%s)",
            N, audio_s, t_end - start, (t_end - start) / audio_s,
            ", ".join(f"{k} {v:.3f}s" for k, v in
                      self.last_stage_times.items()))
        return outs, self.sample_rate
