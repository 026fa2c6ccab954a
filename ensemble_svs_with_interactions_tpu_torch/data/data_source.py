"""Feature-extraction data sources (host NumPy, data-preparation time):
the port's copy of ``ensemble_svs_with_interactions_tpu/data/
data_source.py``, which the recipe's stage 1 (``bin/prepare_features.py``)
runs.  ``load_wav`` reads and resamples audio; the linguistic, time-lag
and duration sources featurize HTS labels (``io/hts.py``,
``frontend/merlin.py``); ``WORLDAcousticSource`` runs the WORLD analysis
of ``ops/world/analysis.py`` (native C++ where it builds) and codes its
streams.  The mel voices' ``MelF0AcousticSource`` gives (log-mel, lf0,
vuv) frames: ``logmelfilterbank`` (a SciPy STFT through the mel
filterbank) and the F0 of the same analysis.  The mel filterbank is also
what the vocoder losses (``train/vocoder.py``) cast to float32 and keep
on the device.
"""

from __future__ import annotations

from os.path import join
from typing import List, Optional, Tuple

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly

from ensemble_svs_with_interactions_tpu_torch.frontend import merlin as fe
from ensemble_svs_with_interactions_tpu_torch.io import hts
from ensemble_svs_with_interactions_tpu_torch.ops import sptk
from ensemble_svs_with_interactions_tpu_torch.ops.mlpg import (
    apply_delta_windows,
    default_windows,
)
from ensemble_svs_with_interactions_tpu_torch.ops.pitch import (
    compute_f0_correction_ratio,
    extract_smoothed_continuous_f0,
    extract_smoothed_f0,
    extract_vibrato_likelihood,
    extract_vibrato_parameters,
    hz_to_cent_based_c4,
    interp1d,
    lowpass_filter,
)
from ensemble_svs_with_interactions_tpu_torch.ops.world import (
    analysis,
    codec,
)


def load_wav(path, target_sr: Optional[int] = None) -> Tuple[np.ndarray, int]:
    """Read a wav as float64 in [-1, 1], optionally resampling."""
    fs, x = wavfile.read(path)
    if x.dtype == np.int16:
        x = x.astype(np.float64) / 32768.0
    elif x.dtype == np.int32:
        x = x.astype(np.float64) / 2147483648.0
    else:
        x = x.astype(np.float64)
    if x.ndim > 1:
        x = x.mean(axis=1)
    if target_sr is not None and fs != target_sr:
        from math import gcd

        g = gcd(fs, target_sr)
        x = resample_poly(x, target_sr // g, fs // g)
        fs = target_sr
    return x, fs


def _collect_files(data_root, utt_list, ext: str) -> List[str]:
    with open(utt_list) as f:
        utt_ids = [line.strip() for line in f if line.strip()]
    return [join(data_root, f"{u}{ext}") for u in utt_ids]


def _midi_to_hz(x: np.ndarray, idx: int, log_f0: bool = False) -> np.ndarray:
    z = np.zeros(len(x))
    nz = x[:, idx] > 0
    z[nz] = 440.0 * 2.0 ** ((x[nz, idx] - 69) / 12.0)
    if log_f0:
        z[nz] = np.log(z[nz])
    return z


class FileDataSource:
    """Minimal (collect_files, collect_features) protocol."""

    def collect_files(self):
        raise NotImplementedError

    def collect_features(self, *args):
        raise NotImplementedError


class MusicalLinguisticSource(FileDataSource):
    """Labels -> linguistic features with interpolated log-F0 conditioning."""

    def __init__(
        self,
        utt_list,
        data_root,
        question_path,
        add_frame_features: bool = False,
        subphone_features: Optional[str] = None,
        log_f0_conditioning: bool = True,
        frame_period: float = 5,
    ):
        self.utt_list = utt_list
        self.data_root = data_root
        self.add_frame_features = add_frame_features
        self.subphone_features = subphone_features
        self.binary_dict, self.numeric_dict = hts.load_question_set(question_path)
        self.log_f0_conditioning = log_f0_conditioning
        self.frame_period = frame_period
        self.pitch_indices = hts.get_pitch_indices(self.binary_dict, self.numeric_dict)

    def collect_files(self):
        return _collect_files(self.data_root, self.utt_list, ".lab")

    def _featurize(self, labels):
        frame_shift = int(self.frame_period * 1e4)
        labels.frame_shift = frame_shift
        feats = fe.linguistic_features(
            labels,
            self.binary_dict,
            self.numeric_dict,
            add_frame_features=self.add_frame_features,
            subphone_features=self.subphone_features,
            frame_shift=frame_shift,
        )
        if self.log_f0_conditioning:
            for idx in self.pitch_indices:
                feats[:, idx] = interp1d(_midi_to_hz(feats, idx, True))
        return feats.astype(np.float32)

    def collect_features(self, path):
        return self._featurize(hts.load(path))


class MultiTrackMusicalLinguisticSource(MusicalLinguisticSource):
    """Same as MusicalLinguisticSource, but also returns note start times
    (for cross-track note synchronization)."""

    def collect_features(self, path):
        labels = hts.load(path)
        feats = self._featurize(labels)
        return feats, np.asarray(labels.start_times)


class TimeLagFeatureSource(FileDataSource):
    """Aligned-minus-score phone onsets, in frames (shape (N, 1))."""

    def __init__(self, utt_list, label_phone_score_dir, label_phone_align_dir):
        self.utt_list = utt_list
        self.label_phone_score_dir = label_phone_score_dir
        self.label_phone_align_dir = label_phone_align_dir

    def collect_files(self):
        score = _collect_files(self.label_phone_score_dir, self.utt_list, ".lab")
        align = _collect_files(self.label_phone_align_dir, self.utt_list, ".lab")
        return score, align

    def collect_features(self, label_score_path, label_align_path):
        score = hts.load(label_score_path)
        align = hts.load(label_align_path)
        timelag = np.asarray(align.start_times) - np.asarray(score.start_times)
        return (timelag.astype(np.float32) / 50000).reshape(-1, 1)


class DurationFeatureSource(FileDataSource):
    """Per-phone durations in frames (shape (N, 1))."""

    def __init__(self, utt_list, data_root):
        self.utt_list = utt_list
        self.data_root = data_root

    def collect_files(self):
        return _collect_files(self.data_root, self.utt_list, ".lab")

    def collect_features(self, path):
        return fe.duration_features(hts.load(path)).astype(np.float32)


class WORLDAcousticSource(FileDataSource):
    """Full WORLD analysis -> (features, wave, postfilter_features).

    Feature layout: [mgc(+deltas), lf0-or-difflf0(+deltas), vuv,
    bap(+deltas), (vib(+deltas), vib_flags)].
    """

    def __init__(
        self,
        utt_list,
        wav_root,
        label_root,
        question_path,
        f0_extractor: str = "harvest",
        f0_floor: Optional[float] = 150,
        f0_ceil: Optional[float] = 700,
        frame_period: float = 5,
        mgc_order: int = 59,
        num_windows: int = 3,
        relative_f0: bool = True,
        interp_unvoiced_aperiodicity: bool = True,
        vibrato_mode: str = "none",
        sample_rate: int = 48000,
        d4c_threshold: float = 0.85,
        trajectory_smoothing: bool = False,
        trajectory_smoothing_cutoff: float = 50,
        trajectory_smoothing_f0: bool = True,
        trajectory_smoothing_cutoff_f0: float = 20,
        correct_vuv: bool = False,
        correct_f0: bool = False,
        dynamic_features_flags: Optional[List[bool]] = None,
        use_world_codec: bool = False,
        use_mcep_aperiodicity: bool = False,
        # accepted for reference-config compatibility: resampling here is
        # always scipy polyphase (reference librosa res_type knob)
        res_type: str = "scipy",
        # accepted for reference-config compatibility (prepare_features
        # acoustic params carry it); this source IS the world extractor —
        # mel-F0 features go through MelF0AcousticSource
        feature_type: str = "world",
        # accepted so acoustic.params can carry the mode (consumed by the
        # frame-level linguistic featurization in bin/prepare_features and
        # packed into the engine config by run_recipe; the internal
        # pitch-range pass below never needs subphone dims)
        subphone_features: Optional[str] = "coarse_coding",
        mcep_aperiodicity_order: int = 24,
    ):
        if feature_type != "world":
            raise ValueError(
                f"WORLDAcousticSource extracts WORLD features; got "
                f"feature_type={feature_type!r} (use the MelF0 source)"
            )
        self.utt_list = utt_list
        self.wav_root = wav_root
        self.label_root = label_root
        self.binary_dict, self.numeric_dict = hts.load_question_set(question_path)
        self.pitch_idx = hts.get_pitch_index(self.binary_dict, self.numeric_dict)
        self.f0_extractor = f0_extractor
        self.f0_floor = f0_floor
        self.f0_ceil = f0_ceil
        self.frame_period = frame_period
        self.mgc_order = mgc_order
        self.relative_f0 = relative_f0
        self.interp_unvoiced_aperiodicity = interp_unvoiced_aperiodicity
        self.vibrato_mode = vibrato_mode
        self.windows = default_windows(num_windows)
        self.sample_rate = sample_rate
        self.d4c_threshold = d4c_threshold
        self.trajectory_smoothing = trajectory_smoothing
        self.trajectory_smoothing_cutoff = trajectory_smoothing_cutoff
        self.trajectory_smoothing_f0 = trajectory_smoothing_f0
        self.trajectory_smoothing_cutoff_f0 = trajectory_smoothing_cutoff_f0
        self.correct_vuv = correct_vuv
        self.correct_f0 = correct_f0
        self.use_world_codec = use_world_codec
        self.use_mcep_aperiodicity = use_mcep_aperiodicity
        self.mcep_aperiodicity_order = mcep_aperiodicity_order
        if dynamic_features_flags is None:
            # up to 6 streams: (mgc, lf0, vuv, bap, vib, vib_flags)
            dynamic_features_flags = [True, True, False, True, True, False]
        self.dynamic_features_flags = dynamic_features_flags

    def collect_files(self):
        wav_paths = _collect_files(self.wav_root, self.utt_list, ".wav")
        label_paths = _collect_files(self.label_root, self.utt_list, ".lab")
        return wav_paths, label_paths

    def collect_features(self, wav_path, label_path):
        labels = hts.load(label_path)
        frame_shift = int(self.frame_period * 1e4)
        labels.frame_shift = frame_shift
        num_frames = labels.num_frames()

        # only the score-pitch column is consumed here (F0 search range +
        # score-F0 fill) — subphone features would just append unused dims
        l_features = fe.linguistic_features(
            labels,
            self.binary_dict,
            self.numeric_dict,
            add_frame_features=True,
            subphone_features=None,
            frame_shift=frame_shift,
        )
        f0_score = _midi_to_hz(l_features, self.pitch_idx, False)
        notes = l_features[:, self.pitch_idx]
        notes = notes[notes > 0]

        # Score-informed F0 search range: 600 cents below, 200 above
        # (reference data_source.py:284-301), min 63.5 Hz
        min_f0 = max(63.5, 440.0 * 2 ** ((min(notes) - 6 - 69) / 12))
        max_f0 = 440.0 * 2 ** ((max(notes) + 2 - 69) / 12)
        if self.f0_floor is not None:
            min_f0 = self.f0_floor
        if self.f0_ceil is not None:
            max_f0 = self.f0_ceil
        min_f0 = min(min_f0, 500)

        x, fs = load_wav(wav_path, self.sample_rate)

        if self.f0_extractor == "harvest":
            f0, timeaxis = analysis.harvest(
                x, fs, frame_period=self.frame_period, f0_floor=min_f0, f0_ceil=max_f0
            )
        elif self.f0_extractor == "dio":
            f0, timeaxis = analysis.dio(
                x, fs, frame_period=self.frame_period, f0_floor=min_f0, f0_ceil=max_f0
            )
            f0 = analysis.stonemask(x, f0, timeaxis, fs)
        elif self.f0_extractor == "parselmouth":
            # Boersma-1993 windowed-ACF estimator (ops/praat.py), the
            # algorithm behind parselmouth's to_pitch_ac as the reference
            # uses it (data_source.py:313-338: explicit floor/ceil from
            # the score, praat's 0.6 voicing threshold, no stonemask)
            assert (
                self.f0_floor is not None and self.f0_ceil is not None
            ), "parselmouth mode requires explicit f0_floor/f0_ceil"
            from ensemble_svs_with_interactions_tpu_torch.ops.praat import (
                sound_to_pitch_ac,
            )

            f0, timeaxis = sound_to_pitch_ac(
                x,
                fs,
                time_step=self.frame_period * 0.001,
                pitch_floor=min_f0,
                pitch_ceiling=max_f0,
                voicing_threshold=0.6,
            )
        else:
            raise ValueError(f"unknown f0 extractor: {self.f0_extractor}")
        f0 = np.maximum(f0, 0)

        # V/UV correction from the score (0.5 s smoothed note mask)
        if self.correct_vuv:
            win_length = int(0.5 / (self.frame_period * 0.001))
            mask = np.convolve(f0_score, np.ones(win_length) / win_length, "same")
            if len(f0) > len(mask):
                mask = np.pad(mask, (0, len(f0) - len(mask)))
            else:
                mask = mask[: len(f0)]
            f0 = f0 * np.sign(mask)

        spectrogram = analysis.cheaptrick(x, f0, timeaxis, fs)
        aperiodicity = analysis.d4c(x, f0, timeaxis, fs, threshold=self.d4c_threshold)
        if np.isnan(aperiodicity).any():
            raise RuntimeError(f"aperiodicity has NaN: {wav_path}")

        sr_f0 = int(1 / (self.frame_period * 0.001))
        if self.correct_f0:
            f0_smooth = extract_smoothed_f0(f0, sr_f0, cutoff=20)
            f0 = f0 * compute_f0_correction_ratio(f0_smooth, f0_score[: len(f0)])

        lf0 = f0[:, None].copy()
        nz = np.nonzero(lf0)
        lf0[nz] = np.log(lf0[nz])
        vuv = (lf0 != 0).astype(np.float32)
        lf0 = interp1d(lf0)
        if self.trajectory_smoothing_f0:
            lf0 = extract_smoothed_continuous_f0(
                lf0, sr_f0, cutoff=self.trajectory_smoothing_cutoff_f0
            )

        # Fill score F0 where neither notes nor F0 exist
        lf0_score = _midi_to_hz(l_features, self.pitch_idx, True)
        clf0_score = interp1d(lf0_score)
        mask = lf0_score.copy()
        if len(f0) > len(mask):
            mask = np.pad(mask, (0, len(f0) - len(mask)))
            clf0_score = np.pad(clf0_score, (0, len(f0) - len(clf0_score)))
        else:
            mask = mask[: len(f0)]
            clf0_score = clf0_score[: len(f0)]
        ind = (mask + f0.reshape(-1)) <= 0
        lf0[ind, 0] = clf0_score[ind]

        # Vibrato analysis
        if self.vibrato_mode == "sine":
            f0_for_vib, t_vib = analysis.dio(
                x, fs, frame_period=self.frame_period, f0_floor=min_f0, f0_ceil=max_f0
            )
            f0_for_vib = analysis.stonemask(x, f0_for_vib, t_vib, fs)
            f0_smooth = extract_smoothed_f0(f0_for_vib, sr_f0, cutoff=8)
            f0_smooth_cent = hz_to_cent_based_c4(f0_smooth)
            like = extract_vibrato_likelihood(
                f0_smooth_cent, sr_f0, win_length=64, n_fft=256
            )
            vib_flags, m_a, m_f = extract_vibrato_parameters(
                f0_smooth_cent, like, sr_f0, threshold=0.12
            )
            vib = np.stack([interp1d(m_a), interp1d(m_f)], axis=1)
            vib_flags = vib_flags[:, None].astype(np.float32)
        elif self.vibrato_mode == "diff":
            f0_smooth = extract_smoothed_f0(f0, sr_f0, cutoff=3)
            vib = (f0 - f0_smooth)[:, None]
            vib_flags = None
        elif self.vibrato_mode == "none":
            vib, vib_flags = None, None
        else:
            raise RuntimeError(f"unknown vibrato mode: {self.vibrato_mode}")

        if self.use_world_codec:
            mgc = np.asarray(
                codec.code_spectral_envelope(spectrogram, fs, self.mgc_order + 1)
            )
        else:
            mgc = np.asarray(
                sptk.sp2mc(spectrogram, self.mgc_order, sptk.mcepalpha(fs))
            )
        sp = np.log(spectrogram)  # postfilter target

        # interpolate aperiodicity through unvoiced regions
        if self.interp_unvoiced_aperiodicity:
            is_voiced = (vuv > 0).reshape(-1)
            if np.any(is_voiced):
                for k in range(aperiodicity.shape[1]):
                    aperiodicity[~is_voiced, k] = np.interp(
                        np.where(~is_voiced)[0],
                        np.where(is_voiced)[0],
                        aperiodicity[is_voiced, k],
                    )

        if self.use_mcep_aperiodicity:
            bap = np.asarray(
                sptk.sp2mc(
                    aperiodicity, self.mcep_aperiodicity_order, sptk.mcepalpha(fs)
                )
            )
        else:
            bap = np.asarray(codec.code_aperiodicity(aperiodicity, fs))

        if self.trajectory_smoothing:
            modfs = sr_f0
            for d in range(mgc.shape[1]):
                mgc[:, d] = lowpass_filter(
                    mgc[:, d], modfs, cutoff=self.trajectory_smoothing_cutoff
                )
            for d in range(bap.shape[1]):
                bap[:, d] = lowpass_filter(
                    bap[:, d], modfs, cutoff=self.trajectory_smoothing_cutoff
                )

        sp = sp[:num_frames]
        mgc = mgc[:num_frames]
        lf0 = lf0[:num_frames]
        vuv = vuv[:num_frames]
        bap = bap[:num_frames]
        vib = vib[:num_frames] if vib is not None else None
        vib_flags = vib_flags[:num_frames] if vib_flags is not None else None

        if self.relative_f0:
            f0_score_col = f0_score[:, None][: len(lf0)]
            lf0_score_col = f0_score_col.copy()
            nz = np.nonzero(f0_score_col)
            lf0_score_col[nz] = np.log(f0_score_col[nz])
            lf0_score_col = interp1d(lf0_score_col)
            diff_lf0 = np.clip(lf0 - lf0_score_col, np.log(0.5), np.log(2.0))
            f0_target = diff_lf0
        else:
            f0_target = lf0

        if self.dynamic_features_flags[0]:
            mgc = apply_delta_windows(mgc, self.windows)
        if self.dynamic_features_flags[1]:
            f0_target = apply_delta_windows(f0_target, self.windows)
        if self.dynamic_features_flags[3]:
            bap = apply_delta_windows(bap, self.windows)
        if vib is not None and self.dynamic_features_flags[4]:
            vib = apply_delta_windows(vib, self.windows)

        parts = [mgc, f0_target, vuv, bap]
        pf_parts = [sp, f0_target, vuv, bap]
        if vib is not None:
            parts.append(vib)
            pf_parts.append(vib)
        if vib_flags is not None:
            parts.append(vib_flags)
            pf_parts.append(vib_flags)
        features = np.hstack(parts).astype(np.float32)
        pf_features = np.hstack(pf_parts).astype(np.float32)

        if len(features) < num_frames:
            return None, None, None

        features = features[:num_frames]
        pf_features = pf_features[:num_frames]

        wave = x.astype(np.float32)
        frame_shift_int = int(fs * self.frame_period / 1000)
        T = int(features.shape[0] * frame_shift_int)
        if len(wave) < T:
            if T - len(wave) > frame_shift_int:
                raise RuntimeError(f"unaligned data: {wav_path} / {label_path}")
            wave = np.pad(wave, (0, T - len(wave)))
        wave = wave[:T]

        assert np.isfinite(features).all()
        return features, wave, pf_features


def mel_filterbank(sr: int, fft_size: int, num_mels: int = 80,
                   fmin: float = 30, fmax: Optional[float] = None
                   ) -> np.ndarray:
    """(num_mels, fft_size // 2 + 1) float64 triangular mel filterbank, no
    area normalization; ``fmax`` None (or 0) is ``sr / 2``."""
    fmax = fmax or sr / 2

    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), num_mels + 2)
    bins = np.floor((fft_size + 1) * mel_to_hz(mel_pts) / sr).astype(int)
    fb = np.zeros((num_mels, fft_size // 2 + 1))
    for m in range(1, num_mels + 1):
        lo, c, hi = bins[m - 1], bins[m], bins[m + 1]
        for k in range(lo, c):
            fb[m - 1, k] = (k - lo) / (c - lo)
        for k in range(c, hi):
            fb[m - 1, k] = (hi - k) / (hi - c)
    return fb


def logmelfilterbank(x: np.ndarray, sr: int, fft_size: int = 512,
                     hop_size: int = 120, win_length: Optional[int] = None,
                     fmin: float = 30, fmax: Optional[float] = None,
                     num_mels: int = 80, eps: float = 1e-10) -> np.ndarray:
    """(frames, num_mels) float32 log10 mel spectrogram: a zero-padded
    Hann STFT's magnitude (SciPy) through :func:`mel_filterbank`, floored
    at ``eps``."""
    from scipy.signal import stft

    win_length = win_length or fft_size
    fmax = fmax or sr / 2
    _, _, Z = stft(x, nperseg=win_length, noverlap=win_length - hop_size,
                   nfft=fft_size, window="hann", boundary="zeros",
                   padded=True)
    fb = mel_filterbank(sr, fft_size, num_mels, fmin, fmax)
    mel = np.maximum(eps, np.abs(Z).T @ fb.T)
    return np.log10(mel).astype(np.float32)


class MelF0AcousticSource(FileDataSource):
    """(log-mel, lf0, vuv) acoustic features, 82 columns at 80 mels: the
    mel spectrogram of :func:`logmelfilterbank`; lf0 from harvest (or dio
    and stonemask), interpolated through unvoiced frames and, with
    ``trajectory_smoothing_f0``, low-passed; vuv where F0 is nonzero.
    ``collect_features`` returns (features, the waveform cut to the
    frames' samples, features)."""

    def __init__(self, utt_list, wav_root, label_root, question_path,
                 f0_extractor: str = "harvest", f0_floor: float = 150,
                 f0_ceil: float = 700, frame_period: float = 5,
                 sample_rate: int = 48000,
                 trajectory_smoothing_f0: bool = True,
                 trajectory_smoothing_cutoff_f0: float = 20,
                 correct_vuv: bool = False, fft_size: int = 512,
                 win_length: int = 480, hop_size: int = 120,
                 fmin: float = 30, fmax: Optional[float] = None,
                 num_mels: int = 80):
        self.utt_list = utt_list
        self.wav_root = wav_root
        self.label_root = label_root
        self.binary_dict, self.numeric_dict = hts.load_question_set(
            question_path)
        self.pitch_idx = hts.get_pitch_index(self.binary_dict,
                                             self.numeric_dict)
        self.f0_extractor = f0_extractor
        self.f0_floor = f0_floor
        self.f0_ceil = f0_ceil
        self.frame_period = frame_period
        self.sample_rate = sample_rate
        self.trajectory_smoothing_f0 = trajectory_smoothing_f0
        self.trajectory_smoothing_cutoff_f0 = trajectory_smoothing_cutoff_f0
        self.fft_size = fft_size
        self.win_length = win_length
        self.hop_size = hop_size
        self.fmin = fmin
        self.fmax = fmax or sample_rate // 2
        self.num_mels = num_mels

    def collect_files(self):
        return (_collect_files(self.wav_root, self.utt_list, ".wav"),
                _collect_files(self.label_root, self.utt_list, ".lab"))

    def collect_features(self, wav_path, label_path):
        labels = hts.load(label_path)
        labels.frame_shift = int(self.frame_period * 1e4)
        num_frames = labels.num_frames()
        x, fs = load_wav(wav_path, self.sample_rate)
        if self.f0_extractor == "harvest":
            f0, _ = analysis.harvest(x, fs, self.frame_period,
                                     self.f0_floor, self.f0_ceil)
        else:
            f0, t = analysis.dio(x, fs, self.frame_period, self.f0_floor,
                                 self.f0_ceil)
            f0 = analysis.stonemask(x, f0, t, fs)
        lf0 = f0[:, None].copy()
        nz = np.nonzero(lf0)
        lf0[nz] = np.log(lf0[nz])
        vuv = (lf0 != 0).astype(np.float32)
        lf0 = interp1d(lf0)
        if self.trajectory_smoothing_f0:
            lf0 = extract_smoothed_continuous_f0(
                lf0, int(1 / (self.frame_period * 0.001)),
                cutoff=self.trajectory_smoothing_cutoff_f0)
        mel = logmelfilterbank(
            x, fs, fft_size=self.fft_size, hop_size=self.hop_size,
            win_length=self.win_length, fmin=self.fmin, fmax=self.fmax,
            num_mels=self.num_mels)
        n = min(num_frames, len(mel), len(lf0))
        features = np.hstack([mel[:n], lf0[:n], vuv[:n]]).astype(np.float32)
        return features, x.astype(np.float32)[: n * self.hop_size], features
