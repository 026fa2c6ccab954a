"""NEUTRINO-compatible engine: timing labels, phraselists and raw
f0/mgc/bap feature files; the port's copy of
``ensemble_svs_with_interactions_tpu/neutrino.py``.

The engine is the port's :class:`SPSVS` with NEUTRINO-style I/O
(NNSVS's ``NEUTRINO`` class and its ``NEUTRINO``/``NSF`` command-line
surface): NEUTRINO-format timing labels and float64 ``.f0/.mgc/.bap``
dumps, so drop-in replacement workflows keep working.  The models run on
``device`` (``"cuda"`` unless the caller asks for ``"cpu"``).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ensemble_svs_with_interactions_tpu_torch.io import hts
from ensemble_svs_with_interactions_tpu_torch.ops.world.codec import (
    get_num_aperiodicities,
)
from ensemble_svs_with_interactions_tpu_torch.svs import SPSVS


class NEUTRINO(SPSVS):
    """SPSVS with NEUTRINO-style I/O."""

    def get_num_aperiodicities(self) -> int:
        return get_num_aperiodicities(self.sample_rate)

    def musicxml_to_labels(self, musicxml_path):
        """MusicXML score -> Sinsy-style full-context labels through the
        first-party front end (``frontend/musicxml.py``)."""
        from ensemble_svs_with_interactions_tpu_torch.frontend.musicxml import (
            musicxml_to_labels,
        )

        return musicxml_to_labels(musicxml_path)

    def ust_to_labels(self, ust_path_or_text, table=None):
        """UST (UTAU) score -> full-context labels (``frontend/ust.py``),
        through the pack's ENUNU ``kana2phonemes.table`` when one ships
        with the model and no explicit table is given."""
        from ensemble_svs_with_interactions_tpu_torch.frontend.ust import (
            ust_to_labels,
        )

        if table is None and self.model_dir is not None:
            packed = Path(self.model_dir) / "kana2phonemes.table"
            if packed.exists():
                table = packed
        return ust_to_labels(ust_path_or_text, table=table)

    def get_num_phrases(self, labels) -> int:
        """Number of NEUTRINO phrases in the labels."""
        return len(hts.label2phrases(labels))

    def get_phraselist(self, full_labels, timing_labels) -> str:
        """NEUTRINO-format phraselist text."""
        note_indices = hts.get_note_indices(full_labels)
        return hts.label2phrases_str(timing_labels, note_indices)

    def predict_acoustic_neutrino(self, full_labels, timing_labels=None,
                                  style_shift: int = 0, phrase_num: int = -1,
                                  **postprocess_kw):
        """Labels -> (f0, mgc, bap), float64, in NEUTRINO layout: optional
        pre-estimated timing, ``style_shift`` (the conditioning F0 shifted
        by +shift semitones for inference and the output pitch shifted
        back), and ``phrase_num`` to synthesize a single phrase."""
        if timing_labels is None:
            mod = self.predict_timing(full_labels)
        else:
            mod = full_labels.copy()
            mod.start_times = np.asarray(timing_labels.start_times).copy()
            mod.end_times = np.asarray(timing_labels.end_times).copy()
        if phrase_num >= 0:
            phrases = hts.label2phrases(mod)
            if phrase_num >= len(phrases):
                raise RuntimeError(
                    f"phrase_num is too large: {phrase_num} >= {len(phrases)}"
                )
            mod = phrases[phrase_num]
        acoustic = self.predict_acoustic(mod,
                                         f0_shift_in_cent=style_shift * 100)
        vuv_threshold = postprocess_kw.get("vuv_threshold", 0.5)
        mgc, lf0, vuv, bap = self.postprocess_acoustic(
            acoustic, mod,
            post_filter_type=postprocess_kw.pop("post_filter_type", "gv"),
            f0_shift_in_cent=-style_shift * 100, **postprocess_kw)
        # the postprocess's threshold
        f0 = np.exp(lf0) * (vuv > vuv_threshold)
        return (f0.astype(np.float64), mgc.astype(np.float64),
                bap.astype(np.float64))

    def predict_waveform_neutrino(self, f0, mgc, bap, vocoder_type="world"):
        """(f0, mgc, bap) -> waveform (the ``NSF`` step), through
        ``postprocess_waveform``."""
        from ensemble_svs_with_interactions_tpu_torch.ops.pitch import (
            interp1d,
        )

        lf0 = f0.copy()
        lf0[np.nonzero(f0)] = np.log(f0[np.nonzero(f0)])
        # a continuous lf0: the neural vocoders are trained on the
        # interpolated contour (lf0 = 0 on unvoiced frames would feed them
        # a 1 Hz excitation)
        lf0 = interp1d(lf0)
        vuv = (f0 > 0).astype(np.float32)
        wav = self.predict_waveform(
            (mgc.astype(np.float32), lf0.astype(np.float32), vuv,
             bap.astype(np.float32)), vocoder_type=vocoder_type)
        return self.postprocess_waveform(wav)


def save_neutrino_features(out_f0, out_mgc, out_bap, f0, mgc, bap) -> None:
    """Raw float64 binary dumps (NEUTRINO file format)."""
    f0.astype(np.float64).tofile(out_f0)
    mgc.astype(np.float64).tofile(out_mgc)
    bap.astype(np.float64).tofile(out_bap)


def load_neutrino_features(f0_path, mgc_path, bap_path, mgc_dim: int,
                           num_ap: int):
    f0 = np.fromfile(f0_path, dtype=np.float64).reshape(-1, 1)
    mgc = np.fromfile(mgc_path, dtype=np.float64).reshape(-1, mgc_dim)
    bap = np.fromfile(bap_path, dtype=np.float64).reshape(-1, num_ap)
    return f0, mgc, bap
