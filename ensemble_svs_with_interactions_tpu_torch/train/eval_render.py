"""Dev-set rendering during training (``eval_render: true``): audio and
parameter plots of the first dev batch each epoch, as
``ensemble_svs_with_interactions_tpu/train/eval_render.py`` writes them,
under ``{out_dir}/eval/epoch{N:04d}`` (and to TensorBoard when the writer
has it).  WORLD synthesis runs through the port's ``ops/world`` on the
host CPU; the plots need matplotlib and are skipped with a warning
without it."""

from __future__ import annotations

import warnings
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from ensemble_svs_with_interactions_tpu_torch.gen import vocoder_noise
from ensemble_svs_with_interactions_tpu_torch.ops.multistream import (
    get_static_features,
    get_static_stream_sizes,
    split_streams,
)
from ensemble_svs_with_interactions_tpu_torch.ops.world.synthesis import (
    synthesize_from_streams,
)


def synthesize_from_static(static_feats: np.ndarray,
                           stream_sizes: Sequence[int], sample_rate: int,
                           frame_period: float = 5.0,
                           vuv_threshold: float = 0.3) -> np.ndarray:
    """Static (mgc, lf0, vuv, bap) features -> a waveform, peak-normalized
    to 1 where it exceeds it."""
    mgc, lf0, vuv, bap = split_streams(static_feats, list(stream_sizes))
    hop = int(sample_rate * frame_period / 1000.0)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32))[None]

    wav = synthesize_from_streams(
        t(mgc), t(lf0), t(vuv), t(np.clip(bap, -60, 0)),
        vocoder_noise(1, len(mgc) * hop, "cpu"), sample_rate, frame_period,
        vuv_threshold=vuv_threshold)[0].numpy()
    peak = np.abs(wav).max()
    return wav / peak if peak > 1.0 else wav


def plot_spsvs_params(out_path, pred_static: np.ndarray,
                      target_static: np.ndarray,
                      stream_sizes: Sequence[int]) -> bool:
    """Predicted-vs-target F0 track and mgc heatmaps as a png; False
    (with a warning) where matplotlib is missing."""
    try:
        import matplotlib
    except ImportError:
        warnings.warn("eval_render: matplotlib is not installed; no plots")
        return False
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    p_mgc, p_lf0, p_vuv, _ = split_streams(pred_static, list(stream_sizes))
    t_mgc, t_lf0, t_vuv, _ = split_streams(target_static, list(stream_sizes))
    fig, axes = plt.subplots(3, 1, figsize=(10, 8))
    t_axis = np.arange(len(p_lf0)) * 0.005
    axes[0].plot(t_axis, np.exp(t_lf0[:, 0]) * (t_vuv[:, 0] > 0.5),
                 label="target", linewidth=1)
    axes[0].plot(t_axis, np.exp(p_lf0[:, 0]) * (p_vuv[:, 0] > 0.5),
                 label="predicted", linewidth=1, alpha=0.8)
    axes[0].set_ylabel("F0 [Hz]")
    axes[0].legend()
    axes[1].imshow(t_mgc.T, aspect="auto", origin="lower",
                   interpolation="none")
    axes[1].set_ylabel("target mgc")
    axes[2].imshow(p_mgc.T, aspect="auto", origin="lower",
                   interpolation="none")
    axes[2].set_ylabel("predicted mgc")
    axes[2].set_xlabel("frame")
    fig.tight_layout()
    fig.savefig(out_path, dpi=80)
    plt.close(fig)
    return True


def render_eval_outputs(out_dir, epoch: int, pred_out_feats: np.ndarray,
                        target_out_feats: np.ndarray, lengths, out_scaler,
                        stream_sizes: Sequence[int],
                        has_dynamic_features: Sequence[bool],
                        num_windows: int, sample_rate: int,
                        max_utts: int = 2, writer=None):
    """Render up to ``max_utts`` dev utterances: ``utt{i}_pred.wav`` (int16)
    and ``utt{i}_params.png`` each."""
    from scipy.io import wavfile

    out_dir = Path(out_dir) / "eval" / f"epoch{epoch:04d}"
    out_dir.mkdir(parents=True, exist_ok=True)
    static_sizes = [int(s) for s in get_static_stream_sizes(
        stream_sizes, has_dynamic_features, num_windows)]
    pred = np.asarray(out_scaler.inverse_transform(
        np.asarray(pred_out_feats)))
    target = np.asarray(out_scaler.inverse_transform(
        np.asarray(target_out_feats)))

    def static(x):
        if not any(has_dynamic_features):
            return x
        parts = get_static_features(x[None], num_windows, list(stream_sizes),
                                    list(has_dynamic_features))
        return np.concatenate([np.asarray(p)[0] for p in parts], axis=-1)

    for i in range(min(max_utts, len(pred))):
        n = int(lengths[i])
        if n == 0 or len(static_sizes) != 4:
            continue
        p, t = static(pred[i, :n]), static(target[i, :n])
        wav = synthesize_from_static(p, static_sizes, sample_rate)
        wavfile.write(out_dir / f"utt{i}_pred.wav", sample_rate,
                      (np.clip(wav, -1, 1) * 32767).astype(np.int16))
        plot_spsvs_params(out_dir / f"utt{i}_params.png", p, t, static_sizes)
        if writer is not None and writer.tb is not None:
            writer.tb.add_audio(f"eval/utt{i}",
                                torch.from_numpy(wav.astype(np.float32)[None]),
                                epoch, sample_rate=sample_rate)
