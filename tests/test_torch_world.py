"""Port's device postprocess and WORLD vocoder against the JAX package.

The vocoder is compared by SNR with the same numpy noise fed to both
sides, at the 40 dB bound tests/test_world.py uses: pulse positions come
from a float32 cumulative sum and ``mod``, so a pulse can move by a
sample where the two frameworks round differently.  The postprocess
(GV, log-F0 interpolation, filtfilt smoothing) is float32 arithmetic in
the same order on both sides, compared at atol 1e-4 on the valid frames.
"""

import jax.numpy as jnp
import numpy as np
import torch

from ensemble_svs_with_interactions_tpu.ops import device_post as jax_post
from ensemble_svs_with_interactions_tpu.ops.world import synthesis as jax_syn
from ensemble_svs_with_interactions_tpu.ops.world.codec import (
    get_cheaptrick_fft_size,
)
from ensemble_svs_with_interactions_tpu_torch.ops import device_post
from ensemble_svs_with_interactions_tpu_torch.ops.world import synthesis
from ensemble_svs_with_interactions_tpu_torch.utils.scalers import (
    StandardScaler,
)
from tests.test_torch_svs import few_threads  # noqa: F401  (autouse)

FS = 24000
HOP = 120


def _streams(rng, B, T, M=12, A=3):
    t = np.arange(T)[None, :, None]
    mgc = rng.normal(0, 0.05, size=(B, T, M)).cumsum(axis=1) * 0.2
    mgc[..., 0] += -4.0
    lf0 = np.log(220.0) + 0.05 * np.sin(2 * np.pi * t / 40.0) + np.zeros(
        (B, 1, 1))
    vuv = np.ones((B, T, 1))
    vuv[:, T // 3: T // 3 + 15] = 0.0
    bap = np.clip(-25 + rng.normal(0, 3, size=(B, T, A)), -60, 0)
    return [a.astype(np.float32) for a in (mgc, lf0, vuv, bap)]


def _snr(ref, got):
    err = got - ref
    return 10 * np.log10(np.sum(ref ** 2) / max(np.sum(err ** 2), 1e-30))


def test_vocoder_matches_jax_with_same_noise():
    rng = np.random.default_rng(0)
    B, T = 2, 160
    mgc, lf0, vuv, bap = _streams(rng, B, T)
    noise = rng.normal(size=(B, T * HOP)).astype(np.float32)
    fft = get_cheaptrick_fft_size(FS)
    ref = np.asarray(jax_syn._synthesize_from_streams_impl(
        *(jnp.asarray(a) for a in (mgc, lf0, vuv, bap, noise)),
        FS, HOP, fft, 0.5, 70.0))
    got = synthesis.synthesize_from_streams(
        *(torch.from_numpy(a) for a in (mgc, lf0, vuv, bap, noise)), FS,
        vuv_threshold=0.5, highpass_cutoff=70.0).numpy()
    assert got.shape == ref.shape == (B, T * HOP)
    for b in range(B):
        assert _snr(ref[b], got[b]) > 40.0, _snr(ref[b], got[b])


def test_quantize_peak_norm_int16_matches_jax():
    rng = np.random.default_rng(1)
    wav = rng.normal(0, 0.2, size=(2, 5000)).astype(np.float32)
    lengths = np.array([5000, 3100])
    ref = np.asarray(jax_syn.quantize_peak_norm_int16(
        jnp.asarray(wav), jnp.asarray(lengths)))
    got = synthesis.quantize_peak_norm_int16(
        torch.from_numpy(wav), torch.from_numpy(lengths)).numpy()
    assert got.dtype == np.int16
    assert np.abs(got.astype(np.int32) - ref.astype(np.int32)).max() <= 1


def test_fused_postprocess_matches_jax():
    """Ragged batch: GV over note frames, V/UV-gated log-F0 interpolation
    and the scipy-exact filtfilt with per-row valid lengths."""
    rng = np.random.default_rng(2)
    ss = (8, 1, 1, 3)
    D = sum(ss)
    N, T = 2, 96
    lengths = np.array([96, 57])
    pred = rng.normal(0, 1, size=(N, T, D)).astype(np.float32)
    pred[..., ss[0] + 1] = rng.uniform(-1, 12, size=(N, T))  # vuv gate
    note_mask = rng.uniform(size=(N, T)) < 0.7
    note_mask &= np.arange(T)[None, :] < lengths[:, None]
    mean = rng.normal(0, 0.5, D)
    mean[ss[0]] = np.log(220.0)
    scale = rng.uniform(0.05, 0.3, D)
    scaler = StandardScaler(mean, scale ** 2, scale)
    a, b = device_post.scaler_affine(scaler, D)
    gv = rng.uniform(0.01, 0.1, ss[0]).astype(np.float32)
    cut = [50.0] * ss[0] + [50.0] * ss[3] + [20.0]
    coeffs = device_post.filtfilt_coeffs(cut, 200)
    for mine, theirs in zip(coeffs, jax_post.filtfilt_coeffs(cut, 200)):
        np.testing.assert_array_equal(mine, theirs)
    args = (pred, lengths, note_mask, a, b, gv, *coeffs)
    ref = jax_post.jit_fused_world_postprocess()(
        *(jnp.asarray(x) for x in args), stream_sizes=ss, apply_gv=True,
        gate_threshold=0.5, smooth=True)
    got = device_post.fused_world_postprocess(
        *(torch.from_numpy(np.asarray(x)) for x in args), stream_sizes=ss,
        apply_gv=True)
    for r, g in zip(ref, got):
        r, g = np.asarray(r), g.numpy()
        for n in range(N):
            np.testing.assert_allclose(g[n, : lengths[n]],
                                       r[n, : lengths[n]], atol=1e-4)
