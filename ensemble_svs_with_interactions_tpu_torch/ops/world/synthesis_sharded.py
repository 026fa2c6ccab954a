"""Time-sharded WORLD synthesis: one long track's frames split over the
devices of a mesh.  The counterpart of
``ensemble_svs_with_interactions_tpu/ops/world/synthesis_sharded.py``.

The vocoder is per-frame almost everywhere (the transfer functions, the
per-frame FFT filtering), so each device takes a contiguous run of
frames.  Two things couple neighbouring frames, and the JAX package leaves
them to GSPMD's collectives; here they are carried explicitly:

* the excitation phase, a cumulative sum over every sample: each shard
  sums its own increments from 0 (the blockwise wrapped cumsum of
  ``synthesis._wrapped_phase``), its total mod 1 feeds an exclusive scan
  of offsets on the host, and each shard adds its offset;
* the neighbours' samples: the fractional pulse delay reaches
  ``PULSE_HALF`` samples back and ``PULSE_HALF - 1`` forward, so each
  shard computes its pulses over a halo of ``PULSE_HALF`` samples of
  phase, increment, f0 and amplitude copied from each neighbour (zeros at
  the track's ends, as the single-device call pads); and each frame's
  filtered output spans ``ceil(fft_size / hop)`` hops, so each shard
  overlap-adds its frames with their whole tail, and the gathering device
  (the mesh's first) adds the shards in order, each tail into its right
  neighbours' heads.

The result equals the single-device call's up to float order (the phase
offsets sum in another order, which can move a pulse's fractional delay).
Devices of the mesh may repeat: one card then runs its shards in turn.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ensemble_svs_with_interactions_tpu_torch.ops.world import synthesis as S
from ensemble_svs_with_interactions_tpu_torch.ops.world.codec import (
    get_cheaptrick_fft_size,
)
from ensemble_svs_with_interactions_tpu_torch.parallel.mesh import make_mesh


def _mesh_devices(mesh):
    return list((make_mesh() if mesh is None else mesh).devices)


def _noise(noise, samples: int, device):
    """The single-device engine's B = 1 noise row (``gen.vocoder_noise``)
    where none is given."""
    if noise is not None:
        return torch.as_tensor(noise).reshape(-1)[:samples]
    g = torch.Generator(device).manual_seed(0)
    return torch.randn((1, samples), generator=g, device=device)[0]


def _sharded(frames, noise, T: int, devices, hop: int, fft_size: int,
             fs: int, decode):
    """Run the vocoder over ``len(devices)`` contiguous frame shards.
    ``frames``: per-frame (T, ...) inputs, padded to a multiple of the
    shard count with ``decode``'s silent frames; ``decode(*shard frames on
    a device)`` -> (f0 (1, Ts), H, ap)."""
    n = len(devices)
    Ts = -(-T // n)
    N = T * hop
    noise = F.pad(noise.to(torch.float32), (0, n * Ts * hop - N))
    half = S.PULSE_HALF
    shards = []
    for k, dev in enumerate(devices):
        rows = slice(k * Ts, (k + 1) * Ts)
        f0, H, ap = decode(*(f[rows].to(dev) for f in frames))
        f0_s, inc, amp = S.sample_f0(f0, hop, fs)
        local = S._wrapped_phase(inc)
        shards.append({"dev": dev, "f0": f0, "H": H, "ap": ap, "f0_s": f0_s,
                       "inc": inc, "amp": amp, "local": local})
    # the phase's coupling: exclusive scan of the shards' totals mod 1
    offset = torch.zeros((), dtype=torch.float32)
    for sh in shards:
        sh["phase"] = torch.remainder(sh["local"] + offset.to(sh["dev"]),
                                      1.0)
        offset = torch.remainder(offset + sh["local"][0, -1].cpu(), 1.0)
    keys = ("phase", "inc", "f0_s", "amp")
    out = None
    for k, sh in enumerate(shards):
        dev = sh["dev"]

        def halo(j, part):
            if 0 <= j < n:
                return [shards[j][key][:, part].to(dev) for key in keys]
            return [sh[key].new_zeros(1, half) for key in keys]

        left = halo(k - 1, slice(-half, None))
        right = halo(k + 1, slice(None, half))
        ext = [torch.cat([lo, sh[key], hi], dim=1)
               for lo, key, hi in zip(left, keys, right)]
        prev = torch.cat([ext[0].new_zeros(1, 1), ext[0][:, :-1]], dim=1)
        pulses = S.pulse_train(ext[0], prev, *ext[1:])[:, half:-half]
        y = S.filter_frames(pulses, noise[k * Ts * hop:(k + 1) * Ts * hop]
                            .to(dev)[None], sh["f0"] > 0.0, sh["H"],
                            sh["ap"], hop, fft_size)
        acc = S.overlap_add_full(y, hop)[0].to(devices[0])
        if out is None:
            out = acc.new_zeros(n * Ts * hop + acc.shape[0])
        start = k * Ts * hop
        out[start: start + acc.shape[0]] += acc
    return out[:N]


def synthesize_time_sharded(f0, spectrogram, aperiodicity, fs: int,
                            frame_period: float = 5.0, noise=None,
                            mesh=None):
    """One waveform (T * hop,) float32 on the mesh's first device, frames
    sharded over ``mesh`` (default: a mesh over every card).  Same contract
    as :func:`synthesis.synthesize` on one track: f0 (T,) Hz, spectrogram
    (T, fft//2+1) power envelope, aperiodicity (T, fft//2+1) in [0, 1],
    noise (T * hop,) (default: a standard normal from a generator seeded
    0).  Frames pad to a multiple of the shard count with silent frames
    (f0 0, envelope 1, aperiodicity 1, noise 0) and the result trims back
    to T * hop samples."""
    devices = _mesh_devices(mesh)
    hop = int(fs * frame_period / 1000.0)
    fft_size = (int(spectrogram.shape[-1]) - 1) * 2
    f0 = torch.as_tensor(f0, dtype=torch.float32)
    T = int(f0.shape[0])
    pad = (-T) % len(devices)
    sp = F.pad(torch.as_tensor(spectrogram, dtype=torch.float32),
               (0, 0, 0, pad), value=1.0)
    ap = F.pad(torch.as_tensor(aperiodicity, dtype=torch.float32),
               (0, 0, 0, pad), value=1.0)

    def decode(f0_k, sp_k, ap_k):
        return (f0_k[None], S.minimum_phase_spectrum(sp_k[None], fft_size),
                ap_k[None])

    return _sharded((F.pad(f0, (0, pad)), sp, ap),
                    _noise(noise, T * hop, devices[0]), T, devices, hop,
                    fft_size, fs, decode)


def synthesize_from_streams_time_sharded(mgc, lf0, vuv, bap, fs: int,
                                         frame_period: float = 5.0,
                                         vuv_threshold: float = 0.5,
                                         noise=None,
                                         highpass_cutoff: float = 0.0,
                                         mesh=None):
    """One long coded-stream track, frames sharded over ``mesh``: the same
    contract as :func:`synthesis.synthesize_from_streams` on one (T, D)
    track (mgc, lf0 (T, 1), vuv (T, 1), bap), the whole vocoder (codec
    decode, V/UV gating, synthesis, high-pass) on each shard.  ``noise``
    (T * hop,) defaults to the single-device engine's B = 1 row
    (``gen.vocoder_noise``).  Frames pad with silent frames (vuv 0, noise
    0) and trim back.  Returns (T * hop,) float32 on the mesh's first
    device."""
    devices = _mesh_devices(mesh)
    hop = int(fs * frame_period / 1000.0)
    fft_size = get_cheaptrick_fft_size(fs)
    arrs = [torch.as_tensor(a, dtype=torch.float32)
            for a in (mgc, lf0, vuv, bap)]
    T = int(arrs[1].shape[0])
    pad = (-T) % len(devices)
    arrs = [F.pad(a, (0, 0, 0, pad)) for a in arrs]

    def decode(*shard):
        return S.decode_streams(*(a[None] for a in shard), fs, hop, fft_size,
                                float(vuv_threshold), float(highpass_cutoff))

    return _sharded(arrs, _noise(noise, T * hop, devices[0]), T, devices,
                    hop, fft_size, fs, decode)
