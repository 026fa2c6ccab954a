"""Duration-informed autoregressive decoder: the counterpart of
``Prenet``, ``zoneout_blend``, ``_ARDecoderCore``, ``ar_decode`` and the
decoder classes in ``ensemble_svs_with_interactions_tpu/models/tacotron.py``.

Every option of the JAX decoder is ported: the pre-net (``prenet_layers``,
its dropout on at evaluation too unless ``eval_dropout`` is False),
zoneout, the prenet-less Gaussian noise on the fed-back frame
(``prenet_noise_std``), the prenet-less dropout, the residual-F0 head
(scaled tanh or not) and the dim-wise MDN head (``use_mdn``), at any
reduction factor, with or without the strided-conv downsampling.

Inference is a Python loop over the T / r reduced steps.  The parts of
each step that do not depend on the fed-back frame (the encoder's share of
the first cell's input projection and of the output heads) are computed
for all steps in one matmul before the loop.

Teacher forcing (training, or evaluation with targets) feeds the decoder
the current target frame through the pre-net where there is one, and the
previous target frame (the go frame ``initial_value`` at the first step)
where there is none, as the JAX package does.  Every input of the first
LSTM cell is then known before the loop.  With ``zoneout == 0`` each cell
runs as one recurrence over the whole sequence (the hand-written forward
and BPTT kernels on the card), and the output heads run batched: there is
no per-step Python loop.  Zoneout blends each step's state with the
previous one (Bernoulli masks in training, ``p * prev + (1 - p) * new`` at
evaluation), which changes the recurrence itself: with ``zoneout > 0`` the
cells step in PyTorch, one layer after the other, the recurrence in
float32 as on the kernels.

Random draws (dropout and zoneout masks, the prenet noise, MDN sampling)
come from an explicit ``torch.Generator`` on the generator's own device
and move to the data's: a CPU generator gives the same draws on the card
and the CPU.  They cannot reproduce ``jax.random``'s bits, so parity with
the JAX package is tested with the probabilities at 0, at evaluation, or
with JAX's own masks and noise handed in where the decoder takes its
draws.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ensemble_svs_with_interactions_tpu_torch.base import (
    BaseModel,
    PredictionType,
)
from ensemble_svs_with_interactions_tpu_torch.models.layers import (
    MaskedBatchNorm,
    dropout,
    lstm_sequence,
    lstm_weights_init,
    time_mask,
)
from ensemble_svs_with_interactions_tpu_torch.parallel.mesh import shard_draw
from ensemble_svs_with_interactions_tpu_torch.ops.mdn import (
    mdn_get_most_probable_sigma_and_mu,
)

_MAX_LF0_RATIO = 600.0 * np.log(2) / 1200.0


def lf0_residual(raw):
    """The residual log-F0 ``_MAX_LF0_RATIO * tanh(raw)``, in float32 at
    least.  The JAX package's ratio is a NumPy float64 scalar, which JAX
    does not take as a weak type: it promotes a bf16 ``tanh`` to float32.
    So under AMP the predicted log-F0, the score's denormalized log-F0
    (about 6, where bf16 steps by 0.03) plus this residual (at most 0.35),
    is summed in float32, and only its normalized value is rounded to the
    output's dtype."""
    t = torch.tanh(raw)
    return _MAX_LF0_RATIO * t.to(torch.promote_types(t.dtype,
                                                     torch.float32))


class LSTMCell(nn.Module):
    """One LSTM cell with the recurrence kernel's weight layout: w_x (C, 4H),
    w_h (H, 4H), b (4H,), gate order i, f, g, o (flax OptimizedLSTMCell)."""

    def __init__(self, in_dim: int, hidden_dim: int):
        super().__init__()
        self.w_x, self.w_h, self.b = lstm_weights_init(in_dim, hidden_dim)

    def sequence(self, x):
        """Hidden states (B, T, H) of the cell run over x (B, T, C) from a
        zero state (the recurrence in float32 under bf16)."""
        return lstm_sequence(x, self.w_x, self.b, self.w_h)

    @staticmethod
    def update(z, c):
        """Gate pre-activations z (B, 4H) and cell c -> (new c, new h)."""
        i, f, g, o = z.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return c, torch.sigmoid(o) * torch.tanh(c)


def _uniform(shape, generator, device, batch_axis: int):
    """Uniform draws in [0, 1) from ``generator`` on its own device, moved
    to ``device``; the batch at ``batch_axis`` (a mesh shard's rows cut
    from the whole batch's draw, ``parallel.mesh.shard_draw``)."""
    return shard_draw(lambda s: torch.rand(s, generator=generator,
                                           device=generator.device),
                      shape, batch_axis).to(device)


def _normal(shape, generator, device, dtype, batch_axis: int):
    """Standard normal draws from ``generator`` on its own device, moved to
    ``device`` in ``dtype``; the batch at ``batch_axis``."""
    return shard_draw(lambda s: torch.randn(s, generator=generator,
                                            device=generator.device),
                      shape, batch_axis).to(device, dtype)


def prenet_dropout_scales(shape, p: float, generator, device,
                          dtype=torch.float32):
    """Multipliers for the fed-back frames of a prenet-less decoder:
    1 / (1 - p) where a unit is kept (probability 1 - p), 0 where dropped,
    in the ``dtype`` of the frames they scale.  Drawn from ``generator``
    on its own device and moved to ``device``, so a CPU generator gives
    the same masks on every device."""
    keep = _uniform(shape, generator, device, 1) < (1.0 - p)
    return keep.to(dtype) / (1.0 - p)


class Prenet(nn.Module):
    """Tacotron pre-net: ``layers`` of ``fc{i}`` (Dense, ``hidden_dim``
    wide) and ReLU, with dropout ``dropout`` after the Dense and again
    after the ReLU (twice a layer, as the JAX package and the reference
    apply it).  Dropout applies where the caller hands the keep masks
    (:meth:`draw_masks`, or JAX's replayed), and not without them."""

    def __init__(self, in_dim: int, layers: int = 2, hidden_dim: int = 256,
                 dropout: float = 0.5):
        super().__init__()
        self.layers, self.hidden_dim = layers, hidden_dim
        self.dropout = dropout
        for i in range(layers):
            setattr(self, f"fc{i}", nn.Linear(in_dim if i == 0
                                              else hidden_dim, hidden_dim))

    def draw_masks(self, lead_shape, generator, device):
        """The 2 * ``layers`` keep masks (each ``lead_shape + (hidden,)``,
        True with probability 1 - ``dropout``) of one forward, stacked on
        a first axis; None with no dropout."""
        if self.dropout <= 0:
            return None
        if generator is None:
            raise ValueError("prenet dropout needs a torch.Generator")
        return _uniform((2 * self.layers, *lead_shape, self.hidden_dim),
                        generator, device, 2) < (1.0 - self.dropout)

    def forward(self, x, masks=None):
        def drop(v, k):
            if masks is None:
                return v
            return torch.where(masks[k], v / (1.0 - self.dropout),
                               torch.zeros_like(v))

        for i in range(self.layers):
            x = drop(getattr(self, f"fc{i}")(x), 2 * i)
            x = drop(torch.relu(x), 2 * i + 1)
        return x


def zoneout_blend(prev_state, new_state, prob: float, train: bool,
                  masks=None):
    """Zoneout on an LSTM (c, h) state tuple: in training each unit keeps
    its previous value where its mask is True (``masks`` = (c's, h's),
    True with probability ``prob``), at evaluation the deterministic
    blend ``prob * prev + (1 - prob) * new``."""
    if prob <= 0.0:
        return new_state
    if train:
        return tuple(torch.where(m, p, n)
                     for p, n, m in zip(prev_state, new_state, masks))
    return tuple(prob * p + (1.0 - prob) * n
                 for p, n in zip(prev_state, new_state))


class _ARDecoderCore(nn.Module):
    """Decoder LSTM cells ``cell{i}``, the optional ``prenet`` and the
    output head over ``[h, enc]``: the bias-free ``feat_out`` (unit order
    (dim, step)) or, with ``use_mdn``, the dim-wise MDN Denses ``log_pi``,
    ``log_sigma`` and ``mu`` (unit order (gaussian, step, dim)).
    :meth:`forward` runs the whole inference loop and
    :meth:`teacher_forced` the decoder over known targets.  With
    ``residual_f0`` the output's ``out_lf0_idx`` column (of every mixture
    component under MDN) is the score's log-F0 plus a residual, bounded
    by a scaled tanh when ``scaled_tanh``; without, the residuals are
    zeros.  The first fed frame is ``initial_value`` everywhere."""

    def __init__(self, enc_dim: int, out_dim: int, layers: int,
                 hidden_dim: int, prenet_layers: int = 0,
                 prenet_hidden_dim: int = 256, prenet_dropout: float = 0.5,
                 zoneout: float = 0.0, reduction_factor: int = 1,
                 residual_f0: bool = False, scaled_tanh: bool = True,
                 out_lf0_idx: int = 0, out_lf0_mean: float = 0.0,
                 out_lf0_scale: float = 1.0, use_mdn: bool = False,
                 num_gaussians: int = 8, sampling_mode: str = "mean",
                 prenet_noise_std: float = 0.0, eval_dropout: bool = True,
                 initial_value: float = 0.0):
        super().__init__()
        self.out_dim, self.layers = out_dim, layers
        self.hidden_dim, self.r = hidden_dim, reduction_factor
        self.prenet_dropout, self.zoneout = prenet_dropout, zoneout
        self.residual_f0, self.scaled_tanh = residual_f0, scaled_tanh
        self.out_lf0_idx = out_lf0_idx
        self.out_lf0_mean, self.out_lf0_scale = out_lf0_mean, out_lf0_scale
        self.use_mdn, self.num_gaussians = use_mdn, num_gaussians
        self.sampling_mode = sampling_mode
        self.prenet_noise_std = prenet_noise_std
        self.eval_dropout = eval_dropout
        self.initial_value = initial_value
        self.prenet = (Prenet(out_dim, prenet_layers, prenet_hidden_dim,
                              prenet_dropout)
                       if prenet_layers > 0 else None)
        fed = prenet_hidden_dim if prenet_layers > 0 else out_dim
        for i in range(layers):
            setattr(self, f"cell{i}",
                    LSTMCell(enc_dim + fed if i == 0 else hidden_dim,
                             hidden_dim))
        hcs = hidden_dim + enc_dim
        if use_mdn:
            n = num_gaussians * reduction_factor * out_dim
            self.log_pi = nn.Linear(hcs, n)
            self.log_sigma = nn.Linear(hcs, n)
            self.mu = nn.Linear(hcs, n)
        else:
            self.feat_out = nn.Linear(hcs, out_dim * reduction_factor,
                                      bias=False)

    # ------------------------------------------------------------ draws
    def _draws(self, T: int, B: int, device, dtype, generator, train: bool,
               inference: bool) -> dict:
        """Every random tensor one decode over T reduced steps needs, time
        major, drawn in a fixed order: the pre-net's keep masks (where its
        dropout is on: in training or with ``eval_dropout``), the prenet
        noise, the zoneout masks of each layer (training), the MDN
        sampling noise (inference with ``sampling_mode: random``).  The
        prenet-less dropout draws its own (:func:`prenet_dropout_scales`,
        :func:`layers.dropout`)."""
        D, Hd = self.out_dim, self.hidden_dim
        want = {
            "prenet": (self.prenet is not None and self.prenet_dropout > 0
                       and (train or self.eval_dropout)),
            "noise": self.prenet is None and self.prenet_noise_std > 0,
            "zoneout": self.zoneout > 0 and train,
            "eps": (inference and self.use_mdn
                    and self.sampling_mode == "random"),
        }
        if any(want.values()) and generator is None:
            raise ValueError("the AR decoder's random draws need a "
                             "torch.Generator")
        out = {}
        if want["prenet"]:
            out["prenet"] = self.prenet.draw_masks((T, B), generator, device)
        if want["noise"]:
            out["noise"] = _normal((T, B, D), generator, device, dtype, 1)
        if want["zoneout"]:
            out["zoneout"] = _uniform((self.layers, 2, T, B, Hd), generator,
                                      device, 3) < self.zoneout
        if want["eps"]:
            out["eps"] = _normal((T, B, self.r, D), generator, device, dtype,
                                 1)
        return out

    # ------------------------------------------------------------ heads
    def _heads(self):
        return ([self.log_pi, self.log_sigma, self.mu] if self.use_mdn
                else [self.feat_out])

    def _head_weights(self):
        """(w_h (H, n), w_enc (C, n), bias (n,) or None) of the heads
        concatenated, split at the hidden state's share of their input."""
        Hd = self.hidden_dim
        w = torch.cat([m.weight for m in self._heads()], dim=0)
        b = (torch.cat([m.bias for m in self._heads()])
             if self.use_mdn else None)
        return w[:, :Hd].t(), w[:, Hd:].t(), b

    def _res(self, raw):
        return lf0_residual(raw) if self.scaled_tanh else raw

    def _put_lf0(self, x, res, den):
        """x (..., D) with its ``out_lf0_idx`` column replaced by the
        normalized log-F0 ``den + res``."""
        k = self.out_lf0_idx
        lf0 = (den + res - self.out_lf0_mean) / self.out_lf0_scale
        return torch.cat([x[..., :k], lf0[..., None].to(x.dtype),
                          x[..., k + 1:]], dim=-1)

    def _outputs(self, raw, lf0_den):
        """Head outputs ``raw`` (..., n) and the score's log-F0 ``lf0_den``
        (..., r) -> deterministic: (out (..., r, D), res (..., r));
        MDN: ((log_pi, log_sigma, mu) each (..., G, r, D), res
        (..., r, G))."""
        D, r, k = self.out_dim, self.r, self.out_lf0_idx
        lead = raw.shape[:-1]
        if not self.use_mdn:
            out = raw.reshape(*lead, D, r).transpose(-1, -2)
            if not self.residual_f0:
                return out, out.new_zeros(*lead, r)
            res = self._res(out[..., k])
            return self._put_lf0(out, res, lf0_den), res
        G = self.num_gaussians
        log_pi, log_sigma, mu = (
            a.reshape(*lead, G, r, D) for a in raw.chunk(3, dim=-1))
        log_pi = torch.log_softmax(log_pi, dim=-3)
        if self.residual_f0:
            res = self._res(mu[..., k])                    # (..., G, r)
            mu = self._put_lf0(mu, res, lf0_den.unsqueeze(-2))
            res = res.transpose(-1, -2)                    # (..., r, G)
        else:
            res = mu.new_zeros(*lead, r, G)
        return (log_pi, log_sigma, mu), res

    def _select(self, params, eps_t=None):
        """Per-dimension most probable component of one step's (B, G, r,
        D) mixtures -> (mu_sel, sigma_sel) (B, r, D), sampled around
        mu_sel with ``eps_t`` (B, r, D) where given."""
        lp, ls, m = (a.transpose(1, 2) for a in params)  # (B, r, G, D)
        sigma, mu = mdn_get_most_probable_sigma_and_mu(lp, ls, m)
        if eps_t is not None:
            mu = mu + sigma * eps_t
        return mu, sigma

    # ------------------------------------------------------------ decode
    def forward(self, enc, lf0_den, generator=None, train: bool = False):
        """Free-running decode.  enc (B, T, C) reduced-rate encoder
        outputs, lf0_den (B, T, r) denormalized score log-F0 (None without
        ``residual_f0``) -> outs (B, T, r, D), res (B, T, r); under MDN
        ((mu_sel, sigma_sel) (B, T, r, D) each, res (B, T, r, G))."""
        B, T, C = enc.shape
        D, Hd = self.out_dim, self.hidden_dim
        draws = self._draws(T, B, enc.device, enc.dtype, generator, train,
                            inference=True)
        feed = self._feed(draws, T, B, enc, generator)
        zmask = draws.get("zoneout")
        eps = draws.get("eps")
        cell0 = self.cell0
        xw_enc = torch.matmul(enc, cell0.w_x[:C]) + cell0.b
        w_fed = cell0.w_x[C:]
        w_head_h, w_head_enc, b_head = self._head_weights()
        head_enc = torch.matmul(enc, w_head_enc)
        if b_head is not None:
            head_enc = head_enc + b_head
        cells = [getattr(self, f"cell{i}") for i in range(self.layers)]
        cs = [enc.new_zeros(B, Hd) for _ in range(self.layers)]
        hs = [enc.new_zeros(B, Hd) for _ in range(self.layers)]
        prev = enc.new_full((B, D), self.initial_value)
        outs, ress = [], []
        for t in range(T):
            fed = feed(prev, t)
            inp = None
            for i, cell in enumerate(cells):
                if i == 0:
                    z = xw_enc[:, t] + fed @ w_fed + hs[0] @ cell.w_h
                else:
                    z = inp @ cell.w_x + (hs[i] @ cell.w_h + cell.b)
                new = LSTMCell.update(z, cs[i])
                if self.zoneout > 0:
                    new = zoneout_blend(
                        (cs[i], hs[i]), new, self.zoneout, train,
                        None if zmask is None else zmask[i, :, t])
                cs[i], hs[i] = new
                inp = hs[i]
            raw = inp @ w_head_h + head_enc[:, t]
            out, res = self._outputs(
                raw, None if lf0_den is None else lf0_den[:, t])
            if self.use_mdn:
                out = self._select(out, None if eps is None else eps[t])
            prev = out[0][:, -1] if self.use_mdn else out[:, -1]
            outs.append(out)
            ress.append(res)
        res = torch.stack(ress, dim=1)
        if self.use_mdn:
            return tuple(torch.stack(o, dim=1) for o in zip(*outs)), res
        return torch.stack(outs, dim=1), res

    def _feed(self, draws, T: int, B: int, enc, generator):
        """The free-running decode's ``feed(prev, t)``: step t's input from
        the previous output frame, through the pre-net (with its masks
        of step t where its dropout is on), with the prenet noise, or
        through the prenet-less dropout (masks from ``generator``)."""
        if self.prenet is not None:
            masks = draws.get("prenet")
            if masks is None:
                return lambda prev, t: self.prenet(prev)
            return lambda prev, t: self.prenet(prev, masks[:, t])
        if "noise" in draws:
            noise = self.prenet_noise_std * draws["noise"]
            return lambda prev, t: prev + noise[t]
        if self.prenet_dropout <= 0:
            return lambda prev, t: prev
        if generator is None:
            raise ValueError("prenet dropout at inference needs a "
                             "torch.Generator")
        scales = prenet_dropout_scales((T, B, self.out_dim),
                                       self.prenet_dropout, generator,
                                       enc.device, enc.dtype)
        return lambda prev, t: prev * scales[t]

    def _zoneout_sequence(self, cell, x, masks, train: bool):
        """Hidden states (B, T, H) of ``cell`` over x (B, T, C) from a zero
        state, each step's state blended by :func:`zoneout_blend` (masks
        (2, T, B, H) in training).  The input projection runs in x's
        dtype, the recurrence in float32, as ``cell.sequence`` runs it."""
        xw = (torch.matmul(x, cell.w_x) + cell.b).float()
        w_h = cell.w_h.float()
        B, T = x.shape[0], x.shape[1]
        c = h = xw.new_zeros(B, self.hidden_dim)
        hs = []
        for t in range(T):
            new = LSTMCell.update(xw[:, t] + h @ w_h, c)
            c, h = zoneout_blend((c, h), new, self.zoneout, train,
                                 None if masks is None else masks[:, t])
            hs.append(h)
        return torch.stack(hs, dim=1).to(x.dtype)

    def teacher_forced(self, enc, tgt, lf0_den, generator=None,
                       train: bool = False):
        """enc (B, T, C) reduced-rate encoder outputs, tgt (B, T, D) the
        targets at the reduced rate, lf0_den (B, T, r) -> outs
        (B, T, r, D), res (B, T, r); under MDN ((log_pi, log_sigma, mu)
        (B, T, G, r, D) each, res (B, T, r, G)).  The pre-net takes the
        current target frame; without one the decoder is fed the previous
        frame, with the prenet noise or through Bernoulli dropout with p =
        ``prenet_dropout`` (masks from ``generator``)."""
        B, T, _ = enc.shape
        D = self.out_dim
        draws = self._draws(T, B, enc.device, enc.dtype, generator, train,
                            inference=False)
        if self.prenet is not None:
            masks = draws.get("prenet")
            fed = self.prenet(tgt, None if masks is None
                              else masks.transpose(1, 2))
        else:
            fed = torch.cat([tgt.new_full((B, 1, D), self.initial_value),
                             tgt[:, :-1]], dim=1)
            if "noise" in draws:
                fed = fed + self.prenet_noise_std * draws["noise"].transpose(
                    0, 1)
            else:
                if self.prenet_dropout > 0 and generator is None:
                    raise ValueError("prenet dropout needs a torch.Generator")
                fed = dropout(fed, self.prenet_dropout, generator)
        h = torch.cat([enc, fed], dim=-1)
        zmask = draws.get("zoneout")
        for i in range(self.layers):
            cell = getattr(self, f"cell{i}")
            if self.zoneout <= 0:
                h = cell.sequence(h)
            else:
                h = self._zoneout_sequence(
                    cell, h, None if zmask is None else zmask[i], train)
        hcs = torch.cat([h, enc], dim=-1)
        raw = torch.cat([m(hcs) for m in self._heads()], dim=-1)
        return self._outputs(raw, lf0_den)


def ar_decode(parent, encoder_outs, in_lf0_idx=None, lf0_params=None,
              generator=None, targets=None, train: bool = False):
    """AR decode for a decoder module ``parent`` that owns
    ``conv_downsample`` (the depthwise stride-r conv that takes the
    encoder to the reduced rate; None takes every r-th frame, or every
    frame at r = 1) and ``ar_core``: free-running inference, or
    teacher-forced over ``targets`` (B, T, D), of which every r-th frame
    (``[:, r-1::r]``) is the reduced-rate target.  With ``lf0_params``
    (in_lf0_min, in_lf0_max) the decode is residual-F0 around the score
    log-F0 at ``in_lf0_idx`` of the encoder outputs.  ``train`` turns on
    the pre-net's dropout (also on at evaluation with ``eval_dropout``)
    and zoneout's masks (its deterministic blend otherwise).

    encoder_outs (B, T, C) -> (outs, lf0_residual): outs (B, T, D) and
    the residual (B, T, 1), or None without residual F0.  Under MDN outs
    is ``(log_pi, log_sigma, mu)`` (B, T, G, D) teacher-forced and
    ``(mu, sigma)`` (B, T, D) of the per-dimension most probable component
    free-running, and the residual (B, T, G) covers every component.
    """
    r = parent.reduction_factor
    core = parent.ar_core
    B, T_orig, _ = encoder_outs.shape
    pad = (-T_orig) % r
    if pad:
        encoder_outs = F.pad(encoder_outs, (0, 0, 0, pad))
        if targets is not None:
            targets = F.pad(targets, (0, 0, 0, pad))
    if parent.conv_downsample is not None:
        enc = parent.conv_downsample(
            encoder_outs.transpose(1, 2)).transpose(1, 2)
    else:
        enc = encoder_outs[:, r - 1:: r]
    T = enc.shape[1]
    lf0_den = None
    if lf0_params is not None:
        in_lf0_min, in_lf0_max = lf0_params
        lf0_score = encoder_outs[:, :, in_lf0_idx]
        lf0_den = (lf0_score * (in_lf0_max - in_lf0_min)
                   + in_lf0_min).reshape(B, -1, r)[:, :T]
    if targets is None:
        outs, res = core(enc, lf0_den, generator, train)
    else:
        outs, res = core.teacher_forced(
            enc, targets[:, r - 1:: r].to(enc.dtype), lf0_den, generator,
            train)
    if core.use_mdn:
        G = core.num_gaussians
        if targets is None:
            outs = tuple(o.reshape(B, T * r, -1)[:, :T_orig] for o in outs)
        else:
            outs = tuple(o.movedim(3, 2).reshape(B, T * r, G, -1)[:, :T_orig]
                         for o in outs)
        res = res.reshape(B, T * r, G)
    else:
        outs = outs.reshape(B, T * r, -1)[:, :T_orig]
        res = res.reshape(B, T * r, 1)
    if lf0_params is None:
        return outs, None
    return outs, res[:, :T_orig]


class Postnet(nn.Module):
    """Tacotron 2 Post-Net: ``layers`` bias-free convs (``conv{i}``, zero
    padding (k - 1) / 2, ``channels`` wide, the last back to the input's
    width), each followed by a masked batch norm (``bn{i}``), tanh but
    after the last, and dropout ``dropout`` in training."""

    def __init__(self, in_dim: int, layers: int = 5, channels: int = 512,
                 kernel_size: int = 5, dropout: float = 0.5):
        super().__init__()
        self.layers, self.dropout = layers, dropout
        for i in range(layers):
            cin = in_dim if i == 0 else channels
            cout = in_dim if i == layers - 1 else channels
            setattr(self, f"conv{i}", nn.Conv1d(
                cin, cout, kernel_size, padding=(kernel_size - 1) // 2,
                bias=False))
            setattr(self, f"bn{i}", MaskedBatchNorm(cout))

    def forward(self, x, mask=None, train: bool = False, generator=None):
        for i in range(self.layers):
            x = getattr(self, f"conv{i}")(x.transpose(1, 2)).transpose(1, 2)
            x = getattr(self, f"bn{i}")(x, mask=mask, train=train)
            if i != self.layers - 1:
                x = torch.tanh(x)
            if train and self.dropout > 0:
                x = dropout(x, self.dropout, generator)
        return x


def apply_postnet(parent, outs, lengths, train: bool, generator=None):
    """``[outs, outs + postnet(outs)]``, the coarse and fine outputs the
    trainer supervises both; inference takes the last.  The Post-Net's
    batch statistics cover the valid steps of ``lengths``."""
    mask = time_mask(lengths, outs.shape[1], outs.device)
    return [outs, outs + parent.postnet(outs, mask, train, generator)]


def add_ar_decoder(module, enc_dim: int, out_dim: int, layers: int,
                   hidden_dim: int, reduction_factor: int,
                   downsample_by_conv: bool, postnet_layers: int = 0,
                   postnet_channels: int = 512, postnet_kernel_size: int = 5,
                   postnet_dropout: float = 0.0, **core):
    """Give ``module`` the AR decoder over ``enc_dim``-wide encoder
    outputs: ``conv_downsample`` (None unless r > 1 with
    ``downsample_by_conv``), ``ar_core`` (an :class:`_ARDecoderCore` with
    the options ``core``) and, with ``postnet_layers > 0`` and no MDN
    head, ``postnet`` (else None)."""
    module.reduction_factor = reduction_factor
    module.conv_downsample = (
        nn.Conv1d(enc_dim, enc_dim, reduction_factor,
                  stride=reduction_factor, groups=enc_dim)
        if reduction_factor > 1 and downsample_by_conv else None)
    module.ar_core = _ARDecoderCore(enc_dim, out_dim, layers, hidden_dim,
                                    reduction_factor=reduction_factor,
                                    **core)
    module.postnet = (Postnet(out_dim, postnet_layers, postnet_channels,
                              postnet_kernel_size, postnet_dropout)
                      if postnet_layers > 0 and not core.get("use_mdn")
                      else None)


def decode_and_refine(module, encoder_outs, lengths, y, train: bool,
                      generator):
    """The non-residual AR decode of a module built by
    :func:`add_ar_decoder`, then its Post-Net where it has one."""
    outs, _ = ar_decode(module, encoder_outs, generator=generator, targets=y,
                        train=train)
    if module.postnet is not None:
        return apply_postnet(module, outs, lengths, train, generator)
    return outs


class NonAttentiveDecoder(BaseModel):
    """Duration-informed Tacotron decoder without attention over encoder
    outputs (B, T, ``in_dim``): the downsampling to the reduced rate, the
    AR decoder core from the go frame ``initial_value`` and, with
    ``postnet_layers > 0`` and no MDN head, the residual Post-Net
    (``[coarse, fine]``).  With ``use_mdn`` it is PROBABILISTIC: MDN
    parameters teacher-forced, ``(mu, sigma)`` free-running."""

    def __init__(self, in_dim: int = 512, out_dim: int = 80, layers: int = 2,
                 hidden_dim: int = 1024, prenet_layers: int = 2,
                 prenet_hidden_dim: int = 256, prenet_dropout: float = 0.5,
                 zoneout: float = 0.1, reduction_factor: int = 1,
                 downsample_by_conv: bool = False, init_type: str = "none",
                 initial_value: float = 0.0, use_mdn: bool = False,
                 num_gaussians: int = 8, sampling_mode: str = "mean",
                 prenet_noise_std: float = 0.0, eval_dropout: bool = True,
                 postnet_layers: int = 0, postnet_channels: int = 512,
                 postnet_kernel_size: int = 5, postnet_dropout: float = 0.0):
        super().__init__()
        self.use_mdn = use_mdn
        add_ar_decoder(
            self, in_dim, out_dim, layers, hidden_dim, reduction_factor,
            downsample_by_conv, postnet_layers, postnet_channels,
            postnet_kernel_size, postnet_dropout,
            prenet_layers=prenet_layers, prenet_hidden_dim=prenet_hidden_dim,
            prenet_dropout=prenet_dropout, zoneout=zoneout, use_mdn=use_mdn,
            num_gaussians=num_gaussians, sampling_mode=sampling_mode,
            prenet_noise_std=prenet_noise_std, eval_dropout=eval_dropout,
            initial_value=float(initial_value))

    def is_autoregressive(self) -> bool:
        return True

    def prediction_type(self):
        return (PredictionType.PROBABILISTIC if self.use_mdn
                else PredictionType.DETERMINISTIC)

    def forward(self, encoder_outs, lengths=None, y=None, train: bool = False,
                generator=None):
        return decode_and_refine(self, encoder_outs, lengths, y, train,
                                 generator)

    def inference(self, x, lengths=None, generator=None):
        outs = self(x, lengths, generator=generator)
        return outs[-1] if isinstance(outs, list) else outs


class MDNNonAttentiveDecoder(NonAttentiveDecoder):
    """:class:`NonAttentiveDecoder` with the MDN head on by default."""

    def __init__(self, *args, use_mdn: bool = True, **kwargs):
        super().__init__(*args, use_mdn=use_mdn, **kwargs)
