"""The AR decoder options on the port against the JAX package, on the CPU,
at tiny widths: ``Prenet`` and ``zoneout_blend`` (``models/tacotron.py``),
and every AR decoder class (``NonAttentiveDecoder``,
``MDNNonAttentiveDecoder``, ``ResF0NonAttentiveDecoder``,
``MDNResF0NonAttentiveDecoder``, ``BiLSTMResF0NonAttentiveDecoder``,
``MultiTrackBiLSTMResF0NonAttentiveDecoder``, ``BiLSTMNonAttentiveDecoder``,
``BiLSTMMDNNonAttentiveDecoder``) with the pre-net, zoneout, the prenet
noise, ``scaled_tanh`` and ``eval_dropout`` either way and the MDN heads
with random sampling, at r = 1 and 2 and both downsamplings.

Weights are the port's, drawn by ``utils/flax_init`` and carried to the JAX
twin with ``torch_to_flax``; inputs are seeded NumPy arrays with mixed
lengths and an odd T.  Random draws cannot match across the frameworks,
so JAX's are replayed: ``Prenet`` and ``zoneout_blend`` take JAX's own
masks (recorded from ``jax.random.bernoulli``, or rebuilt from the split
keys), and in the decoders ``replayed_draws`` records every
``jax.random.bernoulli`` / ``normal`` draw of a JAX run in call order and
hands the port's ``_draws`` each slot's masks and noise from it, step by
step, layer by layer, c and h apart.  Teacher-forced and free-running
outputs (MDN tuples included) at ATOL: over T / r <= 23 steps at these widths the
free-running decode is not yet chaotic, so no float64 oracle is needed.
The gradients of a teacher-forced training loss at GRAD_ATOL of their
scale.
"""

import contextlib
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ensemble_svs_with_interactions_tpu.models import tacotron as jax_tacotron
from ensemble_svs_with_interactions_tpu.utils.config import (
    instantiate as jax_instantiate,
)
from ensemble_svs_with_interactions_tpu_torch.base import PredictionType
from ensemble_svs_with_interactions_tpu_torch.models import tacotron
from ensemble_svs_with_interactions_tpu_torch.utils.config import instantiate
from ensemble_svs_with_interactions_tpu_torch.utils.flax_init import (
    init_module,
    init_variables,
)
from ensemble_svs_with_interactions_tpu_torch.utils.flax_port import (
    flax_to_torch,
    torch_to_flax,
)
from tests.test_torch_npss_ar import LENGTHS, B, T
from tests.test_torch_svs import few_threads  # noqa: F401

ATOL = 1e-5
GRAD_ATOL = 2e-5
PKG = "ensemble_svs_with_interactions_tpu.models"
LF0 = {"in_lf0_min": 5.2, "in_lf0_max": 6.6, "out_lf0_mean": 5.9,
       "out_lf0_scale": 0.25}
RNGS = {"prenet": jax.random.PRNGKey(0), "zoneout": jax.random.PRNGKey(1),
        "dropout": jax.random.PRNGKey(2)}


def expected_draws(core, train: bool, inference: bool) -> dict:
    """What JAX's ``_ARDecoderCore`` draws at each step, in its call order
    (``models/tacotron.py:177-264`` of the JAX package), as the counts of
    the slots of the port's ``_draws``: the pre-net's 2 * layers keep masks
    where its dropout is on; without a pre-net one noise or keep-mask draw
    (drawn even at p = 0); zoneout's c and h masks of each layer in
    training; the MDN sampling noise in random-mode inference."""
    if core.prenet is None:
        pre = 1
    elif core.prenet_dropout > 0 and (train or core.eval_dropout):
        pre = 2 * core.prenet.layers
    else:
        pre = 0
    return {"pre": pre,
            "zoneout": 2 * core.layers if core.zoneout > 0 and train else 0,
            "eps": int(inference and core.use_mdn
                       and core.sampling_mode == "random")}


class Replay:
    """JAX's random draws, recorded in call order as JAX makes them, and
    the port's AR-decoder draws rebuilt from them: each ``_draws`` call of
    the port takes the next decoder's T steps of draws, slot by slot in
    JAX's order (step t, then the pre-net's masks, then layer i's c and h
    zoneout masks, then the sampling noise).  So a mask read at the wrong
    step, layer or c/h slot is a different mask, as it would be in JAX."""

    def __init__(self):
        self.drawn, self.at, self.keep = [], 0, None

    def record(self, draw):
        def recorded(*args, **kwargs):
            v = draw(*args, **kwargs)
            jax.debug.callback(lambda a: self.drawn.append(np.asarray(a)), v,
                               ordered=True)
            return v
        return recorded

    def take(self, shape=None):
        jax.effects_barrier()
        v = self.drawn[self.at]
        self.at += 1
        assert shape is None or tuple(v.shape) == tuple(shape), (
            v.shape, shape)
        return torch.from_numpy(np.array(v))

    def rewind(self):
        self.at, self.keep = 0, None

    def assert_spent(self):
        """The port took every draw JAX made, no more, no fewer."""
        jax.effects_barrier()
        assert self.at == len(self.drawn), (self.at, len(self.drawn))

    def port_draws(self, real):
        def draws(core, T, B, device, dtype, generator, train, inference):
            mine = real(core, T, B, device, dtype,
                        torch.Generator().manual_seed(0), train, inference)
            n = expected_draws(core, train, inference)
            steps = [[self.take() for _ in range(sum(n.values()))]
                     for _ in range(T)]

            def slot(j):
                return torch.stack([s[j] for s in steps])   # (T, ...)

            want, self.keep = {}, None
            if core.prenet is None:
                if core.prenet_noise_std > 0:
                    want["noise"] = slot(0).to(device, dtype)
                else:
                    self.keep = slot(0)
            elif n["pre"]:
                want["prenet"] = torch.stack([slot(j)
                                              for j in range(n["pre"])])
            if n["zoneout"]:
                z = n["pre"]
                want["zoneout"] = torch.stack([
                    torch.stack([slot(z + 2 * i), slot(z + 2 * i + 1)])
                    for i in range(core.layers)])
            if n["eps"]:
                want["eps"] = slot(n["pre"] + n["zoneout"]).reshape(
                    mine["eps"].shape).to(device, dtype)
            assert sorted(mine) == sorted(want), (sorted(mine), sorted(want))
            for k, v in want.items():
                assert v.shape == mine[k].shape and v.dtype == mine[k].dtype, k
            return want
        return draws

    def port_scales(self, shape, p, generator, device, dtype=torch.float32):
        keep, self.keep = self.keep, None
        assert tuple(keep.shape) == tuple(shape)
        return keep.to(device, dtype) / (1.0 - p)

    def port_dropout(self, x, p, generator):
        """The pre-net-less decoder's teacher-forced dropout takes the
        step's keep masks of the last ``_draws``; any other (a Post-Net's)
        takes JAX's next draw, an ``nn.Dropout`` mask of x's shape."""
        keep, self.keep = self.keep, None
        if p <= 0:
            return x
        keep = (keep.transpose(0, 1) if keep is not None
                else self.take(x.shape))
        return torch.where(keep, x / (1 - p), torch.zeros_like(x))


@contextlib.contextmanager
def replayed_draws():
    """Record JAX's ``jax.random.bernoulli`` / ``normal`` draws (JAX's own,
    from its keys) and replay them in the port's AR decoders
    (:class:`Replay`).  Yields the :class:`Replay`."""
    replay = Replay()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "bernoulli",
                   replay.record(jax.random.bernoulli))
        mp.setattr(jax.random, "normal", replay.record(jax.random.normal))
        mp.setattr(tacotron._ARDecoderCore, "_draws",
                   replay.port_draws(tacotron._ARDecoderCore._draws))
        mp.setattr(tacotron, "prenet_dropout_scales", replay.port_scales)
        mp.setattr(tacotron, "dropout", replay.port_dropout)
        yield replay


def close(got, want, atol=ATOL):
    if isinstance(want, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(want)
        for g, w in zip(got, want):
            close(g, w, atol)
        return
    w, g = np.asarray(want), got.detach().numpy()
    assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape)
    np.testing.assert_allclose(g, w, rtol=0, atol=atol)


# ------------------------------------------------------------------ parts
@pytest.mark.parametrize("enabled", [False, True])
def test_prenet_matches_jax(enabled):
    """``Prenet`` with JAX's dropout masks replayed (recorded from
    ``jax.random.bernoulli``; two a layer), and with dropout off."""
    x = np.random.default_rng(0).normal(size=(4, 7, 3)).astype(np.float32)
    port = init_module(tacotron.Prenet(3, layers=2, hidden_dim=5,
                                       dropout=0.4))
    variables = torch_to_flax(port)
    jm = jax_tacotron.Prenet(2, 5, 0.4, dropout_enabled=enabled)
    drawn, bernoulli = [], jax.random.bernoulli

    def record(key, p=0.5, shape=None):
        drawn.append(bernoulli(key, p, shape))
        return drawn[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "bernoulli", record)
        want = jm.apply(variables, x, rngs={"prenet": jax.random.PRNGKey(3)})
    assert len(drawn) == (4 if enabled else 0)
    masks = torch.from_numpy(np.stack(drawn)) if drawn else None
    close(port(torch.from_numpy(x), masks), want)
    drawn_port = port.draw_masks((4, 7), torch.Generator().manual_seed(0),
                                 "cpu")
    assert drawn_port.shape == (4, 4, 7, 5)
    assert abs(drawn_port.float().mean().item() - 0.6) < 0.1


@pytest.mark.parametrize("train", [False, True])
def test_zoneout_blend_matches_jax(train):
    """In training the masks rebuilt from JAX's split keys (True keeps the
    previous state), at evaluation the deterministic blend."""
    rng = np.random.default_rng(1)
    prev, new = ([rng.normal(size=(3, 8)).astype(np.float32)
                  for _ in range(2)] for _ in range(2))
    key = jax.random.PRNGKey(7)
    want = jax_tacotron.zoneout_blend(tuple(prev), tuple(new), 0.3, train,
                                      key if train else None)
    masks = None
    if train:
        masks = [torch.from_numpy(np.asarray(jax.random.bernoulli(
            k, 0.3, (3, 8)))) for k in jax.random.split(key)]
    got = tacotron.zoneout_blend(tuple(map(torch.from_numpy, prev)),
                                 tuple(map(torch.from_numpy, new)), 0.3,
                                 train, masks)
    close(got, want)
    same = tacotron.zoneout_blend(tuple(map(torch.from_numpy, prev)),
                                  tuple(map(torch.from_numpy, new)), 0.0,
                                  train, masks)
    close(same, tuple(new))


# --------------------------------------------------------------- decoders
def core_options(r=2, conv=True, prenet=2, zoneout=0.2, **kw):
    return {"prenet_layers": prenet, "prenet_hidden_dim": 4,
            "prenet_dropout": 0.3, "zoneout": zoneout,
            "reduction_factor": r, "downsample_by_conv": conv, **kw}


def nonattentive(cls="tacotron.NonAttentiveDecoder", **kw):
    net = {"_target_": f"{PKG}.{cls}", "in_dim": 10, "out_dim": 3,
           "layers": 2, "hidden_dim": 6, "initial_value": 0.5,
           "num_gaussians": 2, **core_options(**kw)}
    return net


def resf0(cls="acoustic.ResF0NonAttentiveDecoder", **kw):
    return {"_target_": f"{PKG}.{cls}", "in_dim": 10, "out_dim": 2,
            "layers": 1, "hidden_dim": 6, "in_lf0_idx": 4,
            "out_lf0_idx": 1, "num_gaussians": 2, **LF0,
            **core_options(**kw)}


def bilstm(cls="acoustic.BiLSTMNonAttentiveDecoder", out_dim=3, **kw):
    net = {"_target_": f"{PKG}.{cls}", "in_dim": 12, "out_dim": out_dim,
           "in_ph_start_idx": 1, "in_ph_end_idx": 6, "embed_dim": 5,
           "ff_hidden_dim": 6, "conv_hidden_dim": 5, "lstm_hidden_dim": 3,
           "num_lstm_layers": 1, "decoder_layers": 2,
           "decoder_hidden_dim": 5, "num_gaussians": 2,
           **core_options(**kw)}
    if "ResF0" in cls:
        net.update(in_lf0_idx=7, out_lf0_idx=0, **LF0)
    return net


CASES = {
    "nonattentive_r1_postnet": nonattentive(
        r=1, conv=False, postnet_layers=2, postnet_channels=4,
        postnet_kernel_size=3),
    "nonattentive_noise_r2": nonattentive(prenet=0, prenet_noise_std=0.3),
    "mdn_nonattentive_r2_slice": nonattentive(
        "tacotron.MDNNonAttentiveDecoder", conv=False,
        sampling_mode="random", postnet_layers=2),
    "resf0_r1_no_tanh": resf0(r=1, conv=False, scaled_tanh=False),
    "mdn_resf0_r2_zoneout0": resf0("acoustic.MDNResF0NonAttentiveDecoder",
                                   zoneout=0.0),
    "bilstm_resf0_r2_slice": bilstm(
        "acoustic.BiLSTMResF0NonAttentiveDecoder", out_dim=1, conv=False,
        eval_dropout=False),
    "multitrack_resf0_mdn_r1": bilstm(
        "acoustic.MultiTrackBiLSTMResF0NonAttentiveDecoder", out_dim=1, r=1,
        conv=False, use_mdn=True, sampling_mode="random"),
    "bilstm_r2_postnet": bilstm(postnet_layers=2, postnet_channels=4,
                                postnet_kernel_size=3, initial_value=-1.0),
    "bilstm_mdn_r1_noise": bilstm("acoustic.BiLSTMMDNNonAttentiveDecoder",
                                  r=1, prenet=0, prenet_noise_std=0.2,
                                  postnet_layers=2),
}


def case_inputs(net, seed=0):
    """(args, y) of a decoder: the inputs (both tracks' for the multitrack
    model) over B x T with mixed lengths, and targets."""
    rng = np.random.default_rng(seed)

    def x():
        a = rng.uniform(0, 1, (B, T, net["in_dim"])).astype(np.float32)
        return a * (np.arange(T)[None, :, None] < LENGTHS[:, None, None])

    args = [x()]
    if "MultiTrack" in net["_target_"]:
        args.append(x())
    y = rng.normal(size=(B, T, net["out_dim"])).astype(np.float32)
    return args, y


def run_port(module, args, y=None, train=False, method=None):
    t = [torch.from_numpy(a) for a in args]
    lengths = torch.from_numpy(LENGTHS)
    g = torch.Generator().manual_seed(0)
    if "x_sub" in inspect.signature(module.forward).parameters:
        kw = {"lengths": lengths, "generator": g}
        if method is None:
            return module(*t, y=None if y is None else torch.from_numpy(y),
                          train=train, **kw)
        return module.inference(*t, **kw)
    kw = {"generator": g}
    if method is None:
        return module(*t, lengths,
                      y=None if y is None else torch.from_numpy(y),
                      train=train, **kw)
    return module.inference(*t, lengths, **kw)


def run_jax(jm, variables, args, y=None, train=False, method=None,
            mutable=False):
    kw = {"rngs": RNGS}
    if mutable:
        kw["mutable"] = ["batch_stats"]
    if "MultiTrack" in type(jm).__name__:
        if method is not None:
            return jm.apply(variables, *args, lengths=LENGTHS,
                            method=jm.inference, **kw)
        return jm.apply(variables, *args, lengths=LENGTHS, y=y, train=train,
                        **kw)
    if method is not None:
        return jm.apply(variables, *args, LENGTHS, method=jm.inference, **kw)
    return jm.apply(variables, *args, LENGTHS, y, train=train, **kw)


def twins(net, seed=0):
    module = init_module(instantiate(net), seed=seed).eval()
    return module, jax_instantiate(net), torch_to_flax(module)


@pytest.mark.parametrize("case", sorted(CASES))
def test_decoder_matches_jax(case):
    """Teacher-forced at evaluation and free-running ``inference``; under
    MDN the teacher-forced (log_pi, log_sigma, mu) and the free-running
    (mu, sigma) (sampled with ``sampling_mode: random``)."""
    net = CASES[case]
    module, jm, variables = twins(net)
    mdn = net.get("use_mdn", "MDN" in net["_target_"])
    assert module.prediction_type() == (
        PredictionType.PROBABILISTIC if mdn else PredictionType.DETERMINISTIC)
    args, y = case_inputs(net)
    with replayed_draws() as replay:
        want_tf = run_jax(jm, variables, args, y)
        want_fr = run_jax(jm, variables, args, method="inference")
        with torch.no_grad():
            got_tf = run_port(module, args, y)
            got_fr = run_port(module, args, method="inference")
        replay.assert_spent()
    close(got_tf, want_tf)
    close(got_fr, want_fr)


def _loss(outs, weights):
    """A fixed linear functional of every output of a decoder's forward."""
    leaves = []

    def walk(o):
        if isinstance(o, (tuple, list)):
            for v in o:
                walk(v)
        elif o is not None:
            leaves.append(o)

    walk(outs)
    return sum((leaf * w).sum() for leaf, w in zip(leaves, weights))


def _weights(outs, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=np.shape(o)).astype(np.float32)
            for o in jax.tree_util.tree_leaves(outs)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_decoder_training_matches_jax(case):
    """A teacher-forced training forward (the pre-net's and zoneout's
    masks and the noise replayed, batch statistics in training mode):
    its outputs, and the gradients of a fixed linear loss over them
    against ``jax.grad`` of the same loss."""
    net = CASES[case]
    module, jm, variables = twins(net)
    args, y = case_inputs(net, seed=1)
    with replayed_draws() as replay:
        want, _ = run_jax(jm, variables, args, y, train=True, mutable=True)
        got = run_port(module, args, y, train=True)
        replay.assert_spent()
    close(got, want)
    weights = _weights(want)

    def jloss(params):
        outs, _ = run_jax(jm, {**variables, "params": params}, args, y,
                          train=True, mutable=True)
        return _loss(outs, [jnp.asarray(w) for w in weights])

    jgrads = jax.grad(jloss)(variables["params"])   # the same keys, draws
    _loss(got, [torch.from_numpy(w) for w in weights]).backward()
    ref = flax_to_torch(instantiate(net), {
        "params": jax.tree_util.tree_map(np.asarray, jgrads),
        **({"batch_stats": variables["batch_stats"]}
           if "batch_stats" in variables else {})})
    want_grads = dict(ref.named_parameters())
    scale = max(p.detach().abs().max().item()
                for p in want_grads.values())
    for name, p in module.named_parameters():
        np.testing.assert_allclose(
            p.grad.numpy(), want_grads[name].detach().numpy(), rtol=0,
            atol=GRAD_ATOL * max(scale, 1.0), err_msg=name)


# ------------------------------------------------- the kernels or the loop
@pytest.mark.parametrize("zoneout", [0.0, 0.1])
def test_teacher_forced_cells_use_the_kernels_only_without_zoneout(
        zoneout, monkeypatch):
    """A spy on ``lstm_sequence`` (what the recurrence kernels run behind):
    teacher-forced, the decoder's cells go through it exactly when
    zoneout is 0, and step in PyTorch otherwise; free-running they never
    do."""
    net = nonattentive(zoneout=zoneout, prenet=2)
    module = init_module(instantiate(net)).eval()
    calls = []
    real = tacotron.lstm_sequence
    monkeypatch.setattr(tacotron, "lstm_sequence",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    args, y = case_inputs(net)
    with torch.no_grad():
        run_port(module, args, y)
        assert len(calls) == (2 if zoneout == 0 else 0)
        calls.clear()
        run_port(module, args, method="inference")
    assert not calls


# ------------------------------------------------------ templates, weights
TEMPLATES = {k: CASES[k] for k in ("mdn_nonattentive_r2_slice",
                                   "mdn_resf0_r2_zoneout0",
                                   "bilstm_mdn_r1_noise",
                                   "nonattentive_r1_postnet")}


@pytest.mark.parametrize("case", sorted(TEMPLATES))
def test_flax_init_templates_match_jax(case):
    """``init_variables`` gives the JAX ``init``'s tree: the pre-net's
    ``ar_core/prenet/fc{i}``, cell 0 at its pre-net width, the MDN
    Denses ``log_pi`` / ``log_sigma`` / ``mu`` with their biases (no
    Post-Net under MDN); and ``flax_to_torch`` takes it back bitwise."""
    net = TEMPLATES[case]
    module = instantiate(net)
    got = init_variables(module, seed=0)
    jm = jax_instantiate(net)
    args, y = case_inputs(net)
    want = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), **RNGS},
        *[jnp.asarray(a) for a in args], jnp.asarray(LENGTHS)))
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), dict(want))
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape), got) == shapes
    back = torch_to_flax(flax_to_torch(module, got))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(got)):
        np.testing.assert_array_equal(a, b)


def test_mdn_decoders_have_no_postnet_and_sample_with_a_generator():
    """Under MDN the Post-Net options build nothing (as in JAX), and
    random sampling draws from the generator: two seeds, two
    trajectories; one seed, one."""
    net = CASES["mdn_nonattentive_r2_slice"]
    module = init_module(instantiate(net)).eval()
    assert module.postnet is None
    x = torch.from_numpy(case_inputs(net)[0][0])
    with torch.no_grad():
        a, b, c = (module.inference(x, generator=torch.Generator()
                                    .manual_seed(s))[0] for s in (0, 0, 1))
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="Generator"):
        module.inference(x)
