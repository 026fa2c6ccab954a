"""The bf16 AMP arm of the port's multitrack acoustic train step and
gradient accumulation, against the JAX package at tiny dims.

The tiny flagship of ``test_torch_train.py`` (every dropout 0, zoneout 0)
runs one AMP step on each side: JAX ``use_amp=True`` (``donate=False``)
with an SGD transform whose state keeps the clipped gradient, the port's
``use_amp=True`` with SGD.  Tolerances, set from bf16's 8-bit mantissa
(relative rounding 2**-9, compounded over a few stacked layers):

* every metric at rtol 2e-2;
* each parameter's clipped gradient, and its SGD update, by
  ``chip_smoke.judge_amp``: within 5e-2 of its scale, max(its largest JAX
  entry, 1e-3 x the largest entry of any gradient).  bf16 does not
  resolve every gradient that well: JAX's AMP step itself lies up to 114%
  of the scale from its float32 gradient on the encoder and the decoders'
  input layers, whose gradients are 1-5 times the floor, and the port
  follows that departure to cosine 0.96 or better.  So a gradient outside
  5e-2 passes only where its cosine with JAX's is at least 0.95, its L2
  distance from JAX's at most 0.35 of JAX's norm, and it is no farther
  from the port's float32 step (which matches JAX's at 1e-5 in
  ``test_torch_train.py``) than 3 times JAX's, or than 3 x 5e-2 of the
  scale where JAX's lies nearer float32 than that.  The readings behind
  these bounds: ``python -m tests.test_torch_train_amp``.  A zero,
  inverted or halved gradient fails
  (``test_amp_judge_fails_planted_faults``).  A gradient that vanishes in
  float32 (the bias of a conv in front of a training-mode batch norm)
  holds rounding noise and passes within the floor, or no farther from
  float32 than that;
* the running statistics after the step within 2e-2 of each buffer's
  largest entry (an rtol alone is ill-posed on means near zero; both
  sides round them to bf16);
* the port's AMP loss within 2e-2 of its float32 loss;
* ``MaskedBatchNorm`` under bf16 against JAX's under ``amp_cast``, on
  inputs whose mean is large against their spread: output and running
  statistics within one bf16 ulp (rtol 2**-7; the running statistics'
  update rounds in another order).  Computing the statistics in
  float32 misses by far more there, which the gradient rule cannot see.

Accumulation (``build_optimizer(..., accum_steps=k)``) is held against
``optax.MultiSteps`` at 1e-6 on given gradients and, through the float32
acoustic step, against the JAX step at 1e-5.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from ensemble_svs_with_interactions_tpu.models import layers as jax_layers
from ensemble_svs_with_interactions_tpu.train import loop as jax_loop
from ensemble_svs_with_interactions_tpu.train import multitrack as jax_mt
from ensemble_svs_with_interactions_tpu_torch.models import layers, tacotron
from ensemble_svs_with_interactions_tpu_torch.train import loop
from ensemble_svs_with_interactions_tpu_torch.train import multitrack as mt
from ensemble_svs_with_interactions_tpu_torch.utils.config import instantiate
from ensemble_svs_with_interactions_tpu_torch.utils.flax_port import (
    flax_to_torch,
)
from tests.test_torch_train import (  # noqa: F401  (flagship: a fixture)
    METRICS,
    SS,
    _batch,
    _jax_weights,
    _flagship,
    _rngs,
    _t,
    flagship,
)
from tests.test_torch_svs import few_threads  # noqa: F401  (autouse)

AMP_RTOL = 2e-2
GRAD_RTOL = chip_smoke.AMP_GRAD_RTOL  # 5e-2
COS_MIN = 0.95
L2_MAX = 0.35
LR = 0.5
WEIGHTS = {"logf0_diff": 1.0, "mgc_diff": 1.0}


def _sgd_keeping_grads(lr):
    """optax.sgd(lr) whose state is the last (clipped) gradient it got."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda grads, state, params=None: (
            jax.tree_util.tree_map(lambda g: -lr * g, grads), grads))


@contextlib.contextmanager
def jax_device_lstm():
    """The JAX package's LSTM layers on their device training path, here on
    the CPU: ``_MaskedLSTMLayer`` takes the trainable Pallas recurrence
    (``ops/pallas_lstm.py`` ``lstm_layer_pallas_trainable``, in interpret
    mode) in a training forward of a one-device run at H <= 256, as on
    the TPU (``models/layers.py:114-149``), and its masked scan otherwise.
    That path returns each layer's output in its input's dtype (bf16
    under AMP), where the scan, the CPU's path, returns its float32
    carry."""
    from ensemble_svs_with_interactions_tpu.ops import pallas_lstm

    saved = (pallas_lstm.lstm_layer_pallas_trainable, jax.default_backend,
             jax.device_count)
    pallas_lstm.lstm_layer_pallas_trainable = functools.partial(
        saved[0], interpret=True)
    jax.default_backend = lambda: "tpu"
    jax.device_count = lambda backend=None: 1
    try:
        yield
    finally:
        (pallas_lstm.lstm_layer_pallas_trainable, jax.default_backend,
         jax.device_count) = saved


def _as_port(cfg, variables):
    return flax_to_torch(instantiate(cfg), variables).state_dict()


def _port_amp_step(cfg, variables, opt_cfg, use_amp=True, **kw):
    module = flax_to_torch(instantiate(cfg), variables)
    opt, sched = loop.build_optimizer(module.parameters(), opt_cfg, **kw)
    step, eval_step = mt.create_multitrack_acoustic_train_step(
        module, opt, {"stream_sizes": SS}, scheduler=sched,
        pitch_reg_weight=1.0, use_amp=use_amp, device="cpu")
    return module, opt, step, eval_step


def _amp_runs(flagship):
    """One AMP step of batch 3 on each side and one port float32 step:
    metrics, clipped gradients, new parameters and running statistics,
    each keyed by the port's state-dict names."""
    cfg, jm, variables = flagship
    tx = _sgd_keeping_grads(LR)
    jstep, _ = jax_mt.create_multitrack_acoustic_train_step(
        jm, tx, {"stream_sizes": SS}, pitch_reg_weight=1.0, use_amp=True,
        donate=False)
    state = {"params": variables["params"],
             "batch_stats": variables["batch_stats"],
             "opt_state": tx.init(variables["params"]),
             "step": jnp.asarray(0)}
    batch = _batch(3)
    new_state, metrics = jstep(state, {k: jnp.asarray(v) for k, v in
                                       batch.items()}, _jax_weights(),
                               jax.random.PRNGKey(0))
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    runs = {"jax": {
        "metrics": {k: float(v) for k, v in metrics.items()},
        "grads": _as_port(cfg, {"params": np_tree(new_state["opt_state"]),
                                "batch_stats": variables["batch_stats"]}),
        "state": _as_port(cfg, {"params": np_tree(new_state["params"]),
                                "batch_stats": np_tree(
                                    new_state["batch_stats"])})}}
    for name, use_amp in (("port", True), ("port_f32", False)):
        module, _, step, _ = _port_amp_step(
            cfg, variables, {"name": "SGD", "params": {"lr": LR}}, use_amp)
        got = step(batch, WEIGHTS, torch.Generator().manual_seed(0))
        runs[name] = {"metrics": got,
                      "grads": {k: p.grad.clone() for k, p in
                                module.named_parameters()},
                      "state": {k: v.clone() for k, v in
                                module.state_dict().items()}}
    runs["before"] = _as_port(cfg, variables)
    runs["jax"]["grads"] = {k: runs["jax"]["grads"][k]
                            for k in runs["port"]["grads"]}
    return runs


@pytest.fixture(scope="module")
def amp_runs(flagship):
    return _amp_runs(flagship)


def test_amp_metrics_match_jax(amp_runs):
    ref, got = amp_runs["jax"]["metrics"], amp_runs["port"]["metrics"]
    for k in METRICS + ("GradNorm",):
        np.testing.assert_allclose(got[k], ref[k], rtol=AMP_RTOL, atol=1e-7,
                                   err_msg=k)
    assert got["GradNorm"] > 1.0  # the clip was active


def _failed(got, ref, oracle):
    judged = chip_smoke.judge_amp(got, ref, oracle, GRAD_RTOL, COS_MIN,
                                  L2_MAX)
    return {k: v for k, v in judged.items() if not v["ok"]}


def test_amp_clipped_gradients_match_jax(amp_runs):
    bad = _failed(amp_runs["port"]["grads"], amp_runs["jax"]["grads"],
                  amp_runs["port_f32"]["grads"])
    assert not bad, bad


@pytest.mark.parametrize("fault", [0.0, -1.0, 0.5],
                         ids=["zeroed", "inverted", "halved"])
def test_amp_judge_fails_planted_faults(amp_runs, fault):
    """The gradient rule fails every encoder gradient scaled by ``fault``
    (the encoder's gradients are those bf16 resolves worst, all outside
    5e-2 of JAX's), and still passes every other one."""
    grads = dict(amp_runs["port"]["grads"])
    planted = [k for k in grads if k.startswith("encoder.")]
    assert planted
    for k in planted:
        grads[k] = fault * grads[k]
    bad = _failed(grads, amp_runs["jax"]["grads"],
                  amp_runs["port_f32"]["grads"])
    assert sorted(bad) == sorted(planted), sorted(bad)


def _updates(runs, run):
    """{name: new - old} of every parameter after ``run``'s SGD step."""
    return {k: runs[run]["state"][k] - runs["before"][k]
            for k in runs["port"]["grads"]}


def test_amp_sgd_step_matches_jax(amp_runs):
    """The new parameters, judged on the update (new - old)."""
    bad = _failed(*(_updates(amp_runs, run)
                    for run in ("port", "jax", "port_f32")))
    assert not bad, bad


def test_amp_running_statistics_match_jax(amp_runs):
    ref, got = amp_runs["jax"]["state"], amp_runs["port"]["state"]
    names = [k for k in got if k.endswith(("running_mean", "running_var"))]
    assert names
    for k in names:
        scale = ref[k].abs().max().item()
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=0,
                                   atol=AMP_RTOL * scale, err_msg=k)
        # the float32 buffers hold bf16-rounded statistics, as JAX's
        assert torch.equal(got[k], got[k].bfloat16().float()), k


def _bn_case():
    """(x, mask, weight, bias) of a (4, 64, 16) batch with ragged lengths
    whose channel means (2-6) are large against their spread (1), where
    E[x^2] - E[x]^2 in bf16 loses most of its digits."""
    rng = np.random.default_rng(11)
    x = (rng.normal(size=(4, 64, 16)) + rng.uniform(2, 6, 16)).astype(
        np.float32)
    mask = np.arange(64)[None, :] < np.array([64, 50, 33, 60])[:, None]
    return (x, mask, rng.uniform(0.5, 1.5, 16).astype(np.float32),
            rng.normal(size=16).astype(np.float32))


def _port_bn(x, mask, w, b, float32_stats=False):
    """The port's MaskedBatchNorm with bf16 parameters and buffers (as the
    AMP step's functional call holds them) on bf16 x, in training: the
    output and the new running statistics, in float32.  With
    ``float32_stats`` the layer computes in float32 and rounds its output
    to bf16 (the other design)."""
    bn = layers.MaskedBatchNorm(x.shape[-1])
    with torch.no_grad():
        bn.weight.copy_(_t(w))
        bn.bias.copy_(_t(b))
    bn = bn.to(torch.bfloat16)
    xb = _t(x).bfloat16()
    with torch.no_grad():
        if float32_stats:
            out = layers.MaskedBatchNorm.forward(
                bn, xb.float(), _t(mask), train=True).bfloat16()
        else:
            out = bn(xb, _t(mask), train=True)
    return [t.float().numpy() for t in (out, bn.running_mean,
                                        bn.running_var)]


def test_amp_batch_norm_matches_jax():
    """MaskedBatchNorm in the input's dtype: under bf16 the output and the
    running statistics match JAX's ``MaskedBatchNorm`` under ``amp_cast``
    within one bf16 ulp (rtol 2**-7), where the same layer computing its
    statistics in float32 misses the output by 16 ulps of its largest
    entry or more."""
    x, mask, w, b = _bn_case()
    jm = jax_layers.MaskedBatchNorm()
    params = jax_loop.amp_cast({"scale": jnp.asarray(w),
                                "bias": jnp.asarray(b)})
    stats = jax_loop.amp_cast({"mean": jnp.zeros(16), "var": jnp.ones(16)})
    out, upd = jm.apply({"params": params, "batch_stats": stats},
                        jax_loop.amp_cast(jnp.asarray(x)), jnp.asarray(mask),
                        use_running_average=False, mutable=["batch_stats"])
    want = [np.asarray(t.astype(jnp.float32)) for t in (
        out, upd["batch_stats"]["mean"], upd["batch_stats"]["var"])]
    for got, ref, name in zip(_port_bn(x, mask, w, b), want,
                              ("output", "running_mean", "running_var")):
        np.testing.assert_allclose(got, ref, rtol=2.0 ** -7, atol=0,
                                   err_msg=name)
    other = _port_bn(x, mask, w, b, float32_stats=True)[0]
    assert np.abs(other - want[0]).max() > 16 * 2.0 ** -7 * np.abs(
        want[0]).max()


def test_amp_loss_near_float32(amp_runs):
    amp, f32 = amp_runs["port"]["metrics"], amp_runs["port_f32"]["metrics"]
    np.testing.assert_allclose(amp["Loss"], f32["Loss"], rtol=AMP_RTOL)
    assert amp["Loss"] != f32["Loss"]  # the casts took effect


def test_amp_dtypes(flagship, monkeypatch):
    """Under AMP every LSTM layer and decoder cell gets bf16 inputs, every
    recurrence float32, the model returns bf16 but for the AR decoder's
    float32 log-F0 residual (``tacotron.lf0_residual``), and the master
    parameters, their gradients and Adam's state stay float32."""
    cfg, _, variables = flagship
    module, opt, step, eval_step = _port_amp_step(
        cfg, variables, {"name": "Adam", "params": {"lr": 1e-3}})
    seen = {"layer_in": set(), "recurrence": set(), "cell_in": set(),
            "model_out": set()}
    recurrence, sequence = layers.recurrence, tacotron.LSTMCell.sequence

    def spy_recurrence(xw, w_h):
        seen["recurrence"].update({xw.dtype, w_h.dtype})
        return recurrence(xw, w_h)

    def spy_sequence(cell, x):
        seen["cell_in"].add(x.dtype)
        return sequence(cell, x)

    monkeypatch.setattr(layers, "recurrence", spy_recurrence)
    monkeypatch.setattr(tacotron.LSTMCell, "sequence", spy_sequence)
    hooks = [m.register_forward_pre_hook(
        lambda m, args: seen["layer_in"].add(args[0].dtype))
        for m in module.modules() if isinstance(m, layers._MaskedLSTMLayer)]
    hooks.append(module.register_forward_hook(
        lambda m, args, out: seen["model_out"].update(
            t.dtype for t in jax.tree_util.tree_leaves(
                out, is_leaf=lambda x: isinstance(x, torch.Tensor)))))
    metrics = step(_batch(3), WEIGHTS, torch.Generator().manual_seed(0))
    eval_metrics, pred = eval_step(_batch(4), WEIGHTS)
    for h in hooks:
        h.remove()
    assert np.isfinite(metrics["Loss"]) and np.isfinite(eval_metrics["Loss"])
    assert pred.dtype == torch.float32
    assert seen == {"layer_in": {torch.bfloat16},
                    "recurrence": {torch.float32},
                    "cell_in": {torch.bfloat16},
                    "model_out": {torch.bfloat16, torch.float32}}, seen
    for name, p in module.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, \
            name
    for name, b in module.named_buffers():
        assert b.dtype == torch.float32, name
    assert opt.state and all(t.dtype == torch.float32
                             for s in opt.state.values()
                             for t in s.values() if t.is_floating_point())


def _dtypes(tree):
    return tuple(sorted({str(t.dtype).replace("torch.", "") for t in
                         jax.tree_util.tree_leaves(
                             tree, is_leaf=lambda x: isinstance(
                                 x, torch.Tensor))
                         if hasattr(t, "dtype")}))


def _module_dtypes_jax(jm, variables, batch):
    """{module path: {output dtypes}} of every flax module in one AMP
    training forward, traced (the JAX step's ``amp_cast`` of parameters,
    statistics, inputs and targets), with each ``_MaskedLSTMLayer``'s
    input dtype under ``path + "<in"``."""
    import flax.linen as nn

    seen = {}

    def spy(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if context.method_name == "__call__":
            path = "/".join(context.module.scope.path)
            seen.setdefault(path, set()).add(_dtypes(out))
            if type(context.module).__name__ == "_MaskedLSTMLayer":
                seen.setdefault(path + "<in", set()).add(_dtypes(args[0]))
        return out

    def forward(variables, b):
        c = jax_loop.amp_cast
        return jm.apply(c(variables), c(b["in_feats0"]), c(b["in_feats1"]),
                        (b["spks0"], b["spks1"]), b["lengths"],
                        (c(b["out_feats0"]), c(b["out_feats1"])),
                        train=True, rngs=_rngs(), mutable=["batch_stats"])

    # traced only (dtypes need no arithmetic)
    with nn.intercept_methods(spy):
        jax.eval_shape(forward, {"params": variables["params"],
                                 "batch_stats": variables["batch_stats"]},
                       {k: jnp.asarray(v) for k, v in batch.items()})
    return seen


@pytest.fixture(scope="module")
def dtype_flows(flagship):
    """{module path: {output dtypes}} of one AMP training forward: the
    port's, JAX's on its device training path (:func:`jax_device_lstm`)
    and JAX's on the masked scan, each LSTM layer's input dtype under
    ``path + "<in"``."""
    cfg, jm, variables = flagship
    batch = _batch(3)
    with jax_device_lstm():
        device = _module_dtypes_jax(jm, variables, batch)
    scan = _module_dtypes_jax(jm, variables, batch)
    module = flax_to_torch(instantiate(cfg), variables)
    got = {}

    def hook(name, lstm):
        def record(m, args, out):
            got.setdefault(name, set()).add(_dtypes(out))
            if lstm:
                got.setdefault(name + "<in", set()).add(_dtypes(args[0]))
        return record

    hooks = [m.register_forward_hook(hook(
        name.replace(".", "/"), isinstance(m, layers._MaskedLSTMLayer)))
        for name, m in module.named_modules() if name]
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    loop.amp_forward(
        module, (b["in_feats0"], b["in_feats1"], (b["spks0"], b["spks1"]),
                 b["lengths"], (b["out_feats0"], b["out_feats1"])),
        {"train": True, "generator": torch.Generator().manual_seed(0)},
        True, True)
    for h in hooks:
        h.remove()
    return {"port": got, "jax_device": device, "jax_scan": scan}


def test_amp_dtype_flow_matches_jax(dtype_flows):
    """The output dtype of every module, and each LSTM layer's input
    dtype, in one AMP training forward: the port's against the JAX
    package's on its device training path, where each LSTM layer at
    H <= 256 returns its input's dtype (``ops/pallas_lstm.py:387``), on
    every module path both have."""
    got, want = dtype_flows["port"], dtype_flows["jax_device"]
    shared = sorted(set(got) & set(want))
    lstm_in = [k for k in shared if k.endswith("<in")]
    assert len(shared) > 50 and len(lstm_in) >= 8, (len(shared), lstm_in)
    diff = {k: (got[k], want[k]) for k in shared if got[k] != want[k]}
    assert not diff, diff
    assert set().union(*(want[k] for k in lstm_in)) == {("bfloat16",)}


def test_amp_dtype_flow_differs_from_jax_scan(dtype_flows):
    """A pinned difference: on the JAX package's masked scan (the path
    the CPU, inference and H > 256 take) an LSTM layer returns its
    float32 carry, and flax promotes what follows it to float32; the
    port's layers return bf16 as JAX's device training path does.  So
    against the scan, the port differs exactly where the scan has
    float32 and it has bf16, and every LSTM layer's output is among
    them."""
    got, scan = dtype_flows["port"], dtype_flows["jax_scan"]
    shared = sorted(set(got) & set(scan))
    diff = {k: (got[k], scan[k]) for k in shared if got[k] != scan[k]}
    flat = lambda dtypes: set().union(*map(set, dtypes))  # noqa: E731
    assert all("bfloat16" in flat(g) and flat(w) == {"float32"}
               for g, w in diff.values()), diff
    lstm_out = [k[:-3] for k in shared if k.endswith("<in")]
    assert lstm_out and set(lstm_out) <= set(diff), lstm_out


@pytest.mark.parametrize("hidden", [64, 260])
def test_lstm_layer_dtype_against_jax_device_path(hidden):
    """An LSTM layer's output dtype for bf16 inputs in a training forward:
    JAX's device path returns bf16 at H <= 256 (the trainable Pallas
    recurrence) and float32 above (its masked scan), the port returns
    bf16 at every width: a pinned difference above H = 256, where it keeps
    the GEMMs after the layer in bf16."""
    x = jnp.zeros((2, 8, 16), jnp.bfloat16)
    mask = jnp.ones((2, 8), jnp.float32)
    jm = jax_layers._MaskedLSTMLayer(hidden)
    with jax_device_lstm():
        want = jax.eval_shape(lambda x: jm.init_with_output(
            jax.random.PRNGKey(0), x, mask, train=True)[0], x).dtype
    assert str(want) == ("bfloat16" if hidden <= 256 else "float32")
    port = layers._MaskedLSTMLayer(16, hidden)
    params = {k: v.bfloat16() for k, v in port.named_parameters()}
    got = torch.func.functional_call(port, params, (
        torch.zeros(2, 8, 16, dtype=torch.bfloat16), torch.ones(2, 8)))
    assert got.dtype == torch.bfloat16


def test_lf0_residual_promotes_as_jax():
    """The AR decoder's residual log-F0 of bf16 pre-activations is float32,
    as JAX's NumPy float64 ratio makes it, and agrees with JAX's within
    one bf16 ulp of the tanh; float32 and float64 keep their dtype."""
    from ensemble_svs_with_interactions_tpu.models import tacotron as jtaco

    raw = np.random.default_rng(0).normal(0.0, 2.0, (4, 33)).astype(
        np.float32)
    want = jtaco._MAX_LF0_RATIO * jnp.tanh(jnp.asarray(raw, jnp.bfloat16))
    got = tacotron.lf0_residual(torch.from_numpy(raw).bfloat16())
    assert got.dtype == torch.float32 and str(want.dtype) == "float32"
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2 ** -8, atol=0)
    for dtype in (torch.float32, torch.float64):
        assert tacotron.lf0_residual(torch.zeros(2, dtype=dtype)).dtype \
            == dtype


def _snapshot(module, opt):
    return ({k: v.clone() for k, v in module.named_parameters()},
            {id(p): {n: t.clone() for n, t in s.items()}
             for p, s in opt.state.items()})


def _assert_unchanged(module, opt, snap):
    params, state = snap
    for k, v in module.named_parameters():
        assert torch.equal(v, params[k]), k
    assert {id(p) for p in opt.state} == set(state)
    for p, s in opt.state.items():
        for n, t in s.items():
            assert torch.equal(t, state[id(p)][n]), n


def test_amp_nan_loss_skips_the_update(flagship):
    """Under AMP a non-finite batch leaves the parameters and Adam's state
    bitwise as they were (one finite step first, so the state exists)."""
    cfg, _, variables = flagship
    module, opt, step, _ = _port_amp_step(
        cfg, variables, {"name": "Adam", "params": {"lr": 1e-3}})
    g = torch.Generator().manual_seed(0)
    assert np.isfinite(step(_batch(4), WEIGHTS, g)["Loss"])
    snap = _snapshot(module, opt)
    bad = _batch(5)
    bad["out_feats0"][1, 2, 0] = np.nan
    assert not np.isfinite(step(bad, WEIGHTS, g)["Loss"])
    _assert_unchanged(module, opt, snap)


# ------------------------------------------------------------ accumulation
@pytest.mark.parametrize("opt_cfg", [
    {"name": "Adam", "params": {"lr": 1e-2}},
    {"name": "SGD", "params": {"lr": 0.1, "momentum": 0.9}},
], ids=["adam", "sgd_momentum"])
def test_accumulation_matches_optax_multisteps(opt_cfg):
    """k = 3 over 7 micro-steps of given gradients, under a StepLR
    schedule that halves the rate after the first applied update: the
    parameters after every micro-step, and the schedule's ticks."""
    sched_cfg = {"name": "StepLR", "params": {"step_size": 1, "gamma": 0.5}}
    rng = np.random.default_rng(10)
    p0 = {"a": rng.normal(size=(4, 3)).astype(np.float32),
          "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(7)]
    tx = jax_loop.build_optimizer(opt_cfg, sched_cfg, accum_steps=3)
    params = {k: jnp.asarray(v) for k, v in p0.items()}
    opt_state = tx.init(params)
    tparams = {k: torch.nn.Parameter(_t(v)) for k, v in p0.items()}
    opt, sched = loop.build_optimizer(tparams.values(), opt_cfg, sched_cfg,
                                      accum_steps=3)
    assert isinstance(opt, loop.MultiSteps)
    for i, g in enumerate(grads):
        updates, opt_state = tx.update(
            {k: jnp.asarray(v) for k, v in g.items()}, opt_state, params)
        params = optax.apply_updates(params, updates)
        for k, p in tparams.items():
            p.grad = _t(g[k])
        opt.step()
        sched.step()
        assert opt.emitted == (i % 3 == 2) and opt.mini_step == (i + 1) % 3
        assert sched.get_last_lr()[0] == pytest.approx(
            opt_cfg["params"]["lr"] * 0.5 ** ((i + 1) // 3))
        for k, p in tparams.items():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(params[k]), atol=1e-6,
                                       err_msg=f"{k} after micro-step {i}")
        np.testing.assert_allclose(
            torch.cat([a.flatten() for a in opt.acc]).numpy(),
            np.concatenate([np.asarray(opt_state.acc_grads[k]).ravel()
                            for k in ("a", "b")]), atol=1e-6)


def test_acoustic_step_accumulates_like_jax(flagship):
    """accum_steps = 2 over batches 3 and 4 with SGD: the metrics of both
    micro-steps and the parameters after each at 1e-5 (the first leaves
    them as they were)."""
    cfg, jm, variables = flagship
    opt_cfg = {"name": "SGD", "params": {"lr": LR}}
    tx = jax_loop.build_optimizer(opt_cfg, accum_steps=2)
    jstep, _ = jax_mt.create_multitrack_acoustic_train_step(
        jm, tx, {"stream_sizes": SS}, pitch_reg_weight=1.0, donate=False)
    state = {"params": variables["params"],
             "batch_stats": variables["batch_stats"],
             "opt_state": tx.init(variables["params"]),
             "step": jnp.asarray(0)}
    module, opt, step, _ = _port_amp_step(cfg, variables, opt_cfg,
                                          use_amp=False, accum_steps=2)
    before = {k: v.clone() for k, v in module.named_parameters()}
    for i, seed in enumerate((3, 4)):
        batch = _batch(seed)
        state, ref = jstep(state, {k: jnp.asarray(v) for k, v in
                                   batch.items()}, _jax_weights(),
                           jax.random.PRNGKey(i))
        got = step(batch, WEIGHTS, torch.Generator().manual_seed(i))
        for k in METRICS + ("GradNorm",):
            np.testing.assert_allclose(got[k], float(ref[k]), rtol=1e-5,
                                       atol=1e-7, err_msg=k)
        want = _as_port(cfg, {
            "params": jax.tree_util.tree_map(np.asarray, state["params"]),
            "batch_stats": jax.tree_util.tree_map(np.asarray,
                                                  state["batch_stats"])})
        for k, v in module.state_dict().items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-5,
                                       err_msg=f"{k} after micro-step {i}")
        changed = any(not torch.equal(v, before[k])
                      for k, v in module.named_parameters())
        assert changed == (i == 1) == opt.emitted


def test_nonfinite_micro_step_leaves_the_accumulator(flagship):
    """With accum_steps = 2, a non-finite micro-step after a finite one
    leaves the running mean, its count and the parameters as they were;
    the next finite micro-step then applies the update."""
    cfg, _, variables = flagship
    module, opt, step, _ = _port_amp_step(
        cfg, variables, {"name": "Adam", "params": {"lr": 1e-3}},
        accum_steps=2)
    g = torch.Generator().manual_seed(0)
    assert np.isfinite(step(_batch(3), WEIGHTS, g)["Loss"])
    assert opt.mini_step == 1 and not opt.emitted and not opt.state
    acc = [a.clone() for a in opt.acc]
    assert any(a.abs().max() > 0 for a in acc)
    snap = _snapshot(module, opt)
    bad = _batch(5)
    bad["out_feats0"][0, 3, 0] = np.nan
    assert not np.isfinite(step(bad, WEIGHTS, g)["Loss"])
    assert opt.mini_step == 1
    assert all(torch.equal(a, b) for a, b in zip(opt.acc, acc))
    _assert_unchanged(module, opt, snap)
    assert np.isfinite(step(_batch(4), WEIGHTS, g)["Loss"])
    assert opt.emitted and opt.mini_step == 0 and opt.state
    assert all(a.abs().max() == 0 for a in opt.acc)


def main():
    """Print what the gradient rule sees at the tiny flagship: one JSON
    line each for the clipped gradients and the SGD updates
    (``chip_smoke.amp_summary`` without its per-tensor maps).

        JAX_PLATFORMS=cpu python -m tests.test_torch_train_amp
    """
    import json

    runs = _amp_runs(_flagship())
    sets = {"grads": [runs[r]["grads"] for r in ("port", "jax", "port_f32")],
            "updates": [_updates(runs, r)
                        for r in ("port", "jax", "port_f32")]}
    for name, (got, ref, oracle) in sets.items():
        summary = chip_smoke.amp_summary(chip_smoke.judge_amp(
            got, ref, oracle, GRAD_RTOL, COS_MIN, L2_MAX))
        print(json.dumps({"judged": name, **{
            k: v for k, v in summary.items()
            if k not in ("unresolved", "vanishes")}}))


if __name__ == "__main__":
    main()
