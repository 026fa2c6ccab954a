"""The two NPSS voices built on the AR decoder options, on the port
against the JAX package, on the CPU, at the tiny widths of
``tests/test_torch_npss_ar.py`` (one-layer stream decoders with Post-Nets,
``tests/test_torch_npss_steps.ar_step_config``) with the overrides of
``chip_smoke.ar_option_netg``:

* ``npss_ar_tacotron``: the deterministic cascade with every AR decoder at
  the classes' defaults, a 2-layer pre-net and zoneout 0.1;
* ``npss_mdn_ar``: the MDN cascade, the lf0 decoder's MDN head and
  ``BiLSTMMDNNonAttentiveDecoder`` mgc and bap decoders, the pre-nets on
  and zoneout 0.

For each: ``create_train_step``'s evaluation and one step (clipping off)
with the pre-nets' and zoneout's masks replayed
(``tests/test_torch_ar_options.replayed_draws``): the metrics at
STEP_RTOL relative, the running statistics after the step at STEP_RTOL,
every gradient within STEP_RTOL of its scale (``tests/test_torch_trainer.
assert_step_matches_jax``'s rule) or, where JAX's own float32 gradient is
off the port's float64 step by up to ROUNDING times that (a pre-net bias's
gradient is a sum that cancels), no farther from it than JAX's is; and one
free-running
``inference`` of the cascade with the pre-net masks replayed, judged by
PARITY.md's "AR parity under chaos" rule against the port's float64
(``tests/test_torch_npss_ar.judge_free_running``).  The shipped file with
the same overrides builds in the port at its widths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from ensemble_svs_with_interactions_tpu.train import loop as jax_loop
from ensemble_svs_with_interactions_tpu.utils.config import (
    instantiate as jax_instantiate,
)
from ensemble_svs_with_interactions_tpu_torch.base import PredictionType
from ensemble_svs_with_interactions_tpu_torch.models.acoustic import (
    BiLSTMMDNNonAttentiveDecoder,
    BiLSTMNonAttentiveDecoder,
    NPSSMDNMultistreamParametricModel,
    NPSSMultistreamParametricModel,
)
from ensemble_svs_with_interactions_tpu_torch.train import loop
from ensemble_svs_with_interactions_tpu_torch.utils.config import instantiate
from ensemble_svs_with_interactions_tpu_torch.utils.flax_init import (
    init_module,
)
from ensemble_svs_with_interactions_tpu_torch.utils.flax_port import (
    flax_to_torch,
    torch_to_flax,
)
from tests.test_torch_ar_options import CASES, RNGS, replayed_draws
from tests.test_torch_npss_ar import (
    LENGTHS,
    inputs,
    judge_free_running,
    twins,
)
from tests.test_torch_npss_mdn import shipped_netg
from tests.test_torch_npss_steps import ar_step_config, step_batch
from tests.test_torch_svs import few_threads  # noqa: F401
from tests.test_torch_trainer import (
    GRAD_FLOOR,
    STEP_RTOL,
    VANISH,
    _capture_grads,
)

VOICES = chip_smoke.AR_OPTION_VOICES
# A gradient off JAX's by more than STEP_RTOL of its scale passes only where
# JAX's float32 gradient is itself that far from the float64 step (a sum
# that cancels, as a pre-net bias's does), by at most ROUNDING times
# STEP_RTOL, and the port's is no farther: the port stays within
# 2 * ROUNDING * STEP_RTOL of JAX.
ROUNDING = 3


def voice_config(name):
    cfg = ar_step_config()
    cfg["netG"] = chip_smoke.ar_option_netg(cfg["netG"], name)
    return cfg


def assert_step_matches(cfg, batch):
    """``create_train_step``'s evaluation and one step of ``cfg`` from the
    port's flax-scheme weights against JAX's, the draws replayed, judged
    as the module's docstring says."""
    variables = torch_to_flax(init_module(instantiate(cfg["netG"])))
    jm = jax_instantiate(cfg["netG"])
    tx = _capture_grads()
    state = {"params": variables["params"],
             "batch_stats": variables.get("batch_stats", {}),
             "opt_state": tx.init(variables["params"]),
             "step": jnp.asarray(0)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def port_step(dtype):
        module = flax_to_torch(instantiate(cfg["netG"]), variables).to(dtype)
        opt, sched = loop.build_optimizer(
            module.parameters(), {"name": "SGD", "params": {"lr": 0.0}})
        step, eval_step = loop.create_train_step(
            module, opt, cfg, scheduler=sched, clip_norm=1e9, device="cpu",
            pitch_reg_weight=1.0)
        evaluated, _ = eval_step(batch)
        got = step(batch, torch.Generator().manual_seed(0))
        return module, got, evaluated

    pitch = "ResF0" in cfg["netG"]["_target_"] or "lf0_model" in cfg["netG"]
    with replayed_draws() as replay:
        jstep, jeval = jax_loop.create_train_step(
            jm, tx, cfg, clip_norm=1e9, donate=False, pitch_reg_weight=1.0)
        ref_eval, _ = jeval(state, jbatch)
        new_state, ref = jstep(state, jbatch, jax.random.PRNGKey(0))
        module, got, got_eval = port_step(torch.float32)
        replay.assert_spent()
        replay.rewind()
        oracle = {k: p.grad for k, p in port_step(torch.float64)[0]
                  .named_parameters()}
        replay.assert_spent()
    assert (got["Loss_Pitch"] > 0) == pitch
    for mine, theirs in ((got, ref), (got_eval, ref_eval)):
        assert sorted(mine) == sorted(theirs)
        for k, v in theirs.items():
            np.testing.assert_allclose(mine[k], float(v), rtol=STEP_RTOL,
                                       atol=1e-7, err_msg=k)
    ref_module = flax_to_torch(instantiate(cfg["netG"]), {
        "params": new_state["opt_state"],
        **({"batch_stats": new_state["batch_stats"]}
           if new_state["batch_stats"] else {})})
    ref_grads = dict(ref_module.named_parameters())
    largest = max(g.abs().max().item() for g in oracle.values())
    for k, p in module.named_parameters():
        g, o = ref_grads[k].detach(), oracle[k]
        if o.abs().max().item() < VANISH * largest:
            assert max(p.grad.abs().max().item(), g.abs().max().item()) \
                < VANISH * largest, k
            continue
        scale = max(g.abs().max().item(), GRAD_FLOOR * largest)
        err = (p.grad - g).abs().max().item()
        jax_off = (g.double() - o).abs().max().item()
        port_off = (p.grad.double() - o).abs().max().item()
        assert err <= STEP_RTOL * scale or (
            jax_off <= ROUNDING * STEP_RTOL * scale and port_off <= jax_off
        ), (k, err, jax_off, port_off, scale)
    for k, v in ref_module.named_buffers():
        np.testing.assert_allclose(dict(module.named_buffers())[k].numpy(),
                                   v.numpy(), atol=STEP_RTOL, err_msg=k)


@pytest.mark.parametrize("name", VOICES)
def test_voice_train_step_matches_jax(name):
    """One step of the voice, the pitch regularization on (under MDN over
    every component's residual)."""
    cfg = voice_config(name)
    assert_step_matches(cfg, step_batch(cfg))


@pytest.mark.parametrize("case", ["mdn_nonattentive_r2_slice",
                                  "mdn_resf0_r2_zoneout0"])
def test_bare_mdn_decoder_train_step_matches_jax(case):
    """A bare PROBABILISTIC decoder's step: the masked MDN NLL over its
    (B, T, G, D) mixtures (and, with residual F0, the pitch
    regularization over the (B, T, G) residual), zoneout's masks on."""
    net = {**CASES[case], "zoneout": 0.2}
    rng = np.random.default_rng(3)
    B, T = 3, 23
    batch = {"in_feats": rng.uniform(0, 1, (B, T, net["in_dim"])).astype(
                 np.float32),
             "out_feats": rng.normal(size=(B, T, net["out_dim"])).astype(
                 np.float32),
             "lengths": np.array([T, T - 6, T - 11], np.int32),
             "pitch_reg_dyn_ws": rng.uniform(0, 1, (B, T, 1)).astype(
                 np.float32)}
    assert instantiate(net).prediction_type() == \
        PredictionType.PROBABILISTIC
    assert_step_matches({"netG": net}, batch)


@pytest.mark.parametrize("name", VOICES)
def test_voice_inference_matches_jax(name):
    """Free-running ``inference`` of the cascade (the point estimates of
    the MDN streams under MDN), running statistics perturbed."""
    net = voice_config(name)["netG"]
    module, jm, variables = twins(net)
    x = inputs(86, seed=5)
    xt, lengths = torch.from_numpy(x), torch.from_numpy(LENGTHS)
    with replayed_draws() as replay:
        want = jm.apply(variables, x, LENGTHS, method=jm.inference,
                        rngs=RNGS)
        with torch.no_grad():
            got = module.inference(xt, lengths,
                                   generator=torch.Generator().manual_seed(0))
            replay.assert_spent()
            replay.rewind()
            oracle = module.double().inference(
                xt.double(), lengths,
                generator=torch.Generator().manual_seed(0))
            replay.assert_spent()
    assert got.shape == (3, xt.shape[1], 13)
    assert np.isfinite(got.numpy()).all()
    judge_free_running(got, want, oracle)


@pytest.mark.parametrize("name", VOICES)
def test_shipped_voice_builds_in_the_port(name):
    """``acoustic_npss_ar_mgcf0bap.yaml`` with the voice's overrides builds
    at its widths: cell 0 of each decoder takes the encoder's output and
    the pre-net's (16 for lf0, 192 for mgc and bap), the mgc cells are
    H = 1024, and the MDN voice's heads are ``AR_GAUSSIANS`` wide."""
    net = chip_smoke.ar_option_netg(
        shipped_netg("acoustic_npss_ar_mgcf0bap.yaml"), name)
    module = instantiate(net)
    mdn = name == "npss_mdn_ar"
    assert isinstance(module, NPSSMDNMultistreamParametricModel if mdn
                      else NPSSMultistreamParametricModel)
    assert isinstance(module.mgc_model, BiLSTMMDNNonAttentiveDecoder if mdn
                      else BiLSTMNonAttentiveDecoder)
    for k, width in (("lf0_model", 2 * 64 + 1 + 16),
                     ("mgc_model", 2 * 256 + 192),
                     ("bap_model", 2 * 256 + 192)):
        sub = getattr(module, k)
        assert sub.ar_core.prenet.layers == chip_smoke.AR_PRENET_LAYERS
        assert sub.ar_core.cell0.w_x.shape[0] == width, k
        assert sub.ar_core.zoneout == (0.0 if mdn else chip_smoke.AR_ZONEOUT)
        assert sub.prediction_type() == (PredictionType.PROBABILISTIC
                                         if mdn else
                                         PredictionType.DETERMINISTIC)
    assert module.mgc_model.ar_core.cell0.w_h.shape == (1024, 4096)
    if mdn:
        assert module.mgc_model.postnet is None
        assert module.mgc_model.ar_core.mu.out_features == (
            chip_smoke.AR_GAUSSIANS * 2 * 60)


def test_multitrack_losses_take_an_mdn_lf0_as_jax():
    """``train/multitrack.multitrack_acoustic_loss`` with the AR MDN lf0
    decoder's (log_pi, log_sigma, mu) at (B, T, G, 1) in both tracks: the
    MDN NLL over the main track's mixtures in the feature loss, and the
    inter-singer log-F0 term on each track's most probable mean."""
    from ensemble_svs_with_interactions_tpu.train import (
        multitrack as jax_multitrack,
    )
    from ensemble_svs_with_interactions_tpu_torch.train import multitrack

    rng = np.random.default_rng(4)
    B, T, G, ss = 2, 9, 3, [4, 1, 1, 2]

    def arrays():
        lf0 = (np.log(rng.dirichlet(np.ones(G), (B, T)))[..., None],
               rng.normal(size=(B, T, G, 1)) * 0.3,
               rng.normal(size=(B, T, G, 1)))
        return [rng.normal(size=(B, T, 4)), lf0,
                rng.normal(size=(B, T, 1)), rng.normal(size=(B, T, 2))]

    def out():
        o = rng.normal(size=(B, T, sum(ss)))
        o[..., 5] = rng.uniform(size=(B, T)) > 0.3
        return o.astype(np.float32)

    main, sub, out_main, out_sub = arrays(), arrays(), out(), out()
    mask = (np.arange(T)[None, :, None] < np.array([T, 6])[:, None, None]
            ).astype(np.float32)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    as_jax = lambda p: [f32(p[0]), tuple(map(f32, p[1])), f32(p[2]),  # noqa
                        f32(p[3])]
    as_port = lambda p: [torch.from_numpy(f32(p[0])),  # noqa: E731
                         tuple(torch.from_numpy(f32(a)) for a in p[1]),
                         torch.from_numpy(f32(p[2])),
                         torch.from_numpy(f32(p[3]))]
    want = jax_multitrack.multitrack_acoustic_loss(
        as_jax(main), as_jax(sub), out_main, out_sub, mask, ss)
    got = multitrack.multitrack_acoustic_loss(
        as_port(main), as_port(sub), torch.from_numpy(out_main),
        torch.from_numpy(out_sub), torch.from_numpy(mask), ss)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.item(), float(w), rtol=1e-5, atol=1e-7)
    assert got[1].item() > 0
