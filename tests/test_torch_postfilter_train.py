"""The learned postfilter's trainer, its CLI and ``merge_postfilters`` on
the port against the JAX package's, on the CPU, at tiny widths.

* ``train_postfilter`` (through ``bin/train_postfilter.py``) and the JAX
  trainer for 2 epochs on the same pairs: the port's initial weights
  handed to the JAX ``init`` calls and both packages' noise replayed by a
  function of the shape alone (``tests/test_torch_postfilter._noise``),
  so the runs are the same computation.  Each epoch's logged means at
  METRIC_RTOL of max(1, |value|), the best checkpoint's G at PARAM_ATOL;
  JAX's ``load_checkpoint`` restores the port's ``best_loss.ckpt`` whole,
  its Adam state in optax's layout; the JAX metric names.
* ``merge_postfilters`` on postfilters whose config's ``netG`` is a plain
  ``Conv2dPostFilter`` writes the JAX merge's files (configs equal,
  params bitwise).  On the shipped ``postfilter_mgc.yaml`` /
  ``postfilter_bap.yaml`` (full width), whose ``netG`` is itself a
  ``MultistreamPostFilter``, the JAX merge nests it and its pack fails at
  inference; the port's lifts the trained filters, and its pack runs the
  same in both packages and applies each trained filter to its stream.
"""

import json
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from ensemble_svs_with_interactions_tpu.bin import (
    merge_postfilters as jax_merge,
)
from ensemble_svs_with_interactions_tpu.parallel import make_mesh
from ensemble_svs_with_interactions_tpu.train import loop as jax_loop
from ensemble_svs_with_interactions_tpu.train import (
    postfilter_trainer as jax_trainer,
)
from ensemble_svs_with_interactions_tpu.utils.config import _wrap
from ensemble_svs_with_interactions_tpu.utils.config import (
    instantiate as jax_instantiate,
)
from ensemble_svs_with_interactions_tpu.utils.config import (
    load_config as jax_load_config,
)
from ensemble_svs_with_interactions_tpu_torch.bin import merge_postfilters
from ensemble_svs_with_interactions_tpu_torch.bin import (
    train_postfilter as train_cli,
)
from ensemble_svs_with_interactions_tpu_torch.models import postfilters
from ensemble_svs_with_interactions_tpu_torch.train import gan
from ensemble_svs_with_interactions_tpu_torch.train import (
    postfilter_trainer,
)
from ensemble_svs_with_interactions_tpu_torch.train.loop import (
    TrainState,
    save_checkpoint,
)
from ensemble_svs_with_interactions_tpu_torch.utils import flax_msgpack
from ensemble_svs_with_interactions_tpu_torch.utils.config import (
    instantiate,
    load_config,
)
from ensemble_svs_with_interactions_tpu_torch.utils.flax_init import (
    init_module,
)
from ensemble_svs_with_interactions_tpu_torch.utils.flax_port import (
    flax_to_torch,
    torch_to_flax,
)
from tests.test_torch_gan import D_TARGET, G_CONFIG, SS
from tests.test_torch_postfilter import _noise

METRIC_RTOL = 1e-5
PARAM_ATOL = 1e-5
MODULE_ATOL = 1e-5
NEPOCHS = 2
CONFIGS = (Path(__file__).resolve().parents[1] /
           "ensemble_svs_with_interactions_tpu" / "configs" / "postfilter")
PF = "ensemble_svs_with_interactions_tpu.models.postfilters"
ADAM = {"optimizer": {"name": "Adam", "params": {"lr": 1e-3}}}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _replayed_noise(mp):
    mp.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32:
               jnp.asarray(_noise(shape), dtype))
    mp.setattr(postfilters, "draw_noise", lambda shape, generator:
               torch.from_numpy(_noise(shape)))


def write_pairs(root: Path, n, seed, dim=sum(SS)):
    """``n`` (degraded, target) ``-feats.npy`` pairs of 100-230 frames."""
    rng = np.random.default_rng(seed)
    for split, count in (("train_no_dev", n), ("dev", 1)):
        for i in range(count):
            T = int(rng.integers(100, 230))
            y = rng.standard_normal((T, dim)).astype(np.float32)
            x = (y + 0.3 * rng.standard_normal(y.shape)).astype(np.float32)
            for d, a in (("in", x), ("out", y)):
                p = root / split / d
                p.mkdir(parents=True, exist_ok=True)
                np.save(p / f"{split}{i:02d}-feats.npy", a)


def config(root: Path, out_dir: Path):
    dcfg = {"_target_": D_TARGET, "channels": 4, "kernel_size": [7, 3],
            "padding": None}
    return {
        "seed": 7, "verbose": 0, "device": "cpu",
        "data": {s: {"in_dir": str(root / s / "in"),
                     "out_dir": str(root / s / "out")}
                 for s in ("train_no_dev", "dev")},
        "model": {"netG": G_CONFIG, "netD": dcfg},
        "train": {"out_dir": str(out_dir), "nepochs": NEPOCHS,
                  "optim": {"netG": ADAM, "netD": ADAM, "clip_norm": 1.0}},
    }


def _metrics(path: Path):
    return [json.loads(line) for line in path.read_text().splitlines()]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The port's CLI and the JAX trainer on the same pairs from the same
    start: (root, config, port out dir, JAX out dir)."""
    root = tmp_path_factory.mktemp("pf")
    write_pairs(root, 4, seed=0)
    cfg = config(root, root / "port")
    path = root / "train.yaml"
    path.write_text(yaml.safe_dump(json.loads(json.dumps(cfg))))
    with pytest.MonkeyPatch.context() as mp:
        _replayed_noise(mp)
        assert train_cli.main([str(path)]) == 0
        start = {
            "MultistreamPostFilter": torch_to_flax(init_module(
                postfilter_trainer.build_postfilter(_wrap(cfg)), seed=0)),
            "Conv2dD": torch_to_flax(init_module(
                instantiate(cfg["model"]["netD"]), seed=2)),
        }
        mp.setattr(fnn.Module, "init", lambda self, *a, **k: start[
            type(self).__name__])
        mp.setattr(jax_trainer, "make_mesh", lambda: make_mesh(1))
        jax_trainer.train_postfilter(_wrap(dict(
            cfg, train=dict(cfg["train"], out_dir=str(root / "jax")))))
    return root, cfg, root / "port", root / "jax"


def test_trainer_logs_jax_s_metrics(trained):
    """Every epoch's train and dev means, with JAX's names and values."""
    _, _, port, ref = trained
    got, want = _metrics(port / "metrics.jsonl"), _metrics(
        ref / "metrics.jsonl")
    assert len(got) == len(want) == 2 * NEPOCHS
    names = {k for line in got for k in line}
    assert {f"train_no_dev/{k}" for k in gan.METRIC_KEYS} <= names
    assert "dev/Loss_Recon" in names
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k, v in w.items():
            np.testing.assert_allclose(g[k], v, rtol=METRIC_RTOL,
                                       atol=METRIC_RTOL, err_msg=k)


def test_trainer_checkpoints_g_as_jax(trained):
    """``best_loss.ckpt`` and ``latest.ckpt`` hold G; the best G equals
    JAX's; JAX's ``load_checkpoint`` restores the port's file whole."""
    root, cfg, port, ref = trained
    assert sorted(p.name for p in port.glob("*.ckpt")) == sorted(
        p.name for p in ref.glob("*.ckpt"))
    mine = flax_msgpack.from_bytes((port / "best_loss.ckpt").read_bytes())
    theirs = flax_msgpack.from_bytes((ref / "best_loss.ckpt").read_bytes())
    g = jax.tree_util.tree_leaves_with_path(mine["params"])
    w = jax.tree_util.tree_leaves_with_path(theirs["params"])
    assert [p for p, _ in g] == [p for p, _ in w]
    for (p, a), (_, b) in zip(g, w):
        np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_ATOL,
                                   err_msg=str(p))
    params = theirs["params"]
    opt = optax.adam(1e-3)
    state = jax_loop.load_checkpoint(
        port / "best_loss.ckpt",
        jax_loop.TrainState(params, {}, opt.init(params), 0))
    assert int(state.step) == int(theirs["step"]) > 0
    assert int(state.opt_state[0].count) == int(theirs["step"])


def test_trainer_refuses_more_than_one_process(tmp_path):
    """Two processes at a coordinator without this process's rank: refused
    before the trainer joins a group."""
    cfg = config(tmp_path, tmp_path / "out")
    cfg["distributed"] = {"coordinator": "127.0.0.1:1", "num_processes": 2}
    with pytest.raises(ValueError, match="process_id"):
        postfilter_trainer.train_postfilter(_wrap(cfg), device="cpu")


def test_cli_prints_its_usage():
    assert train_cli.main([]) == 1


# ------------------------------------------------------------ the merge


def _plain_config(path: Path, **netG):
    path.write_text(yaml.safe_dump({"netG": {
        "_target_": f"{PF}.Conv2dPostFilter", "channels": 3,
        "kernel_size": [3, 3], **netG}}))
    return path


def _ckpt(module, path: Path):
    save_checkpoint(path, TrainState(torch_to_flax(module)["params"], {},
                                     {}, 1), 1, is_best=True)
    return path / "best_loss.ckpt"


def test_merge_of_plain_postfilters_writes_jax_s_files(tmp_path):
    """Configs whose ``netG`` is a ``Conv2dPostFilter``: the same merged
    config, and params bitwise."""
    mgc = _plain_config(tmp_path / "mgc.yaml", noise_type="frame_wise",
                        in_dim=6)
    bap = _plain_config(tmp_path / "bap.yaml")
    ckpts = [_ckpt(init_module(instantiate(load_config(c).netG), seed=s),
                   tmp_path / f"ck{s}") for s, c in enumerate((mgc, bap))]
    args = ["--mgc-config", str(mgc), "--mgc-ckpt", str(ckpts[0]),
            "--bap-config", str(bap), "--bap-ckpt", str(ckpts[1]),
            "--stream-sizes", "8,1,1,3"]
    assert merge_postfilters.main([str(tmp_path / "port"), *args]) == 0
    assert jax_merge.main([str(tmp_path / "jax"), *args]) == 0
    assert load_config(tmp_path / "port/postfilter_model.yaml") == \
        jax_load_config(tmp_path / "jax/postfilter_model.yaml")
    assert (tmp_path / "port/postfilter_model.params").read_bytes() == \
        (tmp_path / "jax/postfilter_model.params").read_bytes()


@pytest.fixture(scope="module")
def shipped(tmp_path_factory):
    """Stage-9 checkpoints of the shipped mgc and bap postfilters (67
    features, full width), each merged by both packages."""
    root = tmp_path_factory.mktemp("shipped")
    args, trained = [], {}
    for seed, s in enumerate(("mgc", "bap")):
        cfg = CONFIGS / f"postfilter_{s}.yaml"
        net = init_module(instantiate(load_config(cfg).netG), seed=seed)
        trained[s] = net
        args += [f"--{s}-config", str(cfg), f"--{s}-ckpt",
                 str(_ckpt(net, root / s))]
    assert merge_postfilters.main([str(root / "port"), *args]) == 0
    assert jax_merge.main([str(root / "jax"), *args]) == 0
    return root, trained


def test_jax_merge_of_the_shipped_postfilters_cannot_run(shipped):
    """The JAX merge nests each stage-9 ``MultistreamPostFilter`` whole:
    the nested mgc filter sees 56 dims where its noise layer was trained
    on 58, and flax refuses the weight."""
    root, _ = shipped
    cfg = jax_load_config(root / "jax/postfilter_model.yaml")
    assert cfg.netG.mgc_postfilter["_target_"].endswith(
        "MultistreamPostFilter")
    from flax import serialization

    variables = serialization.msgpack_restore(
        (root / "jax/postfilter_model.params").read_bytes())
    net = jax_instantiate(cfg.netG)
    x = np.zeros((1, 64, 67), np.float32)
    with pytest.raises(Exception, match=r"mgc_postfilter/fc.*\(1, 58\)"):
        net.apply(variables, x, method=net.inference)


def test_port_merge_lifts_the_trained_postfilters(shipped):
    """The port's pack holds each trained filter at its stream (offsets
    from its config); it runs in both packages alike and equals each
    stage-9 filter applied on its own."""
    root, trained = shipped
    cfg = load_config(root / "port/postfilter_model.yaml")
    assert cfg.netG.mgc_postfilter["_target_"].endswith("Conv2dPostFilter")
    assert cfg.netG.bap_postfilter["_target_"].endswith("Conv2dPostFilter")
    assert (cfg.netG.mgc_offset, cfg.netG.bap_offset) == (2, 0)
    variables = flax_msgpack.from_bytes(
        (root / "port/postfilter_model.params").read_bytes())
    merged = flax_to_torch(instantiate(cfg.netG), variables).eval()
    x = np.random.default_rng(5).standard_normal((1, 64, 67)).astype(
        np.float32)
    with pytest.MonkeyPatch.context() as mp:
        _replayed_noise(mp)
        with torch.no_grad():
            got = merged.inference(torch.from_numpy(x))
            own = trained["bap"].inference(
                trained["mgc"].inference(torch.from_numpy(x)))
        jnet = jax_instantiate(jax_load_config(
            root / "port/postfilter_model.yaml").netG)
        want = jnet.apply(variables, x, method=jnet.inference)
    np.testing.assert_allclose(got.numpy(), own.numpy(), rtol=0,
                               atol=MODULE_ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=MODULE_ATOL)
    assert not np.allclose(got.numpy()[..., 2:60], x[..., 2:60], atol=1e-3)
    assert not np.allclose(got.numpy()[..., 62:], x[..., 62:], atol=1e-3)


# ------------------------------------ the band-split postfilter (serving)

def band_split_config(stream_sizes=(4, 6, 8), channels=3):
    return {"_target_": f"{PF}.MultistreamConv2dPostFilter",
            "channels": channels, "kernel_size": 5,
            "init_type": "kaiming_normal", "noise_scale": 0.7,
            "stream_sizes": list(stream_sizes)}


@pytest.mark.parametrize("nested", [False, True],
                         ids=["alone", "in_multistream"])
def test_band_split_postfilter_matches_jax(nested):
    """``MultistreamConv2dPostFilter``: the low / mid / high bands that
    overlap by the kernel's half width, alone and as the mgc filter of a
    ``MultistreamPostFilter`` (mgc dims from 2 on), on the same weights
    and noise, with its flax-scheme template equal to JAX's tree."""
    cfg = band_split_config()
    width = sum(cfg["stream_sizes"])
    if nested:
        cfg = {"_target_": f"{PF}.MultistreamPostFilter",
               "stream_sizes": [width + 2, 1, 1, 3], "mgc_offset": 2,
               "bap_offset": 0, "mgc_postfilter": cfg,
               "bap_postfilter": None, "lf0_postfilter": None}
        width += 2 + 5
    module = init_module(instantiate(cfg), seed=4).eval()
    x = np.random.default_rng(6).standard_normal((2, 40, width)).astype(
        np.float32)
    jm = jax_instantiate(cfg)
    with pytest.MonkeyPatch.context() as mp:
        _replayed_noise(mp)
        with torch.no_grad():
            got = module.inference(torch.from_numpy(x))
        want = jm.apply(torch_to_flax(module), x, method=jm.inference)
        tree = jax.eval_shape(lambda: jm.init(
            {"params": jax.random.PRNGKey(0),
             "noise": jax.random.PRNGKey(1)}, x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=MODULE_ATOL)
    assert not np.allclose(got.numpy(), x, atol=1e-3)
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), dict(tree))
    assert jax.tree_util.tree_map(
        lambda a: tuple(a.shape), torch_to_flax(module)) == shapes
