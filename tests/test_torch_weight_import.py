"""The port's reference-checkpoint importer against the JAX package's, on
the CPU, at tiny widths, with no reference checkout: reference-layout
state dicts are built from seeded ``torch.nn`` layers in the reference's
definition order and names (``chip_smoke.reference_state_dict``).  The
JAX package's own importer test (``tests/test_torch_port.py``) needs the
reference checkout and skips without it; this file covers the same
architectures.

* ``utils/torch_port.torch_to_flax`` against JAX's on the same state
  dicts, bitwise and in key order, with the unit count: ``MDN``,
  ``MDNv2``, ``LSTMRNN``, ``FFConvLSTM``, ``ResSkipF0FFConvLSTM``, the AR
  decoder ``BiLSTMResF0NonAttentiveDecoder`` and the transformer with
  ``transformer_scope_pairs``; each onto the port's template
  (``template_variables``), JAX's onto its flax ``init``.
* The port's template yields JAX's ``(kind, path)`` unit list: units of one
  shape pair up by that order, so a different one would cross them.
* The ported variables load into the port's module
  (``flax_port.flax_to_torch``) with every reference tensor in place
  (``chip_smoke.assert_reference_weights``).
* The shape-mismatch error, as in JAX.
* ``bin/enunu2nnsvs.convert_nnsvs_pack`` and ``main`` (scikit-learn
  scalers dumped by ``joblib``) write JAX's converter's files: the same
  names, parsed YAML, decoded msgpack trees (key order too) and ``.npy``
  bytes; the units ported are counted.
* ``SPSVS(..., device="cpu")`` serves the converted pack as the JAX engine
  serves JAX's: durations equal, acoustic features at ATOL, ``svs()`` at
  SNR_DB with the port's WORLD noise fed to JAX.
"""

import copy
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from ensemble_svs_with_interactions_tpu.bin import (
    enunu2nnsvs as jax_enunu,
)
from ensemble_svs_with_interactions_tpu.io import hts as jax_hts
from ensemble_svs_with_interactions_tpu.svs import SPSVS as JaxSPSVS
from ensemble_svs_with_interactions_tpu.utils import (
    torch_port as jax_torch_port,
)
from ensemble_svs_with_interactions_tpu.utils.config import (
    _wrap as jax_wrap,
    instantiate as jax_instantiate,
)
from ensemble_svs_with_interactions_tpu.utils.templates import (
    init_template,
)
from ensemble_svs_with_interactions_tpu_torch import gen
from ensemble_svs_with_interactions_tpu_torch.bin import enunu2nnsvs
from ensemble_svs_with_interactions_tpu_torch.io import hts
from ensemble_svs_with_interactions_tpu_torch.svs import SPSVS
from ensemble_svs_with_interactions_tpu_torch.utils import (
    flax_msgpack,
    torch_port,
    yaml_io,
)
from ensemble_svs_with_interactions_tpu_torch.utils.config import (
    _wrap,
    instantiate,
)
from ensemble_svs_with_interactions_tpu_torch.utils.flax_port import (
    flax_to_torch,
)
from tests.test_torch_svs import (  # noqa: F401
    _short_labels,
    few_threads,
    traced_flax_inits,
)
from tests.util import HED

ATOL = 1e-4
SNR_DB = 40.0
SECONDS = 4.0
M = "ensemble_svs_with_interactions_tpu.models"
LF0 = dict(in_lf0_idx=3, in_lf0_min=5.0, in_lf0_max=6.5, out_lf0_mean=5.9,
           out_lf0_scale=0.23)
# name -> (the model's config (reference keys), units, JAX's test's n)
ARCHS = {
    "MDN": ({"_target_": f"{M}.MDN", "in_dim": 6, "hidden_dim": 8,
             "out_dim": 2, "num_gaussians": 2, "num_layers": 1}, 4),
    "MDNv2": ({"_target_": f"{M}.MDNv2", "in_dim": 6, "hidden_dim": 8,
               "out_dim": 2, "num_gaussians": 3, "num_layers": 3,
               "dropout": 0.5}, 6),
    "LSTMRNN": ({"_target_": f"{M}.LSTMRNN", "in_dim": 6, "hidden_dim": 5,
                 "out_dim": 3, "num_layers": 2, "bidirectional": True}, 5),
    "FFConvLSTM": ({"_target_": f"{M}.FFConvLSTM", "in_dim": 10,
                    "ff_hidden_dim": 8, "conv_hidden_dim": 6,
                    "lstm_hidden_dim": 4, "out_dim": 3}, 14),
    "ResSkipF0FFConvLSTM": ({
        "_target_": f"{M}.acoustic.ResSkipF0FFConvLSTM", "in_dim": 12,
        "ff_hidden_dim": 8, "conv_hidden_dim": 6, "lstm_hidden_dim": 4,
        "out_dim": 5, "out_lf0_idx": 2, **LF0}, 14),
    "BiLSTMResF0NonAttentiveDecoder": ({
        "_target_": f"{M}.acoustic.BiLSTMResF0NonAttentiveDecoder",
        "in_dim": 12, "ff_hidden_dim": 8, "conv_hidden_dim": 6,
        "lstm_hidden_dim": 4, "num_lstm_layers": 1, "out_dim": 1,
        "decoder_layers": 1, "decoder_hidden_dim": 8, "prenet_layers": 1,
        "prenet_hidden_dim": 4, "prenet_dropout": 0.0, "zoneout": 0.0,
        "reduction_factor": 1, "out_lf0_idx": 0, **LF0}, 14),
    "TransformerEncoder": ({
        "_target_": f"{M}.TransformerEncoder", "in_dim": 10, "out_dim": 4,
        "hidden_dim": 8, "attention_dim": 12, "num_heads": 2,
        "num_layers": 2, "kernel_size": 3, "dropout": 0.0}, 22),
}
SCOPES = {"TransformerEncoder": torch_port.transformer_scope_pairs(2)}


def reference_net(name):
    net = dict(ARCHS[name][0])
    net["_target_"] = chip_smoke.REFERENCE_TARGETS[name]
    return net


def jax_template(cfg):
    """JAX's template: ``init_template`` (the AR decoder, whose plain
    ``init`` needs a target, through the training call JAX's own importer
    test uses)."""
    module = jax_instantiate(jax_wrap(cfg))
    if "NonAttentive" in cfg["_target_"]:
        T = 6
        return module.init(
            {k: jax.random.PRNGKey(i) for i, k in enumerate(
                ("params", "dropout", "prenet", "zoneout"))},
            jnp.zeros((1, T, cfg["in_dim"])), jnp.asarray([T]),
            jnp.zeros((1, T, cfg["out_dim"])), train=True)
    return init_template(module, cfg["in_dim"], cfg.get("out_dim"))


def port_module(cfg):
    return instantiate(_wrap(cfg))


def _tree(tree):
    """A nested dict of NumPy arrays, in the tree's own key order."""
    if hasattr(tree, "items"):
        return {k: _tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def assert_same_tree(got, want, path=""):
    """Equal keys in equal order, leaves bitwise with equal dtypes."""
    if isinstance(want, dict):
        assert isinstance(got, dict), path
        assert list(got) == list(want), (path, list(got), list(want))
        for k in want:
            assert_same_tree(got[k], want[k], f"{path}/{k}")
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, path
    np.testing.assert_array_equal(got, want, err_msg=path)


@pytest.fixture(scope="module", params=sorted(ARCHS))
def ported(request):
    """(name, reference layers, the port's variables and units, JAX's)."""
    name = request.param
    cfg, n = ARCHS[name]
    sd, layers = chip_smoke.reference_state_dict(reference_net(name), seed=3)
    sd = {k: v.numpy() for k, v in sd.items()}
    scopes = SCOPES.get(name)
    module = port_module(cfg)
    got = torch_port.torch_to_flax(sd, torch_port.template_variables(module),
                                   scope_pairs=scopes)
    want = jax_torch_port.torch_to_flax(sd, _tree(jax_template(cfg)),
                                        scope_pairs=scopes)
    assert got[1] == want[1] == n
    return name, layers, module, got[0], want[0]


def test_torch_to_flax_is_jax_s_bitwise_in_key_order(ported):
    _, _, _, got, want = ported
    assert_same_tree(_tree(got), _tree(want))


def test_ported_weights_load_into_the_port_module(ported):
    """Every reference tensor ends in the port module at its counterpart,
    in the port's layout."""
    _, layers, module, got, _ = ported
    flax_to_torch(module, got)
    n = chip_smoke.assert_reference_weights(module, layers)
    assert n >= len(layers)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_template_units_are_jax_s(name):
    """The port's template's ``(kind, path)`` units in JAX's order (the
    AR decoder's scanned core sorted by name, as flax returns it)."""
    cfg = ARCHS[name][0]
    got = [(k, p) for k, p, _ in torch_port._flax_units(
        torch_port.template_variables(port_module(cfg))["params"])]
    want = [(k, p) for k, p, _ in jax_torch_port._flax_units(
        _tree(jax_template(cfg))["params"])]
    assert got == want


def test_flax_port_torch_to_flax_is_the_other_direction():
    """``utils/flax_port.torch_to_flax`` reads a port module out; this
    module's ``torch_to_flax`` reads a reference state dict in."""
    from ensemble_svs_with_interactions_tpu_torch.utils import flax_port

    cfg = ARCHS["MDN"][0]
    module = port_module(cfg)
    own = flax_port.torch_to_flax(module)
    sd = {k: v.numpy() for k, v in chip_smoke.reference_state_dict(
        reference_net("MDN"), seed=1)[0].items()}
    variables, n = torch_port.torch_to_flax(sd, own)
    assert n == 4
    np.testing.assert_array_equal(variables["params"]["Dense_0"]["kernel"],
                                  sd["model.0.weight"].T)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_shape_mismatch_raises(pkg):
    cfg = dict(ARCHS["MDN"][0], hidden_dim=16)
    sd = {k: v.numpy() for k, v in chip_smoke.reference_state_dict(
        reference_net("MDN"), seed=0)[0].items()}
    if pkg == "port":
        fn, template = (torch_port.torch_to_flax,
                        torch_port.template_variables(port_module(cfg)))
    else:
        fn, template = (jax_torch_port.torch_to_flax,
                        _tree(jax_template(cfg)))
    with pytest.raises(ValueError, match="shape mismatch"):
        fn(sd, template)


def test_unit_count_mismatch_raises():
    sd = {k: v.numpy() for k, v in chip_smoke.reference_state_dict(
        reference_net("MDNv2"), seed=0)[0].items()}
    cfg = dict(ARCHS["MDNv2"][0], num_layers=2)
    with pytest.raises(ValueError, match="unit count mismatch"):
        torch_port.torch_to_flax(
            sd, torch_port.template_variables(port_module(cfg)))


# -------------------------------------------------------- the converters


def read_pack(d: Path) -> dict:
    """Every file of a pack, decoded: YAML parsed, msgpack trees, arrays,
    other files' bytes."""
    out = {}
    for p in sorted(d.iterdir()):
        if p.suffix == ".yaml":
            out[p.name] = yaml_io.load(p.read_text())
        elif p.suffix == ".params":
            out[p.name] = flax_msgpack.from_bytes(p.read_bytes())
        elif p.suffix == ".npy":
            a = np.load(p)
            out[p.name] = (a.dtype.str, a.shape, a.tobytes())
        else:
            out[p.name] = p.read_bytes()
    return out


def assert_same_pack(got: Path, want: Path):
    a, b = read_pack(got), read_pack(want)
    assert list(a) == list(b)
    for k in b:
        if k.endswith(".params"):
            assert_same_tree(_tree(a[k]), _tree(b[k]), k)
        else:
            assert a[k] == b[k], k


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """A tiny reference pack (the shipped single-track voice's classes),
    converted by both packages: (reference layers, the port's pack, JAX's,
    the port's units, JAX's)."""
    root = tmp_path_factory.mktemp("importer")
    layers = chip_smoke.write_reference_pack(root / "ref", tiny=True)
    got = enunu2nnsvs.convert_nnsvs_pack(root / "ref", root / "port")
    want = jax_enunu.convert_nnsvs_pack(root / "ref", root / "jax")
    return layers, root / "port", root / "jax", got, want


def test_convert_nnsvs_pack_writes_jax_s_files(converted):
    _, port_dir, jax_dir, got, want = converted
    assert got == want == [("timelag", 6), ("duration", 6), ("acoustic", 14)]
    assert [dict(got)[k] for k in chip_smoke.IMPORTER_UNITS] == list(
        chip_smoke.IMPORTER_UNITS.values())
    assert_same_pack(port_dir, jax_dir)
    cfg = yaml_io.load((port_dir / "acoustic_model.yaml").read_text())
    assert cfg["netG"]["_target_"] == f"{M}.acoustic.ResSkipF0FFConvLSTM"


def test_converted_weights_are_the_reference_s(converted):
    layers, port_dir, *_ = converted
    engine = SPSVS(port_dir, device="cpu")
    for phase in ("timelag", "duration", "acoustic"):
        module = getattr(engine, f"{phase}_model").module
        chip_smoke.assert_reference_weights(module, layers[phase])


def test_translate_target_is_jax_s():
    for t in ("nnsvs.model.MDNv2", "nnsvs.acoustic_models.ResSkipF0FFConvLSTM",
              "other.Model"):
        assert enunu2nnsvs.translate_target(t) == jax_enunu.translate_target(t)


@pytest.fixture(scope="module")
def port_vocoder_noise():
    """The JAX vocoder draws the port's ``vocoder_noise``."""
    def normal(key, shape, dtype=jnp.float32):
        n = gen.vocoder_noise(1, int(np.prod(shape)), "cpu").numpy()
        return jnp.asarray(n.reshape(shape), dtype)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal", normal)
        yield


@pytest.fixture(scope="module")
def served(converted, port_vocoder_noise):
    """Both engines on their own converted packs: (JAX's timing, the
    port's, JAX's acoustic features, the port's, JAX's wav, the port's)."""
    _, port_dir, jax_dir, _, _ = converted
    with traced_flax_inits():
        jax_engine = JaxSPSVS(jax_dir)
    engine = SPSVS(port_dir, device="cpu")
    jdm = jax_engine.predict_timing(_short_labels(jax_hts, SECONDS))
    dm = engine.predict_timing(_short_labels(hts, SECONDS))
    jfeats = jax_engine.predict_acoustic(jdm)
    feats = engine.predict_acoustic(dm)
    jwav, jsr = jax_engine.svs(_short_labels(jax_hts, SECONDS))
    wav, sr = engine.svs(_short_labels(hts, SECONDS))
    assert sr == jsr
    return jdm, dm, jfeats, feats, jwav, wav


def test_port_serves_the_converted_pack_as_jax(served):
    jdm, dm, jfeats, feats, jwav, wav = served
    np.testing.assert_array_equal(dm.start_times, jdm.start_times)
    np.testing.assert_array_equal(dm.end_times, jdm.end_times)
    for g, w in zip(feats if isinstance(feats, tuple) else (feats,),
                    jfeats if isinstance(jfeats, tuple) else (jfeats,)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=0,
                                   atol=ATOL)
    assert wav.dtype == jwav.dtype and wav.shape == jwav.shape
    ref, got = jwav.astype(np.float64), wav.astype(np.float64)
    snr = 10 * np.log10(np.sum(ref ** 2)
                        / max(np.sum((got - ref) ** 2), 1e-30))
    assert snr > SNR_DB, snr


def write_enunu(root: Path, ckpts: dict):
    """An ENUNU voicebank directory as JAX's ``tests/test_tools.py``
    writes one: ``enuconfig.yaml``, a question set and kana table, per
    phase ``model.yaml`` and a checkpoint, scikit-learn scalers dumped by
    ``joblib``; ``ckpts`` maps each phase to (model yaml, checkpoint path
    or bytes)."""
    import joblib
    from sklearn.preprocessing import MinMaxScaler, StandardScaler

    (root / "stats").mkdir(parents=True)
    (root / "hed").mkdir()
    (root / "hed" / "q.hed").write_bytes(Path(HED).read_bytes())
    (root / "kana.table").write_text("a a\n")
    rng = np.random.default_rng(0)
    for phase, (model_yaml, ckpt) in ckpts.items():
        (root / "model" / phase).mkdir(parents=True)
        (root / "model" / phase / "model.yaml").write_text(
            yaml_io.dump(model_yaml))
        dst = root / "model" / phase / "best.pth"
        dst.write_bytes(ckpt if isinstance(ckpt, bytes)
                        else Path(ckpt).read_bytes())
        for inout, cls in (("in", MinMaxScaler), ("out", StandardScaler)):
            sc = cls().fit(rng.normal(size=(50, 4)))
            joblib.dump(sc, root / "stats"
                        / f"{inout}_{phase}_scaler.joblib")
    (root / "enuconfig.yaml").write_text(yaml_io.dump({
        "question_path": "hed/q.hed", "table_path": "kana.table",
        "model_dir": "model", "stats_dir": "stats", "sample_rate": 48000,
        "log_f0_conditioning": True,
        "timelag": {"checkpoint": "best.pth", "allowed_range": [-20, 20],
                    "allowed_range_rest": [-40, 40]},
        "duration": {"checkpoint": "best.pth"},
        "acoustic": {"checkpoint": "best.pth", "relative_f0": True}}))
    return root


def test_enunu2nnsvs_main_writes_jax_s_files(converted, tmp_path, capsys):
    """A voicebank whose timing checkpoints port and whose acoustic one is
    not a checkpoint: both packages port 6 + 6 units, keep the acoustic
    one as ``.orig`` and write the same files."""
    ref = converted[1].parent / "ref"
    ckpts = {p: (yaml_io.load((ref / f"{p}_model.yaml").read_text()),
                 ref / f"{p}_model.pth") for p in ("timelag", "duration")}
    ckpts["acoustic"] = (yaml_io.load(
        (ref / "acoustic_model.yaml").read_text()), b"FAKE")
    enunu = write_enunu(tmp_path / "enunu", ckpts)
    assert enunu2nnsvs.main([str(enunu), str(tmp_path / "port")]) == 0
    out = capsys.readouterr().out
    assert "timelag: ported 6 torch layer units" in out
    assert "duration: ported 6 torch layer units" in out
    assert "acoustic: weight port failed" in out
    assert jax_enunu.main([str(enunu), str(tmp_path / "jax")]) == 0
    assert (tmp_path / "port" / "acoustic_model.pth.orig").read_bytes() \
        == b"FAKE"
    assert_same_pack(tmp_path / "port", tmp_path / "jax")


def test_enunu2nnsvs_without_weights_and_without_joblib(converted, tmp_path,
                                                        monkeypatch):
    ref = converted[1].parent / "ref"
    ckpts = {p: (yaml_io.load((ref / f"{p}_model.yaml").read_text()),
                 ref / f"{p}_model.pth")
             for p in ("timelag", "duration", "acoustic")}
    enunu = write_enunu(tmp_path / "enunu", ckpts)
    assert enunu2nnsvs.main([str(enunu), str(tmp_path / "port"),
                             "--no-port-weights"]) == 0
    assert jax_enunu.main([str(enunu), str(tmp_path / "jax"),
                           "--no-port-weights"]) == 0
    assert_same_pack(tmp_path / "port", tmp_path / "jax")
    assert not list((tmp_path / "port").glob("*.params"))
    import builtins

    real_import = builtins.__import__

    def no_joblib(name, *a, **k):
        if name == "joblib":
            raise ImportError("No module named 'joblib'")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_joblib)
    with pytest.raises(ImportError, match="needs joblib"):
        enunu2nnsvs.scaler_to_npy(enunu / "stats" / "in_timelag_scaler.joblib",
                                  tmp_path)


def test_try_port_phase_keeps_the_class_s_keys_only(tmp_path):
    """Reference-only keys are dropped by both packages, nested
    sub-model configs translated and scoped."""
    net = dict(reference_net("MDNv2"), torch_only_knob=3)
    sd = chip_smoke.reference_state_dict(reference_net("MDNv2"), seed=2)[0]
    torch.save(sd, tmp_path / "m.pth")
    cfg = {"netG": net, "stream_sizes": [2], "has_dynamic_features": [False],
           "num_windows": 1}
    n = enunu2nnsvs.try_port_phase("timelag", copy.deepcopy(cfg),
                                   tmp_path / "m.pth", tmp_path / "port")
    assert n == jax_enunu.try_port_phase("timelag", copy.deepcopy(cfg),
                                         tmp_path / "m.pth",
                                         tmp_path / "jax") == 6
    assert_same_pack(tmp_path / "port", tmp_path / "jax")
    got = yaml_io.load((tmp_path / "port" / "timelag_model.yaml").read_text())
    assert "torch_only_knob" not in got["netG"]


def test_registry_converts_an_extracted_tarball(converted, tmp_path,
                                                monkeypatch):
    """A named entry whose published tarball lies extracted in the cache
    (one directory nested) converts there as JAX's ``_download_and_port``
    converts it after its download; an entry with nothing in the cache
    raises naming the converter."""
    from ensemble_svs_with_interactions_tpu import pretrained as jax_pre
    from ensemble_svs_with_interactions_tpu_torch import pretrained

    ref = converted[1].parent / "ref"
    names = pretrained.get_available_model_ids()
    name, other = names[0], names[1]
    safe = name.replace("/", "_")
    for side, mod in (("port", pretrained), ("jax", jax_pre)):
        shutil.copytree(ref, tmp_path / side / f"{safe}_torch" / "pack")
        monkeypatch.setattr(mod, "DEFAULT_CACHE_DIR", tmp_path / side)
    with pytest.raises(NotImplementedError, match="bin/enunu2nnsvs.py"):
        pretrained.retrieve_pretrained_model(other)
    got = pretrained.retrieve_pretrained_model(name)
    assert got == tmp_path / "port" / safe
    assert not (tmp_path / "port" / f"{safe}.partial").exists()
    assert_same_pack(got, jax_pre.retrieve_pretrained_model(name))
    assert pretrained.retrieve_pretrained_model(name) == got
