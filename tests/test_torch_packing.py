"""The port's packed model directories against the JAX package's: its
YAML subset against PyYAML, its msgpack subset against flax, the weight
bridge both ways, the directory written by either package's
``pack_model`` opened by the other's ``SPSVS(model_dir)``, and the port
opening a directory with ``yaml``, ``msgpack``, ``flax`` and ``jax``
blocked, as on the card machine, which has none of them.

Durations must match exactly and streams at 1e-4, as
``tests/test_torch_svs.py`` holds them.
"""

import math
import shutil
import subprocess
import sys
from pathlib import Path

import flax.serialization
import numpy as np
import pytest
import torch
import yaml

from ensemble_svs_with_interactions_tpu.svs import SPSVS as JaxSPSVS
from ensemble_svs_with_interactions_tpu.utils.config import (
    save_config as jax_save_config,
)
from ensemble_svs_with_interactions_tpu.utils.packing import (
    pack_model as jax_pack_model,
)
from ensemble_svs_with_interactions_tpu.utils.scalers import (
    MinMaxScaler as JaxMinMax,
    StandardScaler as JaxStandard,
    save_scaler as jax_save_scaler,
)
from ensemble_svs_with_interactions_tpu_torch.io import hts
from ensemble_svs_with_interactions_tpu_torch.svs import SPSVS
from ensemble_svs_with_interactions_tpu_torch.utils import (
    flax_msgpack,
    yaml_io,
)
from ensemble_svs_with_interactions_tpu_torch.utils.config import (
    instantiate,
    load_config,
    save_config,
)
from ensemble_svs_with_interactions_tpu_torch.utils.flax_port import (
    flax_to_torch,
    torch_to_flax,
)
from ensemble_svs_with_interactions_tpu_torch.utils.packing import pack_model
from ensemble_svs_with_interactions_tpu_torch.utils.scalers import (
    MinMaxScaler,
    StandardScaler,
    load_minmax_scaler,
    load_standard_scaler,
    save_scaler,
)
from tests.test_torch_svs import (
    _short_labels,
    assert_slice_matches,
    tiny_model,
    tiny_phases,
    traced_flax_inits,
)
from tests.util import HED, NIT_LAB

REPO = Path(__file__).resolve().parent.parent
JAX_YAMLS = sorted((REPO / "ensemble_svs_with_interactions_tpu").rglob(
    "*.yaml"))


def same(a, b) -> bool:
    """Equal values of equal types, recursively; NaN equals NaN; arrays
    equal in dtype, shape and every bit."""
    if isinstance(a, (np.ndarray, np.generic)):
        return (type(a) is type(b) and a.dtype == b.dtype
                and np.shape(a) == np.shape(b)
                and np.asarray(a).tobytes() == np.asarray(b).tobytes())
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


def same_tree(a, b) -> bool:
    """Nested dicts of arrays equal as trees, whatever the key order."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and set(a) == set(b)
                and all(same_tree(a[k], b[k]) for k in a))
    return same(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------- YAML
def test_the_jax_package_has_26_yaml_files():
    assert len(JAX_YAMLS) == 26


@pytest.mark.parametrize(
    "path", JAX_YAMLS,
    ids=[str(p.relative_to(REPO / "ensemble_svs_with_interactions_tpu"))
         for p in JAX_YAMLS])
def test_yaml_reads_every_jax_config_as_pyyaml(path):
    """Each config file reads as ``yaml.safe_load`` reads it, and ``dump``
    writes what ``yaml.safe_dump(sort_keys=False)`` writes."""
    text = path.read_text()
    ref = yaml.safe_load(text)
    got = yaml_io.load(text)
    assert same(got, ref)
    assert yaml_io.dump(got) == yaml.safe_dump(ref, sort_keys=False)


TRICKY_SCALARS = [
    "1e-5", "1.0e-05", "1.0e5", "1.0e+5", "1.", ".5", "-.inf", ".Inf",
    "+.INF", ".NaN", ".nan", "+1", "-0", "012", "09", "0x1F", "0b101",
    "1_000", "1:30", "-1:30", "1:30.5", "yes", "No", "ON", "off", "y", "n",
    "~", "null", "Null", "NULL", "nul", "true", "True", "tRue", "FALSE",
    "-x", "a b", "a:b", "a#b", "http://x.y/z", "0.", "+0.5", "1e5",
    "3.14_15", ".", "_1", "0o17", "0_7", "'quoted #x'", '"d\\tq\\u00e9"',
    "'it''s'", "x # comment",
]


@pytest.mark.parametrize("value", TRICKY_SCALARS)
@pytest.mark.parametrize("form", ["k: {}\n", "- {}\n", "[{}]\n", "{{a: {}}}\n"])
def test_yaml_scalar_resolves_as_pyyaml(form, value):
    """YAML 1.1 resolution, PyYAML's: in a block mapping, a block sequence,
    and flow collections."""
    text = form.format(value)
    try:
        ref = yaml.safe_load(text)
    except yaml.YAMLError:
        with pytest.raises(yaml_io.YAMLError):
            yaml_io.load(text)
        return
    assert same(yaml_io.load(text), ref), text


LAYOUTS = [
    "a:\n- 1\n- b: 2\n  c:\n  - 3\n  - - 4\n    - 5\nd: {}\ne: []\n",
    "k: [a,\n  b, {c: d,\n e: [1, 2]}]  # comment\n",
    "a: this is a\n  long string\n\n  with a blank line\nb: 1\n",
    "- 'multi\n  line'\n- \"esc\\\n  aped\"\n",
    "---\na: 1\n...\n",
    "",
    "# only a comment\n",
    "x\n...\n",
    "a:\n  - 1\n  - 2\nb:\n- 3\n",
    "'q k': 1\n\"d\": 2\n1: int key\nnull: n\n",
    "a: 'x' # c\nb:    \nc: ~\n",
    "[1, [2, [3, {a: [4]}]], {}]\n",
]


@pytest.mark.parametrize("text", LAYOUTS)
def test_yaml_reads_layouts_as_pyyaml(text):
    assert same(yaml_io.load(text), yaml.safe_load(text))


DUMPED = [
    {"a": [1, {"b": 2, "c": [3, 4]}, [5, [6]], [], {}],
     "d": {"e": None, "f": True, "g": 1e-5, "h": "1e-5", "i": "yes",
           "j": "", "k": "a: b", "l": "-x", "m": "- x", "n": "#x",
           "o": "x #y", "p": "it's", "q": "tab\there", "r": "\u00e9",
           "t": " lead", "u": "012", "v": "0x1F", "w": 1.0,
           "x": math.inf, "x2": -math.inf, "y": "null", "z": "~",
           "ab": "<<", "ac": "2001-01-01", "ad": "@x", "ae": "x:",
           "af": ":x", "ag": "a,b", "ah": "[x", "ai": "x]", "aj": "?x",
           "ak": "? x", "am": '"q"', "an": "a\\b", "ao": 1e300,
           "ap": 12345678901234567890, "aq": -3, "ar": 0.1, "as": "---",
           "at": "...x", "au": "\u2028", "av": "x\xa0y", "aw": "=",
           "ax": "1.0"},
     1: "int key", None: "none key", True: "bool key", 2.5: "float key"},
    [[[1]], [{"a": 1, "b": [2]}], {"c": {"d": {}}}],
    [],
    {},
    1,
    "s",
    None,
    1.5e-07,
]


@pytest.mark.parametrize("obj", DUMPED)
def test_yaml_dump_writes_what_safe_dump_writes(obj):
    text = yaml_io.dump(obj)
    assert text == yaml.safe_dump(obj, sort_keys=False)
    assert same(yaml.safe_load(text), obj)
    assert same(yaml_io.load(text), obj)


@pytest.mark.parametrize("obj,value", [
    ({"nl": "line\nbreak", "tup": (1, (2, 3)), "nan": math.nan},
     {"nl": "line\nbreak", "tup": [1, [2, 3]], "nan": math.nan}),
    (["a\n\nb", " x \n y "], ["a\n\nb", " x \n y "]),
])
def test_yaml_dump_round_trips_through_pyyaml(obj, value):
    """Strings with line breaks are written double-quoted and tuples as
    lists: PyYAML reads back the same values."""
    text = yaml_io.dump(obj)
    assert same(yaml.safe_load(text), value)
    assert same(yaml_io.load(text), value)


@pytest.mark.parametrize("text,line", [
    ("a: &x 1\n", 1), ("a: 1\nb: *x\n", 2), ("a: !!str 1\n", 1),
    ("a:\n  b: |\n    x\n", 2), ("a: >\n  x\n", 1), ("? a\n: b\n", 1),
    ("%YAML 1.1\n---\na: 1\n", 1), ("a: 2001-01-01\n", 1),
    ("<<: {a: 1}\n", 1), ("a: =\n", 1), ("a:\n\tb: 1\n", 2),
    ("a: [1, 2\n", 2), ("a: 'open\n", 2), ("a: 1\n  b: 2\n", 2),
    ("- a\nb: 1\n", 2), ("a: b: c\n", 1), ("a: 1\n---\nb: 2\n", 2),
])
def test_yaml_rejects_outside_the_subset_with_the_line(text, line):
    with pytest.raises(yaml_io.YAMLError, match=f"^line {line}:"):
        yaml_io.load(text)


def test_configs_and_scalers_are_written_as_the_jax_package_writes_them(
        tmp_path):
    glob, cfgs, _, stats = tiny_model()
    for name, cfg in [("config", glob), *cfgs.items()]:
        jax_save_config(cfg, tmp_path / f"jax_{name}.yaml")
        save_config(cfg, tmp_path / f"port_{name}.yaml")
        assert (tmp_path / f"port_{name}.yaml").read_text() == (
            tmp_path / f"jax_{name}.yaml").read_text()
        assert load_config(tmp_path / f"jax_{name}.yaml") == cfg
    d, m, s = stats["acoustic"]
    for prefix, port, ref in [
            ("in", MinMaxScaler(np.zeros(d), np.ones(d)),
             JaxMinMax(np.zeros(d), np.ones(d))),
            ("out", StandardScaler(m, s ** 2, s), JaxStandard(m, s ** 2, s))]:
        save_scaler(port, str(tmp_path / f"port_{prefix}"))
        jax_save_scaler(ref, str(tmp_path / f"jax_{prefix}"))
    for f in sorted(tmp_path.glob("jax_*.npy")):
        assert (tmp_path / f.name.replace("jax_", "port_")).read_bytes() \
            == f.read_bytes()
    mm = load_minmax_scaler(tmp_path / "jax_in")
    st = load_standard_scaler(tmp_path / "jax_out")
    np.testing.assert_array_equal(mm.scale_, np.ones(d))
    np.testing.assert_array_equal(st.var_, s ** 2)
    with pytest.raises(TypeError):
        save_scaler(object(), str(tmp_path / "x"))


# ------------------------------------------------------------- msgpack
def _extra_leaves():
    return {"scalar": np.float32(1.5), "int64": np.arange(6).reshape(2, 3),
            "bool": np.array([True, False]), "empty": np.zeros((0, 3)),
            "f16": np.ones(5, np.float16), "py": {"i": -70000, "f": 2.5,
                                                  "n": None, "t": True,
                                                  "s": "h\u00e9"}}


def test_msgpack_decodes_flax_bytes(monkeypatch):
    """The tiny flagship's variables (and other leaf types) as flax writes
    them, with a chunk size small enough that several arrays are chunked,
    decode to what flax's own ``msgpack_restore`` gives."""
    _, _, variables, _ = tiny_model()
    tree = {**variables["acoustic"], "extra": _extra_leaves()}
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 256)
    data = flax.serialization.to_bytes(tree)
    assert data.count(b"__msgpack_chunked_array__") > 3
    got = flax_msgpack.from_bytes(data)
    assert same(got, flax.serialization.msgpack_restore(data))
    assert same_tree(got["params"], variables["acoustic"]["params"])


@pytest.mark.parametrize("chunk", [2 ** 30, 300])
def test_msgpack_writes_what_flax_writes(monkeypatch, chunk):
    """The port's ``to_bytes`` gives flax's bytes, and flax's
    ``from_bytes`` restores every leaf, chunked or not."""
    _, _, variables, _ = tiny_model()
    tree = {**variables["acoustic"], "extra": _extra_leaves()}
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", chunk)
    monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", chunk)
    data = flax_msgpack.to_bytes(tree)
    assert data == flax.serialization.to_bytes(tree)
    restored = flax.serialization.from_bytes(tree, data)
    assert same_tree(restored, tree)
    if chunk == 2 ** 30:  # unchunked leaves are read-only views of the input
        got = flax_msgpack.from_bytes(data)
        assert not got["extra"]["int64"].flags.writeable
        assert same_tree(got, tree)


@pytest.mark.parametrize("data", [
    b"\xc7\x01\x05x",                 # ext type 5
    b"\xd4\x02\x00",                  # complex (flax's ext type 2)
    b"\x81\xa1a",                     # truncated
    b"\xc1",                          # never used
    b"\x01\x02",                      # trailing bytes
])
def test_msgpack_rejects_what_it_does_not_read(data):
    with pytest.raises(flax_msgpack.MsgpackError):
        flax_msgpack.from_bytes(data)


# ------------------------------------------------------------ weights
@pytest.mark.parametrize("phase", ["timelag", "duration", "acoustic"])
def test_torch_to_flax_inverts_flax_to_torch(phase):
    """``flax_to_torch(m2, torch_to_flax(m1))`` reproduces every tensor of
    m1 bitwise, and ``torch_to_flax`` gives back the JAX package's own
    variables (per-gate LSTM kernels, bias on the h path, batch stats)."""
    _, cfgs, variables, _ = tiny_model()
    netg = cfgs[phase]["netG"]
    torch.manual_seed(3)
    m1 = instantiate(netg)
    with torch.no_grad():  # batch stats away from their initial values
        for name, b in m1.named_buffers():
            b.copy_(torch.rand_like(b) + 0.5)
    torch.manual_seed(4)
    m2 = flax_to_torch(instantiate(netg), torch_to_flax(m1))
    s1, s2 = m1.state_dict(), m2.state_dict()
    assert list(s1) == list(s2)
    for k in s1:
        assert torch.equal(s1[k], s2[k]), k
    carried = flax_to_torch(instantiate(netg), variables[phase])
    assert same_tree(torch_to_flax(carried), variables[phase])


def test_torch_to_flax_raises_on_a_tensor_it_cannot_place():
    _, cfgs, _, _ = tiny_model()
    module = instantiate(cfgs["duration"]["netG"])
    module.stray = torch.nn.Parameter(torch.zeros(3))
    with pytest.raises(ValueError, match="stray"):
        torch_to_flax(module)


# ---------------------------------------------------- packed directories
@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """{"jax": directory the JAX package's pack_model wrote, "port": one
    the port's pack_model wrote from port modules holding the same
    weights}, and the weights as port state dicts."""
    glob, cfgs, variables, stats = tiny_model()
    jax_dir = tmp_path_factory.mktemp("jax_packed")
    jax_pack_model(jax_dir, glob, HED, tiny_phases(
        cfgs, stats, JaxMinMax, JaxStandard,
        lambda ph: {"variables": variables[ph]}))
    modules = {ph: flax_to_torch(instantiate(cfgs[ph]["netG"]),
                                 variables[ph]) for ph in cfgs}
    port_dir = tmp_path_factory.mktemp("port_packed")
    pack_model(port_dir, glob, HED, tiny_phases(
        cfgs, stats, MinMaxScaler, StandardScaler,
        lambda ph: {"module": modules[ph]}))
    return ({"jax": jax_dir, "port": port_dir},
            {ph: m.state_dict() for ph, m in modules.items()})


def test_port_packed_directory_holds_what_jax_writes(dirs):
    """Same files; configs and scalers byte-equal; the weights equal as
    trees (the key order may differ)."""
    d, _ = dirs
    names = sorted(p.name for p in d["jax"].iterdir())
    assert sorted(p.name for p in d["port"].iterdir()) == names
    for name in names:
        a, b = (d["jax"] / name).read_bytes(), (d["port"] / name).read_bytes()
        if name.endswith(".params"):
            assert same_tree(flax.serialization.msgpack_restore(b),
                             flax.serialization.msgpack_restore(a)), name
        else:
            assert a == b, name


def test_port_packed_directory_renders_in_the_jax_package(dirs):
    """The JAX package's ``SPSVS`` opens what the port wrote, and renders
    as the port does from the same directory."""
    d, _ = dirs
    with traced_flax_inits():
        jax_engine = JaxSPSVS(d["port"])
    assert_slice_matches(jax_engine, SPSVS(d["port"], device="cpu"))


def test_from_parts_renders_as_the_loaded_engine(dirs):
    """``SPSVS.from_parts`` with the same weights gives the engine that
    ``SPSVS(model_dir)`` loads: durations and int16 audio bitwise."""
    d, state_dicts = dirs
    glob, cfgs, _, stats = tiny_model()
    loaded = SPSVS(d["jax"], device="cpu")
    parts = SPSVS.from_parts(glob, HED, tiny_phases(
        cfgs, stats, MinMaxScaler, StandardScaler,
        lambda ph: {"state_dict": state_dicts[ph]}), device="cpu")
    assert "model_dir=" in repr(loaded) and "device='cpu'" in repr(parts)
    labels = [_short_labels(hts) for _ in range(4)]
    pairs = [1, 2, 3, 0]
    for a, b in zip(
            loaded.predict_timing_multitrack_batch(labels, range(4), pairs),
            parts.predict_timing_multitrack_batch(labels, range(4), pairs)):
        assert list(a.start_times) == list(b.start_times)
        assert list(a.end_times) == list(b.end_times)
    for a, b in zip(loaded.svs_ensemble(labels)[0],
                    parts.svs_ensemble(labels)[0]):
        np.testing.assert_array_equal(a, b)


_BLOCKED_RENDER = """
import sys
for name in ("yaml", "msgpack", "flax", "jax"):
    sys.modules[name] = None  # any import of them raises ImportError
import numpy as np
from ensemble_svs_with_interactions_tpu_torch.io import hts
from ensemble_svs_with_interactions_tpu_torch.svs import SPSVS
model_dir, out, lab, seconds = sys.argv[1:]
labels = hts.load(lab)
n = next(i for i, e in enumerate(labels.end_times) if e > float(seconds) * 1e7)
engine = SPSVS(model_dir, device="cpu")
wavs, sr = engine.svs_ensemble([labels[: max(n, 10)] for _ in range(4)])
np.savez(out, *wavs)
jp = "ensemble_svs_with_interactions_tpu"
bad = [m for m in sys.modules if sys.modules[m] is not None
       and (m in ("yaml", "msgpack", "flax", "jax", jp)
            or m.startswith(("yaml.", "msgpack.", "flax.", "jax.", jp + ".")))]
assert not bad, bad
"""


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_port_opens_a_packed_directory_without_yaml_msgpack_flax_jax(
        dirs, tmp_path, writer):
    """As on the card machine: ``yaml``, ``msgpack``, ``flax`` and ``jax``
    cannot be imported, and the port opens the directory and renders what
    it renders with them present."""
    d, _ = dirs
    out = tmp_path / "wavs.npz"
    r = subprocess.run(
        [sys.executable, "-c", _BLOCKED_RENDER, str(d[writer]), str(out),
         str(NIT_LAB), "4.0"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    ref, _ = SPSVS(d[writer], device="cpu").svs_ensemble(
        [_short_labels(hts, 4.0) for _ in range(4)])
    got = np.load(out)
    assert len(got.files) == len(ref)
    for k, wav in enumerate(ref):
        np.testing.assert_array_equal(got[f"arr_{k}"], wav)


def _write_vocoder(model_dir):
    """A tiny packed hn-uSFGAN vocoder, by the port's
    ``save_model_phase`` with a StandardScaler in-scaler."""
    from ensemble_svs_with_interactions_tpu_torch.utils.packing import (
        save_model_phase,
    )
    from tests.test_torch_svs_vocoder import USFGAN_CONFIG, _vocoder

    module, sc = _vocoder(USFGAN_CONFIG, 0)
    save_model_phase(model_dir, "vocoder", USFGAN_CONFIG,
                     torch_to_flax(module), in_scaler=StandardScaler(*sc))


_PF = "ensemble_svs_with_interactions_tpu.models.postfilters"


def _write_band_split(model_dir):
    """A tiny packed band-split postfilter and its out scaler, by the
    port's ``save_model_phase``."""
    from ensemble_svs_with_interactions_tpu_torch.utils.packing import (
        save_model_phase,
    )

    cfg = {"netG": {"_target_": f"{_PF}.MultistreamConv2dPostFilter",
                    "channels": 8, "stream_sizes": [2, 2, 4]}}
    save_model_phase(model_dir, "postfilter", cfg,
                     torch_to_flax(instantiate(cfg["netG"])),
                     out_scaler=StandardScaler(np.zeros(8), np.ones(8),
                                               np.ones(8)))


# part -> (phase, its yaml text or a writer of the whole phase, what the
# port raises; None: the port loads it, as the JAX package does)
UNPORTED_PARTS = {
    "vocoder": ("vocoder", _write_vocoder, None),
    "MelF0MultistreamPostFilter": (
        "postfilter", f"netG:\n  _target_: {_PF}.MelF0MultistreamPostFilter\n"
        "  mel_postfilter: null\n  lf0_postfilter: null\n",
        r"models/postfilters\.py \(MelF0MultistreamPostFilter\)"),
    "MultistreamConv2dPostFilter": ("postfilter", _write_band_split, None),
}


@pytest.mark.parametrize("part", sorted(UNPORTED_PARTS))
def test_unported_packed_models_raise(dirs, tmp_path, part):
    """The JAX package loads a packed neural vocoder, and a mel or
    band-split learned postfilter.  The port loads the vocoder and the
    band-split postfilter too; it refuses a directory with the mel
    postfilter, naming the JAX module, rather than ignore it."""
    d, _ = dirs
    model_dir = tmp_path / "packed"
    shutil.copytree(d["jax"], model_dir)
    name, text, match = UNPORTED_PARTS[part]
    if callable(text):
        text(model_dir)
    else:
        (model_dir / f"{name}_model.yaml").write_text(text)
    if match is None:
        engine = SPSVS(model_dir, device="cpu")
        if name == "vocoder":
            assert engine.default_vocoder_type == "usfgan"
            assert engine.vocoder_in_scaler is not None
        else:
            assert type(engine.postfilter_model.module).__name__ == part
            assert engine.postfilter_out_scaler is not None
        return
    with pytest.raises(NotImplementedError, match=match):
        SPSVS(model_dir, device="cpu")


def test_no_card_raises_unless_the_cpu_is_asked_for(dirs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    d, _ = dirs
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SPSVS(d["jax"])
