"""The port's NEUTRINO surface against the JAX package's: the ``NEUTRINO``
engine (timing labels, phraselists, f0/mgc/bap features, the ``NSF``
waveform), the two CLIs (``bin/neutrino.py``, ``bin/nsf.py``), the HTTP
server (``bin/neutrino_server.py``, every endpoint, in process on
127.0.0.1), the local model registry (``pretrained.py``) and
``bin/run_svs.py``, on the tiny pack that ``tests/util.
build_tiny_packed_model`` writes (MDN timing models, an FFConvLSTM
acoustic model with delta streams), opened by both packages.

Timing labels and phraselists are held equal as text, features at 1e-4,
waveforms at 40 dB SNR with the port's WORLD noise fed to the JAX
vocoder.  The port's engines run on the CPU (``device="cpu"``,
``--device cpu``)."""

import base64
import hashlib
import json
import socket
import tarfile
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.io import wavfile

from ensemble_svs_with_interactions_tpu import pretrained as jax_pretrained
from ensemble_svs_with_interactions_tpu.bin import (
    neutrino as jax_neutrino_cli,
    neutrino_server as jax_srv,
    nsf as jax_nsf_cli,
    run_svs as jax_run_svs,
)
from ensemble_svs_with_interactions_tpu.io import hts as jax_hts
from ensemble_svs_with_interactions_tpu.neutrino import NEUTRINO as JaxNEUTRINO
from ensemble_svs_with_interactions_tpu_torch import gen, pretrained
from ensemble_svs_with_interactions_tpu_torch.bin import (
    neutrino as neutrino_cli,
    neutrino_server as srv,
    nsf as nsf_cli,
    run_svs,
)
from ensemble_svs_with_interactions_tpu_torch.io import hts
from ensemble_svs_with_interactions_tpu_torch.neutrino import NEUTRINO
from ensemble_svs_with_interactions_tpu_torch.utils import misc
from tests.test_torch_svs import few_threads  # noqa: F401  (autouse)
from tests.test_torch_svs import traced_flax_inits
from tests.test_ust import UST
from tests.util import NIT_LAB, build_tiny_packed_model

SR = 24000
ATOL = 1e-4
SNR_DB = 40.0


def _snr(ref, got):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    return 10 * np.log10(np.sum(ref ** 2)
                         / max(np.sum((got - ref) ** 2), 1e-30))


@pytest.fixture(scope="module", autouse=True)
def port_vocoder_noise():
    """The JAX vocoder draws the port's ``vocoder_noise`` (module-scoped,
    so the module's fixtures see it)."""
    def normal(key, shape, dtype=jnp.float32):
        n = gen.vocoder_noise(1, int(np.prod(shape)), "cpu").numpy()
        return jnp.asarray(n.reshape(shape), dtype)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal", normal)
        yield


@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    """The tiny pack, alone in its model root, with an ENUNU table."""
    model_dir = tmp_path_factory.mktemp("root") / "voice"
    model_dir.mkdir()
    build_tiny_packed_model(model_dir)
    (model_dir / "kana2phonemes.table").write_text("か g a\n",
                                                    encoding="utf-8")
    return model_dir


@pytest.fixture(scope="module")
def engines(packed):
    with traced_flax_inits():
        jax_engine = JaxNEUTRINO(packed)
    return jax_engine, NEUTRINO(packed, device="cpu")


@pytest.fixture(scope="module")
def short_lab(tmp_path_factory):
    labels = hts.load(NIT_LAB)
    n = next(i for i, e in enumerate(labels.end_times) if e > 6e7)
    p = tmp_path_factory.mktemp("lab") / "test.lab"
    labels[: max(n, 10)].save(p)
    return p


def _scores(short_lab):
    """name -> (port labels loader, JAX labels loader) over both engines."""
    return {
        "labels": (lambda e: hts.load(short_lab),
                   lambda e: jax_hts.load(short_lab)),
        "musicxml": (lambda e: e.musicxml_to_labels(misc.example_xml_file()),
                     lambda e: e.musicxml_to_labels(misc.example_xml_file())),
        "ust_table": (lambda e: e.ust_to_labels(UST),
                      lambda e: e.ust_to_labels(UST)),
    }


@pytest.mark.parametrize("score", ["labels", "musicxml", "ust_table"])
def test_timing_and_phraselist_match_jax(engines, short_lab, score):
    """Timing labels and the phraselist as text, the phrase count; the
    UST goes through the pack's ``kana2phonemes.table``."""
    jax_engine, engine = engines
    load, jax_load = _scores(short_lab)[score]
    full, ref_full = load(engine), jax_load(jax_engine)
    assert str(full) == str(ref_full)
    if score == "ust_table":
        assert any("-g+" in c for c in full.contexts)
    timing = engine.predict_timing(full)
    ref = jax_engine.predict_timing(ref_full)
    assert str(timing) == str(ref)
    assert engine.get_phraselist(full, timing) == (
        jax_engine.get_phraselist(ref_full, ref))
    assert engine.get_num_phrases(full) == jax_engine.get_num_phrases(
        ref_full) >= 1


ACOUSTIC_CASES = {
    "whole": {},
    "style_shift": {"style_shift": 2},
    "phrase_0": {"phrase_num": 0},
    "phrase_1_shifted": {"phrase_num": 1, "style_shift": -1},
    "given_timing": {"timing": True},
}


@pytest.mark.parametrize("case", sorted(ACOUSTIC_CASES))
def test_predict_acoustic_neutrino_matches_jax(engines, short_lab, case):
    """float64 (f0, mgc, bap) at ATOL: the whole song, a style shift, one
    phrase, and timing labels given."""
    jax_engine, engine = engines
    kw = dict(ACOUSTIC_CASES[case])
    full, ref_full = hts.load(short_lab), jax_hts.load(short_lab)
    ref_kw = dict(kw)
    if kw.pop("timing", False):
        kw["timing_labels"] = engine.predict_timing(full)
        ref_kw = {"timing_labels": jax_engine.predict_timing(ref_full)}
    got = engine.predict_acoustic_neutrino(full, **kw)
    ref = jax_engine.predict_acoustic_neutrino(ref_full, **ref_kw)
    for g, r in zip(got, ref):
        assert g.dtype == np.float64 and g.shape == r.shape
        np.testing.assert_allclose(g, r, atol=ATOL)
    with pytest.raises(RuntimeError, match="phrase_num is too large"):
        engine.predict_acoustic_neutrino(full, phrase_num=99)


def test_predict_waveform_neutrino_matches_jax(engines, short_lab):
    """The same (f0, mgc, bap) through both ``NSF`` steps: int16 of JAX's
    length at SNR_DB."""
    jax_engine, engine = engines
    feats = jax_engine.predict_acoustic_neutrino(jax_hts.load(short_lab))
    ref = jax_engine.predict_waveform_neutrino(*feats)
    got = engine.predict_waveform_neutrino(*feats)
    assert got.dtype == ref.dtype == np.int16 and got.shape == ref.shape
    assert _snr(ref, got) > SNR_DB, _snr(ref, got)


@pytest.mark.parametrize("score", ["labels", "musicxml"])
def test_neutrino_and_nsf_clis_match_jax(tmp_path, packed, short_lab, score):
    """Both packages' ``neutrino`` CLIs: the timing labels and phraselist
    byte for byte, the feature files at ATOL; then both ``nsf`` CLIs on
    the JAX files: the wavs at SNR_DB."""
    src = short_lab if score == "labels" else misc.example_xml_file()
    out = {}
    for name, main, extra in (("jax", jax_neutrino_cli.main, []),
                              ("port", neutrino_cli.main,
                               ["--device", "cpu"])):
        d = tmp_path / name
        d.mkdir()
        files = [d / f for f in ("timing.lab", "out.f0", "out.mgc",
                                 "out.bap")]
        assert main([str(src), *map(str, files), str(packed),
                     "-i", str(d / "phraselist.txt"), "-k", "1", *extra]) == 0
        out[name] = files + [d / "phraselist.txt"]
    for g, r in zip(out["port"], out["jax"]):
        if g.suffix in (".lab", ".txt"):
            assert g.read_bytes() == r.read_bytes() and g.stat().st_size
        else:
            np.testing.assert_allclose(np.fromfile(g), np.fromfile(r),
                                       atol=ATOL)
    feats = [str(p) for p in out["jax"][1:4]]
    assert jax_nsf_cli.main([*feats, str(packed), str(tmp_path / "j.wav")]) == 0
    assert nsf_cli.main([*feats, str(packed), str(tmp_path / "p.wav"),
                         "--device", "cpu"]) == 0
    sr, ref = wavfile.read(tmp_path / "j.wav")
    sr_port, got = wavfile.read(tmp_path / "p.wav")
    assert sr == sr_port == SR and got.shape == ref.shape and len(got) > SR
    assert _snr(ref, got) > SNR_DB


def test_run_svs_through_register_model(tmp_path, packed, short_lab):
    """``bin/run_svs.py`` on a name registered with ``register_model``, in
    both packages: the wavs at SNR_DB."""
    pretrained.register_model("test/tiny_pack", packed)
    jax_pretrained.register_model("test/tiny_pack", packed)
    try:
        assert run_svs.main(["test/tiny_pack", str(short_lab),
                             str(tmp_path / "p.wav"), "--device", "cpu"]) == 0
        with traced_flax_inits():
            assert jax_run_svs.main(["test/tiny_pack", str(short_lab),
                                     str(tmp_path / "j.wav")]) == 0
    finally:
        pretrained.model_registry.pop("test/tiny_pack")
        jax_pretrained.model_registry.pop("test/tiny_pack")
    sr, ref = wavfile.read(tmp_path / "j.wav")
    _, got = wavfile.read(tmp_path / "p.wav")
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert _snr(ref, got) > SNR_DB


def test_pretrained_registry(packed, tmp_path, monkeypatch):
    """Registration, readiness and resolution as JAX's registry gives them
    (``tests/test_cli.py::test_pretrained_registry``), with the cache in a
    temporary directory; ``create_svs_engine`` passes ``device``."""
    for mod in (pretrained, jax_pretrained):
        monkeypatch.setattr(mod, "DEFAULT_CACHE_DIR", tmp_path / "cache")
        mod.register_model("tiny_test", packed)
    try:
        for name in ("tiny_test", "no/such/model", "r9y9/yoko_latest",
                     str(packed)):
            assert pretrained.is_pretrained_model_ready(name) == (
                jax_pretrained.is_pretrained_model_ready(name))
        assert pretrained.retrieve_pretrained_model("tiny_test") == packed
        assert pretrained.is_pretrained_model_ready("tiny_test")
        assert not pretrained.is_pretrained_model_ready("r9y9/yoko_latest")
        engine = pretrained.create_svs_engine("tiny_test", device="cpu")
        assert engine.sample_rate == SR and str(engine.device) == "cpu"
        for mod in (pretrained, jax_pretrained):
            with pytest.raises(ValueError, match="unknown pretrained model"):
                mod.retrieve_pretrained_model("no/such/model")
    finally:
        pretrained.model_registry.pop("tiny_test")
        jax_pretrained.model_registry.pop("tiny_test")


def test_pretrained_named_entries(packed, tmp_path, monkeypatch):
    """The registry ships JAX's named entries (ids, URLs, formats; targets
    the port's engine).  A named entry already complete in the cache
    resolves there, as in JAX; an uncached one raises, naming the unported
    converter, and downloads nothing."""
    import shutil

    assert pretrained.get_available_model_ids() == (
        jax_pretrained.get_available_model_ids())
    for name, entry in jax_pretrained.model_registry.items():
        assert pretrained.model_registry[name]["url"] == entry["url"]
        assert pretrained.model_registry[name]["format"] == entry["format"]
        assert pretrained.model_registry[name]["_target_"] == (
            "ensemble_svs_with_interactions_tpu_torch.svs:SPSVS")
    cache = tmp_path / "cache"
    for mod in (pretrained, jax_pretrained):
        monkeypatch.setattr(mod, "DEFAULT_CACHE_DIR", cache)
    with pytest.raises(NotImplementedError, match="bin/enunu2nnsvs.py"):
        pretrained.retrieve_pretrained_model("r9y9/yoko_latest")
    assert not cache.exists()
    shutil.copytree(packed, cache / "r9y9_yoko_latest")
    for mod in (pretrained, jax_pretrained):
        assert mod.is_pretrained_model_ready("r9y9/yoko_latest")
        assert mod.retrieve_pretrained_model("r9y9/yoko_latest") == (
            cache / "r9y9_yoko_latest")
    engine = pretrained.create_svs_engine("r9y9/yoko_latest", device="cpu")
    assert engine.model_dir == cache / "r9y9_yoko_latest"


# -------------------------------------------------------------- the server
@pytest.fixture(scope="module")
def servers(packed):
    """Both packages' servers, in process on 127.0.0.1 (port 0), over the
    pack's model root; the port's engines on the CPU."""
    root = packed.parent
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(srv, "_MODEL_ROOT", root)
        mp.setattr(srv, "_DEVICE", "cpu")
        mp.setattr(jax_srv, "_MODEL_ROOT", root)
        for name, mod in (("port", srv), ("jax", jax_srv)):
            server = ThreadingHTTPServer(("127.0.0.1", 0), mod.Handler)
            threading.Thread(target=server.serve_forever, daemon=True).start()
            out[name] = (server, f"http://127.0.0.1:{server.server_address[1]}")
        with traced_flax_inits():
            yield out
        for server, _ in out.values():
            server.shutdown()
            server.server_close()


def _get(base, path):
    with urllib.request.urlopen(f"{base}{path}") as r:
        return json.loads(r.read())


def _post(base, path, obj, status=None):
    req = urllib.request.Request(f"{base}{path}", json.dumps(obj).encode(),
                                 {"Content-Type": "application/json"})
    if status is not None:
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(req)
        assert exc.value.code == status
        return json.loads(exc.value.read())
    with urllib.request.urlopen(req) as r:
        return json.loads(r.read())


def _both(servers, path, obj=None, status=None):
    """(port, JAX) responses of one request."""
    return [(_post(servers[k][1], path, obj, status) if obj is not None
             else _get(servers[k][1], path)) for k in ("port", "jax")]


def _stream_chunks(base, obj):
    """POST /stream and return (headers, the chunked body's chunks), read
    off the socket frame by frame."""
    host, port = base.rsplit("/", 1)[-1].split(":")
    body = json.dumps(obj).encode()
    with socket.create_connection((host, int(port))) as s:
        s.sendall(b"POST /stream HTTP/1.1\r\nHost: x\r\n"
                  b"Content-Type: application/json\r\n"
                  + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
        f = s.makefile("rb")
        status = f.readline()
        headers = {}
        while (line := f.readline()) not in (b"\r\n", b""):
            k, v = line.decode().split(":", 1)
            headers[k.strip().lower()] = v.strip()
        assert b" 200 " in status, status
        chunks = []
        while True:
            n = int(f.readline().strip(), 16)
            data = f.read(n)
            assert f.read(2) == b"\r\n"
            if n == 0:
                return headers, chunks
            chunks.append(data)


def test_server_read_endpoints_match_jax(servers, packed):
    """/healthcheck, /models, /models/{id} (the packed config read by the
    port's YAML subset), unknown ids and paths."""
    port, ref = _both(servers, "/healthcheck")
    assert port == ref == {"healthcheck": "OK"}
    port, ref = _both(servers, "/models")
    assert port == ref == {"models": [packed.name]}
    port, ref = _both(servers, f"/models/{packed.name}")
    assert port["config"] == ref["config"]
    assert port["config"]["sample_rate"] == SR
    assert port["repr"].startswith("NEUTRINO(") and "cpu" in port["repr"]
    for k in ("port", "jax"):
        for path in ("/models/ghost", "/nowhere"):
            with pytest.raises(urllib.error.HTTPError) as exc:
                urllib.request.urlopen(servers[k][1] + path)
            assert exc.value.code == 404


def test_server_score_endpoints_match_jax(servers, packed, short_lab):
    """/timing on labels, MusicXML and UST text (the score stored by
    name), /phrases, /acoustic by name with full or mono timing labels and
    a style shift, /waveform, and the 400 for neither labels nor a
    stored name."""
    text = short_lab.read_text()
    xml = open(misc.example_xml_file(), encoding="utf-8").read()
    for req in ({"labels": text}, {"musicxml": xml, "name": "xml"},
                {"ust": UST, "name": "ust"}):
        port, ref = _both(servers, "/timing", {"model": packed.name, **req})
        assert port == ref
        assert port["name"] == req.get(
            "name", hashlib.sha1(text.encode()).hexdigest()[:16])
    port, ref = _both(servers, "/phrases", {"model": packed.name,
                                            "labels": text})
    assert port == ref and port["num_phrases"] >= 1
    timing = _post(servers["port"][1], "/timing",
                   {"model": packed.name, "labels": text, "name": "song"})
    _post(servers["jax"][1], "/timing",
          {"model": packed.name, "labels": text, "name": "song"})
    mono = str(hts.full_to_mono(hts.loads(timing["timing_labels"])))
    for req in ({"name": "song"},
                {"name": "song", "timing_labels": mono, "style_shift": 1},
                {"name": "ust", "phrase_num": 0}):
        port, ref = _both(servers, "/acoustic", {"model": packed.name, **req})
        assert (port["mgc_dim"], port["bap_dim"]) == (
            ref["mgc_dim"], ref["bap_dim"]) == (8, 3)
        for k, dim in (("f0", 1), ("mgc", 8), ("bap", 3)):
            np.testing.assert_allclose(srv._unb64(port[k], np.float64, dim),
                                       srv._unb64(ref[k], np.float64, dim),
                                       atol=ATOL)
    port, ref = _both(servers, "/waveform", {"model": packed.name, **{
        k: ref[k] for k in ("f0", "mgc", "bap", "mgc_dim", "bap_dim")}})
    assert port["sr"] == ref["sr"] == SR
    got, want = (np.frombuffer(base64.b64decode(r["wav"]), np.int16)
                 for r in (port, ref))
    assert got.shape == want.shape and _snr(want, got) > SNR_DB
    port, ref = _both(servers, "/acoustic", {"model": packed.name}, 400)
    assert port == ref


def test_server_stream_matches_jax(servers, packed, engines, short_lab):
    """/stream: a chunked ``audio/wav`` whose first chunk is the RIFF
    header and each later chunk one phrase, equal to the port engine's
    int16 ``svs_streaming`` chunks bit for bit and to the JAX server's
    chunk for chunk at SNR_DB; two concurrent requests give the same
    chunks."""
    _, engine = engines
    req = {"model": packed.name, "labels": short_lab.read_text()}
    headers, port = _stream_chunks(servers["port"][1], req)
    _, ref = _stream_chunks(servers["jax"][1], req)
    assert headers["content-type"] == "audio/wav"
    assert port[0] == ref[0] == srv._wav_stream_header(SR)
    assert port[0][:4] == b"RIFF" and port[0][8:12] == b"WAVE"
    want = list(engine.svs_streaming(hts.load(short_lab), dtype=np.int16))
    assert len(port) == len(ref) == len(want) + 1 > 2
    for p, r, w in zip(port[1:], ref[1:], want):
        p, r = np.frombuffer(p, np.int16), np.frombuffer(r, np.int16)
        assert np.array_equal(p, w)
        assert p.shape == r.shape and _snr(r, p) > SNR_DB
    got = [None, None]

    def fetch(i):
        got[i] = _stream_chunks(servers["port"][1], req)[1]

    ts = [threading.Thread(target=fetch, args=(i,)) for i in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in ts)
    assert got[0] == got[1] == port
    _post(servers["port"][1], "/stream", {"model": packed.name}, 400)


def test_server_create_model_matches_jax(tmp_path, packed):
    """/models/create in both packages' servers on empty roots: the nested
    tarball installed and listed, bad ids and bad tarballs refused
    without touching the root."""
    tarball = tmp_path / "pack.tar.gz"
    with tarfile.open(tarball, "w:gz") as tf:
        tf.add(packed, arcname="uploaded_voice")
    pack = base64.b64encode(tarball.read_bytes()).decode()
    for name, mod in (("port", srv), ("jax", jax_srv)):
        root = tmp_path / name
        root.mkdir()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(mod, "_MODEL_ROOT", root)
            mp.setattr(srv, "_DEVICE", "cpu")
            server = ThreadingHTTPServer(("127.0.0.1", 0), mod.Handler)
            threading.Thread(target=server.serve_forever, daemon=True).start()
            base = f"http://127.0.0.1:{server.server_address[1]}"
            try:
                assert _get(base, "/models") == {"models": []}
                assert _post(base, "/models/create", {
                    "model_id": "voice1", "pack": pack}) == {
                        "model_id": "voice1"}
                _post(base, "/models/create",
                      {"model_id": "../evil", "pack": pack}, 500)
                _post(base, "/models/create", {
                    "model_id": "bad", "pack": base64.b64encode(
                        b"not a tarball").decode()}, 500)
                assert _get(base, "/models") == {"models": ["voice1"]}
                assert sorted(p.name for p in root.iterdir()) == ["voice1"]
                assert (root / "voice1" / "kana2phonemes.table").exists()
            finally:
                server.shutdown()
                server.server_close()


def test_server_score_store_is_lru(monkeypatch):
    """The score store keeps the most recently used names, as JAX's."""
    for mod in (srv, jax_srv):
        monkeypatch.setattr(mod, "_SCORES", type(mod._SCORES)())
        monkeypatch.setattr(mod, "_SCORES_MAX", 3)
        for i in range(4):
            mod._store_score(f"s{i}", "x")
        mod._store_score("s1", "y")
        mod._store_score("s4", "x")
    assert list(srv._SCORES) == list(jax_srv._SCORES) == ["s3", "s1", "s4"]


def test_server_builds_an_engine_once_under_concurrent_loads(monkeypatch,
                                                             packed):
    """Six concurrent first requests for one model build its engine once,
    on the server's device."""
    monkeypatch.setattr(srv, "_MODEL_ROOT", packed.parent)
    monkeypatch.setattr(srv, "_DEVICE", "cpu")
    monkeypatch.setattr(srv, "_ENGINES", {})
    monkeypatch.setattr(srv, "_ENGINE_LOCKS", {})
    calls = []

    class Counting(NEUTRINO):
        def __init__(self, path, **kw):
            calls.append((str(path), kw))
            super().__init__(path, **kw)

    monkeypatch.setattr(srv, "NEUTRINO", Counting)
    out, errs = [], []

    def fetch():
        try:
            out.append(srv._engine(packed.name))
        except Exception as e:  # surfaced by the assert below
            errs.append(e)

    threads = [threading.Thread(target=fetch) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert not errs and len(out) == 6
    assert calls == [(str(packed), {"device": "cpu"})]
    assert all(e is out[0] for e in out)
    with pytest.raises(FileNotFoundError):
        srv._engine("../" + packed.name)
