"""The port's host CLIs against the JAX package's, on the CPU: each run by
both packages on the same inputs, the outputs compared file by file.

* Bitwise: ``sv56``, ``pitch_augmentation``, ``overwrite_phoneme_flags``,
  ``opencpop2nnsvs``, ``nnsvs2opencpop``, ``nnsvs2usfgan`` (the hdf5
  datasets, wavs and lists), ``compare_parity``'s ``codec`` dump,
  ``analyze`` dump and ``metrics`` report.
* ``plot_metrics`` and ``visualize_vibrato``: the arrays handed to
  matplotlib (``Axes.plot`` and ``fill_between`` recorded), bitwise, and
  the image written.
* ``anasyn``: the WORLD analysis is the host's in both packages, the
  synthesis the port's on its device with JAX's excitation draw fed in
  (``anasyn.excitation_noise`` patched), at SNR_DB as the port's WORLD
  tests hold the vocoder.
* ``generate``: a converted tiny voice (``chip_smoke.write_reference_pack``)
  over feature dumps, at ATOL as the serving tests hold acoustic features.
"""

import json
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
from scipy.io import wavfile

import chip_smoke
from ensemble_svs_with_interactions_tpu.bin import (
    anasyn as jax_anasyn,
    compare_parity as jax_compare_parity,
    generate as jax_generate,
    nnsvs2opencpop as jax_nnsvs2opencpop,
    nnsvs2usfgan as jax_nnsvs2usfgan,
    opencpop2nnsvs as jax_opencpop2nnsvs,
    overwrite_phoneme_flags as jax_overwrite_phoneme_flags,
    pitch_augmentation as jax_pitch_augmentation,
    plot_metrics as jax_plot_metrics,
    sv56 as jax_sv56,
    visualize_vibrato as jax_visualize_vibrato,
)
from ensemble_svs_with_interactions_tpu_torch.bin import (
    anasyn,
    compare_parity,
    enunu2nnsvs,
    generate,
    nnsvs2opencpop,
    nnsvs2usfgan,
    opencpop2nnsvs,
    overwrite_phoneme_flags,
    pitch_augmentation,
    plot_metrics,
    sv56,
    visualize_vibrato,
)
from ensemble_svs_with_interactions_tpu_torch.io import hts
from tests.test_torch_svs import few_threads, traced_flax_inits  # noqa: F401
from tests.util import HED, NIT_LAB, synth_wav_from_labels, trim_labels

SR = 24000
SNR_DB = 40.0
ATOL = 1e-4


def assert_same_dirs(a: Path, b: Path):
    """The same relative file names with the same bytes."""
    fa = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    fb = sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    assert fa == fb and fa
    for rel in fa:
        assert (a / rel).read_bytes() == (b / rel).read_bytes(), rel


def both(tmp_path, port_main, jax_main, args):
    """Run the two CLIs with ``args`` (``{out}`` -> each one's output
    directory); returns (port out, JAX out)."""
    outs = []
    for name, main in (("port", port_main), ("jax", jax_main)):
        out = tmp_path / name
        assert main([a.format(out=out) for a in args]) == 0
        outs.append(out)
    return outs


@pytest.fixture(scope="module")
def wav(tmp_path_factory):
    """2 s of the fixture's singing stand-in at SR, int16."""
    binary_dict, numeric_dict = hts.load_question_set(HED)
    labels = trim_labels(hts.load(NIT_LAB), 2.0)
    x = synth_wav_from_labels(labels, binary_dict, numeric_dict,
                              np.random.default_rng(0), sr=SR)[: 2 * SR]
    path = tmp_path_factory.mktemp("wav") / "song.wav"
    wavfile.write(path, SR, x)
    return path


def test_sv56_is_jax_s(tmp_path, wav):
    src = tmp_path / "in"
    src.mkdir()
    shutil.copy(wav, src / "a.wav")
    sr, x = wavfile.read(wav)
    wavfile.write(src / "b.wav", sr, (x // 8).astype(np.int16))
    port, ref = both(tmp_path, sv56.main, jax_sv56.main,
                     [str(src), "{out}", "--ndb", "-30"])
    assert_same_dirs(port, ref)
    lv = sv56.active_speech_level(x / 32768.0, sr)
    jlv = jax_sv56.active_speech_level(x / 32768.0, sr)
    assert lv[0] == jlv[0] and np.array_equal(lv[1], jlv[1])


def test_pitch_augmentation_is_jax_s(tmp_path):
    for side in ("port", "jax"):
        for d, D in (("in_acoustic", 86), ("in_duration", 82),
                     ("out_acoustic", 67)):
            (tmp_path / side / d).mkdir(parents=True)
            for i in range(2):
                np.save(tmp_path / side / d / f"u{i}-feats.npy",
                        np.random.default_rng(i + D).standard_normal(
                            (20, D)).astype(np.float32))
    for side, main in (("port", pitch_augmentation.main),
                       ("jax", jax_pitch_augmentation.main)):
        assert main([str(tmp_path / side), "100", "--question-path", HED,
                     "--acoustic-lf0-idx", "60"]) == 0
    assert_same_dirs(tmp_path / "port", tmp_path / "jax")
    assert list((tmp_path / "port" / "in_acoustic").glob("*_aug+100-*"))


def test_overwrite_phoneme_flags_is_jax_s(tmp_path):
    src = tmp_path / "labs"
    src.mkdir()
    shutil.copy(NIT_LAB, src / "a.lab")
    port, ref = both(tmp_path, overwrite_phoneme_flags.main,
                     jax_overwrite_phoneme_flags.main,
                     [str(src), "flag3", "{out}"])
    assert_same_dirs(port, ref)


@pytest.fixture(scope="module")
def opencpop(tmp_path_factory, wav):
    """An Opencpop-style corpus of two utterances, converted by both."""
    root = tmp_path_factory.mktemp("opencpop")
    src = root / "in"
    (src / "wavs").mkdir(parents=True)
    rows = [
        "u1|text|SP a i SP|rest C4 D#4 rest|0.5 0.40 0.40 0.3|"
        "0.5 0.2013 0.3987 0.3|0 0 1 0",
        "u2|text|SP o n u AP|rest A3 A3 Bb3 rest|0.25 0.3 0.3 0.61 0.2|"
        "0.25 0.1 0.2 0.61 0.2|0 0 0 0 0",
    ]
    (src / "transcriptions.txt").write_text("\n".join(rows) + "\n")
    (src / "train.txt").write_text(rows[0] + "\n")
    (src / "test.txt").write_text(rows[1] + "\n")
    shutil.copy(wav, src / "wavs" / "u1.wav")
    outs = both(root, opencpop2nnsvs.main, jax_opencpop2nnsvs.main,
                [str(src), "{out}"])
    return outs


def test_opencpop2nnsvs_is_jax_s(opencpop):
    assert_same_dirs(*opencpop)


def test_nnsvs2opencpop_is_jax_s(opencpop, tmp_path):
    port_in = opencpop[0] / "acoustic"
    port, ref = both(tmp_path, nnsvs2opencpop.main, jax_nnsvs2opencpop.main,
                     [str(port_in), "{out}"])
    assert_same_dirs(port, ref)
    assert (port / "transcriptions.txt").read_text().count("\n") == 2


def test_nnsvs2usfgan_is_jax_s(tmp_path):
    import h5py

    rng = np.random.default_rng(2)
    D = 60 + 2 + 5
    prefix = tmp_path / "out_acoustic_scaler"
    np.save(f"{prefix}_mean.npy", rng.standard_normal(D))
    var = rng.uniform(0.5, 2, D)
    np.save(f"{prefix}_var.npy", var)
    np.save(f"{prefix}_scale.npy", np.sqrt(var))
    for split in ("dev", "eval", "train_no_dev"):
        d = tmp_path / "dump" / split / "norm" / "in_vocoder"
        d.mkdir(parents=True)
        for i in range(2):
            np.save(d / f"{split}{i}-feats.npy",
                    rng.standard_normal((30, D)).astype(np.float32))
            np.save(d / f"{split}{i}-wave.npy",
                    rng.uniform(-0.5, 0.5, 30 * 240).astype(np.float32))
    args = [str(tmp_path / "dump"), "{out}", "--scaler-prefix", str(prefix),
            "--spk", "demo"]
    port, ref = both(tmp_path, nnsvs2usfgan.main, jax_nnsvs2usfgan.main,
                     args)
    h5s = sorted((port / "hdf5").glob("*.h5"))
    assert len(h5s) == 6
    for p in h5s:
        with h5py.File(p) as a, h5py.File(ref / "hdf5" / p.name) as b:
            assert list(a.keys()) == list(b.keys())
            for k in b:
                np.testing.assert_array_equal(a[k][()], b[k][()])
    for p in sorted((port / "wav").glob("*.wav")):
        assert p.read_bytes() == (ref / "wav" / p.name).read_bytes()
    for p in sorted((port / "scp").glob("*")):
        text = p.read_text().replace(str(port.resolve()), "OUT")
        assert text == (ref / "scp" / p.name).read_text().replace(
            str(ref.resolve()), "OUT")


class Recorder:
    """Records the arrays handed to matplotlib's ``Axes.plot`` and
    ``Axes.fill_between``."""

    def __init__(self, monkeypatch):
        import matplotlib

        matplotlib.use("Agg")
        from matplotlib.axes import Axes

        self.calls = []
        for name in ("plot", "fill_between"):
            real = getattr(Axes, name)

            def record(ax, *args, _real=real, _name=name, **kw):
                self.calls.append((_name, [np.asarray(a, np.float64)
                                           for a in args]))
                return _real(ax, *args, **kw)

            monkeypatch.setattr(Axes, name, record)

    def take(self):
        calls, self.calls = self.calls, []
        return calls


def assert_same_calls(got, want):
    assert [n for n, _ in got] == [n for n, _ in want] and got
    for (_, a), (_, b) in zip(got, want):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_plot_metrics_plots_jax_s_arrays(tmp_path, monkeypatch):
    rec = Recorder(monkeypatch)
    exps = []
    for e in range(2):
        d = tmp_path / f"exp{e}"
        d.mkdir()
        lines = [json.dumps({"epoch": i, "train/Loss": 1.0 / (i + 1 + e),
                             "dev/Loss": 2.0 / (i + 2), "other": 3})
                 for i in range(4)]
        (d / "metrics.jsonl").write_text("\n".join(lines) + "\n")
        exps.append(str(d))
    got = []
    for side, main in (("port", plot_metrics.main),
                       ("jax", jax_plot_metrics.main)):
        out = tmp_path / f"{side}.png"
        assert main(exps + ["--out", str(out)]) == 0
        assert out.stat().st_size > 0
        got.append(rec.take())
    assert_same_calls(*got)
    assert len(got[0]) == 4


def test_visualize_vibrato_plots_jax_s_arrays(tmp_path, monkeypatch, wav):
    rec = Recorder(monkeypatch)
    got = []
    for side, main in (("port", visualize_vibrato.main),
                       ("jax", jax_visualize_vibrato.main)):
        out = tmp_path / f"{side}.png"
        assert main([str(wav), str(out)]) == 0
        assert out.stat().st_size > 0
        got.append(rec.take())
    assert_same_calls(*got)


def test_compare_parity_codec_dump_is_jax_s(tmp_path):
    for side, main in (("port", compare_parity.main),
                       ("jax", jax_compare_parity.main)):
        assert main(["codec", "--fs", "24000", "--dims", "20", "--frames",
                     "6", "--out", str(tmp_path / f"{side}.npz")]) == 0
    a, b = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in b.files:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-12, atol=1e-12,
                                   err_msg=k)
    # and each side reads the other's dump as a match
    assert compare_parity.main(["codec", "--fs", "24000", "--dims", "20",
                                "--frames", "6", "--compare",
                                str(tmp_path / "jax.npz")]) == 0


def test_compare_parity_analyze_dump_is_jax_s(tmp_path, wav):
    for side, main in (("port", compare_parity.main),
                       ("jax", jax_compare_parity.main)):
        assert main(["analyze", str(wav), "--f0-extractor", "dio",
                     "--dims", "20", "--out",
                     str(tmp_path / f"{side}.npz")]) == 0
    a, b = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in b.files:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-12, atol=1e-12,
                                   err_msg=k)


def test_compare_parity_metrics_report_is_jax_s(tmp_path):
    rng = np.random.default_rng(3)
    ss, D = [6, 3, 1, 6], 16
    for d in ("pred", "gt"):
        (tmp_path / d).mkdir()
    for i in range(2):
        gt = rng.standard_normal((40, D)).astype(np.float32)
        gt[:, 6] = np.log(200.0) + 0.1 * rng.standard_normal(40)
        gt[:, 9] = (rng.uniform(size=40) > 0.3).astype(np.float32)
        pred = gt + 0.05 * rng.standard_normal(gt.shape).astype(np.float32)
        np.save(tmp_path / "gt" / f"u{i}-feats.npy", gt)
        np.save(tmp_path / "pred" / f"u{i}-feats.npy", pred[:37])
    for side, main in (("port", compare_parity.main),
                       ("jax", jax_compare_parity.main)):
        assert main(["metrics", str(tmp_path / "pred"), str(tmp_path / "gt"),
                     "--stream-sizes", ",".join(map(str, ss)),
                     "--out", str(tmp_path / f"{side}.json")]) == 0
    got = json.loads((tmp_path / "port.json").read_text())
    assert got == json.loads((tmp_path / "jax.json").read_text())
    assert got["n_utterances"] == 2


@pytest.mark.parametrize("args", [[], ["--use-codec", "--mgc-order", "24"],
                                  ["--f0-extractor", "harvest"]],
                         ids=["plain", "codec", "harvest"])
def test_anasyn_matches_jax(tmp_path, wav, monkeypatch, args):
    """JAX's ``world.synthesize`` draws ``normal(PRNGKey(0), (T * hop,))``;
    the port's CLI takes that draw through its noise hook."""
    import torch

    def jax_draw(samples, generator):
        n = jax.random.normal(jax.random.PRNGKey(0), (samples,))
        return torch.from_numpy(np.array(n))[None]

    monkeypatch.setattr(anasyn, "excitation_noise", jax_draw)
    outs = []
    for side, main in (("port", anasyn.main), ("jax", jax_anasyn.main)):
        out = tmp_path / f"{side}.wav"
        extra = ["--device", "cpu"] if side == "port" else []
        assert main([str(wav), str(out)] + args + extra) == 0
        outs.append(wavfile.read(out))
    (sr, got), (jsr, ref) = outs
    assert sr == jsr == SR and got.dtype == ref.dtype == np.int16
    assert got.shape == ref.shape
    ref, got = ref.astype(np.float64), got.astype(np.float64)
    snr = 10 * np.log10(np.sum(ref ** 2) / max(np.sum((got - ref) ** 2),
                                                1e-30))
    assert snr > SNR_DB, snr


@pytest.fixture(scope="module")
def voice(tmp_path_factory):
    """The converted tiny reference voice and two input dumps."""
    root = tmp_path_factory.mktemp("generate")
    chip_smoke.write_reference_pack(root / "ref", tiny=True)
    enunu2nnsvs.convert_nnsvs_pack(root / "ref", root / "voice")
    feats = root / "feats"
    feats.mkdir()
    rng = np.random.default_rng(4)
    for i, T in enumerate((37, 64)):
        x = rng.uniform(0, 1, (T, 86)).astype(np.float32)
        np.save(feats / f"u{i}-feats.npy", x)
    return root / "voice", feats


@pytest.mark.parametrize("static_only", [False, True])
def test_generate_matches_jax(tmp_path, voice, static_only):
    model_dir, feats = voice
    flag = ["--static-only"] if static_only else []
    assert generate.main([str(model_dir), str(feats), str(tmp_path / "port"),
                          "--device", "cpu"] + flag) == 0
    with traced_flax_inits():
        assert jax_generate.main([str(model_dir), str(feats),
                                  str(tmp_path / "jax")] + flag) == 0
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert len(names) == 2
    for n in names:
        got, ref = np.load(tmp_path / "port" / n), np.load(tmp_path / "jax"
                                                            / n)
        assert got.dtype == ref.dtype == np.float32
        assert got.shape == ref.shape and got.shape[1] == 67
        np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
