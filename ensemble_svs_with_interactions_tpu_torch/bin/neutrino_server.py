"""NEUTRINO-compatible HTTP server; the port's copy of
``ensemble_svs_with_interactions_tpu/bin/neutrino_server.py``.

NNSVS's NEUTRINO-compatible server is a FastAPI app with a model registry,
label upload and timing / acoustic / waveform endpoints.  This one is
built on the stdlib ``http.server`` with the same JSON API surface; the
engines (``neutrino.NEUTRINO``) run on ``--device`` (``cuda`` unless
``--device cpu``):

  GET  /healthcheck                 liveness probe -> {healthcheck: "OK"}
  GET  /models                      list packed models under --model-root
  GET  /models/{id}                 model info -> {config, repr}
  POST /models/create {model_id, pack}      install an uploaded pack
        (base64 tar.gz of a packed-model dir, nested dir flattened —
        NNSVS's server takes an UploadFile)
  POST /phrases   {model, name | labels[, timing_labels]}
        -> {phraselist, num_phrases}  (NNSVS's /run/phrases)
  POST /timing    {model, labels[, name]}   -> {timing_labels, name}
        stores the FULL labels server-side under ``name`` (default: a
        content hash), like NNSVS's score upload + /run/timing
  POST /acoustic  {model, name | labels[, timing_labels]} -> {f0, mgc, bap}
        full labels come from the store (or the request); timing_labels
        may be user-edited mono or full timing (base64 float64 output)
  POST /waveform  {model, f0, mgc, bap}  -> {wav} (base64 int16), {sr}
  POST /stream    {model, name | labels[, vocoder_type, post_filter_type,
                   style_shift, gain]}
        -> chunked ``audio/wav`` (16-bit PCM, unknown-length RIFF header):
        phrase-level chunks are written as soon as ``SPSVS.svs_streaming``
        renders them, so playback can begin after the first phrase
        (e.g. ``curl -sN -d @req.json .../stream | aplay``).  NNSVS's
        server returns whole songs only.

Usage: python -m ensemble_svs_with_interactions_tpu_torch.bin.neutrino_server
       --model-root models/ [--port 8001] [--device cpu]
"""

from __future__ import annotations

import argparse
import base64
import hashlib
import json
import threading
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np

from ensemble_svs_with_interactions_tpu_torch.io import hts
from ensemble_svs_with_interactions_tpu_torch.neutrino import NEUTRINO
from ensemble_svs_with_interactions_tpu_torch.utils import yaml_io

_ENGINES = {}
_ENGINE_LOCKS = {}  # name -> lock held only while THAT model loads
_SCORES = OrderedDict()  # name -> full-context labels text (LRU-bounded)
_SCORES_MAX = 256
_LOCK = threading.Lock()
_MODEL_ROOT = Path("models")
_DEVICE = "cuda"  # where the engines run (--device)


def _engine(name: str) -> NEUTRINO:
    # ThreadingHTTPServer runs handlers concurrently; build each engine
    # exactly once (the load moves the whole pack to the device).  The global lock
    # only guards the dicts — the multi-second model load itself holds a
    # per-model lock, so requests for already-loaded models never queue
    # behind another model's load.  Client-supplied names are validated
    # against the model root BEFORE any dict insertion so spammed bogus
    # names cannot grow the lock/engine dicts.
    model_dir = _MODEL_ROOT / name
    if (
        model_dir.resolve().parent != _MODEL_ROOT.resolve()
        or not (model_dir / "config.yaml").exists()
    ):
        raise FileNotFoundError(f"unknown model: {name!r}")
    with _LOCK:
        engine = _ENGINES.get(name)
        if engine is not None:
            return engine
        load_lock = _ENGINE_LOCKS.setdefault(name, threading.Lock())
    with load_lock:
        with _LOCK:
            engine = _ENGINES.get(name)
        if engine is None:
            # NOTE: on failure the lock entry stays in _ENGINE_LOCKS —
            # popping it would let a thread already blocked on THIS lock
            # object race a newcomer that setdefault()s a fresh one
            # (two concurrent multi-second loads of the same model).
            # Entries are bounded: only names validated against the model
            # root ever reach this point.
            engine = NEUTRINO(model_dir, device=_DEVICE)
            with _LOCK:
                _ENGINES[name] = engine
        return engine


def _store_score(name: str, text: str) -> None:
    with _LOCK:
        _SCORES[name] = text
        _SCORES.move_to_end(name)
        while len(_SCORES) > _SCORES_MAX:
            _SCORES.popitem(last=False)


def _b64(x: np.ndarray) -> str:
    return base64.b64encode(np.ascontiguousarray(x).tobytes()).decode()


def _unb64(s: str, dtype, dim: int) -> np.ndarray:
    return np.frombuffer(base64.b64decode(s), dtype=dtype).reshape(-1, dim).copy()


def _wav_stream_header(sample_rate: int) -> bytes:
    """RIFF/WAVE header for a mono 16-bit PCM stream of unknown length.

    The RIFF and data chunk sizes are 0xFFFFFFFF, the conventional
    "until end of stream" marker players accept for live streams.
    """
    import struct

    byte_rate = sample_rate * 2
    return b"".join(
        [
            b"RIFF", struct.pack("<I", 0xFFFFFFFF), b"WAVE",
            b"fmt ", struct.pack("<IHHIIHH", 16, 1, 1, sample_rate,
                                 byte_rate, 2, 16),
            b"data", struct.pack("<I", 0xFFFFFFFF),
        ]
    )


class Handler(BaseHTTPRequestHandler):
    # HTTP/1.1 for chunked transfer on /stream; every other response
    # carries an explicit Content-Length (see _json) as 1.1 requires.
    protocol_version = "HTTP/1.1"
    def _json(self, obj, status=200):
        body = json.dumps(obj).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        try:
            if self.path == "/healthcheck":
                self._json({"healthcheck": "OK"})
            elif self.path == "/models":
                models = sorted(
                    p.name for p in _MODEL_ROOT.iterdir()
                    if (p / "config.yaml").exists()
                )
                self._json({"models": models})
            elif self.path.startswith("/models/"):
                # model info: the packed config plus the engine repr
                # (loads + caches the engine)
                name = self.path[len("/models/"):]
                # same id validation as /models/create: a raw
                # "/models/../x" path must not escape the model root
                if "/" in name or "\\" in name or name in ("", ".", ".."):
                    raise FileNotFoundError(f"invalid model id: {name!r}")
                engine = _engine(name)
                config = yaml_io.load(
                    (_MODEL_ROOT / name / "config.yaml").read_text()
                )
                self._json({"config": config, "repr": repr(engine)})
            else:
                self._json({"error": "not found"}, 404)
        except FileNotFoundError as e:
            self._json({"error": str(e)}, 404)
        except Exception as e:  # same JSON error envelope as do_POST
            self._json({"error": f"{type(e).__name__}: {e}"}, 500)

    def _create_model(self, req):
        """Install an uploaded packed-model tarball under the model root
        (NNSVS's UploadFile -> JSON base64 here).
        A single nested directory is flattened, so ``tar czf pack.tar.gz
        mymodel/`` round-trips to ``model_root/<model_id>/config.yaml``."""
        import io
        import shutil
        import tarfile

        model_id = req["model_id"]
        if "/" in model_id or "\\" in model_id or model_id in ("", ".", ".."):
            raise ValueError(f"invalid model_id: {model_id!r}")
        data = base64.b64decode(req["pack"])
        model_dir = _MODEL_ROOT / model_id
        staging = _MODEL_ROOT / f"{model_id}.partial"
        shutil.rmtree(staging, ignore_errors=True)
        try:
            staging.mkdir(parents=True)
            with tarfile.open(fileobj=io.BytesIO(data), mode="r:gz") as tf:
                # filter="data" rejects path-traversal members
                tf.extractall(staging, filter="data")
            entries = list(staging.iterdir())
            if len(entries) == 1 and entries[0].is_dir():
                src = entries[0]
            else:
                src = staging
            if not (src / "config.yaml").exists():
                raise ValueError("pack has no config.yaml")
            if model_dir.exists():
                shutil.rmtree(model_dir)
            if src is staging:
                staging.rename(model_dir)
            else:
                src.rename(model_dir)
                shutil.rmtree(staging, ignore_errors=True)
        except BaseException:
            shutil.rmtree(staging, ignore_errors=True)
            raise
        # a re-upload must evict any previously cached engine for the id
        with _LOCK:
            _ENGINES.pop(model_id, None)
        self._json({"model_id": model_id})

    def _full_labels(self, req):
        """FULL labels from the request or the score store — timing labels
        alone (possibly user-edited mono, the NEUTRINO round-trip) carry no
        linguistic contexts.  Returns None after sending a 400 when neither
        is available."""
        stored = None
        if "labels" not in req and req.get("name"):
            with _LOCK:
                stored = _SCORES.get(req["name"])
                if stored is not None:
                    _SCORES.move_to_end(req["name"])
        if "labels" in req:
            return hts.loads(req["labels"])
        if stored is not None:
            return hts.loads(stored)
        self._json(
            {
                "error": "post the full labels or a name "
                "previously registered via /timing"
            },
            400,
        )
        return None

    def do_POST(self):
        length = int(self.headers.get("Content-Length", 0))
        try:
            req = json.loads(self.rfile.read(length))
            if self.path == "/models/create":
                return self._create_model(req)
            engine = _engine(req["model"])
            if self.path == "/phrases":
                # NNSVS's /run/phrases: the phraselist + phrase count for
                # per-phrase synthesis
                full = self._full_labels(req)
                if full is None:
                    return
                timing = (
                    hts.loads(req["timing_labels"])
                    if req.get("timing_labels")
                    else engine.predict_timing(full)
                )
                self._json(
                    {
                        "phraselist": engine.get_phraselist(full, timing),
                        "num_phrases": engine.get_num_phrases(full),
                    }
                )
            elif self.path == "/timing":
                # score input: full labels, MusicXML text, or UST text
                # (NNSVS's /score/musicxml/upload and /score/ust/upload)
                if req.get("musicxml"):
                    from ensemble_svs_with_interactions_tpu_torch.frontend import (
                        load_score,
                    )

                    labels = load_score("score.xml", req["musicxml"])
                    text = str(labels)
                elif req.get("ust"):
                    # engine path: picks up the pack's kana2phonemes.table
                    labels = engine.ust_to_labels(req["ust"])
                    text = str(labels)
                else:
                    text = req["labels"]
                    labels = hts.loads(text)
                name = req.get("name") or hashlib.sha1(
                    text.encode()
                ).hexdigest()[:16]
                _store_score(name, text)
                timing = engine.predict_timing(labels)
                phraselist = engine.get_phraselist(labels, timing)
                self._json(
                    {
                        "timing_labels": str(timing),
                        "phraselist": phraselist,
                        "name": name,
                    }
                )
            elif self.path == "/acoustic":
                full = self._full_labels(req)
                if full is None:
                    return
                timing = (
                    hts.loads(req["timing_labels"])
                    if req.get("timing_labels")
                    else None
                )
                f0, mgc, bap = engine.predict_acoustic_neutrino(
                    full,
                    timing_labels=timing,
                    style_shift=int(req.get("style_shift", 0)),
                    phrase_num=int(req.get("phrase_num", -1)),
                )
                self._json(
                    {
                        "f0": _b64(f0),
                        "mgc": _b64(mgc),
                        "bap": _b64(bap),
                        "mgc_dim": mgc.shape[1],
                        "bap_dim": bap.shape[1],
                    }
                )
            elif self.path == "/stream":
                full = self._full_labels(req)
                if full is None:
                    return
                chunks = engine.svs_streaming(
                    full,
                    vocoder_type=req.get("vocoder_type", "world"),
                    post_filter_type=req.get("post_filter_type", "gv"),
                    style_shift=float(req.get("style_shift", 0)),
                    gain=float(req.get("gain", 1.0)),
                    dtype=np.int16,
                )
                # render the FIRST phrase before the headers go out so
                # model/label errors still surface as a JSON 500
                first = next(chunks, None)
                self.send_response(200)
                self.send_header("Content-Type", "audio/wav")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()

                def _write_chunk(data: bytes):
                    self.wfile.write(b"%x\r\n" % len(data))
                    self.wfile.write(data)
                    self.wfile.write(b"\r\n")

                try:
                    _write_chunk(_wav_stream_header(engine.sample_rate))
                    if first is not None:
                        _write_chunk(first.tobytes())
                        for chunk in chunks:
                            _write_chunk(chunk.tobytes())
                    self.wfile.write(b"0\r\n\r\n")
                except Exception:  # noqa: BLE001 - headers already sent:
                    # a JSON 500 would corrupt the WAV stream; drop the
                    # connection so the client sees a truncated stream
                    self.close_connection = True
            elif self.path == "/waveform":
                mgc_dim = int(req["mgc_dim"])
                bap_dim = int(req["bap_dim"])
                f0 = _unb64(req["f0"], np.float64, 1)
                mgc = _unb64(req["mgc"], np.float64, mgc_dim)
                bap = _unb64(req["bap"], np.float64, bap_dim)
                wav = engine.predict_waveform_neutrino(f0, mgc, bap)
                self._json({"wav": _b64(wav), "sr": engine.sample_rate})
            else:
                self._json({"error": "not found"}, 404)
        except Exception as e:  # noqa: BLE001 - surface errors to the client
            self._json({"error": f"{type(e).__name__}: {e}"}, 500)

    def log_message(self, fmt, *args):
        pass


def main(argv=None):
    global _MODEL_ROOT, _DEVICE
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model-root", default="models")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8001)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    _MODEL_ROOT = Path(args.model_root)
    _DEVICE = args.device
    server = ThreadingHTTPServer((args.host, args.port), Handler)
    print(f"NEUTRINO server at http://{args.host}:{args.port} "
          f"(models from {_MODEL_ROOT}, on {_DEVICE})")
    server.serve_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
