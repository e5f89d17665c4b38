"""Dynamic-batching serving front end of the port, mirroring
`unast_tpu/infer/server.py`: DynamicBatcher coalesces concurrent tts /
tts_mel / asr requests into Synthesizer batches (start at the first
pending request, wait up to max_wait_ms or until max_batch requests), so
the card runs full batches; serve_http puts a stdlib HTTP endpoint over it
(POST /tts text -> WAV bytes, POST /tts_mel, POST /asr WAV bytes -> text,
GET /healthz).

    python -m unast_tpu_torch.infer.server --load_path ckpt/model_best.ckpt \
        --config configs/transformer_trans.json --port 8571 [--device cpu]

--vocoder_ckpt (the CBHG vocoder) comes with the RNN/CBHG vocoder slice of
the port and raises NotImplementedError.
"""

import io
import json
import queue
import threading
import time
import wave
from typing import List, Optional

import numpy as np

from .serve import Synthesizer


def wav_bytes(wav_data: np.ndarray, sr: int = 22050) -> bytes:
    """unast_tpu/infer/server.py::wav_bytes: float32 [-1, 1] -> PCM16 WAV
    container bytes."""
    pcm = (np.clip(wav_data, -1.0, 1.0) * 32767.0).astype(np.int16)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


def parse_wav(data: bytes) -> np.ndarray:
    """unast_tpu/infer/server.py::parse_wav: PCM16 WAV bytes -> float32
    mono [-1, 1]."""
    with wave.open(io.BytesIO(data), "rb") as w:
        n = w.getnframes()
        raw = np.frombuffer(w.readframes(n), dtype=np.int16)
        if w.getnchannels() > 1:
            raw = raw.reshape(-1, w.getnchannels()).mean(axis=1)
    return raw.astype(np.float32) / 32768.0


class _Request:
    __slots__ = ("kind", "payload", "done", "result", "error")

    def __init__(self, kind: str, payload):
        self.kind = kind
        self.payload = payload
        self.done = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None

    def wait(self, timeout: Optional[float] = None):
        if not self.done.wait(timeout):
            raise TimeoutError(f"{self.kind} request timed out")
        if self.error is not None:
            raise self.error
        return self.result


class DynamicBatcher:
    """unast_tpu/infer/server.py::DynamicBatcher: coalesce concurrent
    tts/tts_mel/asr requests into Synthesizer batches. One background
    worker owns the device; callers block on per-request events, so
    arbitrary thread counts are safe."""

    def __init__(self, syn: Synthesizer, max_batch: Optional[int] = None,
                 max_wait_ms: float = 10.0):
        self.syn = syn
        self.max_batch = max_batch or syn.max_batch
        self.max_wait_s = max_wait_ms / 1000.0
        self._q: "queue.Queue[_Request]" = queue.Queue()
        self._closed = False
        self.batch_sizes: List[int] = []  # observability + tests
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # -- client API ---------------------------------------------------------

    def submit(self, kind: str, payload) -> _Request:
        if self._closed:
            raise RuntimeError("batcher is closed")
        req = _Request(kind, payload)
        self._q.put(req)
        return req

    def tts(self, text: str, timeout: Optional[float] = None) -> np.ndarray:
        return self.submit("tts", text).wait(timeout)

    def tts_mel(self, text: str, timeout: Optional[float] = None) -> np.ndarray:
        return self.submit("tts_mel", text).wait(timeout)

    def asr(self, wav_data: np.ndarray, timeout: Optional[float] = None) -> str:
        return self.submit("asr", wav_data).wait(timeout)

    def close(self):
        self._closed = True
        self._q.put(None)  # wake the worker
        self._worker.join(timeout=30)

    # -- worker -------------------------------------------------------------

    def _collect(self):
        """Block for the first request, then coalesce same-kind requests for
        up to max_wait_s / max_batch. Mixed kinds are left queued for the
        next round (each kind runs as its own device batch anyway)."""
        first = self._q.get()
        if first is None:
            return []
        batch = [first]
        deadline = time.monotonic() + self.max_wait_s
        pushback = []
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                req = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if req is None:
                self._q.put(None)  # keep the shutdown signal
                break
            if req.kind == first.kind:
                batch.append(req)
            else:
                pushback.append(req)
        for req in pushback:
            self._q.put(req)
        return batch

    def _run(self):
        while not self._closed:
            batch = self._collect()
            if not batch:
                continue
            self.batch_sizes.append(len(batch))
            kind = batch[0].kind
            payloads = [r.payload for r in batch]
            try:
                if kind == "tts":
                    results = self.syn.tts(payloads)
                elif kind == "tts_mel":
                    results = self.syn.tts_mels(payloads)
                elif kind == "asr":
                    results = self.syn.asr(payloads)
                else:
                    raise ValueError(f"unknown request kind {kind!r}")
                for req, res in zip(batch, results):
                    req.result = res
                    req.done.set()
            except BaseException as e:  # propagate to every caller
                for req in batch:
                    req.error = e
                    req.done.set()


def serve_http(batcher: DynamicBatcher, host: str = "127.0.0.1",
               port: int = 8571, sr: int = 22050):
    """unast_tpu/infer/server.py::serve_http: an unstarted
    ThreadingHTTPServer bound to (host, port). Call .serve_forever()
    (blocking) or drive it from a thread."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, b"ok", "text/plain")
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(n)
            try:
                if self.path == "/tts":
                    text = json.loads(body)["text"]
                    wav_arr = batcher.tts(text)
                    self._send(200, wav_bytes(wav_arr, sr), "audio/wav")
                elif self.path == "/tts_mel":
                    text = json.loads(body)["text"]
                    mel = batcher.tts_mel(text)
                    payload = json.dumps(
                        {"shape": list(mel.shape),
                         "mel": np.asarray(mel, np.float32).tolist()})
                    self._send(200, payload.encode(), "application/json")
                elif self.path == "/asr":
                    text = batcher.asr(parse_wav(body))
                    self._send(200, json.dumps({"text": text}).encode(),
                               "application/json")
                else:
                    self._send(404, b"not found", "text/plain")
            except Exception as e:
                self._send(500, json.dumps({"error": repr(e)}).encode(),
                           "application/json")

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None):
    """unast_tpu/infer/server.py::main: serve a checkpoint over HTTP. The
    trainer's flags (train/config.py) pick the model and --load_path the
    checkpoint; the server runs on --device (default cuda)."""
    import argparse

    from ..train.config import parse_with_config

    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8571)
    ap.add_argument("--max_wait_ms", type=float, default=10.0)
    ap.add_argument("--vocoder_ckpt", default=None)
    known, rest = ap.parse_known_args(argv)
    args = parse_with_config(rest)
    if known.vocoder_ckpt:
        raise NotImplementedError(
            "--vocoder_ckpt (the CBHG vocoder) comes with the RNN/CBHG "
            "vocoder slice of the port (ROADMAP.md queue 1 item 4)")
    syn = Synthesizer.from_checkpoint(args.load_path, args)
    syn.warmup()
    batcher = DynamicBatcher(syn, max_wait_ms=known.max_wait_ms)
    server = serve_http(batcher, known.host, known.port)
    print(f"serving on http://{known.host}:{known.port} "
          f"(POST /tts, /tts_mel, /asr; GET /healthz)", flush=True)
    try:
        server.serve_forever()
    finally:
        batcher.close()


if __name__ == "__main__":
    main()
