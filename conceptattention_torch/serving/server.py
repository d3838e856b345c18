"""HTTP serving daemon: concept-attention generation behind a micro-batcher.

Counterpart of the JAX package's `serving/server.py`: a stdlib
`ThreadingHTTPServer` front end where every connection thread submits its
request to one `MicroBatcher`, whose single worker thread is the only one
that runs the pipelines. It coalesces compatible requests (same
concepts, resolution, steps and normalization) into one
`generate_images(seeds=...)` call on a bucket-padded batch. Per-request
seeds make each response the image of an unbatched `generate_image` call
with the same arguments, up to the rounding of the batched products.

Endpoints
---------
- ``POST /v1/generate``       JSON body (see `GenerateRequest.from_json`);
  base64 PNGs of the image and the per-concept heatmaps.
- ``POST /v1/encode``         heatmaps of a real image (base64 PNG / JPEG);
  concurrent requests coalesce into one `encode_images` call.
- ``POST /v1/generate_video`` per-frame heatmaps from the video pipeline.
- ``POST /v1/loras``          replace the active LoRA adapter set
  ({"adapters": [{"path", "strength"}]}; [] clears it). Swaps run on the
  batcher worker between batches; they need `keep_base_for_swap=True`
  (the daemon's --lora_swap).
- ``GET /v1/loras``           the active adapter set.
- ``GET /healthz``            liveness, the torch device and the model name.
- ``GET /metrics``            batcher counters, queue depth, latency quantiles.

Overload: the batcher's queue is bounded (``max_queue_depth``, 64 by
default); when it is full, a POST fails at once with HTTP 503 and a
``Retry-After`` estimate instead of queueing toward the request timeout.

Run: ``python -m conceptattention_torch.serving --model flux-schnell --port 8000``
(`serving/__main__.py` has the flags: quantization, attention backend,
LoRA, batching knobs).
"""

from __future__ import annotations

import base64
import collections
import dataclasses
import io
import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from conceptattention_torch.serving.batcher import (
    MicroBatcher,
    QueueFullError,
    next_bucket,
)

logger = logging.getLogger("conceptattention_torch.serving")

_ALLOWED_NORMS = ("softmax", "sparsemax", "entmax15", "none")
_MAX_SIDE = 2048
_MAX_CONCEPTS = 16
_MAX_STEPS = 64
_MAX_PROMPT_CHARS = 4096


class RequestError(ValueError):
    """Client error -> HTTP 400."""


def _expect(cond: bool, msg: str) -> None:
    if not cond:
        raise RequestError(msg)


def _req_int(body: dict, name: str, default: int, lo: int, hi: int) -> int:
    v = body.get(name, default)
    _expect(isinstance(v, int) and not isinstance(v, bool) and lo <= v <= hi,
            f"{name} must be an int in [{lo}, {hi}]")
    return v


def _req_bool(body: dict, name: str, default: bool) -> bool:
    v = body.get(name, default)
    _expect(isinstance(v, bool), f"{name} must be a boolean")
    return v


def _req_concepts(body: dict) -> Tuple[str, ...]:
    concepts = body.get("concepts")
    _expect(
        isinstance(concepts, (list, tuple))
        and 1 <= len(concepts) <= _MAX_CONCEPTS
        and all(isinstance(c, str) and c.strip() for c in concepts),
        f"concepts must be 1..{_MAX_CONCEPTS} non-empty strings",
    )
    return tuple(concepts)


def _req_size(body: dict) -> Tuple[int, int]:
    width = _req_int(body, "width", 1024, 16, _MAX_SIDE)
    height = _req_int(body, "height", 1024, 16, _MAX_SIDE)
    _expect(width % 16 == 0 and height % 16 == 0,
            "width/height must be multiples of 16 (VAE 8x + 2x2 packing)")
    return width, height


def _req_norm(body: dict) -> str:
    norm = body.get("attention_norm", "sparsemax")
    _expect(norm in _ALLOWED_NORMS, f"attention_norm must be one of {_ALLOWED_NORMS}")
    return norm


def _req_layer_indices(body: dict) -> Optional[Tuple[int, ...]]:
    layer_indices = body.get("layer_indices")
    if layer_indices is None:
        return None
    _expect(
        isinstance(layer_indices, (list, tuple))
        and len(layer_indices) >= 1
        and all(isinstance(i, int) and not isinstance(i, bool) and i >= 0
                for i in layer_indices),
        "layer_indices must be a non-empty list of non-negative ints",
    )
    return tuple(layer_indices)


def _req_format(body: dict) -> Tuple[str, str]:
    fmt = body.get("heatmap_format", "png")
    _expect(fmt in ("png", "array"), "heatmap_format must be 'png' or 'array'")
    cmap = body.get("cmap", "plasma")
    _expect(isinstance(cmap, str), "cmap must be a string")
    if fmt == "png":  # an unknown cmap must be a 400 here, not a 500 later
        from conceptattention_torch.pipeline.heatmaps import cmap_available

        _expect(cmap_available(cmap), f"unknown cmap {cmap!r}")
    return fmt, cmap


@dataclasses.dataclass(frozen=True)
class GenerateRequest:
    """One /v1/generate request, already validated.

    `batch_key()` covers every field that changes the batched computation
    or its shared inputs; prompt/seed vary freely within a batch, and
    formatting fields (cmap, heatmap_format, return_cross_attention) are
    applied per-request after the batched dispatch.
    """

    prompt: str
    concepts: Tuple[str, ...]
    seed: int = 0
    width: int = 1024
    height: int = 1024
    num_inference_steps: int = 4
    guidance: float = 0.0
    softmax: bool = True
    attention_norm: str = "sparsemax"
    layer_indices: Optional[Tuple[int, ...]] = None
    watermark: bool = True
    cmap: str = "plasma"
    heatmap_format: str = "png"  # "png" (colormapped) | "array" (raw floats)
    return_cross_attention: bool = False

    def batch_key(self) -> tuple:
        return (
            "generate",
            self.concepts,
            self.width,
            self.height,
            self.num_inference_steps,
            self.guidance,
            self.softmax,
            self.attention_norm,
            self.layer_indices,
            self.watermark,
        )

    @classmethod
    def from_json(cls, body: dict) -> "GenerateRequest":
        _expect(isinstance(body, dict), "body must be a JSON object")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(body) - known
        _expect(not unknown, f"unknown fields: {sorted(unknown)}")

        prompt = body.get("prompt")
        _expect(isinstance(prompt, str) and prompt.strip(), "prompt (non-empty string) is required")
        _expect(len(prompt) <= _MAX_PROMPT_CHARS, f"prompt longer than {_MAX_PROMPT_CHARS} chars")
        width, height = _req_size(body)
        guidance = body.get("guidance", 0.0)
        _expect(isinstance(guidance, (int, float)) and not isinstance(guidance, bool),
                "guidance must be a number")
        fmt, cmap = _req_format(body)

        return cls(
            prompt=prompt,
            concepts=_req_concepts(body),
            seed=_req_int(body, "seed", 0, -(2**31), 2**31 - 1),
            width=width,
            height=height,
            num_inference_steps=_req_int(body, "num_inference_steps", 4, 1, _MAX_STEPS),
            guidance=float(guidance),
            softmax=_req_bool(body, "softmax", True),
            attention_norm=_req_norm(body),
            layer_indices=_req_layer_indices(body),
            watermark=_req_bool(body, "watermark", True),
            cmap=cmap,
            heatmap_format=fmt,
            return_cross_attention=_req_bool(body, "return_cross_attention", False),
        )


@dataclasses.dataclass(frozen=True)
class EncodeRequest:
    """One /v1/encode request: concept heatmaps for a REAL image (the
    pipeline's `encode_image`). The image rides in the JSON body as base64
    PNG / JPEG. Concurrent encodes sharing a batch key, which pins shapes
    and protocol but not per-request content (image, prompt, seed and the
    concept words may all differ; only the concept COUNT is keyed),
    coalesce into one batched `encode_images` call."""

    image_b64: str
    concepts: Tuple[str, ...]
    prompt: str = ""
    width: int = 1024
    height: int = 1024
    num_samples: int = 1
    num_steps: int = 4
    noise_timestep: int = 2
    seed: int = 0
    softmax: bool = True
    attention_norm: str = "sparsemax"
    layer_indices: Optional[Tuple[int, ...]] = None
    cmap: str = "plasma"
    heatmap_format: str = "png"
    return_cross_attention: bool = False

    def batch_key(self) -> tuple:
        # Per-request content stays OUT of the key (encode_images takes
        # per-image concepts/prompts/seeds); everything that sets the
        # batch's shapes or the shared reduction protocol stays in.
        return (
            "encode",
            len(self.concepts),
            self.width,
            self.height,
            self.num_samples,
            self.num_steps,
            self.noise_timestep,
            self.softmax,
            self.attention_norm,
            self.layer_indices,
        )

    def decode_image(self):
        """base64 -> PIL image; RequestError on anything undecodable."""
        import PIL.Image

        try:
            raw = base64.b64decode(self.image_b64, validate=True)
            img = PIL.Image.open(io.BytesIO(raw))
            img.load()
            return img.convert("RGB")
        except Exception as e:  # noqa: BLE001 — client data, surfaced as 400
            raise RequestError(f"image is not decodable base64 PNG/JPEG: "
                               f"{type(e).__name__}") from e

    @classmethod
    def from_json(cls, body: dict) -> "EncodeRequest":
        _expect(isinstance(body, dict), "body must be a JSON object")
        known = {f.name for f in dataclasses.fields(cls)} | {"image"}
        unknown = set(body) - known
        _expect(not unknown, f"unknown fields: {sorted(unknown)}")

        image_b64 = body.get("image")
        _expect(isinstance(image_b64, str) and image_b64,
                "image (base64 PNG/JPEG string) is required")
        prompt = body.get("prompt", "")
        _expect(isinstance(prompt, str) and len(prompt) <= _MAX_PROMPT_CHARS,
                f"prompt must be a string of <= {_MAX_PROMPT_CHARS} chars")
        width, height = _req_size(body)
        num_steps = _req_int(body, "num_steps", 4, 1, _MAX_STEPS)
        noise_timestep = _req_int(body, "noise_timestep", min(2, num_steps - 1),
                                  0, num_steps - 1)
        fmt, cmap = _req_format(body)

        req = cls(
            image_b64=image_b64,
            concepts=_req_concepts(body),
            prompt=prompt,
            width=width,
            height=height,
            num_samples=_req_int(body, "num_samples", 1, 1, 8),
            num_steps=num_steps,
            noise_timestep=noise_timestep,
            seed=_req_int(body, "seed", 0, -(2**31), 2**31 - 1),
            softmax=_req_bool(body, "softmax", True),
            attention_norm=_req_norm(body),
            layer_indices=_req_layer_indices(body),
            cmap=cmap,
            heatmap_format=fmt,
            return_cross_attention=_req_bool(body, "return_cross_attention", False),
        )
        req.decode_image()  # validate NOW (400), not inside the batch (500)
        return req


_SWAP_NONCE = iter(range(1 << 62))


@dataclasses.dataclass(frozen=True)
class LoraSwapRequest:
    """One POST /v1/loras request: replace the active LoRA adapter set
    (empty list clears it). Swaps ride the batcher like any other request —
    each gets a unique batch key, so the worker runs it alone, serialized
    against generation batches (no forward ever sees half-swapped params).
    Requires the server's pipeline to retain its pristine base
    (`keep_base_for_swap=True` / the daemon's --lora_swap flag)."""

    paths: Tuple[str, ...]
    strengths: Tuple[float, ...]
    nonce: int = dataclasses.field(default_factory=lambda: next(_SWAP_NONCE))

    def batch_key(self) -> tuple:
        return ("lora_swap", self.nonce)

    @classmethod
    def from_json(cls, body: dict) -> "LoraSwapRequest":
        import os

        _expect(isinstance(body, dict), "body must be a JSON object")
        unknown = set(body) - {"adapters"}
        _expect(not unknown, f"unknown fields: {sorted(unknown)}")
        adapters = body.get("adapters")
        _expect(isinstance(adapters, list) and len(adapters) <= 8,
                "adapters must be a list of <= 8 {path, strength} objects "
                "(empty list clears the active set)")
        paths, strengths = [], []
        for a in adapters:
            _expect(isinstance(a, dict) and isinstance(a.get("path"), str),
                    "each adapter needs a string 'path'")
            _expect(not (set(a) - {"path", "strength"}),
                    f"unknown adapter fields: {sorted(set(a) - {'path', 'strength'})}")
            s = a.get("strength", 1.0)
            _expect(isinstance(s, (int, float)) and not isinstance(s, bool)
                    and -16.0 <= s <= 16.0, "strength must be a number in [-16, 16]")
            _expect(os.path.isfile(a["path"]),
                    f"adapter path not found: {a['path']}")
            paths.append(a["path"])
            strengths.append(float(s))
        return cls(paths=tuple(paths), strengths=tuple(strengths))


_VIDEO_NONCE = iter(range(1 << 62))


@dataclasses.dataclass(frozen=True)
class VideoGenerateRequest:
    """One POST /v1/generate_video request: per-frame concept heatmaps from
    the CogVideoX video DiT (the video pipeline's `generate_video`). The
    video pipeline samples at batch 1, so each request gets a unique batch
    key: the shared batcher still serializes it against image generate /
    encode batches (one thread drives the device), but never coalesces
    video requests together."""

    prompt: str
    concepts: Tuple[str, ...]
    negative_prompt: str = ""
    num_frames: int = 4
    height: int = 32   # LATENT sizes (pre-patchify), like generate_video
    width: int = 32
    num_inference_steps: int = 10
    guidance_scale: float = 6.0
    scheduler: str = "ddim"
    seed: int = 0
    layer_indices: Optional[Tuple[int, ...]] = None
    cmap: str = "plasma"
    heatmap_format: str = "png"
    return_cross_attention: bool = False
    nonce: int = dataclasses.field(default_factory=lambda: next(_VIDEO_NONCE))

    def batch_key(self) -> tuple:
        return ("video", self.nonce)

    @classmethod
    def from_json(cls, body: dict) -> "VideoGenerateRequest":
        _expect(isinstance(body, dict), "body must be a JSON object")
        known = {f.name for f in dataclasses.fields(cls)} - {"nonce"}
        unknown = set(body) - known
        _expect(not unknown, f"unknown fields: {sorted(unknown)}")
        prompt = body.get("prompt")
        _expect(isinstance(prompt, str) and 0 < len(prompt) <= _MAX_PROMPT_CHARS,
                f"prompt must be a non-empty string of <= {_MAX_PROMPT_CHARS} chars")
        negative = body.get("negative_prompt", "")
        _expect(isinstance(negative, str) and len(negative) <= _MAX_PROMPT_CHARS,
                f"negative_prompt must be a string of <= {_MAX_PROMPT_CHARS} chars")
        scheduler = body.get("scheduler", "ddim")
        _expect(scheduler in ("ddim", "dpm"), "scheduler must be 'ddim' or 'dpm'")
        guidance = body.get("guidance_scale", 6.0)
        _expect(isinstance(guidance, (int, float)) and not isinstance(guidance, bool)
                and 0.0 <= guidance <= 32.0, "guidance_scale must be in [0, 32]")
        fmt, cmap = _req_format(body)
        return cls(
            prompt=prompt,
            concepts=_req_concepts(body),
            negative_prompt=negative,
            num_frames=_req_int(body, "num_frames", 4, 1, 64),
            # Latent-space sizes: 256 latent px = a 2048-px decoded frame.
            height=_req_int(body, "height", 32, 2, 256),
            width=_req_int(body, "width", 32, 2, 256),
            num_inference_steps=_req_int(body, "num_inference_steps", 10, 1,
                                         _MAX_STEPS),
            guidance_scale=float(guidance),
            scheduler=scheduler,
            seed=_req_int(body, "seed", 0, -(2**31), 2**31 - 1),
            layer_indices=_req_layer_indices(body),
            cmap=cmap,
            heatmap_format=fmt,
            return_cross_attention=_req_bool(body, "return_cross_attention",
                                             False),
        )


def _png_b64(pil_image) -> str:
    buf = io.BytesIO()
    pil_image.save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode("ascii")


def _format_heatmaps(maps: np.ndarray, concepts: Sequence[str], fmt: str, cmap: str):
    """[C, h, w] float maps -> {concept: png-b64} or {concept: [[...]]}."""
    if fmt == "png":
        from conceptattention_torch.pipeline.heatmaps import heatmaps_to_pil

        pils = heatmaps_to_pil(maps, cmap)
        return {c: _png_b64(p) for c, p in zip(concepts, pils)}
    return {c: np.asarray(m, np.float32).tolist() for c, m in zip(concepts, maps)}


class ServerMetrics:
    """Thread-safe request counters + a bounded latency reservoir."""

    def __init__(self, window: int = 512):
        self._lock = threading.Lock()
        self.requests_total = 0
        self.errors_total = 0
        self._latencies = collections.deque(maxlen=window)

    def record(self, latency_s: float, ok: bool) -> None:
        with self._lock:
            self.requests_total += 1
            if not ok:
                self.errors_total += 1
            else:
                self._latencies.append(latency_s)

    def snapshot(self) -> dict:
        with self._lock:
            lats = sorted(self._latencies)
            out = {
                "requests_total": self.requests_total,
                "errors_total": self.errors_total,
            }
        if lats:
            q = lambda p: round(1000.0 * lats[min(len(lats) - 1, int(p * len(lats)))], 1)
            out["latency_ms"] = {"p50": q(0.50), "p90": q(0.90), "p99": q(0.99),
                                 "max": round(1000.0 * lats[-1], 1)}
        return out


class ConceptAttentionServer:
    """Owns the pipeline, the micro-batcher, and the HTTP listener.

    `start()` serves on a daemon thread (port 0 picks a free port — read
    `.port` after construction); `stop()` shuts the listener down and drains
    the batcher. Also usable as a context manager.
    """

    def __init__(
        self,
        pipeline,
        host: str = "127.0.0.1",
        port: int = 8000,
        max_batch: int = 8,
        max_wait_ms: float = 25.0,
        bucket_sizes: Sequence[int] = (1, 2, 4, 8),
        request_timeout_s: float = 600.0,
        max_queue_depth: Optional[int] = 64,
        video_pipeline=None,
    ):
        self.pipeline = pipeline
        # Optional VideoConceptAttentionPipeline: enables /v1/generate_video
        # on the same batcher and worker thread (a 400 if absent).
        self.video_pipeline = video_pipeline
        self.metrics = ServerMetrics()
        self.request_timeout_s = request_timeout_s
        self.max_queue_depth = max_queue_depth
        self._buckets = tuple(sorted(set(int(b) for b in bucket_sizes)))
        if max_batch > self._buckets[-1]:
            # Otherwise bursts above the top bucket run at every observed
            # batch size, which bucketing exists to prevent.
            raise ValueError(
                f"max_batch={max_batch} exceeds the largest bucket "
                f"{self._buckets[-1]}; add it to bucket_sizes or lower max_batch"
            )
        self.batcher = MicroBatcher(
            self._run_batch,
            max_batch=max_batch,
            max_wait_ms=max_wait_ms,
            group_key=lambda r: r.batch_key(),
            name="serving-batcher",
            max_queue_depth=max_queue_depth,
        )
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            server_version = "conceptattention-torch"
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # route to logging, not stderr
                logger.debug("%s %s", self.address_string(), fmt % args)

            def _reply(self, code: int, payload: dict,
                       headers: Optional[dict] = None) -> None:
                data = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                for k, v in (headers or {}).items():
                    self.send_header(k, str(v))
                if self.close_connection:
                    # Advertise the close (set when the request body can't be
                    # consumed) so well-behaved clients don't race a reuse
                    # against the server-side teardown.
                    self.send_header("Connection", "close")
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path == "/healthz":
                    self._reply(200, outer._health())
                elif self.path == "/metrics":
                    self._reply(200, outer._metrics())
                elif self.path == "/v1/loras":
                    self._reply(200, {"active_loras": outer.pipeline.active_loras})
                else:
                    self._reply(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                routes = {"/v1/generate": GenerateRequest,
                          "/v1/encode": EncodeRequest,
                          "/v1/generate_video": VideoGenerateRequest,
                          "/v1/loras": LoraSwapRequest}
                request_cls = routes.get(self.path)
                if request_cls is None:
                    self._reply(404, {"error": f"no route {self.path}"})
                    return
                t0 = time.monotonic()
                try:
                    try:
                        length = int(self.headers.get("Content-Length", 0))
                    except (TypeError, ValueError) as e:
                        # Body length unknowable -> the connection can't be
                        # resynchronized for keep-alive; drop it after the 400.
                        self.close_connection = True
                        raise RequestError("invalid Content-Length header") from e
                    if not 0 < length <= 16 * 1024 * 1024:
                        # Refusing without consuming the body would leave its
                        # bytes to be parsed as the next request line on this
                        # keep-alive connection — close instead of draining.
                        self.close_connection = True
                        raise RequestError("missing/oversized body")
                    try:
                        body = json.loads(self.rfile.read(length))
                    except json.JSONDecodeError as e:
                        raise RequestError(f"invalid JSON: {e}") from e
                    request = request_cls.from_json(body)
                    outer._validate_against_model(request)
                except RequestError as e:
                    outer.metrics.record(time.monotonic() - t0, ok=False)
                    self._reply(400, {"error": str(e)})
                    return
                try:
                    try:
                        fut = outer.batcher.submit(request)
                    except QueueFullError as e:
                        # Admission control: fail fast under sustained
                        # overload instead of queueing toward the
                        # request_timeout_s deadline. 503 + Retry-After tells
                        # well-behaved clients when to come back.
                        outer.metrics.record(time.monotonic() - t0, ok=False)
                        self._reply(503, {"error": str(e)},
                                    headers={"Retry-After": outer._retry_after_s()})
                        return
                    output, batch_size = fut.result(
                        timeout=outer.request_timeout_s
                    )
                    # Formatting (PNG encode + base64) runs HERE, on the
                    # per-connection thread: the batcher worker drives the
                    # device, and encoding a batch's outputs there would
                    # stall the next batch on an idle device. A per-request
                    # formatting failure also only fails THIS request, not
                    # its batch siblings.
                    result = outer._format_result(request, output, batch_size)
                except Exception as e:  # noqa: BLE001 — surfaced as 500
                    outer.metrics.record(time.monotonic() - t0, ok=False)
                    logger.exception("generate failed")
                    self._reply(500, {"error": f"{type(e).__name__}: {e}"})
                    return
                latency = time.monotonic() - t0
                outer.metrics.record(latency, ok=True)
                result["latency_ms"] = round(1000.0 * latency, 1)
                self._reply(200, result)

        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._serve_thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> "ConceptAttentionServer":
        self._serve_thread = threading.Thread(
            target=self._httpd.serve_forever, name="serving-http", daemon=True
        )
        self._serve_thread.start()
        logger.info("serving %s on port %d", self.pipeline.model_name, self.port)
        return self

    def serve_forever(self) -> None:
        self._httpd.serve_forever()

    def stop(self, drain_timeout_s: Optional[float] = None) -> None:
        """Stop listening, then DRAIN: by default block until every accepted
        request (in-flight and queued batches) has finished; a generation
        batch can run for seconds to minutes, so a fixed short timeout would
        kill it mid-flight. Pass `drain_timeout_s` to bound the wait;
        requests still queued when it expires are failed."""
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._serve_thread is not None:
            self._serve_thread.join(timeout=10)
        self.batcher.close(timeout=drain_timeout_s)

    def __enter__(self) -> "ConceptAttentionServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------------
    def _health(self) -> dict:
        device = getattr(self.pipeline, "device", torch.device("cpu"))
        name = torch.cuda.get_device_name(device) if device.type == "cuda" else device.type
        return {
            "status": "ok",
            "model": self.pipeline.model_name,
            "platform": device.type,
            "device": name,
            "queue_depth": self.batcher.queue_depth(),
        }

    def _metrics(self) -> dict:
        out = self.metrics.snapshot()
        out["batcher"] = self.batcher.stats.snapshot()
        out["queue_depth"] = self.batcher.queue_depth()
        out["max_queue_depth"] = self.max_queue_depth
        return out

    def _retry_after_s(self) -> int:
        """Retry-After for a 503: estimated seconds until the queue drains —
        full-queue batches to run x observed p50 latency (which includes one
        batch's queue wait), floored at 1 s and capped at the request
        timeout. Batches-to-run divides by the OBSERVED mean batch size, not
        max_batch: the batcher only coalesces requests sharing batch_key(),
        so a heterogeneous queue drains in smaller batches and a max_batch
        estimate would undershoot by up to that factor. With no latency
        history yet, a conservative 30 s."""
        lat = self.metrics.snapshot().get("latency_ms")
        if not lat:
            return 30
        per_batch = (self.batcher.stats.snapshot().get("mean_batch_size")
                     or self.batcher.max_batch)
        batches = max(1, -(-(self.max_queue_depth or 1) // max(1, int(per_batch))))
        est = batches * lat["p50"] / 1000.0
        return int(min(max(1.0, est), self.request_timeout_s))

    # ------------------------------------------------------------------
    def warmup(self, prototype: GenerateRequest,
               buckets: Optional[Sequence[int]] = None) -> None:
        """Run one batch per bucket size before taking traffic, so each
        bucket's first request does not pay the first call's costs (the
        kernels' build and load, cuBLAS's and the allocator's first use).
        The prototype should match expected traffic's batch key (concept
        COUNT, resolution, steps); prompts and seeds don't matter.
        """
        for b in buckets or self._buckets:
            reqs = [dataclasses.replace(prototype, seed=prototype.seed + i)
                    for i in range(b)]
            t0 = time.monotonic()
            self._run_batch(reqs)
            logger.info("warmup bucket %d: %.1fs", b, time.monotonic() - t0)

    # ------------------------------------------------------------------
    def _validate_against_model(self, request) -> None:
        """Model-dependent validation from_json can't do (it has no pipeline):
        reject as 400 what would otherwise assert deep inside the batch."""
        if isinstance(request, LoraSwapRequest):
            if getattr(self.pipeline, "_swap_base", None) is None:
                raise RequestError(
                    "this server was started without LoRA swap support "
                    "(restart with --lora_swap / keep_base_for_swap=True)"
                )
            return
        if isinstance(request, VideoGenerateRequest):
            if self.video_pipeline is None:
                raise RequestError(
                    "this server was started without a video pipeline "
                    "(pass video_pipeline= / the daemon's --video flag)"
                )
            vcfg = self.video_pipeline.cfg
            if request.height % vcfg.patch_size or request.width % vcfg.patch_size:
                raise RequestError(
                    f"latent height/width must be divisible by "
                    f"patch_size={vcfg.patch_size}"
                )
            if request.layer_indices is not None and any(
                i >= vcfg.num_layers for i in request.layer_indices
            ):
                raise RequestError(
                    f"layer_indices out of range for this video model "
                    f"(num_layers {vcfg.num_layers})"
                )
            return
        depth = self.pipeline.cfg.depth
        if request.layer_indices is not None and any(
            i >= depth for i in request.layer_indices
        ):
            raise RequestError(
                f"layer_indices out of range for this model (depth {depth})"
            )

    def _run_batch(self, requests):
        """One worker cycle for a compatible request group; returns the RAW
        pipeline output per request (formatting happens on the per-connection
        threads — see do_POST).

        Generation groups become ONE batched `generate_images` call,
        padded up to the next bucket size by repeating the head request
        (padding outputs are decoded and dropped), so the set of batch
        shapes stays that of the buckets. Encode groups become one
        `encode_images` call, padded the same way.
        """
        head = requests[0]
        if isinstance(head, LoraSwapRequest):
            # Unique batch key -> the group is exactly this one request; the
            # swap happens on the one worker thread that drives the device,
            # so no generation batch can interleave with half-swapped params.
            active = self.pipeline.swap_loras(
                list(head.paths) or None, list(head.strengths) or 1.0
            )
            logger.info("lora swap: %s", active)
            return [(active, 1)]
        if isinstance(head, EncodeRequest):
            return self._run_encode_group(requests)
        if isinstance(head, VideoGenerateRequest):
            # Unique batch key -> exactly one request per group (b1 sampler).
            return [(self._run_video(r), 1) for r in requests]
        n = len(requests)
        m = next_bucket(n, self._buckets)
        prompts = [r.prompt for r in requests] + [head.prompt] * (m - n)
        seeds = [r.seed for r in requests] + [head.seed] * (m - n)
        outputs = self.pipeline.generate_images(
            prompts,
            list(head.concepts),
            width=head.width,
            height=head.height,
            layer_indices=(None if head.layer_indices is None
                           else list(head.layer_indices)),
            seeds=seeds,
            num_inference_steps=head.num_inference_steps,
            guidance=head.guidance,
            softmax=head.softmax,
            attention_norm=head.attention_norm,
            watermark=head.watermark,
            return_pil_heatmaps=False,  # formatting is per-request, later
        )[:n]
        return [(out, n) for out in outputs]

    def _run_encode_group(self, requests):
        """Coalesced /v1/encode group -> ONE `encode_images` call, padded
        to the next bucket size by repeating the last request (padding
        outputs dropped). The batch key guarantees shared shapes and
        protocol; image, prompt, seed and concept words are per-request."""
        head = requests[0]
        n = len(requests)
        m = next_bucket(n, self._buckets)
        grp = list(requests) + [requests[-1]] * (m - n)
        outputs = self.pipeline.encode_images(
            [r.decode_image() for r in grp],
            [list(r.concepts) for r in grp],
            prompts=[r.prompt for r in grp],
            seeds=[r.seed for r in grp],
            width=head.width,
            height=head.height,
            layer_indices=(None if head.layer_indices is None
                           else list(head.layer_indices)),
            num_samples=head.num_samples,
            num_steps=head.num_steps,
            noise_timestep=head.noise_timestep,
            softmax=head.softmax,
            attention_norm=head.attention_norm,
            return_pil_heatmaps=False,  # formatting is per-request, later
        )[:n]
        return [(out, n) for out in outputs]

    def _run_video(self, request: VideoGenerateRequest):
        return self.video_pipeline.generate_video(
            request.prompt,
            list(request.concepts),
            negative_prompt=request.negative_prompt,
            num_frames=request.num_frames,
            height=request.height,
            width=request.width,
            num_inference_steps=request.num_inference_steps,
            guidance_scale=request.guidance_scale,
            scheduler=request.scheduler,
            seed=request.seed,
            layer_indices=(None if request.layer_indices is None
                           else list(request.layer_indices)),
            return_cross_attention=request.return_cross_attention,
        )

    def _format_result(self, request, output, batch_size: int) -> dict:
        if isinstance(request, LoraSwapRequest):
            return {"active_loras": output}
        if isinstance(request, VideoGenerateRequest):
            # concept_heatmaps: [C, F, h, w] -> {concept: [per-frame ...]}.
            maps = np.asarray(output.concept_heatmaps, np.float32)
            frames = [
                _format_heatmaps(maps[:, f], request.concepts,
                                 request.heatmap_format, request.cmap)
                for f in range(maps.shape[1])
            ]
            payload = {
                "concept_heatmaps": {
                    c: [fr[c] for fr in frames] for c in request.concepts
                },
                "num_frames": int(maps.shape[1]),
                "batch_size": batch_size,
            }
            if request.return_cross_attention:
                xmaps = np.asarray(output.cross_attention_maps, np.float32)
                xframes = [
                    _format_heatmaps(xmaps[:, f], request.concepts,
                                     request.heatmap_format, request.cmap)
                    for f in range(xmaps.shape[1])
                ]
                payload["cross_attention_maps"] = {
                    c: [fr[c] for fr in xframes] for c in request.concepts
                }
            return payload
        payload = {
            "concept_heatmaps": _format_heatmaps(
                output.concept_heatmaps, request.concepts,
                request.heatmap_format, request.cmap,
            ),
            "batch_size": batch_size,
        }
        if isinstance(request, GenerateRequest):
            payload["image"] = _png_b64(output.image)
        if request.return_cross_attention:
            payload["cross_attention_maps"] = _format_heatmaps(
                output.cross_attention_maps, request.concepts,
                request.heatmap_format, request.cmap,
            )
        return payload
