"""The port's serving daemon (`serving/`) on the CPU, mirroring
`tests/test_serving.py`, and against the JAX package's daemon.

The port's pipeline holds flux-tiny weights carried across from the JAX
init, in f32 on the CPU. The load-bearing property is the JAX test's: a
request's output does not depend on the batch it rode in
(`generate_images(seeds=...)` draws each prompt's noise from its own seed),
so coalescing and bucket padding are invisible to clients. Tolerances are
the JAX test's: one grey level of batched-matmul slack for images, 1e-4 for
heatmaps, 2e-3 for a swapped adapter against the same adapter merged at
construction, 1e-5 for served video against the direct call.

`test_same_bodies_to_jax_and_port_servers` sends the same bodies to a JAX
daemon and a port daemon over the same weights, with seed-keyed numpy noise
injected into both packages (threefry cannot be reproduced in torch) and the
VAE encoding to its posterior mean; they agree to `TOL` of
`tests/test_torch_pipeline.py` (1e-4; one grey level for the PNG image).
"""

import base64
import http.client
import io
import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conceptattention_torch import ConceptAttentionFluxPipeline as TorchPipeline
from conceptattention_torch import VideoConceptAttentionPipeline as TorchVideoPipeline
from conceptattention_torch.models.video.dit import CogVideoXConfig as TVideoCfg
from conceptattention_torch.pipeline import concept_pipeline as t_pipe
from conceptattention_torch.serving import (
    ConceptAttentionServer,
    EncodeRequest,
    GenerateRequest,
    LoraSwapRequest,
    MicroBatcher,
    QueueFullError,
    RequestError,
    VideoGenerateRequest,
    next_bucket,
)
from conceptattention_torch.weights.from_jax import params_from_numpy
from conceptattention_tpu import ConceptAttentionFluxPipeline as JaxPipeline
from conceptattention_tpu.pipeline import concept_pipeline as j_pipe

torch.set_num_threads(2)  # six test workers share the host's cores

SIZE = 64  # flux-tiny: VAE factor 2 -> 32x32 latents -> 16x16 tokens
CONCEPTS = ["cat", "sky"]


# ---------------------------------------------------------------------------
class TestMicroBatcher:
    def test_coalesces_concurrent_requests(self):
        release = threading.Event()
        calls = []

        def batch_fn(reqs):
            calls.append(list(reqs))
            if len(calls) == 1:
                release.wait(5)  # hold the worker so the queue fills
            return [r * 10 for r in reqs]

        b = MicroBatcher(batch_fn, max_batch=8, max_wait_ms=50)
        futs = [b.submit(1)]
        while not calls:  # the first request is on the worker
            time.sleep(0.005)
        futs += [b.submit(i) for i in (2, 3, 4)]
        release.set()
        assert [f.result(5) for f in futs] == [10, 20, 30, 40]
        b.close()
        assert len(calls) == 2 and calls[1] == [2, 3, 4]
        assert b.stats.requests_total == 4 and b.stats.batches_total == 2
        snap = b.stats.snapshot()
        assert snap["mean_batch_size"] == 2.0 and snap["batch_size_hist"] == {1: 1, 3: 1}

    def test_respects_max_batch(self):
        release = threading.Event()
        calls = []

        def batch_fn(reqs):
            calls.append(list(reqs))
            if len(calls) == 1:
                release.wait(5)
            return list(reqs)

        b = MicroBatcher(batch_fn, max_batch=2, max_wait_ms=200)
        futs = [b.submit(0)]
        while not calls:
            time.sleep(0.005)
        futs += [b.submit(i) for i in (1, 2, 3, 4)]
        release.set()
        assert [f.result(5) for f in futs] == [0, 1, 2, 3, 4]
        b.close()
        assert max(len(c) for c in calls) <= 2

    def test_groups_by_key(self):
        release = threading.Event()
        calls = []

        def batch_fn(reqs):
            calls.append(list(reqs))
            if len(calls) == 1:
                release.wait(5)
            return list(reqs)

        b = MicroBatcher(batch_fn, max_batch=8, max_wait_ms=30, group_key=lambda r: r % 2)
        futs = [b.submit(0)]
        while not calls:
            time.sleep(0.005)
        futs += [b.submit(i) for i in (2, 3, 4, 5)]  # evens batch, odds batch
        release.set()
        assert [f.result(5) for f in futs] == [0, 2, 3, 4, 5]
        b.close()
        batches = [sorted(c) for c in calls[1:]]
        assert [2, 4] in batches and [3, 5] in batches

    def test_error_propagates_to_every_future(self):
        def batch_fn(reqs):
            raise RuntimeError("device on fire")

        b = MicroBatcher(batch_fn, max_batch=4, max_wait_ms=5)
        futs = [b.submit(i) for i in range(3)]
        for f in futs:
            with pytest.raises(RuntimeError, match="device on fire"):
                f.result(5)
        assert b.stats.errors_total == 3
        b.close()

    def test_close_rejects_new_and_drains(self):
        b = MicroBatcher(lambda reqs: list(reqs), max_batch=4, max_wait_ms=1)
        assert b.submit(7).result(5) == 7
        b.close()
        with pytest.raises(RuntimeError):
            b.submit(8)

    def test_result_count_mismatch_is_an_error(self):
        b = MicroBatcher(lambda reqs: [1, 2, 3], max_batch=1, max_wait_ms=1)
        with pytest.raises(RuntimeError, match="results"):
            b.submit("x").result(5)
        b.close()

    @pytest.mark.parametrize("bad", [dict(max_batch=0), dict(max_queue_depth=0)])
    def test_rejects_bad_limits(self, bad):
        with pytest.raises(ValueError):
            MicroBatcher(lambda reqs: list(reqs), **bad)

    def test_next_bucket(self):
        assert next_bucket(1, (1, 2, 4, 8)) == 1
        assert next_bucket(3, (1, 2, 4, 8)) == 4
        assert next_bucket(8, (1, 2, 4, 8)) == 8
        assert next_bucket(9, (1, 2, 4, 8)) == 9  # beyond the largest bucket


# ---------------------------------------------------------------------------
class TestRequestValidation:
    def test_minimal_ok(self):
        r = GenerateRequest.from_json({"prompt": "a cat", "concepts": ["cat"]})
        assert r.width == 1024 and r.attention_norm == "sparsemax"

    @pytest.mark.parametrize("body,msg", [
        ({}, "prompt"),
        ({"prompt": "x"}, "concepts"),
        ({"prompt": "x", "concepts": []}, "concepts"),
        ({"prompt": "x", "concepts": ["c"], "width": 100}, "multiples of 16"),
        ({"prompt": "x", "concepts": ["c"], "num_inference_steps": 0}, "num_inference_steps"),
        ({"prompt": "x", "concepts": ["c"], "attention_norm": "magic"}, "attention_norm"),
        ({"prompt": "x", "concepts": ["c"], "heatmap_format": "bmp"}, "heatmap_format"),
        ({"prompt": "x", "concepts": ["c"], "softmax": 1}, "boolean"),
        ({"prompt": "x", "concepts": ["c"], "bogus": 1}, "unknown"),
        ({"prompt": "x", "concepts": ["c"], "layer_indices": [-1]}, "layer_indices"),
        ({"prompt": "x", "concepts": ["c"], "cmap": "notacmap"}, "cmap"),
    ])
    def test_rejects(self, body, msg):
        with pytest.raises(RequestError, match=msg):
            GenerateRequest.from_json(body)

    def test_batch_key_ignores_prompt_seed_and_formatting(self):
        a = GenerateRequest.from_json({"prompt": "a", "concepts": ["c"], "seed": 1,
                                       "cmap": "viridis"})
        b = GenerateRequest.from_json({"prompt": "b", "concepts": ["c"], "seed": 2,
                                       "heatmap_format": "array"})
        c = GenerateRequest.from_json({"prompt": "a", "concepts": ["c", "d"], "seed": 1})
        assert a.batch_key() == b.batch_key() != c.batch_key()

    @pytest.mark.parametrize("body,msg", [
        ({"prompt": "x", "concepts": ["c"], "scheduler": "euler"}, "scheduler"),
        ({"prompt": "x", "concepts": ["c"], "guidance_scale": 99}, "guidance_scale"),
        ({"prompt": "", "concepts": ["c"]}, "prompt"),
        ({"prompt": "x", "concepts": ["c"], "nonce": 1}, "unknown"),
    ])
    def test_video_rejects(self, body, msg):
        with pytest.raises(RequestError, match=msg):
            VideoGenerateRequest.from_json(body)

    def test_video_and_swap_requests_never_share_a_batch(self, tmp_path):
        body = {"prompt": "x", "concepts": ["c"]}
        assert VideoGenerateRequest.from_json(body).batch_key() != \
            VideoGenerateRequest.from_json(body).batch_key()
        path = tmp_path / "a.safetensors"
        path.write_bytes(b"")
        swap = {"adapters": [{"path": str(path), "strength": 0.5}]}
        a, b = LoraSwapRequest.from_json(swap), LoraSwapRequest.from_json(swap)
        assert a.batch_key() != b.batch_key()
        assert a.paths == (str(path),) and a.strengths == (0.5,)
        with pytest.raises(RequestError, match="not found"):
            LoraSwapRequest.from_json({"adapters": [{"path": str(tmp_path / "none")}]})


# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def pipes():
    """The port's and the JAX package's flux-tiny pipelines, f32, one set of
    weights (the JAX init, carried across)."""
    j = JaxPipeline("flux-tiny", dtype=jnp.float32)
    t = TorchPipeline("flux-tiny", dtype=torch.float32, device="cpu",
                      params=params_from_numpy(jax.tree.map(np.asarray, j.params)),
                      ae_params=params_from_numpy(jax.tree.map(np.asarray, j.ae_params)))
    return t, j


@pytest.fixture(scope="module")
def pipe(pipes):
    return pipes[0]


class TestPerRequestSeeds:
    def test_batched_seeds_match_single_generation(self, pipe):
        """generate_images(seeds=[s1, s2]) row i == generate_image(seed=si)."""
        prompts, seeds = ["a cat", "a dog"], [11, 12]
        kwargs = dict(width=SIZE, height=SIZE, num_inference_steps=1, return_image_array=True,
                      return_pil_heatmaps=False, watermark=False)
        batched = pipe.generate_images(prompts, CONCEPTS, seeds=seeds, **kwargs)
        for prompt, seed, out in zip(prompts, seeds, batched):
            solo = pipe.generate_image(prompt, CONCEPTS, seed=seed, **kwargs)
            np.testing.assert_allclose(np.asarray(out.image, np.float32),
                                       np.asarray(solo.image, np.float32), atol=1.0)
            np.testing.assert_allclose(out.concept_heatmaps, solo.concept_heatmaps, atol=1e-4)

    def test_seeds_length_mismatch(self, pipe):
        with pytest.raises(ValueError, match="seeds"):
            pipe.generate_images(["a"], CONCEPTS, seeds=[1, 2], width=SIZE, height=SIZE,
                                 num_inference_steps=1)


# ---------------------------------------------------------------------------
def _post(port, body, path="/v1/generate", timeout=300):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request("POST", path, json.dumps(body), {"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = json.loads(resp.read())
    conn.close()
    return resp.status, data


def _get(port, path, timeout=30):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request("GET", path)
    resp = conn.getresponse()
    data = json.loads(resp.read())
    conn.close()
    return resp.status, data


def _png_to_array(b64: str) -> np.ndarray:
    import PIL.Image

    return np.asarray(PIL.Image.open(io.BytesIO(base64.b64decode(b64))))


def _png_b64(arr) -> str:
    import PIL.Image

    buf = io.BytesIO()
    PIL.Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


@pytest.fixture(scope="module")
def server(pipe):
    srv = ConceptAttentionServer(pipe, port=0, max_batch=2, max_wait_ms=150, bucket_sizes=(2,),
                                 request_timeout_s=300)
    with srv:
        yield srv


BASE_BODY = {"prompt": "a cat in the sky", "concepts": CONCEPTS, "width": SIZE, "height": SIZE,
             "num_inference_steps": 1, "seed": 3}


class TestServerEndToEnd:
    def test_single_request_roundtrip(self, server, pipe):
        status, data = _post(server.port, BASE_BODY)
        assert status == 200, data
        img = _png_to_array(data["image"])
        assert img.shape == (SIZE, SIZE, 3)
        assert set(data["concept_heatmaps"]) == set(CONCEPTS)
        assert _png_to_array(data["concept_heatmaps"]["cat"]).shape[:2] == (SIZE // 4, SIZE // 4)
        assert data["latency_ms"] > 0 and data["batch_size"] == 1
        # the padded batch of 2 matches a direct unbatched generate_image
        solo = pipe.generate_image(BASE_BODY["prompt"], CONCEPTS, width=SIZE, height=SIZE,
                                   num_inference_steps=1, seed=3, return_image_array=True)
        diff = np.abs(img.astype(np.float32) - np.asarray(solo.image, np.float32))
        assert diff.max() <= 2.0 and diff.mean() < 0.5

    def test_concurrent_requests_coalesce(self, server):
        results = {}

        def call(i):
            results[i] = _post(server.port, dict(BASE_BODY, prompt=f"a photo number {i}",
                                                 seed=100 + i))

        before = server.batcher.stats.batches_total
        threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert all(status == 200 for status, _ in results.values())
        assert server.batcher.stats.batches_total - before < 4  # coalesced (max_batch=2)
        imgs = [_png_to_array(d["image"]) for _, d in results.values()]
        assert any(not np.array_equal(imgs[0], im) for im in imgs[1:])

    def test_heatmap_array_format(self, server, pipe):
        status, data = _post(server.port, dict(BASE_BODY, heatmap_format="array",
                                               return_cross_attention=True))
        assert status == 200, data
        arr = np.asarray(data["concept_heatmaps"]["sky"], np.float32)
        assert arr.shape == (SIZE // 4, SIZE // 4)
        assert set(data["cross_attention_maps"]) == set(CONCEPTS)
        solo = pipe.generate_image(BASE_BODY["prompt"], CONCEPTS, width=SIZE, height=SIZE,
                                   num_inference_steps=1, seed=3, return_pil_heatmaps=False)
        np.testing.assert_allclose(arr, solo.concept_heatmaps[1], atol=1e-4)

    def test_bad_request_is_400(self, server):
        status, data = _post(server.port, {"prompt": "x"})
        assert status == 400 and "concepts" in data["error"]
        status, _ = _post(server.port, BASE_BODY, path="/v1/nope")
        assert status == 404
        status, _ = _get(server.port, "/nope")
        assert status == 404

    def test_unknown_cmap_is_400_not_batch_poison(self, server):
        status, data = _post(server.port, dict(BASE_BODY, cmap="notacmap"))
        assert status == 400 and "cmap" in data["error"]
        # the array format uses no colormap: any string is accepted
        status, _ = _post(server.port, dict(BASE_BODY, cmap="notacmap", heatmap_format="array"))
        assert status == 200

    def test_layer_indices_beyond_model_depth_is_400(self, server):
        status, data = _post(server.port, dict(BASE_BODY, layer_indices=[999]))
        assert status == 400 and "depth" in data["error"]

    def test_invalid_content_length_is_400(self, server):
        conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=30)
        conn.putrequest("POST", "/v1/generate")
        conn.putheader("Content-Length", "abc")
        conn.endheaders()
        resp = conn.getresponse()
        assert resp.status == 400 and resp.will_close
        conn.close()

    def test_max_batch_must_fit_buckets(self, pipe):
        with pytest.raises(ValueError, match="bucket"):
            ConceptAttentionServer(pipe, port=0, max_batch=16, bucket_sizes=(1, 2, 4, 8))

    def test_warmup_runs_every_bucket(self, server):
        proto = GenerateRequest.from_json(dict(BASE_BODY))
        before = server.metrics.requests_total
        server.warmup(proto)  # one _run_batch per bucket, outside HTTP
        assert server.metrics.requests_total == before
        status, _ = _post(server.port, BASE_BODY)
        assert status == 200

    def test_encode_roundtrip_matches_direct_call(self, server, pipe):
        import PIL.Image

        arr = (np.random.RandomState(0).rand(SIZE, SIZE, 3) * 255).astype(np.uint8)
        body = {"image": _png_b64(arr), "concepts": CONCEPTS, "width": SIZE, "height": SIZE,
                "num_steps": 2, "noise_timestep": 1, "seed": 4, "heatmap_format": "array"}
        status, data = _post(server.port, body, path="/v1/encode")
        assert status == 200, data
        served = np.asarray(data["concept_heatmaps"]["cat"], np.float32)
        assert served.shape == (SIZE // 4, SIZE // 4) and "image" not in data
        direct = pipe.encode_image(PIL.Image.fromarray(arr), list(CONCEPTS), width=SIZE,
                                   height=SIZE, num_steps=2, noise_timestep=1, seed=4,
                                   return_pil_heatmaps=False)
        np.testing.assert_allclose(served, direct.concept_heatmaps[0], atol=1e-4)

    def test_encode_requests_coalesce_across_concepts(self, server, pipe):
        """Concurrent /v1/encode requests with different concept words (one
        count), seeds and images share a batch key and coalesce into one
        encode_images call; each still matches its own encode_image."""
        import PIL.Image

        rng = np.random.RandomState(7)
        words = [["cat", "sky"], ["dog", "sea"], ["tree", "rock"], ["sun", "grass"]]
        arrays = [(rng.rand(SIZE, SIZE, 3) * 255).astype(np.uint8) for _ in range(4)]
        bodies = [{"image": _png_b64(arrays[i]), "concepts": words[i], "width": SIZE,
                   "height": SIZE, "num_steps": 2, "noise_timestep": 1, "seed": 50 + i,
                   "heatmap_format": "array"} for i in range(4)]
        assert len({EncodeRequest.from_json(b).batch_key() for b in bodies}) == 1
        results = {}

        def call(i):
            results[i] = _post(server.port, bodies[i], path="/v1/encode")

        before = server.batcher.stats.batches_total
        threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert all(status == 200 for status, _ in results.values())
        assert server.batcher.stats.batches_total - before < 4
        for i in range(4):
            direct = pipe.encode_image(PIL.Image.fromarray(arrays[i]), words[i], width=SIZE,
                                       height=SIZE, num_steps=2, noise_timestep=1, seed=50 + i,
                                       return_pil_heatmaps=False)
            served = np.asarray(results[i][1]["concept_heatmaps"][words[i][0]], np.float32)
            np.testing.assert_allclose(served, direct.concept_heatmaps[0], atol=1e-4,
                                       err_msg=f"request {i}")

    def test_encode_bad_inputs_are_400(self, server):
        status, data = _post(server.port, {"image": "!!notb64!!", "concepts": CONCEPTS},
                             path="/v1/encode")
        assert status == 400 and "decodable" in data["error"]
        ok_img = base64.b64encode(b"x").decode()  # valid base64, not an image
        status, data = _post(server.port, {"image": ok_img, "concepts": CONCEPTS},
                             path="/v1/encode")
        assert status == 400 and "decodable" in data["error"]
        status, data = _post(server.port, dict(image=ok_img, concepts=CONCEPTS, num_steps=2,
                                               noise_timestep=5), path="/v1/encode")
        assert status == 400 and "noise_timestep" in data["error"]

    def test_health_and_metrics(self, server):
        status, health = _get(server.port, "/healthz")
        assert status == 200 and health["status"] == "ok" and health["model"] == "flux-tiny"
        assert health["platform"] == "cpu"  # the torch device's type
        status, metrics = _get(server.port, "/metrics")
        assert status == 200 and metrics["requests_total"] >= 1
        assert metrics["batcher"]["batches_total"] >= 1 and "latency_ms" in metrics
        status, data = _get(server.port, "/v1/loras")
        assert status == 200 and data["active_loras"] == []


# ---------------------------------------------------------------------------
class TestAdmissionControl:
    """A bounded queue: overload fails at once with QueueFullError / HTTP 503
    and Retry-After instead of waiting toward the request timeout."""

    def test_batcher_rejects_when_queue_full(self):
        release, started = threading.Event(), threading.Event()

        def batch_fn(reqs):
            started.set()
            release.wait(30)
            return list(reqs)

        b = MicroBatcher(batch_fn, max_batch=1, max_wait_ms=1, max_queue_depth=2)
        try:
            f0 = b.submit(0)
            assert started.wait(10)  # the worker is inside batch_fn
            f1, f2 = b.submit(1), b.submit(2)  # the queue is full (depth 2)
            with pytest.raises(QueueFullError):
                b.submit(3)
            assert b.stats.rejects_total == 1
            release.set()
            assert [f.result(30) for f in (f0, f1, f2)] == [0, 1, 2]
            assert b.submit(4).result(30) == 4  # a drained queue admits again
        finally:
            release.set()
            b.close(timeout=5)

    def test_http_503_with_retry_after_under_burst(self):
        import PIL.Image

        class _Out:
            image = PIL.Image.new("RGB", (8, 8))
            concept_heatmaps = np.zeros((len(CONCEPTS), 4, 4), np.float32)
            cross_attention_maps = np.zeros((len(CONCEPTS), 4, 4), np.float32)

        class _SlowPipe:
            """A stand-in pipeline whose generate waits on an Event."""

            model_name = "fake"
            active_loras: list = []
            device = torch.device("cpu")

            class cfg:
                depth = 2

            def __init__(self):
                self.release, self.started = threading.Event(), threading.Event()

            def generate_images(self, prompts, concepts, **_kw):
                self.started.set()
                self.release.wait(30)
                return [_Out() for _ in prompts]

        slow = _SlowPipe()
        srv = ConceptAttentionServer(slow, port=0, max_batch=1, max_wait_ms=1, bucket_sizes=(1,),
                                     request_timeout_s=60, max_queue_depth=1)
        statuses = {}

        def call(i):
            conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=60)
            conn.request("POST", "/v1/generate",
                         json.dumps(dict(BASE_BODY, width=16, height=16, seed=i)),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            statuses[i] = (resp.status, resp.getheader("Retry-After"), json.loads(resp.read()))
            conn.close()

        with srv:
            t0 = threading.Thread(target=call, args=(0,))
            t0.start()
            assert slow.started.wait(10)  # the worker is busy; the queue is empty
            t1 = threading.Thread(target=call, args=(1,))
            t1.start()
            deadline = time.monotonic() + 10
            while srv.batcher.queue_depth() < 1 and time.monotonic() < deadline:
                time.sleep(0.005)
            assert srv.batcher.queue_depth() == 1
            call(2)  # the queue is full: refused at once
            status, retry_after, data = statuses[2]
            assert status == 503 and "full" in data["error"]
            assert retry_after is not None and int(retry_after) >= 1
            slow.release.set()
            t0.join(30)
            t1.join(30)
            assert statuses[0][0] == 200 and statuses[1][0] == 200
            _, metrics = _get(srv.port, "/metrics")
            assert metrics["batcher"]["rejects_total"] == 1 and metrics["max_queue_depth"] == 1
            _, health = _get(srv.port, "/healthz")
            assert health["platform"] == "cpu"


# ---------------------------------------------------------------------------
def write_adapter(path, cfg, seed=21, rank=4):
    """A rank-`rank` adapter over every flux target in the BFL naming, as a
    `.safetensors` file."""
    from safetensors.numpy import save_file

    rng = np.random.default_rng(seed)
    d, m = cfg.hidden_size, cfg.mlp_hidden_dim
    dims = {"img_attn.qkv": (d, 3 * d), "img_attn.proj": (d, d), "img_mod.lin": (d, 6 * d),
            "img_mlp.0": (d, m), "img_mlp.2": (m, d)}
    dims |= {k.replace("img", "txt"): v for k, v in dims.items()}
    single = {"linear1": (d, 3 * d + m), "linear2": (d + m, d), "modulation.lin": (d, 3 * d)}
    sd = {}
    for blocks, n, table in (("double_blocks", cfg.depth, dims),
                             ("single_blocks", cfg.depth_single_blocks, single)):
        for i in range(n):
            for module, (d_in, d_out) in table.items():
                key = f"{blocks}.{i}.{module}"
                sd[f"{key}.lora_A.weight"] = (0.05 * rng.standard_normal((rank, d_in))).astype(np.float32)
                sd[f"{key}.lora_B.weight"] = (0.05 * rng.standard_normal((d_out, rank))).astype(np.float32)
    save_file(sd, str(path))
    return str(path)


class TestLoraSwap:
    """POST /v1/loras replaces the active adapter set at run time; swaps run
    on the batcher's worker, so they serialize with generation batches."""

    @pytest.fixture(scope="class")
    def adapter_path(self, tmp_path_factory, pipe):
        return write_adapter(tmp_path_factory.mktemp("loras") / "style.safetensors", pipe.cfg)

    @pytest.fixture(scope="class")
    def swap_server(self, pipe):
        swap_pipe = TorchPipeline("flux-tiny", dtype=torch.float32, device="cpu",
                                  params=pipe.params, ae_params=pipe.ae_params,
                                  keep_base_for_swap=True)
        srv = ConceptAttentionServer(swap_pipe, port=0, max_batch=2, max_wait_ms=50,
                                     bucket_sizes=(2,), request_timeout_s=300)
        with srv:
            yield srv

    def test_swap_changes_output_and_clear_restores(self, swap_server, adapter_path, pipe):
        port = swap_server.port
        assert _get(port, "/v1/loras") == (200, {"active_loras": []})
        status, base = _post(port, dict(BASE_BODY, heatmap_format="array"))
        assert status == 200, base
        base_maps = np.asarray(base["concept_heatmaps"]["cat"], np.float32)

        status, data = _post(port, {"adapters": [{"path": adapter_path, "strength": 0.7}]},
                             path="/v1/loras")
        assert status == 200, data
        assert data["active_loras"] == [{"source": adapter_path, "strength": 0.7}]
        assert _get(port, "/v1/loras")[1]["active_loras"][0]["source"] == adapter_path

        status, adapted = _post(port, dict(BASE_BODY, heatmap_format="array"))
        assert status == 200, adapted
        adapted_maps = np.asarray(adapted["concept_heatmaps"]["cat"], np.float32)
        assert np.abs(adapted_maps - base_maps).max() > 0
        # the swap == the same adapter merged at construction
        direct = TorchPipeline(
            "flux-tiny", dtype=torch.float32, device="cpu", params=pipe.params,
            ae_params=pipe.ae_params, lora=adapter_path, lora_strength=0.7,
        ).generate_image(BASE_BODY["prompt"], CONCEPTS, width=SIZE, height=SIZE,
                         num_inference_steps=1, seed=BASE_BODY["seed"], return_pil_heatmaps=False)
        np.testing.assert_allclose(adapted_maps, direct.concept_heatmaps[0], atol=2e-3)

        status, data = _post(port, {"adapters": []}, path="/v1/loras")
        assert status == 200 and data["active_loras"] == []
        _, restored = _post(port, dict(BASE_BODY, heatmap_format="array"))
        np.testing.assert_array_equal(
            np.asarray(restored["concept_heatmaps"]["cat"], np.float32), base_maps)

    def test_swap_validation(self, swap_server, server, adapter_path):
        # a server built without keep_base_for_swap refuses swaps with a 400
        status, data = _post(server.port, {"adapters": []}, path="/v1/loras")
        assert status == 400 and "lora_swap" in data["error"]
        status, data = _post(swap_server.port,
                             {"adapters": [{"path": "/nonexistent.safetensors"}]},
                             path="/v1/loras")
        assert status == 400 and "not found" in data["error"]
        status, data = _post(swap_server.port,
                             {"adapters": [{"path": adapter_path, "strength": "x"}]},
                             path="/v1/loras")
        assert status == 400 and "strength" in data["error"]


# ---------------------------------------------------------------------------
VIDEO_CFG = dict(num_attention_heads=4, attention_head_dim=16, time_embed_dim=32,
                 text_embed_dim=64, num_layers=2, max_text_seq_length=16,
                 use_rotary_positional_embeddings=True)


@pytest.fixture(scope="module")
def video_server(pipe):
    """A server with the flux-tiny pipeline and a tiny video pipeline:
    /v1/generate_video rides the batcher that image traffic rides."""
    vpipe = TorchVideoPipeline(cfg=TVideoCfg(**VIDEO_CFG), dtype=torch.float32, device="cpu")
    srv = ConceptAttentionServer(pipe, port=0, max_batch=2, max_wait_ms=25, bucket_sizes=(2,),
                                 request_timeout_s=300, video_pipeline=vpipe)
    with srv:
        yield srv, vpipe


VIDEO_BODY = {"prompt": "a river through a forest", "concepts": ["river", "forest"],
              "num_frames": 2, "height": 8, "width": 8, "num_inference_steps": 2, "seed": 5}


class TestVideoServing:
    def test_video_roundtrip_matches_direct_call(self, video_server):
        server, vpipe = video_server
        status, data = _post(server.port, dict(VIDEO_BODY, heatmap_format="array",
                                               return_cross_attention=True),
                             path="/v1/generate_video")
        assert status == 200, data
        assert data["num_frames"] == 2 and data["batch_size"] == 1
        assert set(data["concept_heatmaps"]) == set(VIDEO_BODY["concepts"])
        assert set(data["cross_attention_maps"]) == set(VIDEO_BODY["concepts"])
        direct = vpipe.generate_video(VIDEO_BODY["prompt"], VIDEO_BODY["concepts"], num_frames=2,
                                      height=8, width=8, num_inference_steps=2, seed=5)
        served = np.asarray(data["concept_heatmaps"]["river"], np.float32)
        assert served.shape == tuple(direct.concept_heatmaps.shape[1:])
        np.testing.assert_allclose(served, direct.concept_heatmaps[0], atol=1e-5)

    def test_video_png_format(self, video_server):
        server, _ = video_server
        status, data = _post(server.port, VIDEO_BODY, path="/v1/generate_video")
        assert status == 200, data
        frames = data["concept_heatmaps"]["river"]
        assert len(frames) == VIDEO_BODY["num_frames"]
        assert _png_to_array(frames[0]).shape[:2] == (8 // 2, 8 // 2)  # latent 8 / patch 2

    def test_video_validation(self, video_server, server):
        vsrv, _ = video_server
        status, data = _post(vsrv.port, dict(VIDEO_BODY, height=7), path="/v1/generate_video")
        assert status == 400 and "patch_size" in data["error"]
        status, data = _post(vsrv.port, dict(VIDEO_BODY, layer_indices=[5]),
                             path="/v1/generate_video")
        assert status == 400 and "layer_indices" in data["error"]
        status, data = _post(vsrv.port, dict(VIDEO_BODY, scheduler="euler"),
                             path="/v1/generate_video")
        assert status == 400 and "scheduler" in data["error"]
        status, data = _post(server.port, VIDEO_BODY, path="/v1/generate_video")
        assert status == 400 and "video pipeline" in data["error"]


# ---------------------------------------------------------------------------
def numpy_noise(seed, n, h, w, *args, channels=16, vae_factor=8, **kwargs):
    """f32 numpy noise of one `get_noise` draw's shape, from `seed`."""
    from conceptattention_torch.ops.packing import latent_noise_shape

    shape = latent_noise_shape(n, h, w, channels, vae_factor)
    return np.random.default_rng(int(seed)).standard_normal(shape).astype(np.float32)


@pytest.fixture
def same_noise(monkeypatch):
    """Seed-keyed numpy noise in both packages' diffusion-noise draws (the
    port's generator seed, the JAX key's [0, seed]) and the VAE's posterior
    mean in place of its sample."""
    def t_noise(gen, *args, **kwargs):
        return torch.from_numpy(numpy_noise(gen.initial_seed(), *args, **kwargs))

    def j_noise(key, *args, **kwargs):
        return jnp.asarray(numpy_noise(np.asarray(key)[-1], *args, **kwargs))

    def j_noise_for_keys(keys, height, width, dtype, channels, vae_factor):
        return jnp.concatenate([j_noise(k, 1, height, width, channels=channels,
                                        vae_factor=vae_factor) for k in keys])

    t_encode, j_encode = t_pipe._vae_encode, j_pipe._vae_encode
    monkeypatch.setattr(t_pipe, "get_noise", t_noise)
    monkeypatch.setattr(t_pipe, "_vae_encode", lambda ae, cfg, x, gen=None: t_encode(ae, cfg, x))
    monkeypatch.setattr(j_pipe, "get_noise", j_noise)
    monkeypatch.setattr(j_pipe, "_noise_for_keys", j_noise_for_keys)
    monkeypatch.setattr(j_pipe, "_vae_encode",
                        lambda ae, cfg, x, keys, sample=True: j_encode(ae, cfg, x, None, sample=False))


@pytest.fixture(scope="module")
def both_servers(pipes):
    """A port daemon and a JAX daemon over the same weights, one bucket."""
    from conceptattention_tpu.serving import ConceptAttentionServer as JaxServer

    t, j = pipes
    kw = dict(port=0, max_batch=1, max_wait_ms=1, bucket_sizes=(1,), request_timeout_s=600)
    with ConceptAttentionServer(t, **kw) as t_srv, JaxServer(j, **kw) as j_srv:
        yield t_srv, j_srv


SAME_BODIES = {
    "generate": ("/v1/generate", dict(BASE_BODY, num_inference_steps=2, heatmap_format="array",
                                      return_cross_attention=True, watermark=False)),
    "generate_png": ("/v1/generate", dict(BASE_BODY, num_inference_steps=2, seed=9,
                                          attention_norm="softmax", layer_indices=[0])),
    "encode": ("/v1/encode", {"concepts": CONCEPTS, "width": SIZE, "height": SIZE,
                              "num_steps": 2, "noise_timestep": 1, "seed": 4,
                              "heatmap_format": "array", "return_cross_attention": True}),
}


@pytest.mark.parametrize("name", list(SAME_BODIES))
def test_same_bodies_to_jax_and_port_servers(both_servers, same_noise, name):
    """The same body to both daemons: the same keys, heatmaps within 1e-4,
    the image within one grey level; the PNG heatmaps' colours within one
    entry of the colormap (matplotlib's in both; plasma's entries are at
    most 4 levels apart), as a value within 1e-4 of an entry's edge may
    land on either side."""
    t_srv, j_srv = both_servers
    path, body = SAME_BODIES[name]
    if path == "/v1/encode":
        arr = (np.random.RandomState(3).rand(SIZE, SIZE, 3) * 255).astype(np.uint8)
        body = dict(body, image=_png_b64(arr))
    t_status, got = _post(t_srv.port, body, path=path)
    j_status, want = _post(j_srv.port, body, path=path, timeout=600)
    assert t_status == j_status == 200, (got, want)
    assert set(got) == set(want)
    for key in ("concept_heatmaps", "cross_attention_maps"):
        if key not in want:
            continue
        for c in CONCEPTS:
            if body.get("heatmap_format") == "array":
                np.testing.assert_allclose(np.asarray(got[key][c], np.float32),
                                           np.asarray(want[key][c], np.float32),
                                           rtol=1e-4, atol=1e-4, err_msg=f"{key}[{c}]")
            else:
                g, w = _png_to_array(got[key][c]), _png_to_array(want[key][c])
                assert np.abs(g.astype(int) - w.astype(int)).max() <= 4, f"{key}[{c}]"
    if "image" in want:
        g, w = _png_to_array(got["image"]), _png_to_array(want["image"])
        assert g.shape == w.shape == (SIZE, SIZE, 3)
        assert np.abs(g.astype(int) - w.astype(int)).max() <= 1


# ---------------------------------------------------------------------------
def test_daemon_parser_and_default_device(monkeypatch):
    """The daemon's flags mirror the JAX daemon's; its device is the card
    unless asked, and without one it raises instead of carrying on."""
    from conceptattention_torch.serving.__main__ import build_parser, main, video_config

    args = build_parser().parse_args([])
    assert args.device == "cuda" and args.attention_backend == "fused"
    assert args.bucket_sizes == [1, 2, 4, 8] and args.max_queue_depth == 64
    args = build_parser().parse_args(["--model", "flux-tiny", "--lora", "a", "b", "--lora_swap",
                                      "--video", "--quantize", "w8a8", "--int8_qk"])
    assert args.model_name == "flux-tiny" and args.lora == ["a", "b"] and args.lora_swap
    assert args.video_model == "cogvideox-5b" and args.quantize == "w8a8" and args.int8_qk
    with pytest.raises(SystemExit):
        build_parser().parse_args(["--attention_backend", "pallas"])
    assert video_config("cogvideox-tiny").num_layers == 2
    with pytest.raises(ValueError, match="unknown --video"):
        video_config("cogvideox-huge")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--model", "flux-tiny", "--port", "0"])
