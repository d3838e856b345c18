"""The port's instance autotuner (`kernels/autotune.py`) on the CPU, beside
the JAX package's tile autotuner.

Each case of `tests/test_autotune.py` has its counterpart here, for compiled
instances in place of free tile sizes: the candidates, the overlay's
precedence over the default instance, the sweep's round trip through the
cache (on the CPU `measure_tile` times the plain version), a refused
candidate skipped, all refused raising, a corrupt cache ignored, a bare
filename. Beside them: a launch error is never swallowed, the cache's
schema is JAX's, the overlay is read from the cache once and lazily, a
winner steers only calls of the workload it was timed on, and
the attention with the overlay set still equals the JAX kernel (interpret
mode) within `tests/test_torch_flash_saliency.py`'s tolerance, 1e-5.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conceptattention_torch import kernels
from conceptattention_torch.kernels import autotune
from conceptattention_torch.kernels import flash_saliency as fs
from conceptattention_torch.kernels.autotune import (
    autotune_tiles,
    candidate_tiles,
    load_tile_cache,
    register_tuned_tiles,
)
from conceptattention_tpu.kernels import autotune as j_autotune
from conceptattention_tpu.kernels import flash_saliency as j_fs

torch.set_num_threads(2)  # six test workers share the host's cores

ATTN = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _clean_overlay():
    """Isolate the runtime overlay (and its lazy cache load) per test."""
    saved = dict(fs._TUNED_TILES)
    saved_flag = fs._tile_cache_loaded
    fs._tile_cache_loaded = True  # don't read the user cache
    yield
    fs._TUNED_TILES.clear()
    fs._TUNED_TILES.update(saved)
    fs._tile_cache_loaded = saved_flag


def pure(s, batch_heads):
    """The overlay key of a pure self-attention call (JAX's probe)."""
    return fs.tile_key(128, s, batch_heads, s, 0, 0)


def sweep(cache, candidates, s=256, **kw):
    return autotune_tiles(s, batch=1, heads=1, head_dim=128, candidates=candidates, iters=2,
                          cache_path=cache, device="cpu", **kw)


class TestCandidates:
    def test_every_compiled_instance_at_head_dim_128(self):
        cands = candidate_tiles(4355)
        assert cands == list(range(len(fs.FLASH_D128_INSTANCES))) and len(cands) >= 4
        # the default instance, the one every call takes without a tuned entry, is a candidate
        default = fs.default_instance(128)
        assert default in cands
        assert fs.FLASH_D128_INSTANCES[default] == "<128, 128, 192, 2, overlap wide, 1>"
        # the in-order instance that was the default stays compiled, as a candidate
        assert cands[0] == 0 and fs.FLASH_D128_INSTANCES[0] == "<128, 128, 128, 2, in order, 1>"

    @pytest.mark.parametrize("d", [64, 512])
    def test_other_hopper_head_dims_have_one_instance(self, d):
        assert candidate_tiles(1024, head_dim=d) == [0]

    def test_candidates_do_not_depend_on_the_sequence(self):
        # each instance masks its ragged edge, so all apply at any S
        assert candidate_tiles(128) == candidate_tiles(1286) == candidate_tiles(4355)


DEFAULT = fs.D128_DEFAULT_INSTANCE


class TestPrecedence:
    def test_tuned_overlay_beats_the_default(self):
        assert fs._auto_instance(*pure(4355, 24)) == DEFAULT
        register_tuned_tiles(4355, 2, 128, 24)
        assert fs._auto_instance(*pure(4355, 24)) == 2
        # the overlay is keyed on the workload: other calls keep the default
        assert fs._auto_instance(*pure(4355, 12)) == DEFAULT
        assert fs._auto_instance(*pure(4352, 24)) == DEFAULT
        # an overlay entry naming the old default, instance 0, is taken too
        register_tuned_tiles(4352, 0, 128, 24)
        assert fs._auto_instance(*pure(4352, 24)) == 0

    def test_a_winner_steers_only_its_own_workload(self):
        """A winner of the double block's layout (txt / img / concepts, the
        (T, T) mode) is not taken by a pure self-attention call of the same
        S and B x H, nor by the same layout in another mask mode, and the
        other way round."""
        double = (256, 4096, 3)
        register_tuned_tiles(4355, 1, 128, 24, segments=double)
        assert fs._auto_instance(*fs.tile_key(128, 4355, 24, *double)) == 1
        assert fs._auto_instance(*pure(4355, 24)) == DEFAULT
        assert fs._auto_instance(*fs.tile_key(128, 4355, 24, *double, True, False)) == DEFAULT
        register_tuned_tiles(4355, 2, 128, 24)
        assert fs._auto_instance(*fs.tile_key(128, 4355, 24, *double)) == 1

    def test_default_when_untuned(self):
        assert fs._auto_instance(*pure(2304, 24)) == DEFAULT

    @pytest.mark.parametrize("key", [
        (128, 4355, 24, 256, 4096, 3),     # flux double block
        (128, 4352, 24, 4352, 0, 0),       # flux single block
        (128, 67356, 24, 32, 67320, 4),    # HunyuanVideo double block, 32 text rows
        (128, 67352, 24, 67352, 0, 0),     # HunyuanVideo single block
        (128, 67580, 24, 256, 67320, 4),   # HunyuanVideo double block, 256 text rows
        (128, 1286, 24, 256, 1024, 6),     # eval double block, 11 key tiles of 128
        (128, 1286, 192, 256, 1024, 6),    # the encode cell's B8
    ], ids=["flux-double", "flux-single", "hunyuan-double", "hunyuan-single",
            "hunyuan-double-256", "eval-b1", "eval-b8"])
    def test_default_without_a_tuned_entry(self, key):
        """With no overlay entry every D=128 call takes the register-
        reallocating overlap, from the eval path's short rows to
        HunyuanVideo's 67k-token ones: it led instances 0-2 at each."""
        assert fs._TUNED_TILES == {}
        assert fs._auto_instance(*key) == DEFAULT == fs.default_instance(128)
        assert fs.FLASH_D128_INSTANCES[DEFAULT] == "<128, 128, 192, 2, overlap wide, 1>"

    @pytest.mark.parametrize("d", [64, 512])
    def test_other_head_dims_default_to_their_one_instance(self, d):
        assert fs.default_instance(d) == 0
        assert fs._auto_instance(*fs.tile_key(d, 18002, 96, 226, 17550, 226)) == 0

    def test_cache_is_read_once_and_lazily(self, tmp_path, monkeypatch):
        cache = tmp_path / "tiles.json"
        cache.write_text(json.dumps({autotune._device_kind(): {"128:1286:24:256:1024:6:1:1": {
            "instance": 2, "tflops": 1.0, "probe": {"batch": 1, "heads": 24, "head_dim": 128}}}}))
        monkeypatch.setattr(autotune, "_DEFAULT_CACHE", str(cache))
        eval_call = fs.tile_key(128, 1286, 24, 256, 1024, 6)
        fs._TUNED_TILES.clear()
        fs._tile_cache_loaded = False
        assert fs._TUNED_TILES == {}
        assert fs._auto_instance(*eval_call) == 2
        cache.write_text("{}")
        fs._TUNED_TILES.clear()
        assert fs._auto_instance(*eval_call) == DEFAULT  # not read again


class TestSweepAndCache:
    def test_autotune_roundtrip(self, tmp_path):
        cache = str(tmp_path / "tiles.json")
        cands = [0, 1]
        best = sweep(cache, cands)
        assert best in cands
        # winner registered in the live overlay
        assert fs._auto_instance(*pure(256, 1)) == best
        # ... and persisted under this device kind
        data = json.load(open(cache))
        (kind,) = data.keys()
        assert kind == "cpu"
        ent = data[kind]["128:256:1:256:0:0:1:1"]
        assert ent["instance"] == best
        assert ent["tflops"] > 0
        # a fresh process would load it back
        fs._TUNED_TILES.clear()
        loaded = load_tile_cache(cache)
        assert loaded == {pure(256, 1): best}
        assert fs._auto_instance(*pure(256, 1)) == best

    def test_infeasible_candidates_skipped(self, tmp_path, monkeypatch):
        real = autotune.measure_tile

        def refusing(s, inst, *a, **kw):
            if inst == 1:  # a shape contract refusing the input before any launch
                raise ValueError("instance 1 takes no such shape")
            return real(s, inst, *a, **kw)

        monkeypatch.setattr(autotune, "measure_tile", refusing)
        assert sweep(str(tmp_path / "tiles.json"), [1, 0]) == 0

    def test_all_infeasible_raises(self, tmp_path, monkeypatch):
        monkeypatch.setattr(
            autotune, "measure_tile",
            lambda *a, **kw: (_ for _ in ()).throw(ValueError("refused")),
        )
        with pytest.raises(RuntimeError, match="no feasible"):
            sweep(str(tmp_path / "t.json"), [1])

    def test_a_launch_error_is_not_swallowed(self, tmp_path, monkeypatch):
        def broken(s, inst, *a, **kw):
            raise RuntimeError("ca_flash_saliency_sm90_bf16_instance launch: CUDA error 700")

        monkeypatch.setattr(autotune, "measure_tile", broken)
        cache = tmp_path / "t.json"
        with pytest.raises(RuntimeError, match="CUDA error 700"):
            sweep(str(cache), [0, 1])
        assert not cache.exists() and fs._TUNED_TILES == {}

    def test_an_index_outside_the_compiled_set_is_refused(self, tmp_path):
        n = len(fs.FLASH_D128_INSTANCES)
        with pytest.raises(ValueError, match="instances"):
            autotune.measure_tile(64, n, heads=1, iters=1, device="cpu")
        assert sweep(str(tmp_path / "t.json"), [n, 0], s=64) == 0

    def test_corrupt_cache_is_ignored(self, tmp_path):
        cache = tmp_path / "tiles.json"
        cache.write_text("{not json")
        assert load_tile_cache(str(cache)) == {}

    def test_a_key_without_its_workload_is_skipped(self, tmp_path):
        """(head dim, S, B x H) alone does not say which calls a winner was
        timed on: such an entry steers nothing."""
        cache = tmp_path / "tiles.json"
        entry = {"instance": 1, "tflops": 1.0, "probe": {"batch": 1, "heads": 24, "head_dim": 128}}
        cache.write_text(json.dumps({autotune._device_kind(): {
            "128:1286:24": entry, "128:4352:24:4352:0:0:1:1": entry}}))
        assert load_tile_cache(str(cache)) == {pure(4352, 24): 1}
        assert fs._TUNED_TILES == {pure(4352, 24): 1}

    def test_missing_cache_is_ignored(self, tmp_path):
        assert load_tile_cache(str(tmp_path / "absent.json")) == {}

    def test_bare_filename_cache_path(self, tmp_path, monkeypatch):
        # a cache path with no directory component must not lose the sweep
        monkeypatch.chdir(tmp_path)
        best = sweep("tiles.json", [0])
        assert load_tile_cache("tiles.json") == {pure(256, 1): best}

    def test_cache_schema_is_jax_s(self, tmp_path, monkeypatch):
        """{kind: {key: entry}}, the entry's rate and probe as JAX writes
        them, an instance index in place of JAX's (block_q, block_k)."""
        monkeypatch.setattr(j_autotune, "_device_kind", lambda: "cpu:TFRT_CPU")
        j_path, t_path = tmp_path / "jax.json", tmp_path / "port.json"
        j_autotune._save_cache_entry(1286, (256, 512), 1.25, 1, 24, 128, str(j_path))
        autotune._save_cache_entry(1286, 2, 1.25, 1, 24, 128, str(t_path))
        (j_kind, j_entries), = json.load(open(j_path)).items()
        (t_kind, t_entries), = json.load(open(t_path)).items()
        (j_ent,), (t_ent,) = j_entries.values(), t_entries.values()
        assert set(t_ent) == set(j_ent) - {"block_q", "block_k"} | {"instance"}
        assert t_ent["probe"] == j_ent["probe"] and t_ent["tflops"] == j_ent["tflops"]
        assert t_kind == "cpu" and t_ent["instance"] == 2


def test_cli_sweeps_and_caches(tmp_path, capsys):
    cache = tmp_path / "tiles.json"
    autotune.main(["--seq", "64", "--batch", "1", "--heads", "1", "--iters", "1",
                   "--device", "cpu", "--cache_path", str(cache)])
    out = capsys.readouterr().out
    assert "S=64: sweeping 4 instances" in out and "best instance" in out
    assert list(json.load(open(cache))["cpu"]) == ["128:64:1:64:0:0:1:1"]
    # the double block's layout: txt rows, img rows, concept rows
    autotune.main(["--seq", "70", "--txt_len", "8", "--concepts", "3", "--heads", "1",
                   "--iters", "1", "--device", "cpu", "--cache_path", str(cache)])
    assert list(json.load(open(cache))["cpu"]) == ["128:64:1:64:0:0:1:1", "128:70:1:8:59:3:1:1"]


def test_launch_counts_name_each_instance():
    counts = kernels.launch_counts()
    for i, name in enumerate(fs.FLASH_D128_INSTANCES):
        assert f"flash_saliency (Hopper D=128 instance {i} {name})" in counts
    key = f"flash_saliency (Hopper D=128 instance 2 {fs.FLASH_D128_INSTANCES[2]})"
    kernels.add_launches({key: 3, "flash_saliency": 3})
    after = kernels.launch_counts()
    kernels.add_launches({key: -3, "flash_saliency": -3})
    assert after[key] == counts[key] + 3 and after["flash_saliency"] == counts["flash_saliency"] + 3
    assert kernels.launch_counts() == counts


def rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("d,t,p,c", [(32, 8, 48, 3), (128, 8, 48, 3)],
                         ids=["flux-tiny", "head-dim-128"])
def test_overlay_leaves_the_function_unchanged(d, t, p, c):
    """With the overlay naming a non-default instance for this very call,
    the port's attention equals the JAX kernel in interpret mode (flux-tiny's
    2 heads of 32, and the DiT's head dim 128)."""
    h, s = 2, 64
    q, k, v = (rand(50 + i, 1, h, s, d) for i in range(3))
    ang = rand(60, 1, 1, s, d // 2)
    register_tuned_tiles(s, 2, d, h, segments=(t, p, c))
    register_tuned_tiles(s, 2, 128, h, segments=(t, p, c))
    t_cos, t_sin = fs.expand_rope_tables([(torch.cos(torch.from_numpy(ang)),
                                           torch.sin(torch.from_numpy(ang)))], s)
    j_cos, j_sin = j_fs.expand_rope_tables([(jnp.cos(jnp.asarray(ang)),
                                             jnp.sin(jnp.asarray(ang)))], s)
    got = fs.fused_concept_flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                           t, p, c, True, True, t_cos, t_sin)
    want = j_fs.fused_concept_flash_attention(
        *(jnp.asarray(x) for x in (q, k, v)), txt_len=t, img_len=p, concept_len=c,
        block_q=16, block_k=16, interpret=True, rope_cos=j_cos, rope_sin=j_sin)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN)
    np.testing.assert_array_equal(got[:, :, t + p + c:].numpy(), 0.0)
