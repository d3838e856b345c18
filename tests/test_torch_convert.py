"""The port's checkpoint loader and converters against the JAX package's.

State dicts are synthetic, in the official key names (the Flux DiT's and
VAE's, diffusers' CogVideoX transformer and VAE, whose oracles the JAX
package's own tests define), written to real `.safetensors` files by the
`safetensors` package. The loader must return every dtype bit for bit, bf16
included, so it is held against `safetensors.torch.load_file` (the JAX
package's loader goes through numpy, which has no bf16). Converted leaves
must equal the JAX converter's bit for bit in f32, and the checkpoint-built
pipelines (plain and w8a8) must hold the same trees.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.torch import load_file, save_file

from conceptattention_torch import ConceptAttentionFluxPipeline as TorchPipeline
from conceptattention_torch.config import configs as t_configs
from conceptattention_torch.models.flux import autoencoder as t_vae
from conceptattention_torch.weights import convert as t_convert
from conceptattention_tpu import ConceptAttentionFluxPipeline as JaxPipeline
from conceptattention_tpu.config import configs as j_configs
from conceptattention_tpu.weights import convert as j_convert

torch.set_num_threads(2)  # six test workers share the host's cores


def _flat(tree, prefix=""):
    """{path: numpy array} of a tree of dicts and lists (torch or JAX leaves)."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _flat(sub, f"{prefix}/{i}").items()}
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().cpu().numpy()}
    return {prefix: np.asarray(tree)}


def assert_trees_equal(got, want):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].shape == want[key].shape, key
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def flux_state_dict(cfg, seed=0):
    """The official Flux DiT keys at `cfg`'s shapes, f32, random values."""
    g = torch.Generator().manual_seed(seed)
    d, m, hd = cfg.hidden_size, cfg.mlp_hidden_dim, cfg.head_dim

    def r(*shape):
        return torch.randn(*shape, generator=g) * 0.02

    sd = {}

    def lin(key, din, dout, bias=True):
        sd[f"{key}.weight"] = r(dout, din)
        if bias:
            sd[f"{key}.bias"] = r(dout)

    lin("img_in", cfg.in_channels, d)
    lin("txt_in", cfg.context_in_dim, d)
    embedders = [("time_in", 256), ("vector_in", cfg.vec_in_dim)]
    if cfg.guidance_embed:
        embedders.append(("guidance_in", 256))
    for key, din in embedders:
        lin(f"{key}.in_layer", din, d)
        lin(f"{key}.out_layer", d, d)
    lin("final_layer.adaLN_modulation.1", d, 2 * d)
    lin("final_layer.linear", d, cfg.in_channels)
    for i in range(cfg.depth):
        for stream, attn in (("img", "img_attn"), ("txt", "txt_attn")):
            b = f"double_blocks.{i}"
            lin(f"{b}.{stream}_mod.lin", d, 6 * d)
            lin(f"{b}.{attn}.qkv", d, 3 * d)
            sd[f"{b}.{attn}.norm.query_norm.scale"] = 1 + r(hd)
            sd[f"{b}.{attn}.norm.key_norm.scale"] = 1 + r(hd)
            lin(f"{b}.{attn}.proj", d, d)
            lin(f"{b}.{stream}_mlp.0", d, m)
            lin(f"{b}.{stream}_mlp.2", m, d)
    for i in range(cfg.depth_single_blocks):
        b = f"single_blocks.{i}"
        lin(f"{b}.modulation.lin", d, 3 * d)
        lin(f"{b}.linear1", d, 3 * d + m)
        lin(f"{b}.linear2", d + m, d)
        sd[f"{b}.norm.query_norm.scale"] = 1 + r(hd)
        sd[f"{b}.norm.key_norm.scale"] = 1 + r(hd)
    return sd


_AE_NAMES = {"mid_block_1": "mid.block_1", "mid_block_2": "mid.block_2",
             "mid_attn_1": "mid.attn_1", "w": "weight", "b": "bias", "scale": "weight"}


def ae_state_dict(cfg, seed=0):
    """The official Flux VAE keys, named from the paths of the port's
    random-init tree, with random values."""
    g = torch.Generator().manual_seed(seed)
    tree = t_vae.init_autoencoder_params(torch.Generator().manual_seed(0), cfg)
    return {
        ".".join(_AE_NAMES.get(p, p) for p in path.strip("/").split("/")):
            torch.randn(a.shape, generator=g) * 0.1
        for path, a in _flat(tree).items()
    }


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32, torch.float64,
                                   torch.int8, torch.uint8, torch.int32, torch.int64])
def test_load_safetensors_bit_equal(tmp_path, dtype):
    g = torch.Generator().manual_seed(3)
    raw = torch.randn(3, 5, 7, generator=g) * 50
    tensors = {
        "a.weight": raw.to(dtype),
        "b": raw[0, 0].to(dtype).clone(),  # odd byte count for 1-byte types: later offsets unaligned
        "c.scalar": raw[0, 0, 0].to(dtype).clone(),
        "d.empty": torch.empty(0, 4, dtype=dtype),
        "e.f32": raw[1].clone(),
    }
    path = str(tmp_path / "x.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    got, want = t_convert.load_safetensors(path), load_file(path)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape, key
        assert torch.equal(got[key].reshape(-1).view(torch.uint8),
                           want[key].reshape(-1).view(torch.uint8)), key


def test_load_safetensors_rejects_a_short_file(tmp_path):
    path = tmp_path / "x.safetensors"
    save_file({"a": torch.ones(64)}, str(path))
    path.write_bytes(path.read_bytes()[:-8])
    with pytest.raises(ValueError, match="spans bytes"):
        t_convert.load_safetensors(str(path))


@pytest.mark.parametrize("guidance_embed", [False, True], ids=["schnell-like", "dev-like"])
def test_convert_flux_state_dict_matches_jax(guidance_embed):
    t_cfg = dataclasses.replace(t_configs["flux-tiny"].params, guidance_embed=guidance_embed)
    j_cfg = dataclasses.replace(j_configs["flux-tiny"].params, guidance_embed=guidance_embed)
    sd = flux_state_dict(t_cfg)
    got = t_convert.convert_flux_state_dict(sd, t_cfg, torch.float32)
    assert_trees_equal(got, j_convert.convert_flux_state_dict(sd, j_cfg, jnp.float32))
    # bf16 is the same values rounded once
    got16 = t_convert.convert_flux_state_dict(sd, t_cfg, torch.bfloat16)
    from conceptattention_torch.models.flux.params import tree_leaves

    for a16, a32 in zip(tree_leaves(got16), tree_leaves(got)):
        assert a16.dtype == torch.bfloat16 and torch.equal(a16, a32.to(torch.bfloat16))


def test_converters_use_every_key(monkeypatch):
    """No key of the official layout is left unread (the unused-key report)."""
    readers = []

    class Tracking(t_convert.StateDict):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            readers.append(self)

    monkeypatch.setattr(t_convert, "StateDict", Tracking)
    cfg = dataclasses.replace(t_configs["flux-tiny"].params, guidance_embed=True)
    sd = {**flux_state_dict(cfg), "extra.weight": torch.ones(2)}
    t_convert.convert_flux_state_dict(sd, cfg, torch.float32)
    t_convert.convert_autoencoder_state_dict(ae_state_dict(t_configs["flux-tiny"].ae_params),
                                             t_configs["flux-tiny"].ae_params)
    assert [r.unused() for r in readers] == [["extra.weight"], []]


def test_convert_autoencoder_state_dict_matches_jax():
    sd = ae_state_dict(t_configs["flux-tiny"].ae_params)
    got = t_convert.convert_autoencoder_state_dict(sd, t_configs["flux-tiny"].ae_params)
    want = j_convert.convert_autoencoder_state_dict(sd, j_configs["flux-tiny"].ae_params)
    assert_trees_equal(got, want)


def test_convert_cogvideox_state_dicts_match_jax():
    from test_video import TINY, _TorchCogVideoXOracle
    from test_video_vae import TINY as VAE_TINY
    from test_video_vae import _Oracle

    from conceptattention_torch.models.video.dit import CogVideoXConfig as TCfg
    from conceptattention_torch.models.video.vae import CogVideoXVAEConfig as TVaeCfg
    from conceptattention_tpu.models.video.dit import CogVideoXConfig as JCfg

    torch.manual_seed(5)
    sd = _TorchCogVideoXOracle(JCfg(use_rotary_positional_embeddings=True, **TINY)).float() \
        .diffusers_state_dict()
    got = t_convert.convert_cogvideox_state_dict(sd, TCfg(**TINY), torch.float32)
    assert_trees_equal(got, j_convert.convert_cogvideox_state_dict(sd, JCfg(**TINY), jnp.float32))

    torch.manual_seed(0)
    vae_sd = {k: v.numpy() for k, v in _Oracle(VAE_TINY).state_dict().items()}
    t_cfg = TVaeCfg(**{f.name: getattr(VAE_TINY, f.name) for f in dataclasses.fields(TVaeCfg)})
    got = t_convert.convert_cogvideox_vae_state_dict(vae_sd, t_cfg)
    assert_trees_equal(got, j_convert.convert_cogvideox_vae_state_dict(vae_sd, VAE_TINY))


@pytest.fixture(scope="module")
def checkpoint_files(tmp_path_factory):
    spec = t_configs["flux-tiny"]
    root = tmp_path_factory.mktemp("ckpt")
    flux = {k: v.to(torch.bfloat16) for k, v in flux_state_dict(spec.params, seed=1).items()}
    save_file(flux, str(root / "flux-tiny.safetensors"))
    save_file(ae_state_dict(spec.ae_params, seed=2), str(root / "ae-tiny.safetensors"))
    return str(root / "flux-tiny.safetensors"), str(root / "ae-tiny.safetensors")


@pytest.mark.parametrize("quantize", [False, "w8a8"], ids=["plain", "w8a8"])
def test_pipeline_from_checkpoint_matches_jax(checkpoint_files, monkeypatch, quantize):
    """FLUX_TINY / AE_TINY name bf16 DiT and f32 VAE files: both pipelines
    build the same trees from them (the DiT in f32 from bf16 values, its
    stacks quantized on the host for w8a8)."""
    flux_path, ae_path = checkpoint_files
    monkeypatch.setenv("FLUX_TINY", flux_path)
    monkeypatch.setenv("AE_TINY", ae_path)
    monkeypatch.setenv("AE", "/nonexistent")  # the tiny spec never reads the full-size variable
    j = JaxPipeline("flux-tiny", dtype=jnp.float32, quantize=quantize)
    t = TorchPipeline("flux-tiny", dtype=torch.float32, device="cpu", quantize=quantize)
    assert_trees_equal(t.params, jax.tree.map(np.asarray, j.params))
    assert_trees_equal(t.ae_params, jax.tree.map(np.asarray, j.ae_params))
    if quantize:
        assert "qa" in t.params["double"]["img_mlp_in"]["w"]
    else:
        want = load_file(flux_path)["double_blocks.1.img_attn.qkv.weight"].t().float()
        assert torch.equal(t.params["double"]["img_qkv"]["w"][1].reshape(want.shape), want)
    out = t.generate_image("a dragon", ["dragon", "sky"], width=32, height=32,
                           num_inference_steps=1, return_pil_heatmaps=False,
                           return_image_array=True)
    assert out.image.shape == (32, 32, 3) and np.isfinite(out.concept_heatmaps).all()


def test_checkpoint_spec_fields(monkeypatch):
    for var in ("FLUX_SCHNELL", "FLUX_DEV", "FLUX_TINY", "AE", "AE_TINY"):
        monkeypatch.setenv(var, f"/ckpt/{var}")
    for name in ("flux-schnell", "flux-dev", "flux-tiny"):
        t, j = t_configs[name], j_configs[name]
        for field in ("repo_id", "repo_flow", "repo_ae", "ckpt_env_var", "ae_env_var",
                      "t5_max_length", "ckpt_path", "ae_path"):
            assert getattr(t, field) == getattr(j, field), (name, field)
        assert dataclasses.asdict(t.params) == dataclasses.asdict(j.params)
        assert dataclasses.asdict(t.ae_params) == dataclasses.asdict(j.ae_params)
    assert t_configs["flux-dev"].params.guidance_embed
    assert t_configs["flux-tiny"].ae_path == "/ckpt/AE_TINY"
    monkeypatch.delenv("FLUX_DEV")
    assert t_configs["flux-dev"].ckpt_path is None
