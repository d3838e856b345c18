"""The port's sequence-parallel ring path against the JAX package's, on the CPU.

The port's rings run on `make_mesh(seq=N, devices=[cpu] * N)`: N ranks on one
device, each with its own chunk and buffers. The JAX package's run on the
virtual CPU mesh of `tests/conftest.py`, its "ring_rdma" kernel in the TPU
interpret machine. On CPU tensors the port's "ring_rdma" runs K4's plain
version, the "ring" ring. Inputs are numpy draws from a seed. Tolerances:
2e-5 in f32 for one attention (as `tests/test_ring_rdma.py`), 2e-2 for bf16
inputs (one bf16 step of outputs of order 1), and rtol 1e-3 / atol 1e-4 for
the forwards (as `tests/test_context_parallel.py`) and the pipeline stages.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conceptattention_torch import ConceptAttentionFluxPipeline as TorchPipeline
from conceptattention_torch.config import FluxConfig as TFluxConfig
from conceptattention_torch.kernels import ring_rdma as t_rdma
from conceptattention_torch.models.flux.dit import flux_forward as t_flux_forward
from conceptattention_torch.models.video import dit as t_vdit
from conceptattention_torch.ops import attention as t_attn
from conceptattention_torch.ops.packing import make_img_ids as t_img_ids
from conceptattention_torch.ops.packing import pack_latents as t_pack
from conceptattention_torch.ops.rope import embed_nd as t_embed_nd
from conceptattention_torch.ops.schedule import get_schedule
from conceptattention_torch.parallel import make_mesh as t_make_mesh
from conceptattention_torch.parallel import ring_attention as t_ring
from conceptattention_torch.pipeline import concept_pipeline as t_pipe
from conceptattention_torch.pipeline import heatmaps as t_heat
from conceptattention_torch.sampling import rectified_flow as t_flow
from conceptattention_torch.weights.from_jax import params_from_numpy
from conceptattention_tpu import ConceptAttentionFluxPipeline as JaxPipeline
from conceptattention_tpu.config import FluxConfig as JFluxConfig
from conceptattention_tpu.kernels import ring_rdma as j_rdma
from conceptattention_tpu.models.flux.dit import flux_forward as j_flux_forward
from conceptattention_tpu.models.flux.params import init_flux_params
from conceptattention_tpu.models.video import dit as j_vdit
from conceptattention_tpu.ops import attention as j_attn
from conceptattention_tpu.ops.packing import make_img_ids as j_img_ids
from conceptattention_tpu.ops.packing import pack_latents as j_pack
from conceptattention_tpu.ops.rope import embed_nd as j_embed_nd
from conceptattention_tpu.parallel import ring_attention as j_ring
from conceptattention_tpu.parallel.mesh import make_mesh as j_make_mesh
from conceptattention_tpu.pipeline import concept_pipeline as j_pipe
from conceptattention_tpu.pipeline import heatmaps as j_heat

torch.set_num_threads(2)  # six test workers share the host's cores

ATTN = dict(rtol=0, atol=2e-5)
FWD = dict(rtol=1e-3, atol=1e-4)
ABLATIONS = [(True, True), (True, False), (False, True), (False, False)]
CPU = torch.device("cpu")


def close(got, want, tol=ATTN, msg=""):
    if isinstance(got, torch.Tensor):
        got = got.float().numpy()
    np.testing.assert_allclose(got, np.asarray(want, np.float32), err_msg=msg, **tol)


def rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def qkv(seed, b, h, s, d):
    return [rand(seed + i, b, h, s, d) for i in range(3)]


def cpu_mesh(n):
    return t_make_mesh(seq=n, devices=[CPU] * n)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_ring_attention_matches_jax(n):
    arrays = qkv(0, 1, 2, 32, 16)
    got = t_ring.make_ring_attention(cpu_mesh(n))(*map(torch.from_numpy, arrays))
    want = j_ring.make_ring_attention(j_make_mesh(seq=n))(*map(jnp.asarray, arrays))
    close(got, want)


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("cross,self_attention", ABLATIONS)
def test_ring_concept_attention_matches_jax(n, cross, self_attention):
    """[txt 6 | img 18 | concept 3 | pad 5] over N chunks; padded rows (and
    concept rows with both ablations off) exactly zero."""
    t, p, c = 6, 18, 3
    arrays = qkv(10, 1, 2, 32, 16)
    got = t_ring.make_ring_concept_attention(cpu_mesh(n), "seq", t, p, c, cross, self_attention)(
        *map(torch.from_numpy, arrays))
    want = j_ring.make_ring_concept_attention(j_make_mesh(seq=n), "seq", t, p, c, cross,
                                              self_attention)(*map(jnp.asarray, arrays))
    close(got, want)
    seen_by_nothing = t + p + (c if (cross or self_attention) else 0)
    assert not got[:, :, seen_by_nothing:].any()


@pytest.mark.parametrize("case", ["padded", "bf16", "concepts split", "unmasked"])
def test_ring_rdma_matches_jax_interpret(case):
    """K4's wrapper on CPU tensors (its plain version) against the JAX kernel
    in interpret mode on the virtual mesh."""
    n, s = 4, 32
    segs = {"padded": (6, 18, 3), "bf16": (6, 18, 3), "concepts split": (4, 10, 6)}.get(case)
    arrays = qkv(20, 1, 2, s, 16)
    t_in = [torch.from_numpy(a) for a in arrays]
    j_in = [jnp.asarray(a) for a in arrays]
    tol = ATTN
    if case == "bf16":
        t_in, j_in = [x.bfloat16() for x in t_in], [x.astype(jnp.bfloat16) for x in j_in]
        tol = dict(rtol=0, atol=2e-2)
    if segs is None:
        got = t_rdma.make_ring_attention_rdma(cpu_mesh(n))(*t_in)
        want = j_rdma.make_ring_attention_rdma(j_make_mesh(seq=n), "seq", interpret=True)(*j_in)
    else:
        got = t_rdma.make_ring_concept_attention_rdma(cpu_mesh(n), "seq", *segs)(*t_in)
        want = j_rdma.make_ring_concept_attention_rdma(
            j_make_mesh(seq=n), "seq", *segs, interpret=True)(*j_in)
        assert not got[:, :, sum(segs):].any()  # padded rows exactly zero
    assert got.dtype == t_in[0].dtype
    close(got, np.asarray(want, np.float32), tol=tol)


# (case, N, cross, self_attention, S, (txt, img, concept) or None unmasked):
# S = 24 splits into chunks of 12, 8 and 6 with the concepts split across
# chunks 2 and 3 at N = 4; the ragged cases have odd chunks (7 rows) that
# end inside a segment, concepts across a chunk boundary and pad rows.
STEP_CASES = (
    [("unmasked", n, True, True, 24, None) for n in (2, 3, 4)]
    + [("masked", n, cross, self_attention, 24, (5, 11, 3)) for n in (2, 3, 4)
       for cross, self_attention in ABLATIONS]
    + [("ragged", 3, True, True, 21, (4, 10, 3)), ("ragged", 4, False, True, 28, (3, 15, 6))]
)


@pytest.mark.parametrize("case,n,cross,self_attention,s,segs", STEP_CASES)
def test_ring_step_fold_matches_ring_and_jax(case, n, cross, self_attention, s, segs):
    """K4's step function `ring_step_plain`, folded over the N steps (rank my
    takes the chunk of rank (my - step) mod N), equals `ring_attention_rdma_plain`
    and the JAX kernel in interpret mode; the wrapper `ring_step` on CPU
    buffers folds to the same and launches nothing."""
    lc, d = s // n, 16
    arrays = qkv(80, 1, 2, s, d)
    q, k, v = (torch.from_numpy(a) for a in arrays)
    qs, ks, vs = ([x[:, :, r * lc:(r + 1) * lc].contiguous() for r in range(n)] for x in (q, k, v))
    kw = dict(masked=segs is not None, cross=cross, self_attention=self_attention)
    if segs is not None:
        kw.update(txt_len=segs[0], img_len=segs[1], concept_len=segs[2])
    state = [None] * n
    for step in range(n):
        for my in range(n):
            src = (my - step) % n
            state[my] = t_rdma.ring_step_plain(qs[my], ks[src], vs[src], state[my], my, step, n, **kw)
    got = torch.cat(state, dim=2)
    close(got, torch.cat(t_rdma.ring_attention_rdma_plain(qs, ks, vs, **kw), dim=2))
    if segs is None:
        want = j_rdma.make_ring_attention_rdma(j_make_mesh(seq=n), "seq", interpret=True)(
            *map(jnp.asarray, arrays))
    else:
        want = j_rdma.make_ring_concept_attention_rdma(
            j_make_mesh(seq=n), "seq", *segs, cross, self_attention, interpret=True)(
            *map(jnp.asarray, arrays))
        seen_by_nothing = sum(segs[:2]) + (segs[2] if (cross or self_attention) else 0)
        assert not got[:, :, seen_by_nothing:].any()
    close(got, want)

    counters = (t_rdma.ring_attention_rdma.launches, t_rdma.ring_attention_rdma.step_launches,
                t_rdma.ring_attention_rdma.hopper_step_launches)
    b, h = q.shape[:2]
    accs = [torch.full((b, h, lc, d), float("nan")) for _ in range(n)]
    mls = [torch.full((b, h, lc, 2), float("nan")) for _ in range(n)]
    outs = [torch.full((b, h, lc, d), float("nan")) for _ in range(n)]
    for step in range(n):
        held = [(r - step) % n for r in range(n)]
        t_rdma.ring_step(qs, [ks[i] for i in held], [vs[i] for i in held], accs, mls, outs,
                         list(range(n)), n, step, **kw)
    close(torch.cat(outs, dim=2), got)
    assert (t_rdma.ring_attention_rdma.launches, t_rdma.ring_attention_rdma.step_launches,
            t_rdma.ring_attention_rdma.hopper_step_launches) == counters


@pytest.mark.parametrize("d,instance", [(32, "mma_sync"), (64, "hopper"), (128, "hopper")])
def test_ring_instance(d, instance):
    """The flux (128) and CogVideoX (64) head dims take the Hopper step
    kernel; head dim 32 stays on mma.sync."""
    assert t_rdma.ring_instance(d) == instance


def attention_inputs(seed, b=1, h=2, t=6, p=16, c=3, d=8):
    """Per-segment (q, k, v) and real RoPE tables over an image row of p
    positions, as numpy."""
    arrays = [rand(seed + i, b, h, n, d) for i, n in enumerate([t] * 3 + [p] * 3 + [c] * 3)]
    img_ids = np.tile(np.arange(p, dtype=np.float32)[None, :, None], (b, 1, 3))
    ids = [np.concatenate([np.zeros((b, n, 3), np.float32), img_ids], 1) for n in (t, c)]
    return arrays, ids


@pytest.mark.parametrize("backend,jax_backend", [("ring", "ring"), ("ring_rdma", "ring_rdma_interpret")])
@pytest.mark.parametrize("cross,self_attention", [(True, True), (False, False)])
def test_joint_concept_attention_ring_backends(backend, jax_backend, cross, self_attention):
    """`joint_concept_attention` on a ring of 4: merged outputs and extras
    against the JAX backend of the same name (the interpret-mode kernel for
    "ring_rdma", as `TestRingRdmaBackend` runs it); with both ablations off
    the concept stream passes its values through."""
    arrays, ids = attention_inputs(30)
    axes = (2, 2, 4)
    t_segs = [tuple(torch.from_numpy(a) for a in arrays[i:i + 3]) for i in (0, 3, 6)]
    j_segs = [tuple(jnp.asarray(a) for a in arrays[i:i + 3]) for i in (0, 3, 6)]
    t_pe = [t_embed_nd(torch.from_numpy(x), axes, 100) for x in ids]
    j_pe = [j_embed_nd(jnp.asarray(x), axes, 100) for x in ids]
    got = t_attn.joint_concept_attention(
        *t_segs, *t_pe, t_attn.ConceptAttentionSpec(cross_attention=cross,
                                                    self_attention=self_attention,
                                                    backend=backend, mesh=cpu_mesh(4)))
    want = j_attn.joint_concept_attention(
        *j_segs, *j_pe, j_attn.ConceptAttentionSpec(cross_attention=cross,
                                                    self_attention=self_attention,
                                                    backend=jax_backend, mesh=j_make_mesh(seq=4)))
    for g, w, name in zip(got[:3], want[:3], ("txt", "img", "concept")):
        close(g, w, tol=dict(rtol=0, atol=5e-5), msg=name)
    for key in ("concept_out_h", "img_out_h", "concept_v"):
        close(got[3][key], want[3][key], tol=dict(rtol=0, atol=5e-5), msg=key)


FLUX_SMALL = dict(in_channels=4, vec_in_dim=8, context_in_dim=8, hidden_size=32, mlp_ratio=2.0,
                  num_heads=2, depth=2, depth_single_blocks=1, axes_dim=(4, 6, 6), qkv_bias=True,
                  guidance_embed=False)


@pytest.mark.parametrize("backend", ["ring", "ring_rdma"])
def test_flux_forward_ring_matches_jax(backend):
    """The flux DiT with its double blocks on a ring of 4 (single blocks on
    the plain path, as in JAX): against the JAX ring forward and against the
    port's own sdpa forward."""
    j_cfg, t_cfg = JFluxConfig(**FLUX_SMALL), TFluxConfig(**FLUX_SMALL)
    j_params = init_flux_params(jax.random.PRNGKey(0), j_cfg, jnp.float32)
    t_params = params_from_numpy(jax.tree.map(np.asarray, j_params))
    b, p_tok, t_tok, c_tok = 1, 16, 4, 3
    inputs = dict(
        img=rand(40, b, p_tok, 4), img_ids=np.array(j_img_ids(4, 4, b)),
        txt=rand(41, b, t_tok, 8), txt_ids=np.zeros((b, t_tok, 3), np.float32),
        timesteps=np.array([0.5], np.float32), y=rand(42, b, 8),
        concepts=rand(43, b, c_tok, 8), concept_ids=np.zeros((b, c_tok, 3), np.float32),
        concept_vec=rand(44, b, 8),
    )
    t_in = {k: torch.from_numpy(v) for k, v in inputs.items()}
    got_pred, got_sal = t_flux_forward(
        t_params, t_cfg, spec=t_attn.ConceptAttentionSpec(backend=backend, mesh=cpu_mesh(4)), **t_in)
    ref_pred, ref_sal = t_flux_forward(t_params, t_cfg, spec=t_attn.ConceptAttentionSpec(backend="sdpa"),
                                       **t_in)
    j_spec = j_attn.ConceptAttentionSpec(backend="ring", mesh=j_make_mesh(seq=4))
    want_pred, want_sal = jax.jit(lambda kw: j_flux_forward(j_params, j_cfg, spec=j_spec, **kw))(
        {k: jnp.asarray(v) for k, v in inputs.items()})
    close(got_pred, want_pred, tol=FWD, msg="pred")
    close(got_pred, ref_pred.numpy(), tol=FWD, msg="pred vs sdpa")
    assert set(got_sal) == set(want_sal) == {"output", "cross_attention"}
    for tap in got_sal:
        close(got_sal[tap], want_sal[tap], tol=FWD, msg=tap)
        close(got_sal[tap], ref_sal[tap].numpy(), tol=FWD, msg=f"{tap} vs sdpa")


VIDEO_TINY = dict(num_attention_heads=2, attention_head_dim=16, in_channels=4, out_channels=4,
                  time_embed_dim=8, text_embed_dim=16, num_layers=2, sample_width=8,
                  sample_height=8, sample_frames=9, patch_size=2, max_text_seq_length=6,
                  use_rotary_positional_embeddings=True)


def test_video_forward_ring_rdma_matches_jax():
    """The CogVideoX DiT with `ring_rdma` on a ring of 4 against the JAX
    ring forward and the port's sdpa forward (CFG batch 2, 6 text tokens,
    48 video tokens, 6 concept slots: S = 60 over 4 chunks of 15)."""
    t_cfg, j_cfg = t_vdit.CogVideoXConfig(**VIDEO_TINY), j_vdit.CogVideoXConfig(**VIDEO_TINY)
    j_params = j_vdit.init_video_dit_params(jax.random.PRNGKey(0), j_cfg, jnp.float32)
    t_params = params_from_numpy(jax.tree.map(np.asarray, j_params))
    args = [rand(50, 2, 3, 4, 8, 8), rand(51, 2, 6, 16), np.array([999.0, 500.0], np.float32)]
    concepts = rand(52, 2, 6, 16)
    t_args = [torch.from_numpy(a) for a in args]
    got_pred, got_sal = t_vdit.video_dit_forward(
        t_params, t_cfg, *t_args, concepts=torch.from_numpy(concepts),
        spec=t_attn.ConceptAttentionSpec(backend="ring_rdma", mesh=cpu_mesh(4)))
    ref_pred, ref_sal = t_vdit.video_dit_forward(
        t_params, t_cfg, *t_args, concepts=torch.from_numpy(concepts),
        spec=t_attn.ConceptAttentionSpec(backend="sdpa"))
    j_spec = j_attn.ConceptAttentionSpec(backend="ring", mesh=j_make_mesh(seq=4))
    want_pred, want_sal = jax.jit(
        lambda *a: j_vdit.video_dit_forward(j_params, j_cfg, *a[:3], concepts=a[3], spec=j_spec))(
        *(jnp.asarray(a) for a in args), jnp.asarray(concepts))
    close(got_pred, want_pred, tol=FWD, msg="pred")
    close(got_pred, ref_pred.numpy(), tol=FWD, msg="pred vs sdpa")
    for tap in ("output", "cross_attention"):
        close(got_sal[tap], want_sal[tap], tol=FWD, msg=tap)
        close(got_sal[tap], ref_sal[tap].numpy(), tol=FWD, msg=f"{tap} vs sdpa")


PROMPT, CONCEPTS, SIZE, STEPS = "a dragon on a rock", ["dragon", "rock", "sky"], 32, 2


@pytest.fixture(scope="module")
def pipes():
    """The JAX pipeline with `make_mesh(seq=4)` and the "ring" backend (the
    ppermute ring keeps the run short; the interpret-mode kernel is covered
    above), and the port's with a CPU ring of 4 and "ring_rdma", on the same
    flux-tiny weights."""
    j = JaxPipeline("flux-tiny", dtype=jnp.float32, mesh=j_make_mesh(seq=4),
                    attention_backend="ring")
    params = jax.tree.map(np.asarray, j.params)
    ae_params = jax.tree.map(np.asarray, j.ae_params)
    t = TorchPipeline("flux-tiny", dtype=torch.float32, mesh=cpu_mesh(4),
                      attention_backend="ring_rdma", params=params_from_numpy(params),
                      ae_params=params_from_numpy(ae_params))
    fused = TorchPipeline("flux-tiny", dtype=torch.float32, device="cpu",
                          params=params_from_numpy(params), ae_params=params_from_numpy(ae_params))
    return t, j, fused


def test_pipeline_ring_stages_match_jax(pipes):
    """The denoise (with injected numpy noise) and the encode forward of the
    port's ring_rdma pipeline against the JAX pipeline's ring, then the
    heatmap reduction."""
    t, j, _ = pipes
    assert t.attention_spec.mesh is t.mesh and t.device == CPU
    noise = rand(60, 1, t.spec.ae_params.z_channels, SIZE // t.vae_factor, SIZE // t.vae_factor)
    grid = (noise.shape[2] // 2, noise.shape[3] // 2)
    schedule = get_schedule(STEPS, grid[0] * grid[1], shift=False)
    txt, txt_ids, vec = t._prepare_text(PROMPT)
    c_emb, c_ids, c_vec = t._prepare_concepts(CONCEPTS)
    t_lat, t_sal = t_flow.denoise(
        t.params, t.cfg, t_pack(torch.from_numpy(noise)), t_img_ids(*grid, 1), txt, txt_ids, vec,
        schedule, 0.0, concepts=c_emb, concept_ids=c_ids, concept_vec=c_vec, spec=t.attention_spec)
    t_enc = t_pipe._encode_forward(
        t.params, t.cfg, t_pack(torch.from_numpy(noise)), t_img_ids(*grid, 1), txt, txt_ids,
        c_vec, c_emb, c_ids, c_vec, torch.full((1,), 0.5), t.attention_spec)
    txt, txt_ids, vec = j._prepare_text(PROMPT)
    c_emb, c_ids, c_vec = j._prepare_concepts(CONCEPTS)
    j_lat, j_sal = j_pipe._generate_latents(
        j.params, j.cfg, j_pack(jnp.asarray(noise)), j_img_ids(*grid, 1), txt, txt_ids, vec,
        c_emb, c_ids, c_vec, jnp.asarray(schedule), 0.0, j._attention_spec(), j.cfg.guidance_embed)
    j_enc = j_pipe._encode_forward(
        j.params, j.cfg, j_pack(jnp.asarray(noise)), j_img_ids(*grid, 1), txt, txt_ids, c_vec,
        c_emb, c_ids, c_vec, jnp.full((1,), 0.5, jnp.float32), j._attention_spec())
    close(t_lat, j_lat, tol=FWD, msg="latents")
    for tap in ("output", "cross_attention"):
        close(t_sal[tap], j_sal[tap], tol=FWD, msg=tap)
        close(t_enc[tap], j_enc[tap], tol=FWD, msg=f"encode {tap}")
        got = t_heat.reduce_maps(t_sal[tap], [0, 1], None, True, "sparsemax", grid)
        want = j_heat.reduce_maps(j_sal[tap], [0, 1], None, True, "sparsemax", grid)
        close(got, want, tol=FWD, msg=f"maps {tap}")


def test_pipeline_ring_entry_points(pipes):
    """`generate_image` and `encode_image` through the ring_rdma pipeline:
    heatmaps equal the fused pipeline's on the same weights and seed (the
    noise draws are the port's own), and no kernel launches on the CPU."""
    t, _, fused = pipes
    before = (t_rdma.ring_attention_rdma.launches, t_rdma.ring_attention_rdma.step_launches)
    kw = dict(width=SIZE, height=SIZE, return_pil_heatmaps=False)
    gen = t.generate_image(PROMPT, CONCEPTS, num_inference_steps=STEPS, return_image_array=True, **kw)
    gen_ref = fused.generate_image(PROMPT, CONCEPTS, num_inference_steps=STEPS,
                                   return_image_array=True, **kw)
    image = np.random.default_rng(61).integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)
    enc, enc_ref = (p.encode_image(image, CONCEPTS, **kw) for p in (t, fused))
    for got, want in ((gen, gen_ref), (enc, enc_ref)):
        for maps in ("concept_heatmaps", "cross_attention_maps"):
            assert np.isfinite(getattr(got, maps)).all()
            close(getattr(got, maps), getattr(want, maps), tol=FWD, msg=maps)
    assert np.abs(gen.image.astype(int) - gen_ref.image.astype(int)).max() <= 1
    assert (t_rdma.ring_attention_rdma.launches, t_rdma.ring_attention_rdma.step_launches) == before


@pytest.mark.parametrize("case", ["other axis", "batch_axis", "head_axis", "int8_qk",
                                  "no mesh (spec)", "no mesh (pipeline)", "int8_qk (pipeline)",
                                  "device and mesh", "too few devices", "no card"])
def test_refusals(case):
    """What the ring path does not take raises, as in the JAX package. The
    mesh's other axes and the dp x sp x tp ring (`batch_axis` / `head_axis`)
    are ported: a mesh with any axis beside `seq` has JAX's shape, and the
    composed ring equals the seq ring over the whole batch and heads, while
    a batch or head count that does not split over its axis raises."""
    arrays, ids = attention_inputs(70, b=2)
    segs = [tuple(torch.from_numpy(a) for a in arrays[i:i + 3]) for i in (0, 3, 6)]
    pes = [t_embed_nd(torch.from_numpy(x), (2, 2, 4), 100) for x in ids]

    def attend(segs=segs, pes=pes, **spec):
        return t_attn.joint_concept_attention(*segs, *pes, t_attn.ConceptAttentionSpec(**spec))

    if case == "other axis":
        for axis in ("data", "model", "pipe", "expert"):
            mesh = t_make_mesh(seq=2, devices=[CPU] * 8, **{axis: 2})
            assert mesh.shape == dict(j_make_mesh(seq=2, **{axis: 2}).shape)
    elif case in ("batch_axis", "head_axis"):
        axis = "data" if case == "batch_axis" else "model"
        mesh = t_make_mesh(seq=2, devices=[CPU] * 4, **{axis: 2})
        want = attend(backend="ring_rdma", mesh=cpu_mesh(2))
        got = attend(backend="ring_rdma", mesh=mesh, **{case: axis})
        for g, w in zip(got[:3], want[:3]):
            close(g, w)
        one_row = [tuple(x[:1] for x in seg) for seg in segs]
        one_pe = [tuple(x[:1] for x in pe) for pe in pes]
        with pytest.raises(ValueError, match="does not split"):
            if case == "batch_axis":
                attend(one_row, one_pe, backend="ring_rdma", mesh=mesh, batch_axis=axis)
            else:
                attend(backend="ring_rdma", mesh=t_make_mesh(seq=2, model=4, devices=[CPU] * 8),
                       head_axis="model")
    elif case == "int8_qk":
        for backend in ("ring", "ring_rdma"):
            with pytest.raises(ValueError, match="int8_qk"):
                attend(backend=backend, mesh=cpu_mesh(2), int8_qk=True)
    elif case == "no mesh (spec)":
        with pytest.raises(ValueError, match="mesh"):
            attend(backend="ring_rdma")
    elif case == "no mesh (pipeline)":
        with pytest.raises(ValueError, match="mesh"):
            TorchPipeline("flux-tiny", device="cpu", attention_backend="ring_rdma")
    elif case == "int8_qk (pipeline)":
        with pytest.raises(ValueError, match="int8_qk"):
            TorchPipeline("flux-tiny", mesh=cpu_mesh(2), attention_backend="ring", int8_qk=True)
    elif case == "device and mesh":
        with pytest.raises(ValueError, match="not both"):
            TorchPipeline("flux-tiny", device="cpu", mesh=cpu_mesh(2), attention_backend="ring")
    elif case == "too few devices":
        with pytest.raises(ValueError, match="needs 4 devices"):
            t_make_mesh(seq=4, devices=[CPU] * 3)
    else:
        if torch.cuda.is_available():
            pytest.skip("a CUDA card is present: make_mesh() takes it")
        with pytest.raises(RuntimeError, match="CUDA"):
            t_make_mesh(seq=2)


def test_mesh_shape_and_devices():
    mesh = cpu_mesh(4)
    assert mesh.shape == {"data": 1, "pipe": 1, "expert": 1, "seq": 4, "model": 1}
    assert mesh.axis_devices("seq") == [CPU] * 4
    assert list(mesh.shape) == list(j_make_mesh(seq=4).shape)


def test_ring_modules_import_no_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys, conceptattention_torch.parallel.ring_attention, "
            "conceptattention_torch.kernels.ring_rdma; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
            "'conceptattention_tpu')]; print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=root)
    assert proc.returncode == 0, proc.stdout + proc.stderr
