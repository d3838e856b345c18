"""The port's profiling utilities against the JAX package's, on the CPU.

`loop_rate`, `PhaseTimer` and `device_trace` are held to their structure
(positive seconds, phase names, a trace file) and never to a ratio of two
timings, which a shared host makes flaky. `compiled_cost` is held to JAX's
cost analysis of the same matmul chain, whose FLOPs both count as 2 m n k a
product (exact), and to the formula of the plain double block's products.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conceptattention_torch.config import FluxConfig
from conceptattention_torch.models.flux import blocks as t_blocks
from conceptattention_torch.models.flux.params import init_flux_params, layer
from conceptattention_torch.ops.attention import ConceptAttentionSpec
from conceptattention_torch.ops.rope import embed_nd
from conceptattention_torch.utils import profiling as t_prof
from conceptattention_tpu.utils import profiling as j_prof

torch.set_num_threads(2)  # six test workers share the host's cores


def test_loop_rate_is_seconds_per_call_and_perturbs_each_call():
    seen = []

    def fn(x, y):
        seen.append(float(x[0, 0]))
        return x @ y

    x, y = torch.ones(64, 64), torch.randn(64, 64)
    rate = t_prof.loop_rate(fn, x, y, iters=4)
    assert rate > 0 and np.isfinite(rate)
    # the warm call, then 4 calls on x * (1 + i/64)
    assert seen == [1.0] + [1.0 + i / 64 for i in range(4)]
    calls = []
    t_prof.loop_rate(lambda a: calls.append(a), torch.zeros(2), iters=3,
                     perturb=lambda i, a: (a[0] + i,))
    assert [float(c[0]) for c in calls] == [0.0, 0.0, 1.0, 2.0]
    # JAX's loop_rate keeps the signature and returns seconds per call too
    j_rate = j_prof.loop_rate(lambda a, b: a @ b, jnp.ones((64, 64)), jnp.ones((64, 64)), iters=2)
    assert j_rate > 0


def test_phase_timer_accumulates_named_phases():
    timer = t_prof.PhaseTimer()
    for _ in range(2):
        with timer.phase("matmul") as ph:
            ph.fence(torch.randn(32, 32) @ torch.randn(32, 32))
    with timer.phase("sum", fence={"a": [torch.ones(3)]}):
        torch.ones(3).sum()
    assert list(timer.times) == ["matmul", "sum"]
    assert all(v > 0 for v in timer.times.values())
    report = timer.report().splitlines()
    assert [line.split(":")[0] for line in report] == ["matmul", "sum"]
    j_timer = j_prof.PhaseTimer()
    with j_timer.phase("matmul") as ph:
        ph.fence(jnp.ones((4, 4)) @ jnp.ones((4, 4)))
    assert list(j_timer.times) == ["matmul"]


def test_compiled_cost_counts_flops_as_jax_does():
    a, b, c = (np.random.default_rng(i).standard_normal(s).astype(np.float32)
               for i, s in enumerate([(16, 32), (32, 24), (24, 8)]))

    def chain(x, y, z):
        return (x @ y) @ z

    got = t_prof.compiled_cost(chain, *(torch.from_numpy(v) for v in (a, b, c)))
    want = j_prof.compiled_cost(chain, *(jnp.asarray(v) for v in (a, b, c)))
    assert got["flops"] == 2 * (16 * 32 * 24 + 16 * 24 * 8) == want["flops"]
    assert got["bytes_accessed"] is None


def test_compiled_cost_of_the_plain_double_block_is_its_products():
    """The plain (sdpa) double block's FLOPs are those of its matmuls:
    modulations, projections, MLPs, the joint and concept attention and the
    two saliency maps, counted from the shapes."""
    cfg = FluxConfig(in_channels=4, vec_in_dim=8, context_in_dim=8, hidden_size=32, mlp_ratio=2.0,
                     num_heads=2, depth=1, depth_single_blocks=1, axes_dim=(4, 6, 6),
                     qkv_bias=True, guidance_embed=False)
    p = layer(init_flux_params(torch.Generator().manual_seed(0), cfg, torch.float32)["double"], 0)
    b, t, n_img, c, d = 1, 4, 8, 3, cfg.hidden_size
    g = torch.Generator().manual_seed(1)
    img, txt, con = (torch.randn(b, n, d, generator=g) for n in (n_img, t, c))
    vec, cvec = torch.randn(b, d, generator=g), torch.randn(b, d, generator=g)
    ids = torch.arange(t + n_img, dtype=torch.float32)[None, :, None].repeat(b, 1, 3)
    cids = torch.arange(c + n_img, dtype=torch.float32)[None, :, None].repeat(b, 1, 3)
    pe, cpe = embed_nd(ids, cfg.axes_dim, cfg.theta), embed_nd(cids, cfg.axes_dim, cfg.theta)
    cost = t_prof.compiled_cost(
        t_blocks.double_block, p, img, txt, vec, pe, cfg.num_heads, concepts=con, concept_vec=cvec,
        concept_pe=cpe, spec=ConceptAttentionSpec(backend="sdpa"))
    assert cost["flops"] == double_block_flops(b, t, n_img, c, d, cfg.mlp_hidden_dim)


def double_block_flops(b, t, p, c, d, m):
    """2 FLOPs a multiply-add over the plain double block's products."""
    tokens = b * (t + p + c)
    linear = tokens * (3 * d + d + 2 * m) * d  # qkv, proj, mlp in and out
    modulation = 3 * b * 6 * d * d  # img, txt, concept
    joint = 2 * b * (t + p) ** 2 * d  # scores and values over every head
    concept = 2 * b * (c + p) ** 2 * d  # the plain path attends [concept; img] whole
    maps = 2 * b * c * p * d  # "output" and "cross_attention"
    return 2 * (linear + modulation + joint + concept + maps)


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with t_prof.device_trace(str(tmp_path)) as prof:
        torch.randn(64, 64) @ torch.randn(64, 64)
    with open(os.path.join(tmp_path, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert prof.key_averages()


def test_device_trace_refuses_a_card_trace_without_kernels(tmp_path, monkeypatch):
    """Where the card is traced, a trace with no kernel event raises rather
    than passing an empty device trace on. The CPU build cannot trace a
    card: a profiler that drops the CUDA activity stands in for a card
    session that recorded nothing."""
    real = torch.profiler.profile

    def recording_nothing_on_the_card(activities, **kw):
        assert torch.profiler.ProfilerActivity.CUDA in activities
        return real(activities=[a for a in activities
                                if a != torch.profiler.ProfilerActivity.CUDA], **kw)

    monkeypatch.setattr(t_prof.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.profiler, "profile", recording_nothing_on_the_card)
    monkeypatch.setattr(t_prof, "_prologue", lambda: None)  # its kernels need the card
    with pytest.raises(RuntimeError, match="left no kernel event"):
        with t_prof.device_trace(str(tmp_path)):
            torch.randn(64, 64) @ torch.randn(64, 64)
    assert t_prof.kernel_events(os.path.join(tmp_path, "trace.json")) == 0
