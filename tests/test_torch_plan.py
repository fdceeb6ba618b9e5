"""The port's planner and lowering held to the JAX package's, array for array.

The same UViT or Hunyuan-DiT configuration goes through both packages' block graph,
skip-aware partition, schedule synthesis, stage layout and step-table
lowering (``auto_pipeline`` with the pipeline degree pinned); every
partition cut, placement, layout table, ``StepTables`` array and liveness
window must be equal.  The port's tables are also certified by the JAX
package's jax-free dataflow proof (``repro.analysis``), which only the test
imports.
"""
import dataclasses

import numpy as np
import pytest

from repro.analysis.certificate import certify_tables
from repro.configs import hunyuan_dit as jax_hunyuan_dit
from repro.configs import uvit_h as jax_uvit_h
from repro.core import hw as jax_hw
from repro.core.profiler import analytic_block_costs as jax_costs
from repro.models.diffusion import HunyuanDiTConfig as JaxHunyuanDiTConfig
from repro.models.diffusion import UViTConfig as JaxUViTConfig
from repro.models.diffusion import hunyuan_pipeline_graph as jax_hunyuan_graph
from repro.models.diffusion import uvit_pipeline_graph as jax_graph
from repro.runtime.adapters import diffusion_model_fns as jax_model_fns
from repro.runtime.compile import auto_pipeline as jax_auto_pipeline
from repro_torch.configs import hunyuan_dit as torch_hunyuan_dit
from repro_torch.configs import uvit_h as torch_uvit_h
from repro_torch.core import hw as torch_hw
from repro_torch.core.profiler import analytic_block_costs as torch_costs
from repro_torch.models.diffusion import HunyuanDiTConfig, UViTConfig
from repro_torch.models.diffusion import \
    hunyuan_pipeline_graph as torch_hunyuan_graph
from repro_torch.models.diffusion import uvit_pipeline_graph as torch_graph
from repro_torch.runtime.adapters import diffusion_model_fns
from repro_torch.runtime.compile import auto_pipeline
from repro_torch.runtime.schedule_exec import StepTables

UNEVEN_8 = [3, 1, 1, 1, 1, 1, 1, 3]
UNEVEN_16 = [3] + [1] * 14 + [3]

# (n_layers, D, V, fwd_times, M, use_ilp); n_layers "uvit-h" is the
# full-width UViT-2.7B the trainer's --arch uvit-h plans (nothing is built)
PLANS = {
    "D2-even": (8, 2, 1, None, 4, False),
    "D2-uneven": (8, 2, 1, UNEVEN_8, 4, False),
    "D4-even": (16, 4, 1, None, 8, False),
    "D4-uneven": (16, 4, 1, UNEVEN_16, 8, False),
    "D4-short": (8, 4, 1, None, 3, False),        # M < D
    "D2-V2-even": (8, 2, 2, None, 4, False),
    "D2-V2-uneven": (16, 2, 2, UNEVEN_16, 4, False),
    "D4-V2-even": (16, 4, 2, None, 4, False),
    "D2-ilp": (8, 2, 1, None, 2, True),
    "uvit-h-D2": ("uvit-h", 2, 1, None, 8, False),
    "uvit-h-D4": ("uvit-h", 4, 1, None, 8, False),
    "uvit-h-D8": ("uvit-h", 8, 1, None, 8, False),
    "uvit-h-D4-V2": ("uvit-h", 4, 2, None, 8, False),
}


def _cfgs(n_layers):
    if n_layers == "uvit-h":
        return jax_uvit_h.CFG, torch_uvit_h.CFG
    kw = dict(img_size=8, in_ch=4, patch=2, d_model=32, n_layers=n_layers,
              n_heads=4, d_ff=64, n_classes=10)
    return JaxUViTConfig("t", **kw), UViTConfig("t", **kw)


# the JAX package's default hardware, carried into the port's record so
# both planners cost the graph identically
TPU = torch_hw.Hardware(**dataclasses.asdict(jax_hw.TPU_V5E))


def _both(name):
    n_layers, D, V, ft, M, ilp = PLANS[name]
    jcfg, tcfg = _cfgs(n_layers)
    jg = jax_graph(jcfg, batch=2, fwd_times=ft, hw=jax_hw.TPU_V5E)
    tg = torch_graph(tcfg, batch=2, fwd_times=ft, hw=TPU)
    kw = dict(pipeline_devices=D, microbatches=M, lam=0.0, interleave=V,
              use_ilp=ilp)
    jcp = jax_auto_pipeline(jg, jax_model_fns(jcfg, "uvit"), D,
                            jax_hw.TPU_V5E, **kw)
    tcp = auto_pipeline(tg, diffusion_model_fns(tcfg, "uvit"), D,
                        TPU, **kw)
    return jg, tg, jcp, tcp


def _assert_plans_equal(jg, tg, jcp, tcp):
    assert [dataclasses.astuple(b) for b in tg.blocks] == \
        [dataclasses.astuple(b) for b in jg.blocks]
    assert [dataclasses.astuple(e) for e in tg.skips] == \
        [dataclasses.astuple(e) for e in jg.skips]

    jp, tp = jcp.partition, tcp.partition
    assert (tp.cuts, tp.devices, tp.folded, tp.num_stages) == \
        (jp.cuts, jp.devices, jp.folded, jp.num_stages)

    key = lambda p: (p.virtual, p.microbatch, p.device, p.step)
    assert sorted(map(key, tcp.schedule.placements)) == \
        sorted(map(key, jcp.schedule.placements))

    for f in ("enc_slots", "dec_slots", "enc_counts", "dec_counts",
              "enc_pad", "dec_pad", "skip_rows"):
        assert getattr(tcp.layout, f) == getattr(jcp.layout, f), f
    assert tcp.layout.skip_consumers() == jcp.layout.skip_consumers()

    jt, tt = jcp.step_tables(), tcp.step_tables()
    for f in dataclasses.fields(StepTables):
        a, b = getattr(tt, f.name), getattr(jt, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    assert (tt.W_down, tt.W_up, tt.W_turn, tt.W_skip) == \
        (jt.W_down, jt.W_up, jt.W_turn, jt.W_skip)

    cert = certify_tables(tt, skip_consumers=tcp.layout.skip_consumers(),
                          overlap=True,
                          wire_dtype=tcp.pcfg.wire_dtype)
    assert cert.ok, cert.violations


@pytest.mark.parametrize("name", sorted(PLANS))
def test_plan_and_step_tables_match_jax(name):
    jg, tg, jcp, tcp = _both(name)
    _assert_plans_equal(jg, tg, jcp, tcp)
    if PLANS[name][3] is not None and PLANS[name][2] == 1:
        assert len(set(tcp.layout.counts)) > 1, "uneven plan came out even"


# (cfg, D, V, M): "full" is Hunyuan-DiT-3B, the trainer's --arch
# hunyuan-dit; "small" the JAX package's wave-hunyuan differential config
HUNYUAN_PLANS = {
    "hunyuan-D2": ("full", 2, 1, 8),
    "hunyuan-D4": ("full", 4, 1, 8),
    "hunyuan-D8": ("full", 8, 1, 8),
    "hunyuan-D4-V2": ("full", 4, 2, 8),
    "hunyuan-small-D2": ("small", 2, 1, 4),
    "hunyuan-small-D4": ("small", 4, 1, 4),
}


@pytest.mark.parametrize("name", sorted(HUNYUAN_PLANS))
def test_hunyuan_plan_and_step_tables_match_jax(name):
    size, D, V, M = HUNYUAN_PLANS[name]
    if size == "full":
        jcfg, tcfg = jax_hunyuan_dit.CFG, torch_hunyuan_dit.CFG
    else:
        kw = dict(img_size=8, in_ch=4, patch=2, d_model=32, n_layers=8,
                  n_heads=4, d_ff=64, ctx_dim=16, ctx_len=4)
        jcfg, tcfg = JaxHunyuanDiTConfig("t", **kw), HunyuanDiTConfig("t",
                                                                      **kw)
    jg = jax_hunyuan_graph(jcfg, batch=2, hw=jax_hw.TPU_V5E)
    tg = torch_hunyuan_graph(tcfg, batch=2, hw=TPU)
    kw = dict(pipeline_devices=D, microbatches=M, lam=0.0, interleave=V)
    jcp = jax_auto_pipeline(jg, jax_model_fns(jcfg, "hunyuan"), D,
                            jax_hw.TPU_V5E, **kw)
    tcp = auto_pipeline(tg, diffusion_model_fns(tcfg, "hunyuan"), D, TPU,
                        **kw)
    assert tcp.partition.num_stages == 2 * V * D
    _assert_plans_equal(jg, tg, jcp, tcp)


def test_h100_preset_and_block_costs():
    h = torch_hw.H100_SXM
    assert (h.peak_flops, h.hbm_bw, h.intra_bw, h.mem_limit) == \
        (989e12, 3.35e12, 450e9, 80e9)
    assert torch_hw.PRESETS["h100-sxm"] is h
    _, tcfg = _cfgs(8)
    jcfg, _ = _cfgs(8)
    # the copied roofline agrees with the JAX one under the same hardware
    jb = jax_costs(jax_graph(jcfg, batch=3).blocks, jax_hw.TPU_V5E)
    tb = torch_costs(torch_graph(tcfg, batch=3).blocks, TPU)
    assert [b.fwd_time for b in tb] == [b.fwd_time for b in jb]
    # and the port plans for the H100 by default
    g = torch_graph(tcfg, batch=3)
    assert g.blocks[0].fwd_time == pytest.approx(max(
        g.blocks[0].flops / h.peak_flops,
        (2 * g.blocks[0].param_bytes + 2 * g.blocks[0].act_bytes) / h.hbm_bw))


def test_unported_options_raise():
    jcfg, tcfg = _cfgs(8)
    g, fns = torch_graph(tcfg, hw=TPU), diffusion_model_fns(tcfg)
    jg, jfns = jax_graph(jcfg), jax_model_fns(jcfg)
    # on four devices the tuner's best plan is P=2 with two data-parallel
    # replicas (G=2): it plans, the JAX tuner's choice (on the same
    # hardware record), dp_size its G
    cp = auto_pipeline(g, fns, 4, TPU)
    jcp = jax_auto_pipeline(jg, jfns, 4, jax_hw.TPU_V5E)
    c, jc = cp.choice, jcp.choice
    assert (c.P, c.G, c.b, c.V, c.M, c.zero_stage) == (
        jc.P, jc.G, jc.b, jc.V, jc.M, jc.zero_stage)
    assert (c.P, c.G) == (2, 2) and cp.pcfg.dp_size == 2
    assert cp.state_spec() == jcp.state_spec() and cp.certify().ok
    # a pinned pipeline with two data replicas plans
    cp = auto_pipeline(g, fns, 4, TPU, pipeline_devices=2, dp_size=2)
    assert (cp.pcfg.dp_size, cp.pcfg.zero_stage) == (2, 0)
    # ZeRO over one replica drops to stage 0, as in the JAX package
    kw = dict(pipeline_devices=2, zero_stage=1)
    cp = auto_pipeline(g, fns, 2, TPU, **kw)
    jcp = jax_auto_pipeline(jg, jfns, 2, jax_hw.TPU_V5E, **kw)
    assert cp.pcfg.zero_stage == jcp.pcfg.zero_stage == 0
    assert cp.state_spec() == jcp.state_spec()
    # the closed-form executor is ported: the route plans and builds
    cp = auto_pipeline(g, fns, 2, pipeline_devices=2, executor="closed_form")
    assert cp.executor == "closed_form" and callable(cp.build())
