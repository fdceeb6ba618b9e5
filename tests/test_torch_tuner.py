"""The port's hybrid tuner, comm model, profiler and plan certificates held
to the JAX package's.

Both packages plan the same graphs with the same ``Hardware`` values (the
port's ``H100_SXM``, carried into the JAX package's record), so every
ranked ``tune`` list, Eq. 14 peak, Eq. 15 schedule time, comm volume and
certificate must agree: discrete fields exactly, floats at rel 1e-12.
Planning needs no parameters and no card.

The tuner-driven ``auto_pipeline`` (no ``pipeline_devices``) must pick the
JAX package's plan, or refuse it by name where that plan has G > 1; its
executor step, and the interleaved (V = 2) and ILP plans of the executor,
are held to the JAX executor run on two host devices in a subprocess
(``python tests/test_torch_tuner.py jax-executor OUT``) at fp32 wire,
rtol 1e-4.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.analysis as jax_analysis
from repro.analysis import certificate as jax_cert
from repro.analysis import dataflow as jax_dataflow
from repro.configs import hunyuan_dit as jax_hunyuan_dit
from repro.configs import sdv2_unet as jax_sdv2
from repro.configs import uvit_h as jax_uvit_h
from repro.core import comm_model as jcm
from repro.core import hw as jax_hw
from repro.core import profiler as jprof
from repro.core import tuner as jtu
from repro.core.partition import partition as jax_partition
from repro.core.schedule import schedule_for_partition as jax_schedule
from repro.models import diffusion as jdm
from repro.runtime.adapters import diffusion_model_fns as jax_model_fns
from repro.runtime.compile import auto_pipeline as jax_auto_pipeline
from repro.runtime.schedule_exec import StepTables as JaxStepTables
from repro_torch import analysis as port_analysis
from repro_torch.analysis import certificate as tcert
from repro_torch.analysis import dataflow as tdataflow
from repro_torch.configs import hunyuan_dit as torch_hunyuan_dit
from repro_torch.configs import sdv2_unet as torch_sdv2
from repro_torch.configs import uvit_h as torch_uvit_h
from repro_torch.convert import params_from_jax
from repro_torch.core import comm_model as tcm
from repro_torch.core import hw as torch_hw
from repro_torch.core import partition as tpart_mod
from repro_torch.core import profiler as tprof
from repro_torch.core import tuner as ttu
from repro_torch.core.schedule import comm_stats, schedule_for_partition
from repro_torch.kernels import launch_counts
from repro_torch.models import diffusion as tdm
from repro_torch.runtime import pipeline as tpipeline
from repro_torch.runtime import schedule_exec as tse
from repro_torch.runtime.adapters import diffusion_model_fns
from repro_torch.runtime.compile import auto_pipeline
from repro_torch.tree import tree_map, tree_paths

UVIT_KW = dict(img_size=8, in_ch=4, patch=2, d_model=32, n_layers=8,
               n_heads=4, d_ff=64, n_classes=10)
HUNYUAN_KW = dict(img_size=8, in_ch=4, patch=2, d_model=32, n_layers=8,
                  n_heads=4, d_ff=64, ctx_dim=16, ctx_len=4)
REPO = pathlib.Path(__file__).resolve().parents[1]
RTOL = 1e-4
REL = 1e-12

# plans run through both executors: (kind, N, auto_pipeline keywords);
# "tuner-*" leave the pipeline degree to the tuner (P=2, V=2, M=2 here)
EXEC_PLANS = {
    "tuner-uvit-N2": ("uvit", 2, {}),
    "tuner-hunyuan-N2": ("hunyuan", 2, {}),
    "interleaved-uvit-D2": ("uvit", 2, dict(pipeline_devices=2, interleave=2,
                                            microbatches=4, lam=0.0)),
    "interleaved-hunyuan-D2": ("hunyuan", 2, dict(
        pipeline_devices=2, interleave=2, microbatches=4, lam=0.0)),
    "ilp-uvit-D2": ("uvit", 2, dict(pipeline_devices=2, microbatches=2,
                                    lam=0.0, use_ilp=True)),
}


def _flatten(tree, prefix=""):
    """Nested dicts of arrays -> {"a/b/c": array}."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: np.asarray(tree)}


def _unflatten(flat):
    out: dict = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def _jax_executor_main(out_path, hw_json):
    """Run each ``EXEC_PLANS`` plan through the JAX executor on a (1, D)
    mesh of host devices; save params, microbatches, loss and merged
    grads."""
    import jax

    from repro.runtime.adapters import make_diffusion_microbatches
    from repro.runtime.compat import tree_to_host

    hw = jax_hw.Hardware(**json.loads(hw_json))
    key = jax.random.PRNGKey(0)
    out = {}
    for name, (kind, N, kw) in EXEC_PLANS.items():
        if kind == "uvit":
            cfg = jdm.UViTConfig("t", **UVIT_KW)
            graph = jdm.uvit_pipeline_graph(cfg, batch=2, hw=hw)
        else:
            cfg = jdm.HunyuanDiTConfig("t", **HUNYUAN_KW)
            graph = jdm.hunyuan_pipeline_graph(cfg, batch=2, hw=hw)
        cp = jax_auto_pipeline(graph, jax_model_fns(cfg, kind), N, hw,
                               wire_dtype="float32", **kw)
        M, D = cp.pcfg.num_microbatches, cp.partition.num_devices
        params = cp.model_fns.init_fn(key)
        state = cp.split_params(params)
        B = 2 * M
        batch = {"latents": jax.random.normal(key, (B, 8, 8, 4))}
        if kind == "uvit":
            batch["labels"] = jax.random.randint(key, (B,), 0, 10)
            mb, aux = make_diffusion_microbatches(batch, key, M, cfg, "uvit")
        else:
            batch["text_embeds"] = jax.random.normal(key, (B, 4, 16))
            mb, aux = make_diffusion_microbatches(batch, key, M, cfg,
                                                  "hunyuan", params=params)
        mesh = jax.make_mesh((1, D), ("data", "model"))
        loss, grads = jax.jit(jax.value_and_grad(cp.bind(mesh)))(
            state, mb, aux)
        grads = cp.merge_params(*tree_to_host(grads))
        for part, tree in (("params", params), ("mb", mb), ("aux", aux),
                           ("grads", grads)):
            for k, v in _flatten(jax.device_get(tree)).items():
                out[f"{name}|{part}|{k}"] = v
        out[f"{name}|loss"] = np.asarray(float(loss))
        out[f"{name}|plan"] = np.asarray(
            [D, M, cp.layout.V] + list(cp.partition.cuts))
    np.savez(out_path, **out)


H100 = torch_hw.H100_SXM
JH100 = jax_hw.Hardware(**dataclasses.asdict(H100))


def _graphs(name):
    """(JAX graph, port graph) of ``name`` under the same H100 values."""
    if name == "uvit-small":
        return (jdm.uvit_pipeline_graph(jdm.UViTConfig("t", **UVIT_KW),
                                        batch=2, hw=JH100),
                tdm.uvit_pipeline_graph(tdm.UViTConfig("t", **UVIT_KW),
                                        batch=2, hw=H100))
    if name == "hunyuan-small":
        return (jdm.hunyuan_pipeline_graph(
                    jdm.HunyuanDiTConfig("t", **HUNYUAN_KW), batch=2,
                    hw=JH100),
                tdm.hunyuan_pipeline_graph(
                    tdm.HunyuanDiTConfig("t", **HUNYUAN_KW), batch=2,
                    hw=H100))
    if name == "uvit-h":
        return (jdm.uvit_pipeline_graph(jax_uvit_h.CFG, batch=1, hw=JH100),
                tdm.uvit_pipeline_graph(torch_uvit_h.CFG, batch=1, hw=H100))
    if name == "hunyuan-dit":
        return (jdm.hunyuan_pipeline_graph(jax_hunyuan_dit.CFG, batch=1,
                                           hw=JH100),
                tdm.hunyuan_pipeline_graph(torch_hunyuan_dit.CFG, batch=1,
                                           hw=H100))
    assert name == "sdv2-unet"
    return (jdm.unet_block_graph(jax_sdv2.CFG, batch=1, hw=JH100),
            tdm.unet_block_graph(torch_sdv2.CFG, batch=1, hw=H100))


def _choice_key(c):
    part = c.partition
    return (c.P, c.G, c.b, c.V, c.M, c.zero_stage, c.wave,
            None if part is None else (part.cuts, part.devices, part.folded))


def _assert_choices_equal(jc, tc):
    assert [_choice_key(c) for c in tc] == [_choice_key(c) for c in jc]
    for a, b in zip(tc, jc):
        assert a.t_sample == pytest.approx(b.t_sample, rel=REL)
        assert a.t_sched == pytest.approx(b.t_sched, rel=REL)
        assert a.peak_mem == pytest.approx(b.peak_mem, rel=REL)


# ---------------------------------------------------------------------------
# tune: the ranked list, the scores and the drops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N", [2, 4, 8])
@pytest.mark.parametrize("graph", ["uvit-small", "hunyuan-small", "uvit-h",
                                   "hunyuan-dit", "sdv2-unet"])
def test_tune_matches_jax(graph, N):
    jg, tg = _graphs(graph)
    jd, td = [], []
    jc = jtu.tune(jg, N, hw=JH100, drops=jd)
    tc = ttu.tune(tg, N, hw=H100, drops=td)
    assert tc, "the tuner found no choice"
    _assert_choices_equal(jc, tc)
    assert td == jd
    # the port's default hardware is the H100's
    assert [_choice_key(c) for c in ttu.tune(tg, N)] == \
        [_choice_key(c) for c in tc]


def test_tune_with_simulation_and_options_matches_jax():
    jg, tg = _graphs("hunyuan-small")
    kw = dict(use_simulation=True, wire_dtype="float32", overlap=False,
              interleave_options=(1, 2), zero_stages=(0, 2),
              max_microbatch=64, microbatches_per_iter=lambda P: 2 * P)
    jd, td = [], []
    _assert_choices_equal(jtu.tune(jg, 4, hw=JH100, drops=jd, **kw),
                          ttu.tune(tg, 4, hw=H100, drops=td, **kw))
    assert td == jd
    # a memory budget below the smallest plan drops every candidate, with
    # the same reasons
    tiny_j = dataclasses.replace(JH100, mem_limit=1e3)
    tiny_t = dataclasses.replace(H100, mem_limit=1e3)
    jd, td = [], []
    assert jtu.tune(jg, 4, hw=tiny_j, drops=jd) == []
    assert ttu.tune(tg, 4, hw=tiny_t, drops=td) == []
    assert td == jd and any("memory budget" in d for d in td)


def test_reference_b_tie_goes_to_the_smallest_microbatch():
    """The analytic model is linear in b, so every b of a (P, V) ties on
    t_sample; the stable sort keeps the order of the b sweep (b = 1 first),
    as in the JAX package."""
    _, tg = _graphs("uvit-h")
    best = [c for c in ttu.tune(tg, 2) if c.P > 1]
    assert (best[0].P, best[0].G, best[0].V, best[0].M, best[0].b) == \
        (2, 1, 2, 2, 1)
    assert best[1].b == 2 and best[1].t_sample == best[0].t_sample


# ---------------------------------------------------------------------------
# Eqs. 14-16 and shrink_plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [
    dict(P=2, b=4, wave=True),
    dict(P=2, b=4, wave=True, V=2),
    dict(P=4, b=1, wave=False),
    dict(P=2, b=8, wave=True, windows=(3, 2)),
    dict(P=2, b=8, wave=True, windows=(3, 2, 2), wire_bytes=4),
    dict(P=2, b=8, wave=True, V=2, windows=(5, 2, 3)),
    dict(P=2, b=2, wave=True, dp=4, zero_stage=1),
    dict(P=2, b=2, wave=True, V=2, dp=2, zero_stage=2),
    dict(P=4, b=2, wave=False, dp=2, zero_stage=2, windows=(2, 1, 1)),
])
def test_peak_memory_matches_jax(case):
    jg, tg = _graphs("uvit-h")
    P, V = case["P"], case.get("V", 1)
    jpart, tpart = _partitions(jg, tg, P, V)
    jp, tp = jtu.profile_partition(jg, jpart), ttu.profile_partition(tg, tpart)
    assert dataclasses.astuple(tp) == dataclasses.astuple(jp)
    kw = {k: v for k, v in case.items() if k not in ("P", "b")}
    got = ttu.peak_memory(tp, P, case["b"], **kw)
    want = jtu.peak_memory(jp, P, case["b"], **kw)
    assert got == pytest.approx(want, rel=REL)
    for dp, z in ((1, 0), (4, 1), (4, 2)):
        assert ttu.zero_param_state_breakdown(3e9, dp=dp, zero_stage=z) == \
            jtu.zero_param_state_breakdown(3e9, dp=dp, zero_stage=z)
        assert ttu.zero_param_state_bytes(3e9, dp=dp, zero_stage=z,
                                          m_gather=1e8) == \
            jtu.zero_param_state_bytes(3e9, dp=dp, zero_stage=z,
                                       m_gather=1e8)


def _partitions(jg, tg, P, V, wave=True):
    """The same wave (or linear) partition from both packages."""
    jp = jax_partition(jg, P, hw=JH100, interleave=V, force_wave=wave)
    tp = tpart_mod.partition(tg, P, interleave=V, force_wave=wave)
    assert (tp.cuts, tp.devices) == (jp.cuts, jp.devices)
    return jp, tp


@pytest.mark.parametrize("kw", [
    dict(), dict(M=6, V=2), dict(wire_dtype="float32", overlap=False),
    dict(G=4), dict(G=4, zero_stage=2)])
def test_t_sched_paper_and_grad_sync_match_jax(kw):
    jg, tg = _graphs("hunyuan-dit")
    jpart, tpart = _partitions(jg, tg, 2, 1)
    jp, tp = jtu.profile_partition(jg, jpart), ttu.profile_partition(tg,
                                                                     tpart)
    kw = dict(kw)
    G = kw.pop("G", 1)
    for b in (1, 8):
        assert ttu.t_sched_paper(tp, 2, b, G, H100, **kw) == pytest.approx(
            jtu.t_sched_paper(jp, 2, b, G, JH100, **kw), rel=REL)
    z = kw.get("zero_stage", 0)
    for G_ in (1, 2, 8):
        assert ttu.t_grad_sync(5e9, G_, H100, z) == pytest.approx(
            jtu.t_grad_sync(5e9, G_, JH100, z), rel=REL)
        assert ttu.t_allreduce(5e9, G_, H100) == pytest.approx(
            jtu.t_allreduce(5e9, G_, JH100), rel=REL)


def test_t_sched_simulated_matches_jax():
    jg, tg = _graphs("uvit-small")
    jpart, tpart = _partitions(jg, tg, 2, 2)
    jp, tp = jtu.profile_partition(jg, jpart), ttu.profile_partition(tg,
                                                                     tpart)
    for kw in (dict(part=None), dict(part="p"), dict(part="p",
                                                     overlap=False)):
        jk = dict(kw, part=jpart if kw["part"] else None)
        tk = dict(kw, part=tpart if kw["part"] else None)
        assert ttu.t_sched_simulated(tp, 2, 4, 2, H100, microbatches=4,
                                     wave=True, **tk) == pytest.approx(
            jtu.t_sched_simulated(jp, 2, 4, 2, JH100, microbatches=4,
                                  wave=True, **jk), rel=REL)


@pytest.mark.parametrize("args", [
    (8, dict(dp=2, pp=4)), (6, dict(dp=2, pp=4, zero_stage=2)),
    (3, dict(dp=2, pp=4, zero_stage=1)), (1, dict(dp=1, pp=8)),
    (4, dict(dp=1, pp=4))])
def test_shrink_plan_matches_jax(args):
    n, kw = args
    assert ttu.shrink_plan(n, **kw) == jtu.shrink_plan(n, **kw)
    # the graph= path re-runs the tuner on the surviving count
    jg, tg = _graphs("hunyuan-dit")
    assert ttu.shrink_plan(n, graph=tg, hw=H100, **kw) == \
        jtu.shrink_plan(n, graph=jg, hw=JH100, **kw)
    with pytest.raises(ValueError, match="cluster is gone"):
        ttu.shrink_plan(0, **kw)


# ---------------------------------------------------------------------------
# the comm model
# ---------------------------------------------------------------------------

def test_comm_model_formulas_match_jax():
    assert tcm.WIRE_BYTES == jcm.WIRE_BYTES
    assert tcm.ACT_DENOM_BYTES == jcm.ACT_DENOM_BYTES
    assert tcm.WIRE_BYTES and set(tcm.WIRE_BYTES) == set(
        tpipeline.WIRE_DTYPES) == set(tcert.WIRE_DTYPES)
    for w in ("bfloat16", "float32"):
        assert tcm.wire_factor(w) == jcm.wire_factor(w)
    for K, D, a in ((32, 4, 1e6), (26, 8, 3e5)):
        assert tcm.naive_pp_volume(K, D, a) == jcm.naive_pp_volume(K, D, a)
        assert tcm.pulse_volume(D, a) == jcm.pulse_volume(D, a)
    for G, st in ((2, 2), (8, 3), (4, 1)):
        assert tcm.zero_volume_per_iter(7e9, G, st) == \
            jcm.zero_volume_per_iter(7e9, G, st)


@pytest.mark.parametrize("P,V", [(2, 1), (4, 1), (2, 2)])
def test_partition_and_lowered_comm_volume_match_jax(P, V):
    jg, tg = _graphs("uvit-h")
    jpart, tpart = _partitions(jg, tg, P, V)
    jv = jcm.partition_comm_volume(jg, jpart)
    tv = tcm.partition_comm_volume(tg, tpart)
    assert dataclasses.astuple(tv) == dataclasses.astuple(jv)
    assert (tv.fwd_total, tv.train_total) == (jv.fwd_total, jv.train_total)
    assert tcm.per_sample_volume(tg, tpart, 4) == \
        jcm.per_sample_volume(jg, jpart, 4)
    # a linear partition relays every skip hop by hop
    lin_j, lin_t = _partitions(jg, tg, P, 1, wave=False)
    lv = tcm.partition_comm_volume(tg, lin_t)
    assert dataclasses.astuple(lv) == dataclasses.astuple(
        jcm.partition_comm_volume(jg, lin_j))
    assert lv.skip_bytes > 0

    # the port's lowered tables priced as the JAX package prices its own
    sched = schedule_for_partition(tpart, 2 * P)
    ttabs = tse.StepTables.from_schedule(sched, folded=True,
                                         devices=tpart.devices)
    jtabs = JaxStepTables.from_schedule(jax_schedule(jpart, 2 * P),
                                        folded=True, devices=jpart.devices)
    prof = ttu.profile_partition(tg, tpart)
    payload = prof.out_bytes_per_sample[0] * 4
    for w in ("bfloat16", "float32"):
        tl = tcm.lowered_comm_volume(ttabs, payload, w)
        jl = jcm.lowered_comm_volume(jtabs, payload, w)
        assert dataclasses.astuple(tl) == dataclasses.astuple(jl)
        assert (tl.hop_bytes, tl.fwd_total, tl.train_total,
                tl.dense_fp32_total) == (jl.hop_bytes, jl.fwd_total,
                                         jl.train_total, jl.dense_fp32_total)
        assert tl.live_hops < tl.dense_hops
    to, jo = tcm.overlap_accounting(ttabs), jcm.overlap_accounting(jtabs)
    assert dataclasses.astuple(to) == dataclasses.astuple(jo)
    assert to.total_hops == sum(ttabs.live_hops)
    for ov in (True, False):
        assert to.comm_time(2e-5, 1e-5, ov) == jo.comm_time(2e-5, 1e-5, ov)
    # the planner's own hop analysis agrees with the lowering's
    stats = comm_stats(sched, tpart.device_of_stage, True)
    assert dataclasses.astuple(tcm.overlap_accounting(stats)) == \
        dataclasses.astuple(to)


# ---------------------------------------------------------------------------
# the tuner-driven auto_pipeline
# ---------------------------------------------------------------------------

def _both_plans(kind, N, **kw):
    jg, tg = _graphs(f"{kind}-small")
    jcfg = (jdm.UViTConfig("t", **UVIT_KW) if kind == "uvit"
            else jdm.HunyuanDiTConfig("t", **HUNYUAN_KW))
    tcfg = (tdm.UViTConfig("t", **UVIT_KW) if kind == "uvit"
            else tdm.HunyuanDiTConfig("t", **HUNYUAN_KW))
    jcp = jax_auto_pipeline(jg, jax_model_fns(jcfg, kind), N, JH100, **kw)
    tcp = auto_pipeline(tg, diffusion_model_fns(tcfg, kind), N, H100, **kw)
    return jcp, tcp


@pytest.mark.parametrize("kind", ["uvit", "hunyuan"])
def test_tuner_driven_plan_matches_jax(kind):
    jcp, tcp = _both_plans(kind, 2)
    assert tcp.choice is not None and jcp.choice is not None
    assert _choice_key(tcp.choice) == _choice_key(jcp.choice)
    assert tcp.choice.t_sample == pytest.approx(jcp.choice.t_sample, rel=REL)
    assert (tcp.choice.P, tcp.choice.G, tcp.choice.V) == (2, 1, 2)
    assert (tcp.partition.cuts, tcp.partition.devices) == \
        (jcp.partition.cuts, jcp.partition.devices)
    assert tcp.pcfg.num_microbatches == jcp.pcfg.num_microbatches == \
        tcp.choice.M
    assert tcp.layout.V == jcp.layout.V == 2
    for f in ("enc_slots", "dec_slots", "enc_counts", "dec_counts",
              "skip_rows"):
        assert getattr(tcp.layout, f) == getattr(jcp.layout, f), f
    # describe() carries the tuner's line, as the JAX package's does
    assert tcp.describe().splitlines()[-1] == \
        jcp.describe().splitlines()[-1]
    assert "tuner: P=2 G=1" in tcp.describe()
    # a pinned interleave restricts the search, as in the JAX package
    jcp1, tcp1 = _both_plans(kind, 2, interleave=1)
    assert tcp1.layout.V == jcp1.layout.V == 1
    assert _choice_key(tcp1.choice) == _choice_key(jcp1.choice)


def test_trainer_trains_the_tuner_plan():
    """``train.run(args, compiled=plan)`` trains on the tuner's own plan
    (``uvit-pp`` at N=2: P=2 V=2 M=2), step for step as the trainer trains
    the same plan pinned by its flags; without ``--pipeline`` a plan is
    refused."""
    from repro_torch.launch import train
    argv = ["--arch", "uvit-pp", "--pipeline", "--global-batch", "8",
            "--steps", "2", "--log-every", "100", "--wire-dtype", "float32",
            "--device", "cpu"]
    args = train._parse_args(argv)
    cfg = train._model_config(args)
    cp = auto_pipeline(tdm.uvit_pipeline_graph(cfg, batch=4, hw=H100),
                       diffusion_model_fns(cfg), 2, H100,
                       wire_dtype="float32")
    c = cp.choice
    assert (c.P, c.G, c.V, c.M) == (2, 1, 2, 2)
    got = train.run(args, compiled=cp)
    assert got.compiled is cp
    pinned = train.run(train._parse_args(argv + [
        "--devices", "2", "--microbatches", "2", "--interleave", "2"]))
    assert pinned.compiled.partition.cuts == cp.partition.cuts
    assert sorted(got.losses) == [0, 1]
    assert got.losses == pinned.losses
    with pytest.raises(ValueError, match="needs --pipeline"):
        train.run(train._parse_args(["--arch", "uvit", "--device", "cpu"]),
                  compiled=cp)


@pytest.mark.parametrize("kind", ["uvit", "hunyuan"])
def test_tuner_choice_with_dp_is_refused_by_name(kind):
    """At N=4 the JAX package plans P=2 G=2 (dp = 2); the port refuses that
    very choice and does not fall back to a lower-ranked G=1 one."""
    jg, tg = _graphs(f"{kind}-small")
    jcfg = (jdm.UViTConfig("t", **UVIT_KW) if kind == "uvit"
            else jdm.HunyuanDiTConfig("t", **HUNYUAN_KW))
    tcfg = (tdm.UViTConfig("t", **UVIT_KW) if kind == "uvit"
            else tdm.HunyuanDiTConfig("t", **HUNYUAN_KW))
    c = jax_auto_pipeline(jg, jax_model_fns(jcfg, kind), 4, JH100).choice
    assert c.G > 1
    want = (f"P={c.P} G={c.G} b={c.b} V={c.V} M={c.M} "
            f"zero_stage={c.zero_stage}")
    with pytest.raises(NotImplementedError, match=want):
        auto_pipeline(tg, diffusion_model_fns(tcfg, kind), 4, H100)
    # a pinned ZeRO stage restricts the search to it: the G=2 choice now
    # carries ZeRO-1, and is refused by name as well
    c1 = jax_auto_pipeline(jg, jax_model_fns(jcfg, kind), 4, JH100,
                           zero_stage=1).choice
    assert (c1.G, c1.zero_stage) == (2, 1)
    with pytest.raises(NotImplementedError, match="G=2 .*zero_stage=1"):
        auto_pipeline(tg, diffusion_model_fns(tcfg, kind), 4, H100,
                      zero_stage=1)


def test_tuner_errors_match_jax():
    jg, tg = _graphs("uvit-small")
    fns = diffusion_model_fns(tdm.UViTConfig("t", **UVIT_KW))
    jfns = jax_model_fns(jdm.UViTConfig("t", **UVIT_KW))
    with pytest.raises(ValueError, match="force_wave requires"):
        auto_pipeline(tg, fns, 2, force_wave=True)
    with pytest.raises(ValueError, match="zero_stage must be in"):
        auto_pipeline(tg, fns, 2, zero_stage=3)
    # nothing fits: the error lists every drop, as the JAX package's does
    tiny_t = dataclasses.replace(H100, mem_limit=1e3)
    tiny_j = dataclasses.replace(JH100, mem_limit=1e3)
    with pytest.raises(ValueError) as te:
        auto_pipeline(tg, fns, 2, tiny_t)
    with pytest.raises(ValueError) as je:
        jax_auto_pipeline(jg, jfns, 2, tiny_j)
    assert str(te.value) == str(je.value)
    assert "no feasible pipeline plan for N=2" in str(te.value)
    # N=1: only pure data parallelism exists, which carries no pipeline
    with pytest.raises(ValueError) as te:
        auto_pipeline(tg, fns, 1)
    with pytest.raises(ValueError) as je:
        jax_auto_pipeline(jg, jfns, 1, JH100)
    assert str(te.value) == str(je.value)
    assert "pure data parallelism" in str(te.value)


# ---------------------------------------------------------------------------
# certificates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["uvit", "hunyuan"])
def test_certificate_matches_jax(kind):
    jcp, tcp = _both_plans(kind, 2)
    tc = tcp.certify(name="tuner")
    jc = jax_cert.certify_plan(jcp, name="tuner")
    assert tc.ok and jc.ok
    assert tc.to_dict() == jc.to_dict()
    assert tc.summary() == jc.summary()
    # the JSON round trip, read by both packages
    assert tcert.PlanCertificate.from_json(tc.to_json()) == tc
    assert jax_cert.PlanCertificate.from_json(tc.to_json()).to_dict() == \
        tc.to_dict()


def test_planted_fault_is_flagged_by_both():
    _, tcp = _both_plans("uvit", 2)
    tabs = tcp.step_tables()
    consumers = tcp.layout.skip_consumers()
    bad_sel = tabs.rx_slot.copy()
    d, k = map(int, np.argwhere(tabs.down_valid)[0])
    bad_sel[d, k] = (bad_sel[d, k] + 1) % max(tabs.W_down, 2)
    bad = dataclasses.replace(tabs, rx_slot=bad_sel)
    tc = tcert.certify_tables(bad, skip_consumers=consumers)
    jc = jax_cert.certify_tables(bad, skip_consumers=consumers)
    assert not tc.ok and not jc.ok
    assert tc.to_dict() == jc.to_dict()
    assert tc.violations and "FAIL" in tc.summary()
    # a dropped send is a lost message in both
    sends = tabs.down_send.copy()
    d, k = map(int, np.argwhere(sends)[0])
    sends[d, k] = False
    bad = dataclasses.replace(tabs, down_send=sends)
    tc = tcert.certify_tables(bad, skip_consumers=consumers)
    jc = jax_cert.certify_tables(bad, skip_consumers=consumers)
    assert not tc.ok and tc.to_dict() == jc.to_dict()


def test_saved_plan_recertifies_in_both_packages(tmp_path):
    _, tcp = _both_plans("hunyuan", 2)
    tabs = tcp.step_tables()
    path = tmp_path / "plan.json"
    tcert.export_plan(tabs, path, skip_consumers=tcp.layout.skip_consumers(),
                      name="tuner")
    tsaved, jsaved = tcert.load_plan(path), jax_cert.load_plan(path)
    tc, jc = tsaved.certify(), jsaved.certify()
    assert tc.ok and tc.to_dict() == jc.to_dict()
    assert tc.hops == tcp.certify().hops
    with pytest.raises(ValueError, match="not a saved plan"):
        path.write_text(json.dumps({"schema": "other"}))
        tcert.load_plan(path)
    # certify_schedule lowers through the port's StepTables
    cs = tcert.certify_schedule(
        tcp.schedule, folded=True, devices=tcp.partition.devices,
        skip_consumers=tcp.layout.skip_consumers())
    assert cs.ok and cs.plan["V"] == 2


def test_analysis_package_mirrors_the_reference():
    assert port_analysis.CHECKS == jax_dataflow.CHECKS
    assert sorted(port_analysis.__all__) == sorted(jax_analysis.__all__)
    assert (tdataflow.IDLE, tdataflow.RUN_ENC, tdataflow.RUN_DEC) == \
        (tse.IDLE, tse.RUN_ENC, tse.RUN_DEC)
    assert tcert.CERTIFICATE_SCHEMA == jax_cert.CERTIFICATE_SCHEMA
    assert tcert.PLAN_SCHEMA == jax_cert.PLAN_SCHEMA


# ---------------------------------------------------------------------------
# the profiler
# ---------------------------------------------------------------------------

def test_measure_block_times_on_cpu():
    cfg = tdm.UViTConfig("t", use_skip_kernel=True, use_flash=True,
                         **UVIT_KW)
    fns = diffusion_model_fns(cfg)
    params = fns.init_fn(torch.Generator().manual_seed(0), "cpu")
    (enc, dec), _ = fns.split_blocks(params)
    x = torch.randn(2, cfg.n_tokens, cfg.d_model)
    with torch.no_grad():
        enc0, dec0 = tree_map(lambda a: a[0], (enc, dec))
        calls = [(fns.enc_block_fn, (enc0, x, {})),
                 (fns.dec_block_fn, (dec0, x, x, {})),
                 (lambda a: a.sum(), (x,))]
        before = launch_counts()
        times = tprof.measure_block_times([f for f, _ in calls],
                                          [a for _, a in calls], iters=2)
    assert launch_counts() == before            # CPU: plain versions only
    assert len(times) == 3
    assert all(isinstance(t, float) and t > 0 for t in times)
    # no tensor among the arguments: the host clock as well
    assert tprof.measure_block_times([lambda: None], [()], warmup=0)[0] >= 0
    assert tprof._device_of(({"a": [1, x]},)) == torch.device("cpu")


def test_reprofile_graph_matches_jax():
    jg, tg = _graphs("sdv2-unet")
    tr, jr = tprof.reprofile_graph(tg), jprof.reprofile_graph(jg, JH100)
    assert [dataclasses.astuple(b) for b in tr.blocks] == \
        [dataclasses.astuple(b) for b in jr.blocks]
    assert tr.skips == tg.skips
    # measured costs enter a graph through fwd_times, and move the cuts
    ut = tdm.UViTConfig("t", **UVIT_KW)
    ft = [3.0, 1, 1, 1, 1, 1, 1, 3.0]
    g = tdm.uvit_pipeline_graph(ut, batch=2, fwd_times=ft)
    assert [b.fwd_time for b in g.blocks] == ft
    assert tpart_mod.partition(g, 2, lam=0.0).cuts != \
        tpart_mod.partition(tdm.uvit_pipeline_graph(ut, batch=2), 2,
                            lam=0.0).cuts


# ---------------------------------------------------------------------------
# executor parity against the JAX executor
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_executor(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_exec") / "out.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO / "src")]
                   + [p for p in os.environ.get("PYTHONPATH", "").split(
                       os.pathsep) if p]))
    proc = subprocess.run(
        [sys.executable, __file__, "jax-executor", str(out),
         json.dumps(dataclasses.asdict(H100))],
        capture_output=True, text=True, timeout=600, env=env, cwd=str(REPO))
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def _saved(res, name, part):
    pre = f"{name}|{part}|"
    return _unflatten({k[len(pre):]: v for k, v in res.items()
                       if k.startswith(pre)})


@pytest.mark.parametrize("name", sorted(EXEC_PLANS))
def test_executor_step_matches_the_jax_executor(jax_executor, name):
    kind, N, kw = EXEC_PLANS[name]
    if kind == "uvit":
        cfg = tdm.UViTConfig("t", use_skip_kernel=True, use_flash=True,
                             **UVIT_KW)
        graph = tdm.uvit_pipeline_graph(cfg, batch=2)
    else:
        cfg = tdm.HunyuanDiTConfig("t", use_skip_kernel=True, use_flash=True,
                                   **HUNYUAN_KW)
        graph = tdm.hunyuan_pipeline_graph(cfg, batch=2)
    cp = auto_pipeline(graph, diffusion_model_fns(cfg, kind), N,
                       wire_dtype="float32", **kw)
    D, M, V, *cuts = (int(x) for x in jax_executor[f"{name}|plan"])
    assert (cp.partition.num_devices, cp.pcfg.num_microbatches,
            cp.layout.V, list(cp.partition.cuts)) == (D, M, V, cuts)
    if "tuner" in name or "interleaved" in name:
        assert V == 2
    assert cp.certify().ok

    params = _saved(jax_executor, name, "params")
    mb_aux = (_saved(jax_executor, name, "mb"),
              _saved(jax_executor, name, "aux"))
    stacks, edge = cp.split_params(params_from_jax(params, "cpu"))
    p = tree_map(lambda x: x.requires_grad_(True), (stacks, edge))
    mb, aux = params_from_jax(mb_aux, "cpu")
    (enc, dec), edge = p
    before = launch_counts()
    loss = cp.build()(enc, dec, edge, mb, aux)
    loss.backward()
    assert launch_counts() == before          # CPU: plain versions only
    grads = dict(tree_paths(cp.merge_params(*tree_map(
        lambda x: x.grad if x.grad is not None else torch.zeros_like(x),
        p))))
    want = _flatten(_saved(jax_executor, name, "grads"))
    np.testing.assert_allclose(float(loss.detach()),
                               float(jax_executor[f"{name}|loss"]),
                               rtol=RTOL, err_msg=name)
    assert sorted(grads) == sorted(want)
    for k, v in grads.items():
        np.testing.assert_allclose(v.numpy(), want[k], rtol=RTOL, atol=1e-6,
                                   err_msg=f"{name}: {k}")


if __name__ == "__main__" and sys.argv[1:2] == ["jax-executor"]:
    _jax_executor_main(*sys.argv[2:4])
