"""The port's architecture registry held to the JAX package's (CPU, fp32).

- ``list_archs`` and, for each of the 13 archs, the bundle's name,
  family, param counts, shape support, notes and ``asdict`` of every plan;
  every supported shape's ``batch_struct`` (under its plan and under a
  ``pp_*`` plan's microbatches) and every ``cache_struct`` against JAX's
  ``ShapeDtypeStruct``s and ``jax.eval_shape`` (a cache's ``pos`` is a
  host int here), ``scaled_cfg``'s fields;
- ``uvit_block_graph`` and ``hunyuan_block_graph`` at the full configs,
  block for block and edge for edge, under JAX's ``TPU_V5E`` numbers;
- int8 AdamW: ``_quantize``/``_dequantize`` codes and scales equal, five
  clipped ``int8_adamw_update`` steps (params rtol 1e-5, each moment
  within one step of its block's scale);
- ``LMPipelineAdapter``: its splits bitwise, its linear and folded
  pipelines at D=2 and 4, M=4 against JAX's ``lm_loss`` averaged over the
  microbatches (loss and grads, rtol 1e-4);
- the step builders on smoke LM bundles against JAX's on a one-device
  mesh: ``build_sharded_train_step`` (fp32 and int8 moments) and
  ``build_pp_train_step`` (``pp_wave`` and ``pp_1f1b`` at D=2, equal
  microbatches) over three steps, ``build_forward_step``, four
  ``build_sharded_serve_step`` steps (tokens equal, caches rtol 1e-4);
- UViT's and Hunyuan-DiT's ``make_microbatches`` and ``loss_fn`` with
  JAX's draws injected;
- the refusals: a grid of ranks, TP/EP/sequence/data axes larger than 1.

The JAX references compile at XLA's lowest backend optimization level
(``FAST``), as ``test_torch_lm.py``'s do.
"""
import dataclasses
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import base as jbase
from repro.configs import hunyuan_dit as jhunyuan
from repro.configs import lm_common as jlm_common
from repro.configs import uvit_h as juvit
from repro.configs.smoke import SMOKE_FACTORIES as JAX_SMOKE
from repro.core import hw as jax_hw
from repro.models import diffusion as jdm
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.runtime.adapters import LMPipelineAdapter as JLMPipelineAdapter
from repro.runtime.pipeline import PipelineConfig as JPipelineConfig
from repro.train import steps as jsteps
from repro_torch import configs as tconfigs
from repro_torch.configs import base as tbase
from repro_torch.configs import hunyuan_dit as thunyuan
from repro_torch.configs import lm_common as tlm_common
from repro_torch.configs import uvit_h as tuvit
from repro_torch.configs.smoke import LM_FACTORIES
from repro_torch.configs.smoke import SMOKE_FACTORIES as TORCH_SMOKE
from repro_torch.convert import params_from_jax, state_from_jax
from repro_torch.core import hw as torch_hw
from repro_torch.launch.mesh import RankGrid
from repro_torch.models import diffusion as tdm
from repro_torch.models import lm as tlm
from repro_torch.optim import adamw as tadamw
from repro_torch.runtime.adapters import LMPipelineAdapter
from repro_torch.runtime.pipeline import PipelineConfig
from repro_torch.train import steps as tsteps
from repro_torch.tree import tree_leaves, tree_map, tree_paths

RTOL = 1e-4
FAST = {"xla_backend_optimization_level": 0}
KEY = jax.random.PRNGKey(0)
ARCHS = jconfigs.list_archs()
TPU = torch_hw.Hardware(**dataclasses.asdict(jax_hw.TPU_V5E))
STEPS = 3
TRAIN_B, TRAIN_S, TRAIN_M = 4, 16, 4
# AdamW's eps at 1e-6 in the trajectories, both packages: at 1e-8 its
# first step turns an embed gradient entry of 1.5e-9 (2.4e-9 in the port:
# fp32 summation order, 1e-8 of the leaf's largest entry) into updates
# 0.07 lr apart, past the params' bar
J_OPT = jadamw.AdamWConfig(eps=1e-6)
T_OPT = tadamw.AdamWConfig(eps=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes gain nothing from more threads, and tier-1 runs six
    test processes on the host's cores at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, what="", rtol=RTOL):
    """rtol; an entry near zero may err by 1e-5 of its leaf's largest
    magnitude (fp32 rounding in another summation order)."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    atol = max(1e-6, 1e-5 * float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def _jax_paths(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): v for path, v in flat}


def _close_tree(got, want, what=""):
    """A port tree (params or caches) against a JAX one, leaf by leaf; a
    cache's ``pos`` (a host int here) against every entry of JAX's."""
    want = {k: np.asarray(v) for k, v in _jax_paths(jax.device_get(want))
            .items()}
    got = dict(tree_paths(got))
    assert sorted(got) == sorted(want), what
    for k, g in got.items():
        if k.split("/")[-1] == "pos":
            assert np.all(want[k] == g), (what, k, g, want[k])
        else:
            _close(g, want[k], f"{what} {k}")


def _dtype_name(d) -> str:
    return str(d).removeprefix("torch.") if isinstance(d, torch.dtype) \
        else jnp.dtype(d).name


def _struct(tree, paths) -> dict:
    """path -> (shape, dtype) of a struct tree; a host-int ``pos`` is a
    scalar int32 of any shape (JAX stacks one a layer)."""
    out = {}
    for k, v in paths(tree).items():
        if isinstance(v, int):
            assert k.split("/")[-1] == "pos", k
            out[k] = ("pos", "int32")
        elif k.split("/")[-1] == "pos":
            out[k] = ("pos", _dtype_name(v.dtype))
        else:
            assert not isinstance(v, torch.Tensor) or v.is_meta, k
            out[k] = (tuple(v.shape), _dtype_name(v.dtype))
    return out


def _same_struct(got, want, what):
    assert _struct(got, lambda t: dict(tree_paths(t))) == \
        _struct(want, _jax_paths), what


def _fields(cfg) -> dict:
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            v = _fields(v)
        elif isinstance(v, (torch.dtype, type)):   # a dtype of either
            v = _dtype_name(v)
        out[f.name] = v
    return out


def _same_fields(got, want, what):
    """The fields both configs have are equal (the port's ``use_flash`` is
    its own; the JAX ``LMConfig``'s ``remat_policy`` and
    ``seq_shard_activations`` are not ported, no config sets them)."""
    g, w = _fields(got), _fields(want)
    assert set(w) - set(g) <= {"remat_policy", "seq_shard_activations"}, what
    for k in set(g) & set(w):
        if isinstance(g[k], dict):
            assert {a: b for a, b in g[k].items() if a != "use_flash"} == \
                w[k], (what, k)
        else:
            assert g[k] == w[k], (what, k, g[k], w[k])


def _shapes(jb):
    return [(jbase.SHAPES[s], tbase.SHAPES[s]) for s in jbase.SHAPES
            if jb.supported(s)]


# ---------------------------------------------------------------------------
# the registry and its bundles
# ---------------------------------------------------------------------------

def test_list_archs_and_the_registry_match_jax():
    assert tconfigs.list_archs() == jconfigs.list_archs()
    assert (tconfigs.ASSIGNED, tconfigs.PAPER_ARCHS) == \
        (jconfigs.ASSIGNED, jconfigs.PAPER_ARCHS)
    assert {k: dataclasses.asdict(v) for k, v in tbase.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}
    assert tconfigs.get_arch("smollm-360m") is tconfigs.get_arch(
        "smollm-360m")
    assert [f.name for f in dataclasses.fields(tbase.ArchBundle)] == \
        [f.name for f in dataclasses.fields(jbase.ArchBundle)]
    assert [f.name for f in dataclasses.fields(tsteps.ParallelPlan)] == \
        [f.name for f in dataclasses.fields(jsteps.ParallelPlan)]
    assert dataclasses.asdict(tsteps.ParallelPlan()) == \
        dataclasses.asdict(jsteps.ParallelPlan())


@pytest.mark.parametrize("arch", ARCHS)
def test_bundle_matches_jax(arch):
    jb, tb = jconfigs.get_arch(arch), tconfigs.get_arch(arch)
    for f in ("name", "family", "param_count", "active_param_count",
              "shape_support", "notes"):
        assert getattr(tb, f) == getattr(jb, f), f
    assert {k: dataclasses.asdict(v) for k, v in tb.plans.items()} == \
        {k: dataclasses.asdict(v) for k, v in jb.plans.items()}
    for f in ("make_decode_fn", "cache_struct", "make_adapter",
              "make_microbatches", "scaled_cfg", "smoke"):
        assert (getattr(tb, f) is None) == (getattr(jb, f) is None), f
    _same_fields(tb.cfg, jb.cfg, arch)
    if tb.scaled_cfg is not None:
        for n in (1, 2, 4):
            _same_fields(tb.scaled_cfg(n), jb.scaled_cfg(n), f"{arch} {n}")


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_structs_match_jax(arch):
    jb, tb = jconfigs.get_arch(arch), tconfigs.get_arch(arch)
    jpp = jsteps.ParallelPlan(strategy="pp_1f1b", microbatches=8)
    tpp = tsteps.ParallelPlan(strategy="pp_1f1b", microbatches=8)
    for js, ts in _shapes(jb):
        _same_struct(tb.batch_struct(ts), jb.batch_struct(js),
                     f"{arch} {ts.name}")
        _same_struct(tb.batch_struct(ts, tpp), jb.batch_struct(js, jpp),
                     f"{arch} {ts.name} pp")
    if jb.cache_struct is not None:
        for js, ts in _shapes(jb):
            _same_struct(tb.cache_struct(ts), jb.cache_struct(js),
                         f"{arch} {ts.name} cache")


# ---------------------------------------------------------------------------
# the analytic block graphs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,batch", [("uvit", 1), ("uvit", 8),
                                        ("hunyuan", 1), ("hunyuan", 8)])
def test_block_graphs_match_jax(kind, batch):
    jfn, tfn, jcfg, tcfg = (
        (jdm.uvit_block_graph, tdm.uvit_block_graph, juvit.CFG, tuvit.CFG)
        if kind == "uvit" else
        (jdm.hunyuan_block_graph, tdm.hunyuan_block_graph, jhunyuan.CFG,
         thunyuan.CFG))
    jg, tg = jfn(jcfg, batch, jax_hw.TPU_V5E), tfn(tcfg, batch, TPU)
    assert [dataclasses.astuple(b) for b in tg.blocks] == \
        [dataclasses.astuple(b) for b in jg.blocks]
    assert [dataclasses.astuple(e) for e in tg.skips] == \
        [dataclasses.astuple(e) for e in jg.skips]
    assert (len(tg.blocks), len(tg.skips)) == (34, 16)
    # and the port plans for the H100 by default
    b = tfn(tcfg, batch).blocks[3]
    assert b.fwd_time == pytest.approx(max(
        b.flops / torch_hw.H100_SXM.peak_flops,
        (2 * b.param_bytes + 2 * b.act_bytes) / torch_hw.H100_SXM.hbm_bw))


# ---------------------------------------------------------------------------
# int8 AdamW
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,scale", [((37, 50), 1.0), ((8192,), 1e-3),
                                         ((3, 5000), 10.0), ((10,), 0.0)])
def test_quantize_and_dequantize_match_jax(shape, scale):
    x = (np.random.default_rng(1).standard_normal(shape) * scale
         ).astype(np.float32)
    jq, js = jadamw._quantize(jnp.asarray(x))
    tq, ts = tadamw._quantize(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert tq.shape[0] % 32 == 0 and tq.shape == jq.shape and \
        ts.shape == js.shape
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tadamw._dequantize(tq, ts, shape).numpy(),
        np.asarray(jadamw._dequantize(jq, js, shape)))


def test_int8_adamw_update_matches_jax():
    """Five clipped steps (gradient norms 5-30 against ``clip_norm`` 1)
    over leaves of 1850, 8192 and 27 entries and one whose gradient is
    zero."""
    rng = np.random.default_rng(2)
    shapes = {"a": (37, 50), "b": (8192,), "c": {"d": (3, 3, 3)},
              "z": (10,)}
    params = jax.tree.map(
        lambda s: rng.standard_normal(s).astype(np.float32), shapes,
        is_leaf=lambda s: isinstance(s, tuple))
    cfg = jadamw.AdamWConfig(lr=1e-2)
    tcfg = tadamw.AdamWConfig(lr=1e-2)
    jp, js = params, jadamw.int8_adamw_init(params)
    tp = params_from_jax(params, "cpu")
    ts = tadamw.int8_adamw_init(tp)
    for step in range(5):
        grads = jax.tree.map(
            lambda x: (rng.standard_normal(x.shape) * (step + 1)).astype(
                np.float32), params)
        grads["z"] = np.zeros_like(grads["z"])
        jp, js = jadamw.int8_adamw_update(jp, grads, js, cfg)
        tadamw.int8_adamw_update(tp, params_from_jax(grads, "cpu"), ts, tcfg)
        _close_tree(tp, jp, f"params after step {step}")
        assert int(ts["step"]) == int(js["step"]) == step + 1
        for mom in ("m", "v"):
            jm, tm = _jax_paths(js[mom]), dict(tree_paths(ts[mom]))
            for path in {k.rsplit("/", 1)[0] for k in jm}:
                jq, jsc = (np.asarray(jm[f"{path}/{c}"]) for c in "qs")
                tq, tsc = tm[f"{path}/q"].numpy(), tm[f"{path}/s"].numpy()
                assert tq.shape[0] % 32 == 0 and tq.shape == jq.shape
                # within one step of the block's scale
                diff = np.abs(tq * tsc - jq.astype(np.float32) * jsc)
                assert np.all(diff <= 1.001 * jsc + 1e-30), (mom, path)


# ---------------------------------------------------------------------------
# LMPipelineAdapter against JAX's lm_loss over the microbatches
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _adapter_case():
    """The smollm smoke config at 8 layers, its JAX params, 4 microbatches
    of 2 x 16 tokens, and JAX's ``lm_loss`` averaged over them with its
    gradient."""
    jcfg = dataclasses.replace(JAX_SMOKE["smollm-360m"]()[3], n_layers=8)
    tcfg = dataclasses.replace(LM_FACTORIES["smollm-360m"]()[3], n_layers=8)
    params = jax.device_get(jax.jit(lambda k: jlm.init_lm(k, jcfg))(KEY))
    tokens = np.random.default_rng(3).integers(0, 256, (4, 2, 16)).astype(
        np.int32)

    def ref_loss(p):
        return jnp.mean(jnp.stack([jlm.lm_loss(p, {"tokens": tokens[m]}, jcfg)
                                   for m in range(4)]))
    fn = jax.jit(jax.value_and_grad(ref_loss)).lower(params).compile(
        compiler_options=FAST)
    loss, grads = jax.device_get(fn(params))
    return jcfg, tcfg, params, tokens, loss, grads


@pytest.mark.parametrize("wave", [False, True])
@pytest.mark.parametrize("D", [2, 4])
def test_lm_adapter_splits_bitwise_and_pipelines_match_jax(wave, D):
    jcfg, tcfg, params, tokens, want_loss, want_grads = _adapter_case()
    jad = JLMPipelineAdapter(jcfg, JPipelineConfig(D, 4), wave=wave)
    tad = LMPipelineAdapter(tcfg, PipelineConfig(D, 4), wave=wave)
    tparams = params_from_jax(params, "cpu")
    jstacks, jedge = jax.device_get(jad.split_params(params))
    stacks, edge = tad.split_params(tparams)
    for got, want in ((stacks, jstacks), (edge, jedge)):
        jw = {k: np.asarray(v) for k, v in _jax_paths(want).items()}
        tg = dict(tree_paths(got))
        assert sorted(tg) == sorted(jw)
        for k, v in tg.items():
            np.testing.assert_array_equal(v.numpy(), jw[k], err_msg=k)
    merged = tad.merge_params(stacks, edge)
    jmerged = jax.device_get(jad.merge_params(jstacks, jedge))
    for k, v in tree_paths(merged):
        np.testing.assert_array_equal(v.numpy(),
                                      np.asarray(_jax_paths(jmerged)[k]))
    for x in tree_leaves((stacks, edge)):
        x.requires_grad_(True)
    loss = tad.build()(*stacks, edge, {"tokens": torch.from_numpy(tokens)})
    loss.backward()
    _close(loss, want_loss, "loss")
    grads = tad.merge_params(*tree_map(lambda x: x.grad, (stacks, edge)))
    _close_tree(grads, want_grads, f"grads D={D} wave={wave}")


# ---------------------------------------------------------------------------
# the step builders on smoke LM bundles
# ---------------------------------------------------------------------------

def _mesh():
    return jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))


@functools.lru_cache(maxsize=None)
def _smoke_bundles():
    """smollm's bundle on its smoke config, in both packages, with the JAX
    params."""
    jcfg = JAX_SMOKE["smollm-360m"]()[3]
    tcfg = LM_FACTORIES["smollm-360m"]()[3]
    jb = jlm_common.lm_bundle("smollm-360m", jcfg,
                              jconfigs.get_arch("smollm-360m").plans)
    tb = tlm_common.lm_bundle("smollm-360m", tcfg,
                              tconfigs.get_arch("smollm-360m").plans)
    params = jax.device_get(jax.jit(jb.init_fn)(KEY))
    return jb, tb, params


def _train_tokens():
    return np.random.default_rng(5).integers(
        0, 256, (TRAIN_B, TRAIN_S)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_trajectory(int8: bool):
    """``STEPS`` steps of JAX's ``build_sharded_train_step`` on a one-device
    mesh: the losses, and the params and optimizer state after each."""
    jb, _, params = _smoke_bundles()
    plan = dataclasses.replace(jb.plans["prefill_32k"], int8_optimizer=int8)
    tokens = _train_tokens()
    struct = {"tokens": jax.ShapeDtypeStruct(tokens.shape, jnp.int32)}
    step, example, _, _ = jsteps.build_sharded_train_step(
        jb.loss_fn, jb.init_fn, struct, _mesh(), plan, J_OPT)
    o_init = jadamw.int8_adamw_init if int8 else jadamw.adamw_init
    p, o = jax.tree.map(jnp.asarray, params), o_init(params)
    fn = step.lower(p, o, {"tokens": tokens}, KEY).compile(
        compiler_options=FAST)
    losses, after, states = [], [], []
    for _ in range(STEPS):
        p, o, loss = fn(p, o, {"tokens": tokens}, KEY)
        losses.append(float(loss))
        after.append(jax.device_get(p))
        states.append(jax.device_get(o))
    return losses, after, states


def _held_to_jax(losses, after, int8, what):
    want_losses, want_after, _ = _jax_trajectory(int8)
    for i in range(STEPS):
        _close(np.float32(losses[i]), np.float32(want_losses[i]),
               f"{what} loss {i}")
        _close_tree(after[i], want_after[i], f"{what} params {i}")


def _codes_within_one(got, want, what):
    """int8 moments: codes within one of JAX's, scales at rtol 1e-4."""
    jm, tm = _jax_paths(want), dict(tree_paths(got))
    assert sorted(jm) == sorted(tm), what
    for k, v in tm.items():
        if k.endswith("/q"):
            d = np.abs(v.numpy().astype(np.int32)
                       - np.asarray(jm[k]).astype(np.int32))
            assert d.max() <= 1, (what, k)
        elif k.endswith("/s"):
            _close(v, jm[k], f"{what} {k}")


def _int8_params_close(got, want, state, what):
    """Params after an int8 step against JAX's, rtol 1e-4, except where
    the step's incoming moments hold a zero code of v beside a non-zero
    code of m (a third of the entries: a block's codes scale to its
    largest v): there v is this step's ``(1 - b2) g^2`` alone, the update
    ``m / sqrt(v)`` goes as ``1 / |g|`` (up to 80 lr), and fp32 gradient
    differences of a few 1e-4 relative move it.  Those entries are held
    within one lr: the port's worst here is 0.42 lr, and JAX compiled
    against JAX eager on the same step parts by up to 1.46 lr."""
    mq = {k.rsplit("/", 1)[0]: np.asarray(v)
          for k, v in _jax_paths(state["m"]).items() if k.endswith("/q")}
    vq = {k.rsplit("/", 1)[0]: np.asarray(v)
          for k, v in _jax_paths(state["v"]).items() if k.endswith("/q")}
    want = {k: np.asarray(v) for k, v in _jax_paths(want).items()}
    for k, g in tree_paths(got):
        w = want[k]
        ill = ((vq[k] == 0) & (mq[k] != 0)).reshape(-1)[:w.size].reshape(
            w.shape)
        g = g.numpy()
        assert np.all(np.abs(g - w)[ill] <= T_OPT.lr), (what, k)
        _close(np.where(ill, w, g), w, f"{what} {k}")


@pytest.mark.parametrize("int8", [False, True])
def test_sharded_train_step_matches_jax(int8):
    """Three steps from the same params, losses and params at rtol 1e-4.
    With int8 moments each step starts from JAX's params and state after
    the step before, whose codes a free-running run may not share (a
    moment at a rounding tie takes the next code; held within one), and
    the params are held as ``_int8_params_close`` says."""
    _, tb, params = _smoke_bundles()
    plan = dataclasses.replace(tb.plans["prefill_32k"], int8_optimizer=int8)
    tokens = torch.from_numpy(_train_tokens())
    step, (p_struct, o_struct, b_struct) = tsteps.build_sharded_train_step(
        tb.loss_fn, tb.init_fn, {"tokens": tbase.meta(tokens.shape,
                                                      torch.int32)},
        {"data": 1, "model": 1}, plan, T_OPT)
    assert all(x.is_meta for x in tree_leaves((p_struct, o_struct,
                                               b_struct)))
    p = params_from_jax(params, "cpu")
    o = (tadamw.int8_adamw_init if int8 else tadamw.adamw_init)(p)
    _same_struct(o_struct, jax.eval_shape(
        jadamw.int8_adamw_init if int8 else jadamw.adamw_init, params),
        "optimizer state")
    if not int8:
        losses, after = [], []
        for _ in range(STEPS):
            p, o, loss = step(p, o, {"tokens": tokens})
            losses.append(float(loss))
            after.append(tree_map(torch.clone, p))
        _held_to_jax(losses, after, int8, "sharded")
        return
    want_losses, want_after, want_states = _jax_trajectory(True)
    incoming = jax.device_get(jadamw.int8_adamw_init(params))
    for i in range(STEPS):
        if i:
            p = params_from_jax(want_after[i - 1], "cpu")
            o = params_from_jax(want_states[i - 1], "cpu")
            incoming = want_states[i - 1]
        p, o, loss = step(p, o, {"tokens": tokens})
        _close(loss, np.float32(want_losses[i]), f"int8 loss {i}")
        _int8_params_close(p, want_after[i], incoming, f"int8 step {i}")
        assert int(o["step"]) == i + 1
        for mom in ("m", "v"):
            _codes_within_one(o[mom], want_states[i][mom],
                              f"step {i} {mom}")


@pytest.mark.parametrize("strategy", ["pp_wave", "pp_1f1b"])
def test_pp_train_step_matches_jax_sharded_step(strategy):
    """D=2, M=4 equal microbatches: the pipeline's mean of microbatch
    losses is the whole batch's loss, so JAX's sharded step is the
    reference (its params converted after each step)."""
    _, tb, params = _smoke_bundles()
    plan = tsteps.ParallelPlan(strategy=strategy, pp_degree=2,
                               microbatches=TRAIN_M)
    mesh = {"data": 1, "model": 2}
    adapter = tb.make_adapter(plan, mesh)
    assert adapter.wave == (strategy == "pp_wave")
    assert adapter.pcfg.num_devices == 2 and adapter.pcfg.remat
    shape = tbase.ShapeSpec("t", "train", TRAIN_S, TRAIN_B)
    struct = tb.batch_struct(shape, plan)
    assert tuple(struct["tokens"].shape) == (TRAIN_M, TRAIN_B // TRAIN_M,
                                            TRAIN_S)
    step, (p_struct, o_struct, _) = tsteps.build_pp_train_step(
        adapter, mesh, struct, plan, tb.make_microbatches, T_OPT)
    assert all(x.is_meta for x in tree_leaves((p_struct, o_struct)))
    p = adapter.split_params(params_from_jax(params, "cpu"))
    o = tadamw.adamw_init(p)
    tokens = torch.from_numpy(_train_tokens()).reshape(struct["tokens"].shape)
    losses, after = [], []
    for _ in range(STEPS):
        p, o, loss = step(p, o, {"tokens": tokens})
        losses.append(float(loss))
        after.append(adapter.merge_params(*tree_map(torch.clone, p)))
    _held_to_jax(losses, after, False, strategy)


def test_forward_and_serve_steps_match_jax():
    jb, tb, params = _smoke_bundles()
    tp = params_from_jax(params, "cpu")
    tokens = _train_tokens()
    # the forward step (the prefill plan)
    jstep, _, _, _ = jsteps.build_forward_step(
        jb.loss_fn, jb.init_fn,
        {"tokens": jax.ShapeDtypeStruct(tokens.shape, jnp.int32)}, _mesh(),
        jb.plans["prefill_32k"])
    want = jstep.lower(params, {"tokens": tokens}, KEY).compile(
        compiler_options=FAST)(params, {"tokens": tokens}, KEY)
    tstep, (p_struct, _) = tsteps.build_forward_step(
        tb.loss_fn, tb.init_fn, {"tokens": tbase.meta(tokens.shape,
                                                      torch.int32)},
        {"data": 1, "model": 1}, tb.plans["prefill_32k"])
    assert all(x.is_meta for x in tree_leaves(p_struct))
    _close(tstep(tp, {"tokens": torch.from_numpy(tokens)}), want, "forward")
    # four greedy serve steps after a prefill (the decode plan)
    B, P, n = 2, 8, 4
    jshape = jbase.ShapeSpec("s", "decode", P + n + 1, B)
    tshape = tbase.ShapeSpec("s", "decode", P + n + 1, B)
    prompt = tokens[:B, :P]
    jlogits, jcache = jax.jit(jlm.prefill, static_argnums=(2, 3))(
        params, prompt, jb.cfg, P + n + 1)
    jserve, _, _, _ = jsteps.build_sharded_serve_step(
        jb.make_decode_fn(jshape), jb.init_fn, jb.cache_struct(jshape),
        jax.ShapeDtypeStruct((B, 1), jnp.int32), _mesh(),
        jb.plans["decode_32k"])
    jtok = jnp.argmax(jlogits, -1).astype(jnp.int32)
    jserve = jserve.lower(params, jtok, jcache).compile(
        compiler_options=FAST)
    tserve, (_, t_struct, c_struct) = tsteps.build_sharded_serve_step(
        tb.make_decode_fn(tshape), tb.init_fn, tb.cache_struct(tshape),
        tbase.meta((B, 1), torch.int32), {"data": 1, "model": 1},
        tb.plans["decode_32k"])
    _same_struct(c_struct, jb.cache_struct(jshape), "serve caches")
    with torch.inference_mode():
        tlogits, tcache = tlm.prefill(tp, torch.from_numpy(prompt), tb.cfg,
                                      P + n + 1)
    _close(tlogits, jlogits, "prefill logits")
    ttok = torch.argmax(tlogits, -1).to(torch.int32)
    for i in range(n):
        jtok, jcache = jserve(params, jtok, jcache)
        ttok, tcache = tserve(tp, ttok, tcache)
        assert ttok.dtype == torch.int32 and tuple(ttok.shape) == (B, 1)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok),
                                      err_msg=f"step {i}")
    _close_tree(tcache, jcache, "caches after the serve steps")
    assert tcache["layers"]["pos"] == P + n


# ---------------------------------------------------------------------------
# the diffusion bundles' microbatches and losses, JAX's draws injected
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["uvit-h", "hunyuan-dit"])
def test_diffusion_microbatches_and_loss_match_jax(arch):
    """The smoke config in place of the module's (fp32): a batch of 8 in
    4 microbatches, JAX's DDPM draws of ``KEY`` injected."""
    jmod, tmod = (juvit, tuvit) if arch == "uvit-h" else (jhunyuan, thunyuan)
    jcfg, tcfg = JAX_SMOKE[arch]()[3], TORCH_SMOKE[arch]()[3]
    params = jax.device_get(jax.jit(lambda k: (
        jdm.init_uvit if arch == "uvit-h" else jdm.init_hunyuan)(k, jcfg))(
            KEY))
    tp = params_from_jax(params, "cpu")
    rng = np.random.default_rng(6)
    batch = {"latents": rng.standard_normal((4, 2, 8, 8, 4)).astype(
        np.float32)}
    if arch == "uvit-h":
        batch["labels"] = rng.integers(0, 10, (4, 2)).astype(np.int32)
    else:
        batch["text_embeds"] = rng.standard_normal((4, 2, 7, 16)).astype(
            np.float32)
    key = jax.random.PRNGKey(7)
    rt, rn = jax.random.split(key)
    t = np.asarray(jax.random.uniform(rt, (8,)))
    noise = np.asarray(jax.random.normal(rn, (8, 8, 8, 4), jnp.float32))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    edge = {k: v for k, v in params.items()
            if k not in ("enc_blocks", "dec_blocks")}
    with mock.patch.object(jmod, "CFG", jcfg), \
            mock.patch.object(tmod, "CFG", tcfg):
        want = jax.device_get(jmod.make_microbatches(batch, key, edge))
        got = tmod.make_microbatches(
            tbatch, None, {k: v for k, v in tp.items()
                           if k not in ("enc_blocks", "dec_blocks")},
            t=torch.from_numpy(t), noise=torch.from_numpy(noise))
        _close_tree(list(got), list(want), f"{arch} microbatches")
        want_loss = jax.jit(jmod.loss_fn).lower(params, batch, key).compile(
            compiler_options=FAST)(params, batch, key)
        _close(tmod.loss_fn(tp, tbatch, t=torch.from_numpy(t),
                            noise=torch.from_numpy(noise)),
               want_loss, f"{arch} loss")
        # drawn from a generator when no draws are given: finite, and the
        # same generator state gives the same loss
        losses = [float(tmod.loss_fn(tp, tbatch,
                                     torch.Generator().manual_seed(1)))
                  for _ in range(2)]
        assert np.isfinite(losses[0]) and losses[0] == losses[1]


def test_hunyuan_temb_trains_time_mlp_through_the_pipeline():
    """The bundle's microbatches keep ``temb``'s graph, so the pipeline
    step's ``time_mlp`` gradient is not zero (as under JAX's
    ``build_pp_train_step``)."""
    tcfg = TORCH_SMOKE["hunyuan-dit"]()[3]
    with mock.patch.object(thunyuan, "CFG", tcfg):
        plan = tsteps.ParallelPlan(strategy="pp_wave", microbatches=2)
        adapter = thunyuan.make_adapter(plan, {"model": 2})
        gen = torch.Generator().manual_seed(0)
        p = adapter.init_pipeline_params(gen, "cpu")
        batch = {"latents": torch.randn(2, 1, 8, 8, 4, generator=gen),
                 "text_embeds": torch.randn(2, 1, 7, 16, generator=gen)}
        (stacks, edge) = p
        for x in tree_leaves(p):
            x.requires_grad_(True)
        args = thunyuan.make_microbatches(batch, gen, edge)
        adapter.build()(*stacks, edge, *args).backward()
    assert all(float(x.grad.abs().sum()) > 0
               for x in tree_leaves(edge["time_mlp"]))


# ---------------------------------------------------------------------------
# what one process refuses
# ---------------------------------------------------------------------------

P = tsteps.ParallelPlan
REFUSALS = [
    # mesh, plan, the word the error names
    ({"data": 1, "model": 4}, P(), "tensor parallelism"),
    ({"data": 1, "model": 4}, P(ep=True), "expert"),
    ({"data": 2, "model": 1}, P(tp_axis=None, seq_shard_axis="data"),
     "sequence sharding"),
    ({"data": 2, "model": 1}, P(tp_axis=None), "data parallelism"),
    ({"model": 2}, P(tp_axis=None, fsdp_axes=("model",)), "FSDP"),
    # over ranks, what a grid still refuses (tensor parallelism runs)
    (RankGrid(world=2, dp=1, pp=2, rank=0), P(ep=True), "a grid of 2 ranks"),
]


@pytest.mark.parametrize("mesh,plan,word", REFUSALS)
def test_one_process_refuses_what_it_cannot_run(mesh, plan, word):
    _, tb, _ = _smoke_bundles()
    struct = {"tokens": tbase.meta((2, 8), torch.int32)}
    for build in (tsteps.build_sharded_train_step,
                  tsteps.build_forward_step):
        with pytest.raises(NotImplementedError, match=word):
            build(tb.loss_fn, tb.init_fn, struct, mesh, plan)


def test_pp_adapters_refuse_data_replicas_and_a_grid_of_ranks():
    tb = tconfigs.get_arch("smollm-360m")
    plan = tb.plans["train_4k"]
    with pytest.raises(NotImplementedError, match="data parallelism"):
        tb.make_adapter(plan, {"data": 2, "model": 4})
    # a grid of ranks gives a rank's adapter (D = pp, dp replicas), which
    # builds only with the rank's ring and data group: one process refuses
    grid = tb.make_adapter(plan, RankGrid(world=8, dp=2, pp=4, rank=0))
    assert (grid.pcfg.num_devices, grid.pcfg.dp_size) == (4, 2)
    with pytest.raises(ValueError, match="dp_size=2"):
        grid.build()
    one = tb.make_adapter(plan, RankGrid(world=1, dp=1, pp=1, rank=0))
    assert one.pcfg.num_devices == 1 and one.wave
    # size-1 axes are no-ops: smollm's own decode plan (TP over "model")
    step, _ = tsteps.build_sharded_serve_step(
        tb.make_decode_fn(tbase.SHAPES["decode_32k"]), tb.init_fn, {},
        tbase.meta((2, 1), torch.int32), {"data": 1, "model": 1},
        tb.plans["decode_32k"])
    assert callable(step)
