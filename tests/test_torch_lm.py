"""The port's decoder-LM family held to the JAX package's.

Parameters are drawn by the JAX package (``jax.random``) and carried into
the port with ``params_from_jax``; inputs are numpy arrays made from a seed
and handed to both.  fp32 throughout, values and gradients at rtol 1e-4,
the bar of the JAX package's own differential tests; an entry near zero
may err by 1e-5 of its leaf's largest magnitude (atol; at least 1e-6),
fp32 rounding in another summation order:

- the layers: ``apply_rope``, attention with qk-norm (and with a window,
  at shifted positions), SwiGLU, MLA, and MoE under each of its three
  dispatches, at a capacity that keeps every assignment and at one that
  drops some;
- ``lm_loss`` and its gradients for the seven decoder-LM smoke configs
  (tied, window, MQA + GELU MLP, qk-norm with MoE scatter, MLA with MoE
  and MTP, vision prefix), the port with its kernels on (flash on CPU
  tensors runs its plain version), one JAX fixture per config;
- the seven full configs: their widths letter for letter and
  ``param_count`` / ``active_param_count`` exactly; ``lm_pipeline_graph``
  block for block.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.smoke import SMOKE_FACTORIES as JAX_SMOKE
from repro.core import hw as jax_hw
from repro.models import layers as JL
from repro.models import lm as jlm
from repro_torch.configs.smoke import LM_FACTORIES
from repro_torch.convert import params_from_jax
from repro_torch.core import hw as torch_hw
from repro_torch.models import layers as TL
from repro_torch.models import lm as tlm
from repro_torch.tree import tree_paths

RTOL, ATOL = 1e-4, 1e-6
KEY = jax.random.PRNGKey(3)
FAST = {"xla_backend_optimization_level": 0}
LM_KEYS = tuple(LM_FACTORIES)
FULL = {"smollm-360m": "smollm_360m", "h2o-danube-1.8b": "h2o_danube_1_8b",
        "internlm2-20b": "internlm2_20b", "granite-34b": "granite_34b",
        "internvl2-2b": "internvl2_2b",
        "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
        "deepseek-v3-671b": "deepseek_v3_671b"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes gain nothing from more threads, and tier-1 runs six
    test processes on the host's cores at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_flat(tree):
    return {k: np.asarray(v) for k, v in zip(*_paths_and_leaves(tree))}


def _assert_tree_close(torch_tree, jax_tree):
    want = _jax_flat(jax_tree)
    got = dict(tree_paths(torch_tree))
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        _close(v.detach().float().numpy(), want[k], k)


def _paths_and_leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return (["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path) for path, _ in flat],
            [v for _, v in flat])


def _close(got, want, what=""):
    atol = max(ATOL, 1e-5 * float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol, err_msg=what)


def _run_jax(f, *args):
    """``jax.jit(f)(*args)``, compiled at XLA's lowest backend optimization
    level: the same function, compiled in about a third of the time (the
    JAX references are tier-1's cost here, their runs are not)."""
    return jax.jit(f).lower(*args).compile(compiler_options=FAST)(*args)


def _leaves(params):
    p = params_from_jax(jax.device_get(params), "cpu")
    for _, x in tree_paths(p):
        x.requires_grad_(True)
    return p


def _grads(p):
    from repro_torch.tree import tree_map
    return tree_map(lambda x: x.grad, p)


def _torch_cfg(jcfg, cls, **over):
    """The port's dataclass of the same fields as a JAX config."""
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
          if f.name in {g.name for g in dataclasses.fields(cls)}}
    kw.pop("router_dtype", None)
    return cls(**{**kw, **over})


def _layer_parity(jfn, tfn, jp, x, aux_weight=None):
    """Both packages' ``f(p, x)`` and the value and grads (params and
    input) of ``sum(out * w)``, ``w`` a fixed numpy weight of the output's
    shape.  ``jfn``/``tfn`` return ``out`` or ``(out, aux)``; with
    ``aux_weight`` the scalar ``aux`` is compared and enters the objective
    as ``aux_weight * aux`` (one JAX compile either way)."""
    w = None

    def parts(o):
        return (o[0], o[1]) if isinstance(o, tuple) else (o, None)

    def jloss(p, x):
        o, aux = parts(jfn(p, x))
        val = jnp.sum(o * w)
        if aux_weight is not None:
            val = val + aux_weight * aux
        return val, (o, aux)
    shape = jax.eval_shape(lambda: parts(jfn(jp, x))[0]).shape
    w = np.random.default_rng(7).normal(size=shape).astype(np.float32)
    (jval, (out, jaux)), jg = _run_jax(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True), jp, x)
    tp = _leaves(jp)
    tx = torch.tensor(np.asarray(x), requires_grad=True)
    o, aux = parts(tfn(tp, tx))
    _close(o.detach().numpy(), np.asarray(out))
    val = (o * torch.from_numpy(w)).sum()
    if aux_weight is not None:
        np.testing.assert_allclose(float(aux.detach()), float(jaux),
                                   rtol=RTOL)
        val = val + aux_weight * aux
    val.backward()
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=RTOL,
                               atol=ATOL)
    _assert_tree_close(_grads(tp), jg[0])
    _close(tx.grad.numpy(), np.asarray(jg[1]))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_apply_rope_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 9, 3, 16)).astype(np.float32)
    pos = (np.arange(9)[None, :] + np.array([[0], [5]])).astype(np.int32)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 500.0)
    got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 500.0)
    _close(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(TL.rope_freqs(16).numpy(),
                               np.asarray(JL.rope_freqs(16)), rtol=1e-6)
    # bf16 in, bf16 out, the angles in fp32
    xb = torch.from_numpy(x).bfloat16()
    assert TL.apply_rope(xb, torch.from_numpy(pos)).dtype == torch.bfloat16


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("qk_norm,window", [(True, None), (False, 4)])
def test_attention_qk_norm_rope_matches_jax(qk_norm, window, flash):
    jcfg = JL.AttnConfig(32, 4, 2, 8, window=window, qk_norm=qk_norm)
    tcfg = _torch_cfg(jcfg, TL.AttnConfig, use_flash=flash)
    jp = JL.init_attention(KEY, jcfg)
    # qk-norm scales drawn away from 1, so their gradients are tested
    if qk_norm:
        jp = dict(jp, q_norm=1 + 0.1 * jax.random.normal(KEY, (8,)),
                  k_norm=1 - 0.1 * jax.random.normal(KEY, (8,)))
    x = np.random.default_rng(1).normal(size=(2, 11, 32)).astype(np.float32)
    pos = np.arange(3, 14)[None, :].astype(np.int32)     # shifted positions
    _layer_parity(
        lambda p, x: JL.apply_attention(p, x, jcfg, positions=pos),
        lambda p, x: TL.apply_attention(p, x, tcfg,
                                        positions=torch.from_numpy(pos)),
        jp, x)


def test_swiglu_matches_jax():
    jp = JL.init_swiglu(KEY, 16, 40)
    x = np.random.default_rng(2).normal(size=(2, 5, 16)).astype(np.float32)
    _layer_parity(JL.apply_swiglu, TL.apply_swiglu, jp, x)


def test_mla_matches_jax():
    jcfg = JL.MLAConfig(32, 4, q_lora_rank=16, kv_lora_rank=12,
                        qk_nope_dim=8, qk_rope_dim=4, v_head_dim=6)
    tcfg = _torch_cfg(jcfg, TL.MLAConfig)
    jp = JL.init_mla(KEY, jcfg)
    x = np.random.default_rng(3).normal(size=(2, 10, 32)).astype(np.float32)
    _layer_parity(lambda p, x: JL.apply_mla(p, x, jcfg),
                  lambda p, x: TL.apply_mla(p, x, tcfg), jp, x)


# (dispatch, capacity factor, shared experts): 0.5 drops assignments
MOE_CASES = [("onehot", 2.0, 0), ("onehot", 0.5, 1), ("scatter", 2.0, 1),
             ("scatter", 0.5, 0), ("dense", 1.25, 1)]


@pytest.mark.parametrize("dispatch,cf,n_shared", MOE_CASES)
def test_moe_matches_jax(dispatch, cf, n_shared):
    jcfg = JL.MoEConfig(16, 12, n_experts=6, top_k=2, n_shared=n_shared,
                        capacity_factor=cf)
    tcfg = _torch_cfg(jcfg, TL.MoEConfig)
    jp = JL.init_moe(KEY, jcfg)
    x = np.random.default_rng(4).normal(size=(2, 9, 16)).astype(np.float32)
    # the aux loss enters the objective: its gradient reaches the router
    _layer_parity(lambda p, x: JL.apply_moe(p, x, jcfg, dispatch=dispatch),
                  lambda p, x: TL.apply_moe(p, x, tcfg, dispatch=dispatch),
                  jp, x, aux_weight=10.0)
    tp = _leaves(jp)
    if cf < 1:
        # capacity bites: the output differs from the uncapped one
        full = TL.apply_moe(tp, torch.from_numpy(x),
                            dataclasses.replace(tcfg, capacity_factor=8.0),
                            dispatch=dispatch)[0]
        got = TL.apply_moe(tp, torch.from_numpy(x), tcfg,
                           dispatch=dispatch)[0]
        assert not torch.allclose(full, got)


def test_moe_refuses_unknown_dispatch():
    tcfg = TL.MoEConfig(8, 4, n_experts=2, top_k=1)
    p = TL.init_moe(torch.Generator().manual_seed(0), tcfg, device="cpu")
    with pytest.raises(ValueError, match="unknown MoE dispatch"):
        TL.apply_moe(p, torch.zeros(1, 2, 8), tcfg, dispatch="sparse")


# ---------------------------------------------------------------------------
# the seven smoke LMs: lm_loss and its gradients
# ---------------------------------------------------------------------------

def _batch(cfg, prefix: int) -> dict:
    rng = np.random.default_rng(13)
    b = {"tokens": rng.integers(0, cfg.vocab, size=(2, 32)).astype(np.int32)}
    if prefix:
        b["prefix_embeds"] = rng.normal(
            size=(2, prefix, cfg.d_model)).astype(np.float32)
    return b


@functools.lru_cache(maxsize=None)
def _jax_lm(key):
    """The JAX smoke config's params, a batch, and its loss and grads."""
    _, init_fn, _, cfg = JAX_SMOKE[key]()
    batch = _batch(cfg, cfg.vision_prefix)

    def ref(k):         # one compile: init, then the loss and its grads
        p = init_fn(k)
        return p, jax.value_and_grad(lambda p: jlm.lm_loss(
            p, {k: jnp.asarray(v) for k, v in batch.items()}, cfg))(p)
    params, (loss, grads) = _run_jax(ref, KEY)
    return (jax.device_get(params), batch, float(loss),
            jax.device_get(grads))


@pytest.mark.parametrize("key", LM_KEYS)
def test_lm_loss_and_grads_match_jax(key):
    params, batch, loss, grads = _jax_lm(key)
    loss_fn, _, _, cfg = LM_FACTORIES[key](kernels=True)
    tp = _leaves(params)
    got = loss_fn(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    got.backward()
    np.testing.assert_allclose(float(got.detach()), loss, rtol=RTOL)
    _assert_tree_close(_grads(tp), grads)


def test_lm_smoke_configs_are_the_jax_ones():
    """Every field of each smoke config (and of its attention, MLA and MoE
    configs) equals the JAX one's, kernels aside."""
    for key in LM_KEYS:
        jcfg = JAX_SMOKE[key]()[3]
        tcfg = LM_FACTORIES[key](kernels=True)[3]
        _assert_same_config(tcfg, jcfg, key)
        # flash wherever the config has an attention (MLA: the dense one)
        assert (tcfg.attn is not None and tcfg.attn.use_flash) \
            == (key != "deepseek-v3-671b")


# fields of the JAX LM config the port has not: no config sets them
JAX_ONLY = ("remat_policy", "seq_shard_activations")


def _assert_same_config(tcfg, jcfg, what):
    for f in dataclasses.fields(jcfg):
        if f.name in JAX_ONLY:
            assert not hasattr(tcfg, f.name), (what, f.name)
            assert getattr(jcfg, f.name) is None, (what, f.name)
            continue
        a, b = getattr(tcfg, f.name), getattr(jcfg, f.name)
        if f.name in ("dtype", "param_dtype", "router_dtype"):
            assert str(a).split(".")[-1] == jnp.dtype(b).name, (what, f.name)
        elif dataclasses.is_dataclass(b):
            _assert_same_config(a, b, f"{what}.{f.name}")
        else:
            assert a == b, (what, f.name, a, b)


def test_lm_smoke_batches_and_init():
    """``make_batch`` gives the JAX batch's keys, shapes and dtypes;
    ``init_fn`` the JAX tree's paths, shapes and dtypes."""
    for key in LM_KEYS:
        _, jinit, jbatch, _ = JAX_SMOKE[key]()
        _, tinit, tbatch, _ = LM_FACTORIES[key]()
        gen = torch.Generator().manual_seed(0)
        want = jax.eval_shape(lambda: jbatch(KEY))
        got = tbatch(gen, "cpu")
        assert sorted(got) == sorted(want)
        for k in got:
            assert tuple(got[k].shape) == want[k].shape
            assert str(got[k].dtype).split(".")[-1] == want[k].dtype.name
        jshape = {k: v for k, v in zip(*_paths_and_leaves(
            jax.eval_shape(lambda: jinit(KEY))))}
        tshape = dict(tree_paths(tinit(gen, "meta")))
        assert sorted(jshape) == sorted(tshape), key
        for k, v in tshape.items():
            assert tuple(v.shape) == jshape[k].shape, (key, k)


def test_lm_config_refusals():
    """The JAX config's ``remat_policy`` and ``seq_shard_activations`` (a
    GSPMD hint) are no fields of the port's: a config that sets one is
    refused, never run without it."""
    cfg = LM_FACTORIES["smollm-360m"]()[3]
    for over in (dict(remat_policy="dots"), dict(seq_shard_activations="d")):
        with pytest.raises(TypeError):
            dataclasses.replace(cfg, **over)


def test_lm_remat_matches_no_remat():
    """``remat`` recomputes each layer in the backward: the same loss and
    gradients (deepseek: both stacks, MoE and MTP)."""
    params, batch, loss, grads = _jax_lm("deepseek-v3-671b")
    loss_fn, _, _, cfg = LM_FACTORIES["deepseek-v3-671b"]()
    cfg = dataclasses.replace(cfg, remat=True)
    tp = _leaves(params)
    got = tlm.lm_loss(tp, {k: torch.from_numpy(v) for k, v in batch.items()},
                      cfg)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), loss, rtol=RTOL)
    _assert_tree_close(_grads(tp), grads)


# ---------------------------------------------------------------------------
# the seven full configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key", LM_KEYS)
def test_full_config_widths_and_param_counts(key):
    import importlib
    jcfg = importlib.import_module(f"repro.configs.{FULL[key]}").CFG
    tcfg = importlib.import_module(f"repro_torch.configs.{FULL[key]}").CFG
    _assert_same_config(tcfg, jcfg, key)
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()
    # use_flash on every attention the kernel builds (head dims 64, 80 and
    # 128), never on MLA
    want_flash = {"smollm-360m", "h2o-danube-1.8b", "internlm2-20b",
                  "granite-34b", "internvl2-2b", "qwen3-moe-30b-a3b"}
    assert (tcfg.attn is not None and tcfg.attn.use_flash) \
        == (key in want_flash)


def test_lm_pipeline_graph_matches_jax():
    hw = torch_hw.Hardware(**dataclasses.asdict(jax_hw.TPU_V5E))
    for key in ("smollm-360m", "qwen3-moe-30b-a3b"):
        jcfg = JAX_SMOKE[key]()[3]
        tcfg = LM_FACTORIES[key]()[3]
        jg = jlm.lm_pipeline_graph(jcfg, batch=2, seq=32, hw=jax_hw.TPU_V5E)
        tg = tlm.lm_pipeline_graph(tcfg, batch=2, seq=32, hw=hw)
        assert [dataclasses.astuple(b) for b in tg.blocks] == \
            [dataclasses.astuple(b) for b in jg.blocks]
        assert tg.skips == () == tuple(jg.skips)
        times = [1.0 + i for i in range(tcfg.n_layers)]
        assert [b.fwd_time for b in tlm.lm_pipeline_graph(
            tcfg, fwd_times=times).blocks] == times
    with pytest.raises(ValueError, match="one entry per layer"):
        tlm.lm_pipeline_graph(tcfg, fwd_times=[1.0])
