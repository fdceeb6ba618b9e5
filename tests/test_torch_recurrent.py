"""The port's whisper, xLSTM and Mamba2/Zamba2 models held to the JAX
package's.

Parameters are drawn by the JAX package (``jax.random``) and carried into
the port with ``params_from_jax``; inputs are numpy arrays made from a seed
and handed to both.  fp32 throughout, values and gradients at rtol 1e-4;
an entry near zero may err by 1e-5 of its leaf's largest magnitude (atol;
at least 1e-6), fp32 rounding in another summation order.  A function
with several outputs is compared output by output, and its gradients are
those of ``sum_i sum(out_i * w_i)``, ``w_i`` fixed numpy weights:

- ``layer_norm``;
- whisper's ``encode``, ``decode`` and ``whisper_loss`` (flash on: its
  plain version on CPU tensors);
- ``mlstm_parallel``, ``slstm_scan`` (with its final state),
  ``causal_conv``, both xLSTM blocks and ``xlstm_loss``;
- ``_ssd_chunked`` (the carry through ``gated_linear_scan``, whose plain
  version a CPU tensor takes) and ``_ssd_chunked_plain`` (the JAX loop
  over chunks), output and final state, at S a multiple of the chunk and
  at chunk = S; ``apply_mamba2_block`` and
  ``zamba2_loss`` (the scan called once a Mamba2 block);
- the three smoke configs in bf16, loss at rtol 2e-2 (bf16 rounding; the
  xLSTM checks JAX's promotion of its fp32 cells against bf16 weights);
- the smoke and full configs: every field, the params' paths, shapes and
  dtypes, ``param_count`` exactly, and the gap between each full
  config's ``param_count`` and its params, named.
"""
import dataclasses
import functools
import importlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.smoke import SMOKE_FACTORIES as JAX_SMOKE
from repro.models import layers as JL
from repro.models import mamba as jm
from repro.models import whisper as jw
from repro.models import xlstm as jx
from repro_torch.configs.smoke import RECURRENT_FACTORIES
from repro_torch.convert import params_from_jax
from repro_torch.models import layers as TL
from repro_torch.models import mamba as tm
from repro_torch.models import whisper as tw
from repro_torch.models import xlstm as tx
from repro_torch.tree import tree_leaves, tree_paths

RTOL, ATOL = 1e-4, 1e-6
BF16_RTOL = 2e-2
KEY = jax.random.PRNGKey(5)
FAST = {"xla_backend_optimization_level": 0}
KEYS = tuple(RECURRENT_FACTORIES)
FULL = {"whisper-base": "whisper_base", "xlstm-125m": "xlstm_125m",
        "zamba2-2.7b": "zamba2_2_7b"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes gain nothing from more threads, and tier-1 runs six
    test processes on the host's cores at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _paths_and_leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return (["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path) for path, _ in flat],
            [v for _, v in flat])


def _close(got, want, what=""):
    atol = max(ATOL, 1e-5 * float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol, err_msg=what)


def _run_jax(f, *args):
    """``jax.jit(f)(*args)`` compiled at XLA's lowest backend optimization
    level (the JAX references are the file's cost)."""
    return jax.jit(f).lower(*args).compile(compiler_options=FAST)(*args)


def _tuple(out):
    return out if isinstance(out, tuple) else (out,)


def _parity(jfn, tfn, jp, *xs):
    """``jfn(jp, *xs)`` against ``tfn(params_from_jax(jp), *xs)``: each
    output, and the value and gradients (params and every float input) of
    ``sum_i sum(out_i * w_i)``."""
    fl = [i for i, x in enumerate(xs) if np.issubdtype(x.dtype, np.floating)]
    shapes = _tuple(jax.eval_shape(lambda: jfn(jp, *xs)))
    rng = np.random.default_rng(7)
    ws = [rng.normal(size=s.shape).astype(np.float32) for s in shapes]

    def with_floats(fx):
        args = list(xs)
        for i, v in zip(fl, fx):
            args[i] = v
        return args

    def jloss(p, *fx):
        outs = _tuple(jfn(p, *with_floats(fx)))
        return sum(jnp.sum(o * w) for o, w in zip(outs, ws)), outs
    (jval, jouts), jg = _run_jax(jax.value_and_grad(
        jloss, argnums=tuple(range(1 + len(fl))), has_aux=True), jp,
        *[xs[i] for i in fl])
    tp = params_from_jax(jax.device_get(jp), "cpu")
    for _, leaf in tree_paths(tp):
        leaf.requires_grad_(True)
    txs = [torch.tensor(np.asarray(x), requires_grad=i in fl)
           for i, x in enumerate(xs)]
    touts = _tuple(tfn(tp, *txs))
    assert len(touts) == len(jouts)
    for k, (o, j) in enumerate(zip(touts, jouts)):
        _close(o.detach().float().numpy(), np.asarray(j), f"output {k}")
    val = sum((o * torch.from_numpy(w)).sum() for o, w in zip(touts, ws))
    val.backward()
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=RTOL,
                               atol=ATOL)
    _assert_grads_close(tp, jg[0])
    for i, g in zip(fl, jg[1:]):
        _close(txs[i].grad.numpy(), np.asarray(g), f"input {i}")


def _assert_grads_close(tp, jgrads):
    """Each leaf's ``.grad`` (none where the leaf took no part: zeros, as
    JAX gives them) against the JAX gradient tree."""
    want = dict(zip(*_paths_and_leaves(jgrads)))
    got = dict(tree_paths(tp))
    assert sorted(got) == sorted(want)
    for k, leaf in got.items():
        g = (leaf.grad if leaf.grad is not None
             else torch.zeros_like(leaf)).float().numpy()
        _close(g, np.asarray(want[k]), k)


def _normal(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _tokens(rng, vocab, *shape):
    return rng.integers(0, vocab, size=shape).astype(np.int32)


def _smoke(key):
    """The JAX and the port's smoke config of ``key`` (kernels on)."""
    return JAX_SMOKE[key]()[3], RECURRENT_FACTORIES[key](kernels=True)[3]


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = _normal(rng, 3, 5, 24, scale=3.0) + 2.0
    scale, bias = _normal(rng, 24), _normal(rng, 24)
    if dtype == "float32":
        _parity(lambda p, x: JL.layer_norm(x, p["s"], p["b"], 1e-5),
                lambda p, x: TL.layer_norm(x, p["s"], p["b"], 1e-5),
                {"s": jnp.asarray(scale), "b": jnp.asarray(bias)}, x)
        return
    # bf16 in, bf16 out, the statistics in fp32: within one bf16 rounding
    want = JL.layer_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(scale),
                         jnp.asarray(bias))
    got = TL.layer_norm(torch.from_numpy(x).bfloat16(),
                        torch.from_numpy(scale), torch.from_numpy(bias))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=2.0 ** -8,
                               atol=2.0 ** -8)


# ---------------------------------------------------------------------------
# whisper
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _whisper():
    jcfg, tcfg = _smoke("whisper-base")
    params = jax.device_get(_run_jax(lambda k: jw.init_whisper(k, jcfg), KEY))
    rng = np.random.default_rng(11)
    return jcfg, tcfg, params, _normal(rng, 2, 12, 32), _tokens(rng, 256,
                                                               2, 10)


def test_whisper_encode_matches_jax():
    jcfg, tcfg, params, frames, _ = _whisper()
    assert tcfg.use_flash and tcfg.attn_cfg(True).use_flash
    _parity(lambda p, f: jw.encode(p, f, jcfg),
            lambda p, f: tw.encode(p, f, tcfg), params, frames)


def test_whisper_decode_matches_jax():
    """The causal decoder with cross-attention over encoded frames (an
    input here, so its gradient is held too)."""
    jcfg, tcfg, params, _, tokens = _whisper()
    enc = _normal(np.random.default_rng(12), 2, 12, 32)
    _parity(lambda p, t, e: jw.decode(p, t, e, jcfg)[0],
            lambda p, t, e: tw.decode(p, t, e, tcfg)[0], params, tokens, enc)


def test_whisper_loss_matches_jax():
    jcfg, tcfg, params, frames, tokens = _whisper()
    _parity(lambda p, f, t: jw.whisper_loss(p, {"frames": f, "tokens": t},
                                            jcfg),
            lambda p, f, t: tw.whisper_loss(p, {"frames": f, "tokens": t},
                                            tcfg), params, frames, tokens)


# ---------------------------------------------------------------------------
# xLSTM
# ---------------------------------------------------------------------------

def test_mlstm_parallel_matches_jax():
    rng = np.random.default_rng(1)
    B, S, H, Dh = 2, 9, 2, 8
    q, k, v = (_normal(rng, B, S, H, Dh) for _ in range(3))
    i_pre, f_pre = _normal(rng, B, S, H), _normal(rng, B, S, H, scale=2.0)
    _parity(lambda p, *a: jx.mlstm_parallel(*a),
            lambda p, *a: tx.mlstm_parallel(*a), {}, q, k, v, i_pre, f_pre)


@functools.lru_cache(maxsize=None)
def _xlstm():
    jcfg, tcfg = _smoke("xlstm-125m")
    params = jax.device_get(_run_jax(lambda k: jx.init_xlstm(k, jcfg), KEY))
    return jcfg, tcfg, params


def test_slstm_scan_matches_jax():
    """The loop over time, its output and final state ``(c, n, m, h)``,
    gradients through every step (the block's other leaves take no part:
    zero gradients on both sides)."""
    jcfg, _, params = _xlstm()
    sp = params["blocks"][2]
    assert jcfg.is_slstm(2)
    x = _normal(np.random.default_rng(2), 2, 7, jcfg.d_inner)

    def jfn(p, x):
        h, st = jx.slstm_scan(p, x, jx.init_slstm_state(2, jcfg.d_inner))
        return h, st["c"], st["n"], st["m"], st["h"]

    def tfn(p, x):
        h, st = tx.slstm_scan(p, x, tx.init_slstm_state(2, jcfg.d_inner,
                                                        "cpu"))
        return h, st["c"], st["n"], st["m"], st["h"]
    _parity(jfn, tfn, sp, x)


def test_causal_conv_matches_jax():
    rng = np.random.default_rng(3)
    x, w = _normal(rng, 2, 6, 5), _normal(rng, 4, 5)
    _parity(lambda p, x: jx.causal_conv(x, p["w"])[0],
            lambda p, x: tx.causal_conv(x, p["w"])[0], {"w": jnp.asarray(w)},
            x)


@pytest.mark.parametrize("block", ["mlstm", "slstm"])
def test_xlstm_blocks_match_jax(block):
    jcfg, tcfg, params = _xlstm()
    i = 2 if block == "slstm" else 0
    assert jcfg.is_slstm(i) == (block == "slstm")
    x = _normal(np.random.default_rng(4), 2, 8, jcfg.d_model)
    jfn = getattr(jx, f"apply_{block}_block")
    tfn = getattr(tx, f"apply_{block}_block")
    _parity(lambda p, x: jfn(p, x, jcfg)[0],
            lambda p, x: tfn(p, x, tcfg)[0], params["blocks"][i], x)


def test_xlstm_loss_matches_jax():
    jcfg, tcfg, params = _xlstm()
    tokens = _tokens(np.random.default_rng(5), 256, 2, 16)
    _parity(lambda p, t: jx.xlstm_loss(p, {"tokens": t}, jcfg),
            lambda p, t: tx.xlstm_loss(p, {"tokens": t}, tcfg), params,
            tokens)


# ---------------------------------------------------------------------------
# Mamba2 / Zamba2
# ---------------------------------------------------------------------------

def _ssd_inputs(S):
    rng = np.random.default_rng(6)
    b, H, P, N = 2, 4, 8, 8
    return [_normal(rng, b, S, H, P),
            np.log1p(np.exp(_normal(rng, b, S, H))).astype(np.float32),
            -np.exp(_normal(rng, H, scale=0.3)).astype(np.float32),
            _normal(rng, b, S, N), _normal(rng, b, S, N)]


@pytest.mark.parametrize("route,S,chunk", [
    ("scan", 8, 4),             # two chunks
    ("scan", 8, 8),             # chunk = S: one
    ("scan", 12, 4),            # three
    ("plain", 8, 4),
    ("plain", 12, 4)])
def test_ssd_chunked_matches_jax(route, S, chunk):
    """Output and final state of the chunked scan, and their gradients
    (every input, the decay ``a`` among them)."""
    tfn = {"scan": tm._ssd_chunked, "plain": tm._ssd_chunked_plain}[route]
    _parity(lambda p, x, dt, a, B, C: jm._ssd_chunked(x, dt, a, B, C, chunk),
            lambda p, x, dt, a, B, C: tfn(x, dt, a, B, C, chunk),
            {}, *_ssd_inputs(S))


@functools.lru_cache(maxsize=None)
def _zamba2():
    jcfg, tcfg = _smoke("zamba2-2.7b")
    params = jax.device_get(_run_jax(lambda k: jm.init_zamba2(k, jcfg), KEY))
    return jcfg, tcfg, params


def test_mamba2_block_matches_jax():
    jcfg, tcfg, params = _zamba2()
    x = _normal(np.random.default_rng(8), 2, 16, jcfg.d_model)
    _parity(lambda p, x: jm.apply_mamba2_block(p, x, jcfg.mamba)[0],
            lambda p, x: tm.apply_mamba2_block(p, x, tcfg.mamba)[0],
            params["mamba_blocks"][1], x)


def test_zamba2_loss_matches_jax():
    """The whole model: shared blocks 0 and 1 after Mamba2 blocks 2 and 5,
    their gradients summed over their sites; every Mamba2 block's carry
    through one call of the gated linear scan."""
    jcfg, tcfg, params = _zamba2()
    assert jcfg.shared_sites() == tcfg.shared_sites() == [2, 5]
    tokens = _tokens(np.random.default_rng(9), 256, 2, 16)
    calls = []

    def counted(a, x):
        calls.append(tuple(x.shape))
        return scan(a, x)
    scan = tm.gated_linear_scan
    with mock.patch.object(tm, "gated_linear_scan", counted):
        _parity(lambda p, t: jm.zamba2_loss(p, {"tokens": t}, jcfg),
                lambda p, t: tm.zamba2_loss(p, {"tokens": t}, tcfg), params,
                tokens)
    # (R=b, T=S/chunk, C=H*N*P) = (2, 4, 8 * 8 * 8), once a block
    assert calls == [(2, 4, 512)] * jcfg.n_layers


# ---------------------------------------------------------------------------
# bf16, configs and params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key", KEYS)
def test_bf16_smoke_loss_matches_jax(key):
    """bf16 params and activations: the loss at rtol 2e-2.  JAX promotes a
    matmul of fp32 by bf16 to fp32 where PyTorch refuses it; the port
    casts there (xLSTM's cells return fp32, so its stream is fp32 after
    the first block; Mamba2's dt is fp32)."""
    jcfg, tcfg = _smoke(key)
    jcfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16,
                               param_dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(tcfg, dtype=torch.bfloat16,
                               param_dtype=torch.bfloat16)
    jinit = {"whisper-base": jw.init_whisper, "xlstm-125m": jx.init_xlstm,
             "zamba2-2.7b": jm.init_zamba2}[key]
    jloss = {"whisper-base": jw.whisper_loss, "xlstm-125m": jx.xlstm_loss,
             "zamba2-2.7b": jm.zamba2_loss}[key]
    tloss = {"whisper-base": tw.whisper_loss, "xlstm-125m": tx.xlstm_loss,
             "zamba2-2.7b": tm.zamba2_loss}[key]
    rng = np.random.default_rng(10)
    batch = {"tokens": _tokens(rng, 256, 2, 16)}
    if key == "whisper-base":
        batch["frames"] = _normal(rng, 2, 12, 32)
    params, want = _run_jax(lambda k: (lambda p: (p, jloss(p, batch, jcfg)))(
        jinit(k, jcfg)), KEY)
    tp = params_from_jax(jax.device_get(params), "cpu")
    assert all(x.dtype == torch.bfloat16 for x in tree_leaves(tp))
    got = tloss(tp, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg)
    assert torch.isfinite(got)
    np.testing.assert_allclose(float(got), float(want), rtol=BF16_RTOL)


def _assert_same_config(tcfg, jcfg, what):
    """Every field of the JAX config equals the port's (the port's
    ``use_flash`` switches aside)."""
    for f in dataclasses.fields(jcfg):
        a, b = getattr(tcfg, f.name), getattr(jcfg, f.name)
        if f.name in ("dtype", "param_dtype"):
            assert str(a).split(".")[-1] == jnp.dtype(b).name, (what, f.name)
        elif dataclasses.is_dataclass(b):
            _assert_same_config(a, b, f"{what}.{f.name}")
        else:
            assert a == b, (what, f.name, a, b)


@pytest.mark.parametrize("key", KEYS)
def test_smoke_configs_batches_and_params_are_the_jax_ones(key):
    """The smoke config's fields, ``make_batch``'s keys, shapes and dtypes,
    and ``init_fn``'s paths, shapes and dtypes equal the JAX smoke
    factory's; ``param_count`` equal."""
    _, jinit, jbatch, jcfg = JAX_SMOKE[key]()
    _, tinit, tbatch, tcfg = RECURRENT_FACTORIES[key](kernels=True)
    _assert_same_config(tcfg, jcfg, key)
    # flash on every attention: whisper's, Zamba2's shared one
    assert getattr(tcfg, "use_flash", False) == (key == "whisper-base")
    if key == "zamba2-2.7b":
        assert tcfg.shared_attn.use_flash
    assert tcfg.param_count() == jcfg.param_count()
    gen = torch.Generator().manual_seed(0)
    want = jax.eval_shape(lambda: jbatch(KEY))
    got = tbatch(gen, "cpu")
    assert sorted(got) == sorted(want)
    for k in got:
        assert tuple(got[k].shape) == want[k].shape
        assert str(got[k].dtype).split(".")[-1] == want[k].dtype.name
    jshape = dict(zip(*_paths_and_leaves(jax.eval_shape(
        lambda: jinit(KEY)))))
    tshape = dict(tree_paths(tinit(gen, "cpu")))
    assert sorted(jshape) == sorted(tshape)
    for k, v in tshape.items():
        assert tuple(v.shape) == jshape[k].shape, k
        assert str(v.dtype).split(".")[-1] == jshape[k].dtype.name, k


# each full config's param_count() and its params' total: param_count
# (the JAX one's) counts no biases or norms (whisper), no sLSTM shapes,
# convs or norms (xLSTM: "rough"), no convs, dt_bias, a_log, D or shared
# norms (Zamba2)
FULL_COUNTS = {"whisper-base": (70_595_072, 70_658_560),
               "xlstm-125m": (166_182_912, 187_494_144),
               "zamba2-2.7b": (2_444_308_480, 2_445_329_568)}


@pytest.mark.parametrize("key", KEYS)
def test_full_config_widths_and_both_param_counts(key):
    jcfg = importlib.import_module(f"repro.configs.{FULL[key]}").CFG
    tcfg = importlib.import_module(f"repro_torch.configs.{FULL[key]}").CFG
    _assert_same_config(tcfg, jcfg, key)
    count, leaves = FULL_COUNTS[key]
    assert tcfg.param_count() == jcfg.param_count() == count
    init = {"whisper-base": tw.init_whisper, "xlstm-125m": tx.init_xlstm,
            "zamba2-2.7b": tm.init_zamba2}[key]
    jinit = {"whisper-base": jw.init_whisper, "xlstm-125m": jx.init_xlstm,
             "zamba2-2.7b": jm.init_zamba2}[key]
    got = init(torch.Generator().manual_seed(0), tcfg, "meta")
    assert sum(x.numel() for x in tree_leaves(got)) == leaves
    assert sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(
        jax.eval_shape(lambda: jinit(KEY, jcfg)))) == leaves
    # flash at head dim 64 (whisper) and 80 (Zamba2's shared attention)
    if key == "whisper-base":
        assert tcfg.use_flash and tcfg.head_dim == 64
    if key == "zamba2-2.7b":
        assert tcfg.shared_attn.use_flash
        assert tcfg.shared_attn.head_dim == 80
