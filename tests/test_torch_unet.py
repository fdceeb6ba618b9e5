"""The port's SDv2 UNet held to the JAX package's.

Parameters are drawn by the JAX package and carried into the port with
``params_from_jax``; inputs, t and noise are numpy arrays handed to both.
fp32 values and gradients at rtol 1e-4, the bar of the JAX package's own
differential tests; the port runs with flash attention on, which on CPU
tensors takes its plain version.

- ``conv2d`` at stride 1 and 2 on odd and even sizes: XLA's "SAME" puts
  the odd pad element of a stride-2 3x3 conv of an even size at the end,
  (0, 1), where PyTorch's ``padding=1`` pads (1, 1);
- ``group_norm`` with bf16 activations and fp32 leaves and the reverse;
- the res and attention blocks, ``unet_loss`` and its gradients at
  ``smoke_sdv2`` and at a config whose single heads are 112 and 224 wide
  (the full model's head dims);
- ``unet_block_graph`` and its partitions, schedules and step tables at
  D = 2 and 4, array for array against the JAX planner on the same
  ``Hardware``;
- the configs (``configs/sdv2_unet.CFG``, the smoke factories) and both
  parameter counts, with their gap named.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import sdv2_unet as jax_sdv2
from repro.configs import smoke as jax_smoke
from repro.core import hw as jax_hw
from repro.core.partition import partition as jax_partition
from repro.core.schedule import schedule_for_partition as jax_schedule
from repro.models import diffusion as jdm
from repro.runtime.compile import StageLayout as JaxStageLayout
from repro.runtime.schedule_exec import StepTables as JaxStepTables
from repro_torch.configs import sdv2_unet as torch_sdv2
from repro_torch.configs import smoke as torch_smoke
from repro_torch.convert import params_from_jax
from repro_torch.core import hw as torch_hw
from repro_torch.core.partition import partition
from repro_torch.core.schedule import schedule_for_partition
from repro_torch.kernels import launch_counts
from repro_torch.models import diffusion as tdm
from repro_torch.runtime.compile import StageLayout
from repro_torch.runtime.schedule_exec import StepTables
from repro_torch.tree import tree_leaves, tree_paths

RTOL, ATOL = 1e-4, 1e-6
KEY = jax.random.PRNGKey(3)
TPU = torch_hw.Hardware(**dataclasses.asdict(jax_hw.TPU_V5E))
SMOKE_KW = dict(img_size=16, in_ch=4, base_ch=16, ch_mults=(1, 2),
                blocks_per_level=2, attn_levels=(1,), ctx_dim=16, n_heads=4)
# single heads of 112 (level 1, 16 -> 8 px) and 224 (level 2 and the middle)
HEADS_KW = dict(img_size=16, base_ch=56, ch_mults=(1, 2, 4),
                attn_levels=(1, 2), n_heads=1, ctx_dim=64, ctx_len=77)
INIT_UNET_PARAMS = 1_839_817_728
PARAM_COUNT = 980_008_960


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes gain nothing from more threads, and tier-1 runs six
    test processes on the host's cores at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_paths(tree):
    """``[(path, leaf)]`` of a JAX tree, paths as ``tree_paths`` writes
    them."""
    return [("/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path), v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _jax_flat(tree):
    return {k: np.asarray(v) for k, v in _jax_paths(tree)}


def _leaf_grads(params):
    """``{path: grad}`` of a port tree; a leaf the loss never reads (the
    cross-attention's wk/wv) gets zeros, as under jax.grad."""
    return {k: (x.grad if x.grad is not None else torch.zeros_like(x))
            for k, x in tree_paths(params)}


def _assert_grads_close(port_params, jax_grads):
    want = _jax_flat(jax_grads)
    got = _leaf_grads(port_params)
    assert sorted(got) == sorted(want)
    for k, g in got.items():
        np.testing.assert_allclose(g.float().numpy(), want[k], rtol=RTOL,
                                   atol=ATOL, err_msg=k)


def _requires_grad(tree):
    for x in tree_leaves(tree):
        x.requires_grad_(True)
    return tree


def _np(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ---------------------------------------------------------------------------
# conv2d and group_norm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", [8, 7])
@pytest.mark.parametrize("k,stride", [(3, 1), (3, 2), (1, 1)])
def test_conv2d_matches_jax(size, k, stride):
    """Values and both gradients; at an even size a stride-2 3x3 conv pads
    (0, 1), which a symmetric pad would get wrong (checked below)."""
    x, w = _np((2, size, size, 6), 0), _np((k, k, 6, 5), 1)
    g = _np((2, -(-size // stride), -(-size // stride), 5), 2)
    y, vjp = jax.vjp(lambda a, b: jdm.conv2d(a, b, stride), x, w)
    dx, dw = vjp(g)
    tx, tw = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
    ty = tdm.conv2d(tx, tw, stride)
    ty.backward(torch.from_numpy(g))
    assert ty.shape == y.shape
    for got, want in ((ty, y), (tx.grad, dx), (tw.grad, dw)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=RTOL, atol=1e-5)
    if (k, stride) == (3, 2):
        # PyTorch's symmetric padding reads windows shifted by one pixel
        # at an even size, and the same ones at an odd size
        sym = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                       torch.from_numpy(w).permute(3, 2, 0, 1), stride=2,
                       padding=1).permute(0, 2, 3, 1).numpy()
        assert sym.shape == y.shape
        assert np.allclose(sym, np.asarray(y), rtol=RTOL, atol=1e-5) == \
            (size % 2 == 1)


def test_same_pads_are_xlas():
    assert tdm._same_pads(8, 3, 2) == (0, 1)
    assert tdm._same_pads(7, 3, 2) == (1, 1)
    assert tdm._same_pads(8, 3, 1) == (1, 1)
    assert tdm._same_pads(8, 1, 1) == (0, 0)


@pytest.mark.parametrize("x_dtype,leaf_dtype", [
    ("float32", "float32"), ("bfloat16", "float32"), ("float32", "bfloat16"),
    ("bfloat16", "bfloat16")])
def test_group_norm_matches_jax(x_dtype, leaf_dtype):
    """fp32 statistics (population variance) and affine whatever the
    dtypes, the result in x's dtype: fp32 values and gradients at rtol
    1e-4, a bf16 result within one bf16 rounding of JAX's."""
    x = _np((2, 5, 3, 16), 3) * 2 + 1
    scale, bias = 1 + 0.1 * _np((16,), 4), 0.1 * _np((16,), 5)
    jx = jnp.asarray(x, x_dtype)
    js, jb = (jnp.asarray(a, leaf_dtype) for a in (scale, bias))
    want = jdm.group_norm(jx, js, jb, eps=1e-5)
    tt = lambda a, d: params_from_jax(np.asarray(jnp.asarray(a, d)), "cpu")
    tx, ts, tb = tt(x, x_dtype), tt(scale, leaf_dtype), tt(bias, leaf_dtype)
    got = tdm.group_norm(tx, ts, tb, eps=1e-5)
    assert str(got.dtype) == f"torch.{want.dtype}"
    tol = RTOL if x_dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)
    if x_dtype == leaf_dtype == "float32":
        g = _np(x.shape, 6)
        _, vjp = jax.vjp(lambda a, s, b: jdm.group_norm(a, s, b, eps=1e-5),
                         jx, js, jb)
        for t in (tx, ts, tb):
            t.requires_grad_(True)
        tdm.group_norm(tx, ts, tb, eps=1e-5).backward(torch.from_numpy(g))
        for t, w in zip((tx, ts, tb), vjp(g)):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                       rtol=RTOL, atol=1e-5)


# ---------------------------------------------------------------------------
# the res and attention blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cin,cout", [(16, 16), (24, 16)])
def test_resblock_matches_jax(cin, cout):
    """Both shapes: with ``skip_conv`` (cin != cout) and without."""
    cfg = jdm.UNetConfig("t", **SMOKE_KW)
    jp = jax.device_get(jdm._init_resblock(KEY, cin, cout, 32, jnp.float32))
    assert ("skip_conv" in jp) == (cin != cout)
    x, temb = _np((2, 6, 6, cin), 7), _np((2, 32), 8)
    # a mean square, as the DDPM loss takes, so the gradients have the
    # model's scale
    loss = lambda p, a, t: jnp.mean(jdm._apply_resblock(p, a, t, cfg) ** 2)
    want, grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2)))(
        jp, x, temb)
    tp = _requires_grad(params_from_jax(jp, "cpu"))
    tx, tt = (torch.from_numpy(a).requires_grad_(True) for a in (x, temb))
    got = torch.mean(tdm._apply_resblock(tp, tx, tt,
                                         tdm.UNetConfig("t", **SMOKE_KW)) ** 2)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=RTOL)
    _assert_grads_close(tp, grads[0])
    for t, w in ((tx, grads[1]), (tt, grads[2])):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=1e-5)


@pytest.mark.parametrize("kw,c", [(SMOKE_KW, 32), (HEADS_KW, 112),
                                  (HEADS_KW, 224)])
def test_attnblock_matches_jax(kw, c):
    """Self-attention, cross-attention over 77 text tokens and the MLP; at
    the narrow config the single head is 112 or 224 wide."""
    jcfg = jdm.UNetConfig("t", **kw)
    tcfg = tdm.UNetConfig("t", use_flash=True, **kw)
    jp = jax.device_get(jdm._init_attnblock(KEY, c, jcfg))
    x, ctx = _np((2, 4, 4, c), 9), _np((2, 77, jcfg.ctx_dim), 10)
    loss = lambda p, a, t: jnp.mean(jdm._apply_attnblock(p, a, t, jcfg) ** 2)
    want, grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2)))(
        jp, x, ctx)
    tp = _requires_grad(params_from_jax(jp, "cpu"))
    tx, tc = (torch.from_numpy(a).requires_grad_(True) for a in (x, ctx))
    before = launch_counts()
    got = torch.mean(tdm._apply_attnblock(tp, tx, tc, tcfg) ** 2)
    got.backward()
    assert launch_counts() == before          # CPU: the plain version
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=RTOL)
    _assert_grads_close(tp, grads[0])
    for t, w in ((tx, grads[1]), (tc, grads[2])):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=1e-5)


def test_leaf_dtypes_follow_jax():
    """bf16 params with the norm leaves fp32, in the same nested tree."""
    cfg_kw = dict(SMOKE_KW, dtype=jnp.bfloat16, param_dtype=jnp.bfloat16)
    jshapes = jax.eval_shape(lambda k: jdm.init_unet(
        k, jdm.UNetConfig("t", **cfg_kw)), KEY)
    want = {k: (tuple(s.shape), str(s.dtype))
            for k, s in _jax_paths(jshapes)}
    tp = tdm.init_unet(torch.Generator().manual_seed(0), tdm.UNetConfig(
        "t", **dict(cfg_kw, dtype=torch.bfloat16,
                    param_dtype=torch.bfloat16)), "cpu")
    got = {k: (tuple(x.shape), str(x.dtype).replace("torch.", ""))
           for k, x in tree_paths(tp)}
    assert got == want
    assert {k for k, (_, d) in got.items() if d == "float32"} == {
        k for k in got if k.rsplit("/", 1)[-1] in (
            "gn", "gb", "gn1", "gb1", "gn2", "gb2", "lnx", "ln2", "out_gn",
            "out_gb")}


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_loss(name):
    kw, T = (SMOKE_KW, 7) if name == "smoke" else (HEADS_KW, 77)
    jcfg = jdm.UNetConfig("t", **kw)
    jp = jax.jit(lambda k: jdm.init_unet(k, jcfg))(KEY)
    lat, ctx = _np((2, 16, 16, 4), 11), _np((2, T, jcfg.ctx_dim), 12)
    batch = {"latents": jnp.asarray(lat), "text_embeds": jnp.asarray(ctx)}
    rng = jax.random.PRNGKey(9)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jdm.unet_loss(p, batch, rng, jcfg)))(jp)
    # the output alone at the smoke config (the loss covers it at both)
    t_apply = np.array([0.2, 0.7], np.float32)
    out = None if name != "smoke" else np.asarray(jax.jit(
        lambda p: jdm.unet_apply(p, lat, t_apply, {"text_embeds": ctx},
                                 jcfg))(jp))
    # the (t, noise) jdm.ddpm_loss draws from rng, handed to the port
    rt, rn = jax.random.split(rng)
    t = np.array(jax.random.uniform(rt, (2,)))
    noise = np.array(jax.random.normal(rn, lat.shape, jnp.float32))
    return dict(kw=kw, params=jax.device_get(jp), lat=lat, ctx=ctx,
                loss=float(loss), grads=jax.device_get(grads),
                t_apply=t_apply, out=out, t=t, noise=noise)


@pytest.mark.parametrize("name", ["smoke", "heads-112-224"])
def test_unet_output_loss_and_grads_match_jax(name):
    ref = _jax_loss(name)
    cfg = tdm.UNetConfig("t", use_flash=True, **ref["kw"])
    tp = _requires_grad(params_from_jax(ref["params"], "cpu"))
    batch = {"latents": torch.from_numpy(ref["lat"]),
             "text_embeds": torch.from_numpy(ref["ctx"])}
    before = launch_counts()
    if ref["out"] is not None:
        with torch.no_grad():
            out = tdm.unet_apply(tp, batch["latents"],
                                 torch.from_numpy(ref["t_apply"]), batch, cfg)
        np.testing.assert_allclose(out.numpy(), ref["out"], rtol=RTOL,
                                   atol=1e-5)
    loss = tdm.unet_loss(tp, batch, torch.from_numpy(ref["t"]),
                         torch.from_numpy(ref["noise"]), cfg)
    loss.backward()
    assert launch_counts() == before          # CPU: plain versions only
    np.testing.assert_allclose(float(loss.detach()), ref["loss"], rtol=RTOL)
    _assert_grads_close(tp, ref["grads"])


def test_upsample_is_jax_nearest():
    x = _np((2, 3, 5, 4), 13)
    want = jax.image.resize(x, (2, 6, 10, 4), "nearest")
    np.testing.assert_array_equal(
        tdm._upsample2x(torch.from_numpy(x)).numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the block graph and its plans
# ---------------------------------------------------------------------------

def _graphs(batch):
    return (jdm.unet_block_graph(jax_sdv2.CFG, batch, jax_hw.TPU_V5E),
            tdm.unet_block_graph(torch_sdv2.CFG, batch, TPU))


def test_unet_block_graph_matches_jax():
    jg, tg = _graphs(1)
    assert [dataclasses.astuple(b) for b in tg.blocks] == \
        [dataclasses.astuple(b) for b in jg.blocks]
    assert [dataclasses.astuple(e) for e in tg.skips] == \
        [dataclasses.astuple(e) for e in jg.skips]
    assert (len(tg.blocks), len(tg.skips)) == (29, 12)
    # and the port plans for the H100 by default
    h = tdm.unet_block_graph(torch_sdv2.CFG, 1)
    b = h.blocks[5]
    assert b.fwd_time == pytest.approx(max(
        b.flops / torch_hw.H100_SXM.peak_flops,
        (2 * b.param_bytes + 2 * b.act_bytes) / torch_hw.H100_SXM.hbm_bw))


@pytest.mark.parametrize("D,V", [(2, 1), (4, 1), (2, 2)])
def test_unet_partition_and_step_tables_match_jax(D, V):
    """The skip-aware partition of the 29 heterogeneous blocks, the
    portfolio schedule, the stage layout's skip pairing and the lowered
    step tables, array for array."""
    jg, tg = _graphs(1)
    M = 2 * D
    jp = jax_partition(jg, D, lam=0.0, interleave=V)
    tp = partition(tg, D, lam=0.0, interleave=V)
    assert (tp.cuts, tp.devices, tp.folded, tp.num_stages) == \
        (jp.cuts, jp.devices, jp.folded, jp.num_stages)
    assert tp.folded and tp.num_stages == 2 * V * D
    assert tp.collocated_pairs() == jp.collocated_pairs()
    js, ts = jax_schedule(jp, M), schedule_for_partition(tp, M)
    key = lambda p: (p.virtual, p.microbatch, p.device, p.step)
    assert sorted(map(key, ts.placements)) == sorted(map(key, js.placements))
    jl = JaxStageLayout.from_partition(jp, jg)
    tl = StageLayout.from_partition(tp, tg)
    for f in ("enc_slots", "dec_slots", "enc_counts", "dec_counts",
              "enc_pad", "dec_pad", "skip_rows"):
        assert getattr(tl, f) == getattr(jl, f), f
    assert tl.skip_consumers() == jl.skip_consumers()
    jt = JaxStepTables.from_schedule(js, folded=True, devices=jp.devices,
                                     skip_consumers=jl.skip_consumers())
    tt = StepTables.from_schedule(ts, folded=True, devices=tp.devices,
                                  skip_consumers=tl.skip_consumers())
    for f in dataclasses.fields(StepTables):
        a, b = getattr(tt, f.name), getattr(jt, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


# ---------------------------------------------------------------------------
# configs and parameter counts
# ---------------------------------------------------------------------------

def _field(v) -> str:
    """A config field as text, dtypes by name in both packages."""
    if isinstance(v, torch.dtype):
        return str(v).removeprefix("torch.")
    if isinstance(v, type):
        return jnp.dtype(v).name
    return repr(v)


def _fields(cfg):
    return {f.name: _field(getattr(cfg, f.name))
            for f in dataclasses.fields(cfg) if f.name != "use_flash"}


def test_sdv2_config_and_both_param_counts():
    """``init_unet(CFG)`` makes 1,839,817,728 params in both packages, and
    ``CFG.param_count()``, the JAX package's closed form kept as it is,
    gives 980,008,960: it leaves out the up path's third block per level
    and the skip-in convs' extra input channels, 859,808,768 params."""
    assert _fields(torch_sdv2.CFG) == _fields(jax_sdv2.CFG)
    assert torch_sdv2.CFG.dtype == torch_sdv2.CFG.param_dtype == \
        torch.bfloat16
    jshapes = jax.eval_shape(lambda k: jdm.init_unet(k, jax_sdv2.CFG), KEY)
    jn = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(jshapes))
    tp = tdm.init_unet(None, torch_sdv2.CFG, "meta")
    tn = sum(x.numel() for x in tree_leaves(tp))
    assert tn == jn == INIT_UNET_PARAMS
    assert torch_sdv2.CFG.param_count() == jax_sdv2.CFG.param_count() == \
        PARAM_COUNT
    assert INIT_UNET_PARAMS - PARAM_COUNT == 859_808_768
    shape = type("S", (), {"global_batch": 16})()
    shapes = torch_sdv2.batch_struct(shape)
    jb = jax_sdv2.batch_struct(shape)
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in shapes.items()} == \
        {k: (tuple(v.shape), f"torch.{v.dtype}") for k, v in jb.items()}
    assert all(v.is_meta for v in shapes.values())


@pytest.mark.parametrize("name", sorted(torch_smoke.SMOKE_FACTORIES))
def test_smoke_factories_match_jax(name):
    """The same configs and batch shapes as the JAX factories; the port's
    switch their model's kernels on with ``kernels=True`` (the trainer's
    choice) and change nothing else."""
    _, _, jmake, jcfg = jax_smoke.SMOKE_FACTORIES[name]()
    loss_fn, init_fn, make, cfg = torch_smoke.SMOKE_FACTORIES[name]()
    assert type(cfg).__name__ == type(jcfg).__name__
    assert {k: v for k, v in _fields(cfg).items()
            if k != "use_skip_kernel"} == \
        {k: v for k, v in _fields(jcfg).items() if k != "use_skip_kernel"}
    batch = make(torch.Generator().manual_seed(0), "cpu")
    assert {k: tuple(v.shape) for k, v in batch.items()} == \
        {k: tuple(v.shape) for k, v in jmake(KEY).items()}
    params = init_fn(torch.Generator().manual_seed(0), "cpu")
    B = batch["latents"].shape[0]
    loss = loss_fn(params, batch, torch.rand(B), torch.randn(
        batch["latents"].shape))
    assert loss.shape == () and torch.isfinite(loss)
    on = torch_smoke.SMOKE_FACTORIES[name](kernels=True)[3]
    assert not cfg.use_flash and not getattr(cfg, "use_skip_kernel", False)
    assert on.use_flash and getattr(on, "use_skip_kernel", True)
    drop = lambda c: {k: v for k, v in _fields(c).items()
                      if k != "use_skip_kernel"}
    assert drop(on) == drop(cfg)
