"""The port's UViT, Hunyuan-DiT, DDPM loss, AdamW and data pipeline held to
the JAX package.

Parameters are drawn by the JAX package (``jax.random``) and carried into
the port with ``params_from_jax``; inputs, t and noise are numpy arrays
handed to both.  The JAX model runs with ``use_skip_kernel=False`` (its
Pallas path fails on this host's JAX), the port with its kernels switched
on, which on CPU tensors run their plain versions.  fp32 throughout:
loss, outputs and grads at rtol 1e-4, the bar of the JAX package's own
differential tests.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import SyntheticLatentDataset as JaxLatents
from repro.models import diffusion as jdm
from repro.optim import adamw as jopt
from repro_torch.convert import params_from_jax
from repro_torch.data import SyntheticLatentDataset
from repro_torch.models import diffusion as tdm
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               cosine_schedule)
from repro_torch.tree import tree_map, tree_paths

RTOL = 1e-4
KEY = jax.random.PRNGKey(5)
CFG_KW = dict(img_size=8, in_ch=4, patch=2, d_model=32, n_layers=4,
              n_heads=4, d_ff=64, n_classes=10)


def _jax_flat(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(v) for path, v in flat}


def _assert_tree_close(torch_tree, jax_tree, rtol=RTOL, atol=1e-6):
    want = _jax_flat(jax_tree)
    got = dict(tree_paths(torch_tree))
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        np.testing.assert_allclose(v.detach().float().numpy(), want[k],
                                   rtol=rtol, atol=atol, err_msg=k)


def _inputs(B=3):
    rng = np.random.default_rng(11)
    lat = rng.normal(size=(B, 8, 8, 4)).astype(np.float32)
    labels = rng.integers(0, 10, size=B).astype(np.int32)
    return lat, labels


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX model's params, output and loss + grads, computed once (jitted)
    for both kernel settings of the port."""
    jcfg = jdm.UViTConfig("t", **CFG_KW)
    jp = jax.jit(lambda k: jdm.init_uvit(k, jcfg))(KEY)
    lat, labels = _inputs()
    t_apply = np.array([0.1, 0.5, 0.9], np.float32)
    out = jax.jit(lambda p: jdm.uvit_apply(p, lat, t_apply,
                                           {"labels": labels}, jcfg))(jp)
    batch = {"latents": jnp.asarray(lat), "labels": jnp.asarray(labels)}
    rng = jax.random.PRNGKey(9)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jdm.uvit_loss(p, batch, rng, jcfg)))(jp)
    # the (t, noise) jdm.ddpm_loss draws from rng, handed to the port
    rt, rn = jax.random.split(rng)
    t = np.array(jax.random.uniform(rt, (3,)))
    noise = np.array(jax.random.normal(rn, lat.shape, jnp.float32))
    return dict(params=jax.device_get(jp), lat=lat, labels=labels,
                t_apply=t_apply, out=np.asarray(out), loss=float(loss),
                grads=grads, t=t, noise=noise)


@pytest.mark.parametrize("kernels", [False, True])
def test_uvit_apply_matches_jax(jax_ref, kernels):
    r = jax_ref
    tcfg = tdm.UViTConfig("t", use_skip_kernel=kernels, use_flash=kernels,
                          **CFG_KW)
    got = tdm.uvit_apply(params_from_jax(r["params"], "cpu"),
                         torch.from_numpy(r["lat"]),
                         torch.from_numpy(r["t_apply"]),
                         {"labels": torch.from_numpy(r["labels"])}, tcfg)
    assert got.shape == (3, 8, 8, 4)
    np.testing.assert_allclose(got.detach().numpy(), r["out"], rtol=RTOL,
                               atol=1e-5)


@pytest.mark.parametrize("kernels", [False, True])
def test_ddpm_loss_and_grads_match_jax(jax_ref, kernels):
    """The port's loss takes t and noise; JAX's ddpm_loss draws them from its
    rng, so the test hands the port the same two arrays."""
    r = jax_ref
    tcfg = tdm.UViTConfig("t", use_skip_kernel=kernels, use_flash=kernels,
                          **CFG_KW)
    tp = tree_map(lambda x: x.requires_grad_(True),
                  params_from_jax(r["params"], "cpu"))
    tb = {"latents": torch.from_numpy(r["lat"]),
          "labels": torch.from_numpy(r["labels"])}
    tl = tdm.uvit_loss(tp, tb, torch.from_numpy(r["t"]),
                       torch.from_numpy(r["noise"]), tcfg)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), r["loss"], rtol=RTOL)
    _assert_tree_close(tree_map(lambda x: x.grad, tp), r["grads"], atol=1e-5)


# Hunyuan-DiT at the size of the JAX package's wave-hunyuan differential
HCFG_KW = dict(img_size=8, in_ch=4, patch=2, d_model=32, n_layers=8,
               n_heads=4, d_ff=64, ctx_dim=16, ctx_len=4)


@pytest.fixture(scope="module")
def jax_hunyuan():
    """Hunyuan-DiT params, output, and loss + grads (jitted) from the JAX
    package, with the (t, noise) its ddpm_loss draws."""
    jcfg = jdm.HunyuanDiTConfig("t", **HCFG_KW)
    jp = jax.jit(lambda k: jdm.init_hunyuan(k, jcfg))(KEY)
    rng = np.random.default_rng(12)
    lat = rng.normal(size=(3, 8, 8, 4)).astype(np.float32)
    ctx = rng.normal(size=(3, 4, 16)).astype(np.float32)
    t_apply = np.array([0.1, 0.5, 0.9], np.float32)
    out = jax.jit(lambda p: jdm.hunyuan_apply(p, lat, t_apply,
                                              {"text_embeds": ctx}, jcfg))(jp)
    batch = {"latents": jnp.asarray(lat), "text_embeds": jnp.asarray(ctx)}
    key = jax.random.PRNGKey(9)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jdm.hunyuan_loss(p, batch, key, jcfg)))(jp)
    rt, rn = jax.random.split(key)
    t = np.array(jax.random.uniform(rt, (3,)))
    noise = np.array(jax.random.normal(rn, lat.shape, jnp.float32))
    return dict(params=jax.device_get(jp), lat=lat, ctx=ctx,
                t_apply=t_apply, out=np.asarray(out), loss=float(loss),
                grads=grads, t=t, noise=noise)


@pytest.mark.parametrize("kernels", [False, True])
def test_hunyuan_apply_matches_jax(jax_hunyuan, kernels):
    r = jax_hunyuan
    tcfg = tdm.HunyuanDiTConfig("t", use_skip_kernel=kernels,
                                use_flash=kernels, **HCFG_KW)
    got = tdm.hunyuan_apply(params_from_jax(r["params"], "cpu"),
                            torch.from_numpy(r["lat"]),
                            torch.from_numpy(r["t_apply"]),
                            {"text_embeds": torch.from_numpy(r["ctx"])}, tcfg)
    assert got.shape == (3, 8, 8, 4)
    np.testing.assert_allclose(got.detach().numpy(), r["out"], rtol=RTOL,
                               atol=1e-5)


@pytest.mark.parametrize("kernels", [False, True])
def test_hunyuan_loss_and_grads_match_jax(jax_hunyuan, kernels):
    """Every leaf, including ``xattn.wk``/``xattn.wv``, which cross-attention
    never reads (zero gradients on both sides)."""
    r = jax_hunyuan
    tcfg = tdm.HunyuanDiTConfig("t", use_skip_kernel=kernels,
                                use_flash=kernels, **HCFG_KW)
    tp = tree_map(lambda x: x.requires_grad_(True),
                  params_from_jax(r["params"], "cpu"))
    tb = {"latents": torch.from_numpy(r["lat"]),
          "text_embeds": torch.from_numpy(r["ctx"])}
    tl = tdm.hunyuan_loss(tp, tb, torch.from_numpy(r["t"]),
                          torch.from_numpy(r["noise"]), tcfg)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), r["loss"], rtol=RTOL)
    grads = tree_map(lambda x: x.grad if x.grad is not None
                     else torch.zeros_like(x), tp)
    _assert_tree_close(grads, r["grads"], atol=1e-5)
    assert not grads["enc_blocks"]["xattn"]["wk"].any()


def test_hunyuan_init_matches_jax_structure():
    jcfg = jdm.HunyuanDiTConfig("t", param_dtype=jnp.bfloat16, **HCFG_KW)
    jp = jax.device_get(jax.jit(lambda k: jdm.init_hunyuan(k, jcfg))(KEY))
    tcfg = tdm.HunyuanDiTConfig("t", param_dtype=torch.bfloat16, **HCFG_KW)
    mine = tdm.init_hunyuan(torch.Generator().manual_seed(0), tcfg, "cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in tree_paths(mine)} == \
        {k: (tuple(v.shape), v.dtype)
         for k, v in tree_paths(params_from_jax(jp, "cpu"))}
    assert tcfg.param_count() == jcfg.param_count()


def test_schedule_and_embedding_match_jax():
    t = np.linspace(0, 1, 13).astype(np.float32)
    np.testing.assert_allclose(tdm.cosine_alpha_bar(torch.from_numpy(t)),
                               jdm.cosine_alpha_bar(t), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        tdm.timestep_embedding(torch.from_numpy(t), 32),
        jdm.timestep_embedding(jnp.asarray(t), 32), rtol=1e-5, atol=1e-5)


def test_params_from_jax_keeps_names_layouts_and_dtypes():
    jcfg = jdm.UViTConfig("t", param_dtype=jnp.bfloat16, **CFG_KW)
    jp = jax.device_get(jdm.init_uvit(KEY, jcfg))
    tp = params_from_jax(jp, "cpu")
    tcfg = tdm.UViTConfig("t", param_dtype=torch.bfloat16, **CFG_KW)
    mine = tdm.init_uvit(torch.Generator().manual_seed(0), tcfg, "cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in tree_paths(tp)} == \
        {k: (tuple(v.shape), v.dtype) for k, v in tree_paths(mine)}
    for k, v in tree_paths(tp):
        np.testing.assert_array_equal(v.float().numpy(),
                                      _jax_flat(jp)[k].astype(np.float32))


def test_adamw_three_steps_match_jax():
    """In-place AdamW (with clipping active and the cosine warmup lr) over
    three steps: params, m, v and step equal the JAX update's."""
    rng = np.random.default_rng(2)
    params = {"a": rng.normal(size=(5, 7)).astype(np.float32),
              "b": {"c": rng.normal(size=(11,)).astype(np.float32)}}
    grads = [tree_map(lambda x: (3 * rng.normal(size=x.shape)
                                 ).astype(np.float32), params)
             for _ in range(3)]
    cfg_j = jopt.AdamWConfig(lr=1e-2, weight_decay=0.1)
    cfg_t = AdamWConfig(lr=1e-2, weight_decay=0.1)
    jp, js = params, jopt.adamw_init(params)
    tp = params_from_jax(params, "cpu")
    ts = adamw_init(tp)
    for k in range(3):
        lr_j = jopt.cosine_schedule(k, base_lr=1e-2, warmup=2, total=3)
        lr_t = cosine_schedule(k, base_lr=1e-2, warmup=2, total=3)
        assert lr_t == pytest.approx(float(lr_j), rel=1e-6)
        jp, js = jopt.adamw_update(jp, grads[k], js, cfg_j, lr=lr_j)
        out_p, out_s = adamw_update(tp, params_from_jax(grads[k], "cpu"), ts,
                                    cfg_t, lr=lr_t)
        assert out_p is tp and out_s is ts          # updated in place
    _assert_tree_close(tp, jp, rtol=1e-5)
    _assert_tree_close(ts["m"], js["m"], rtol=1e-5)
    _assert_tree_close(ts["v"], js["v"], rtol=1e-5)
    assert int(ts["step"]) == int(js["step"]) == 3


def test_synthetic_latents_match_jax_package():
    for kw in (dict(img_size=8, channels=4), dict(img_size=32, channels=4,
                                                   n_classes=10, seed=3),
               dict(img_size=8, channels=4, text_dim=16, text_len=4)):
        a = SyntheticLatentDataset(**kw).batch(7, 0, 5)
        b = JaxLatents(**kw).batch(7, 0, 5)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_unported_layer_options_raise():
    """Rotary embeddings are ported: a ``rope_theta > 0`` self-attention is
    the dense attention of RoPE-rotated q and k (``rope_theta=0`` of the
    same params is not); the JAX LM config's ``remat_policy``, which the
    port lacks, is refused."""
    from repro_torch.models.layers import (AttnConfig, apply_attention,
                                           apply_rope, attention)
    from repro_torch.models.lm import LMConfig
    cfg = AttnConfig(16, 2, 2, 8)                  # rope_theta > 0
    gen = torch.Generator().manual_seed(0)
    p = {k: torch.randn(16, 16, generator=gen) / 4
         for k in ("wq", "wk", "wv", "wo")}
    x = torch.randn(1, 3, 16, generator=gen)
    q, k, v = ((x @ p[w]).reshape(1, 3, 2, 8) for w in ("wq", "wk", "wv"))
    pos = torch.arange(3)[None]
    want = attention(apply_rope(q, pos), apply_rope(k, pos), v)
    got, _ = apply_attention(p, x, cfg)
    torch.testing.assert_close(got, want.reshape(1, 3, 16) @ p["wo"])
    plain, _ = apply_attention(p, x, dataclasses.replace(cfg, rope_theta=0.0))
    assert not torch.allclose(got, plain)
    assert dataclasses.replace(cfg, rope_theta=0.0).use_flash is False
    with pytest.raises(TypeError, match="remat_policy"):
        LMConfig("t", 8, 16, 1, attn=cfg, remat_policy="dots")
