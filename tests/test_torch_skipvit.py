"""SkipViT in the port held to the JAX package's, from the model to the
trainer.

- ``skipvit_apply``'s output and ``skipvit_loss``'s loss and gradients
  equal the JAX functions' at fp32 rtol 1e-4 (params carried across by
  ``convert.params_from_jax``, the DDPM draws given to both): default
  pairing, sparse ``skip_pairs``, odd and asymmetric ``n_enc/n_mid/n_dec``,
  flash on (its plain version on the CPU);
- ``skipvit_pipeline_graph`` equals JAX's block for block and edge for
  edge, and the partitions, schedules, layouts and step tables equal
  JAX's array for array at D=2 and D=4 (both planners given the same
  hardware record);
- the port's wave executor matches the single-device JAX loss and
  gradients at fp32 wire, rtol 1e-4, on the JAX package's ``wave-asym``,
  ``wave-sparse``, ``wave-interleaved`` and ``wave-interleaved-ilp``
  differentials (``tests/helpers/auto_pipeline_equiv.py``: their configs,
  block costs, ``lam=0``, M, V, ILP and remat), with the asymmetric folds
  and skip-less decoder rows they force;
- the trainer's ``--arch skipvit --pipeline --devices 2`` over five steps
  equals the JAX trainer's (fp32 wire; the JAX trainer's params and
  ``fold_in(PRNGKey(0), step)`` draws injected), and a SkipViT checkpoint
  saved at D=2 resumes elastically at D=4 (one parameter stack:
  ``state_spec``'s ``num_param_stacks == 1`` branch).
"""
import dataclasses
import functools
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hw as jax_hw
from repro.models import diffusion as jdm
from repro.runtime.adapters import make_diffusion_microbatches as jax_mbs
from repro.runtime.adapters import skipvit_model_fns as jax_fns
from repro.runtime.compile import auto_pipeline as jax_auto_pipeline
from repro_torch.convert import params_from_jax
from repro_torch.core import hw as torch_hw
from repro_torch.kernels import launch_counts
from repro_torch.launch import train
from repro_torch.models import diffusion as tdm
from repro_torch.runtime.adapters import (make_diffusion_microbatches,
                                          model_fns, skipvit_model_fns)
from repro_torch.runtime.compile import auto_pipeline
from repro_torch.tree import tree_map, tree_paths
from test_torch_plan import _assert_plans_equal

REPO = pathlib.Path(__file__).resolve().parents[1]
RTOL = 1e-4
KEY = jax.random.PRNGKey(0)
TPU = torch_hw.Hardware(**dataclasses.asdict(jax_hw.TPU_V5E))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    return (jdm.SkipViTConfig("t", **kw),
            tdm.SkipViTConfig("t", use_flash=True, **kw))


def _flat(grads):
    flat = jax.tree_util.tree_flatten_with_path(grads)[0]
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in flat}


def _assert_grads(got: dict, want: dict, name: str):
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), want[k], rtol=RTOL, atol=1e-6,
                                   err_msg=f"{name}: {k}")


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

MODELS = {
    "default": dict(n_enc=3, n_mid=2, n_dec=3),
    "sparse": dict(n_enc=3, n_mid=2, n_dec=3, skip_pairs=((0, 7), (2, 5))),
    "odd-asym": dict(n_enc=3, n_mid=1, n_dec=2),
    "mid-skip": dict(n_enc=2, n_mid=3, n_dec=4,
                     skip_pairs=((0, 8), (1, 3), (4, 6))),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_skipvit_output_loss_and_grads_match_jax(name):
    jcfg, tcfg = _cfgs(**MODELS[name])
    B = 4
    params = jax.device_get(jdm.init_skipvit(KEY, jcfg))
    lat = jax.random.normal(KEY, (B, 8, 8, 4))
    labels = jax.random.randint(KEY, (B,), 0, 10)
    rng = jax.random.PRNGKey(3)
    rt, rn = jax.random.split(rng)
    t = jax.random.uniform(rt, (B,))
    noise = jax.random.normal(rn, lat.shape)
    batch = {"latents": lat, "labels": labels}
    jout = jax.jit(lambda p: jdm.skipvit_apply(p, lat, t, batch, jcfg))(
        params)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jdm.skipvit_loss(p, batch, rng, jcfg)))(params)

    tp = tree_map(lambda x: x.requires_grad_(True),
                  params_from_jax(params, "cpu"))
    tb = params_from_jax(jax.device_get(batch), "cpu")
    tt, tn = (torch.tensor(np.asarray(x)) for x in (t, noise))
    before = launch_counts()
    out = tdm.skipvit_apply(tp, tb["latents"], tt, tb, tcfg)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=RTOL, atol=1e-6)
    loss = tdm.skipvit_loss(tp, tb, tt, tn, tcfg)
    loss.backward()
    assert launch_counts() == before          # CPU: plain versions only
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=RTOL)
    _assert_grads({k: v.grad for k, v in tree_paths(tp)}, _flat(jg), name)
    # the param tree, leaf for leaf
    assert {k: tuple(v.shape) for k, v in tree_paths(tdm.init_skipvit(
        torch.Generator().manual_seed(0), tcfg, "cpu"))} == \
        {k: v.shape for k, v in _flat(params).items()}


# ---------------------------------------------------------------------------
# graphs, partitions and step tables
# ---------------------------------------------------------------------------

# (model, fwd_times, D, V, M, use_ilp)
PLANS = {
    "asym-D2": ("default", [1, 1, 4, 0.5, 0.5, 0.5, 1, 1], 2, 1, 4, False),
    "sparse-D2": ("sparse", [1, 1, 4, 0.5, 0.5, 0.5, 1, 1], 2, 1, 4, False),
    "even-D2": ("default", None, 2, 1, 4, False),
    "asym-D4": ("interleaved", [1, 1, 2, 4, 0.5, 0.5, 0.5, 1, 1, 2], 4, 1,
                8, False),
    "sparse-D4": ("sparse-10", [1, 1, 2, 4, 0.5, 0.5, 0.5, 1, 1, 2], 4, 1,
                  4, False),
    "even-D4": ("trainer", None, 4, 1, 8, False),
    "interleaved-D2": ("interleaved", [1, 1, 2, 4, 0.5, 0.5, 0.5, 1, 1, 2],
                       2, 2, 4, False),
    "ilp-D2": ("default", [1, 1, 4, 0.5, 0.5, 0.5, 1, 1], 2, 2, 2, True),
}
TRAINER_KW = dict(d_model=64, n_heads=4, d_ff=128, n_enc=4, n_mid=2, n_dec=4)


def _model_kw(model):
    return {"trainer": TRAINER_KW,
            "interleaved": dict(n_enc=4, n_mid=2, n_dec=4),
            "sparse-10": dict(n_enc=4, n_mid=2, n_dec=4,
                              skip_pairs=((0, 9), (1, 8), (3, 6)))}.get(
        model, MODELS.get(model))


@pytest.mark.parametrize("name", sorted(PLANS))
def test_skipvit_plans_match_jax(name):
    model, ft, D, V, M, ilp = PLANS[name]
    jcfg, tcfg = _cfgs(**_model_kw(model))
    jg = jdm.skipvit_pipeline_graph(jcfg, batch=2, fwd_times=ft,
                                    hw=jax_hw.TPU_V5E)
    tg = tdm.skipvit_pipeline_graph(tcfg, batch=2, fwd_times=ft, hw=TPU)
    kw = dict(pipeline_devices=D, microbatches=M, lam=0.0, interleave=V,
              use_ilp=ilp)
    jcp = jax_auto_pipeline(jg, jax_fns(jcfg), D, jax_hw.TPU_V5E, **kw)
    tcp = auto_pipeline(tg, skipvit_model_fns(tcfg), D, TPU, **kw)
    assert tcp.partition.num_stages == 2 * V * D
    _assert_plans_equal(jg, tg, jcp, tcp)
    assert tcp.state_spec()["num_param_stacks"] == 1
    assert tcp.fingerprint() == jcp.fingerprint()


def test_skipvit_graph_defaults_to_the_h100():
    _, tcfg = _cfgs(**TRAINER_KW)
    g = tdm.skipvit_pipeline_graph(tcfg, batch=2)
    h = torch_hw.H100_SXM
    b = g.blocks[0]
    assert b.fwd_time == pytest.approx(max(
        b.flops / h.peak_flops, (2 * b.param_bytes + 2 * b.act_bytes)
        / h.hbm_bw))
    assert [(e.src, e.dst) for e in g.skips] == [(i, 9 - i) for i in range(4)]


def test_single_stack_split_merge_round_trip():
    """A homogeneous stack is cut at the fold's turnaround, wherever it
    lands, and merged back exactly (gradients take the same path)."""
    _, tcfg = _cfgs(**MODELS["default"])
    cp = auto_pipeline(tdm.skipvit_pipeline_graph(
        tcfg, fwd_times=[1, 1, 4, 0.5, 0.5, 0.5, 1, 1], hw=TPU),
        skipvit_model_fns(tcfg), 2, TPU, pipeline_devices=2, microbatches=4,
        lam=0.0)
    assert cp.partition.cuts == (0, 2, 3, 6, 8)         # off-centre
    params = tdm.init_skipvit(torch.Generator().manual_seed(1), tcfg, "cpu")
    stacks, edge = cp.split_params(params)
    assert stacks[0]["skip_in"].shape[:3] == (2, 1, cp.layout.enc_pad)
    back = cp.merge_params(stacks, edge)
    assert sorted(back) == sorted(params)
    for k, v in tree_paths(back):
        assert torch.equal(v, dict(tree_paths(params))[k]), k


# ---------------------------------------------------------------------------
# the wave executor against the single-device JAX model
# ---------------------------------------------------------------------------

# the JAX package's SkipViT differentials: (config kw, fwd_times, D, M, V,
# use_ilp, remat, expect an asymmetric fold)
DIFFERENTIALS = {
    "wave-asym": (dict(n_enc=3, n_mid=2, n_dec=3),
                  [1, 1, 4, 0.5, 0.5, 0.5, 1, 1], 2, 4, None, False, True,
                  True),
    "wave-sparse": (dict(n_enc=3, n_mid=2, n_dec=3,
                         skip_pairs=((0, 7), (2, 5))),
                    [1, 1, 4, 0.5, 0.5, 0.5, 1, 1], 2, 4, None, False, True,
                    True),
    "wave-interleaved": (dict(n_enc=4, n_mid=2, n_dec=4),
                         [1, 1, 2, 4, 0.5, 0.5, 0.5, 1, 1, 2], 2, 4, 2,
                         False, False, False),
    "wave-interleaved-ilp": (dict(n_enc=3, n_mid=2, n_dec=3),
                             [1, 1, 4, 0.5, 0.5, 0.5, 1, 1], 2, 2, 2, True,
                             True, False),
}


@functools.lru_cache(maxsize=None)
def _jax_microbatch_step(cfg):
    """One microbatch's JAX loss and grads, jitted once per config."""
    def one(p, xt, t, labels, noise):
        pred = jdm.skipvit_apply(p, xt, t, {"labels": labels}, cfg)
        return jnp.mean(jnp.square(pred - noise))
    return jax.jit(jax.value_and_grad(one))


def test_model_fns_and_microbatches_by_kind():
    """``adapters.model_fns`` gives SkipViT its one-stack callables by kind,
    and SkipViT's microbatches are UViT's (labels and a time token)."""
    _, cfg = _cfgs(n_enc=3, n_mid=2, n_dec=3)
    ucfg = train._model_config(train._parse_args(["--arch", "uvit-nano",
                                                  "--pipeline"]))
    assert model_fns(cfg, "skipvit").num_param_stacks == 1
    assert model_fns(ucfg, "uvit").num_param_stacks == 2
    with pytest.raises(NotImplementedError, match="'lm'"):
        model_fns(cfg, "lm")
    gen = torch.Generator().manual_seed(0)
    batch = {"latents": torch.randn(8, 8, 8, 4, generator=gen),
             "labels": torch.randint(0, 10, (8,), generator=gen)}
    t, noise = torch.rand(8, generator=gen), torch.randn(8, 8, 8, 4,
                                                         generator=gen)
    got = make_diffusion_microbatches(batch, 4, cfg, "skipvit", t=t,
                                      noise=noise)
    want = make_diffusion_microbatches(batch, 4, cfg, "uvit", t=t,
                                       noise=noise)
    assert sorted(got[0]) == ["labels", "noise", "xt"]
    for a, b in zip(tree_paths(got), tree_paths(want)):
        assert a[0] == b[0] and torch.equal(a[1], b[1])


@pytest.mark.parametrize("name", sorted(DIFFERENTIALS))
def test_wave_executor_matches_jax_single_device(name):
    kw, ft, D, M, V, ilp, remat, asym = DIFFERENTIALS[name]
    jcfg, tcfg = _cfgs(**kw)
    cp = auto_pipeline(tdm.skipvit_pipeline_graph(tcfg, fwd_times=ft,
                                                  hw=TPU),
                       skipvit_model_fns(tcfg), D, TPU, pipeline_devices=D,
                       microbatches=M, lam=0.0, interleave=V, use_ilp=ilp,
                       remat=remat, wire_dtype="float32")
    if asym:
        assert not cp.partition.mirror_symmetric(), cp.partition.cuts
        assert cp.layout.enc_counts != cp.layout.dec_counts
    if V:
        assert cp.layout.V == V and cp.partition.num_stages == 2 * V * D
    if name == "wave-sparse":
        assert any(r == -1 for dev in cp.layout.skip_rows for rows in dev
                   for r in rows)
    params = jdm.init_skipvit(KEY, jcfg)
    B = 2 * M
    batch = {"latents": jax.random.normal(KEY, (B, 8, 8, 4)),
             "labels": jax.random.randint(KEY, (B,), 0, 10)}
    mb, aux = jax_mbs(batch, KEY, M, jcfg, "uvit")
    # the single-device loss: the mean over microbatches of each one's
    step = _jax_microbatch_step(jcfg)
    outs = [step(params, mb["xt"][m], aux["t"][m], mb["labels"][m],
                 mb["noise"][m]) for m in range(M)]
    jl = sum(float(o[0]) for o in outs) / M
    jg = jax.tree.map(lambda *g: sum(g) / M, *(o[1] for o in outs))
    stacks, edge = cp.split_params(params_from_jax(jax.device_get(params),
                                                   "cpu"))
    p = tree_map(lambda x: x.requires_grad_(True), (stacks, edge))
    tmb, taux = params_from_jax(jax.device_get((mb, aux)), "cpu")
    (enc, dec), edge = p
    before = launch_counts()
    loss = cp.build()(enc, dec, edge, tmb, taux)
    loss.backward()
    assert launch_counts() == before
    grads = cp.merge_params(*tree_map(
        lambda x: x.grad if x.grad is not None else torch.zeros_like(x), p))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=RTOL,
                               err_msg=name)
    _assert_grads(dict(tree_paths(grads)), _flat(jg), name)


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

STEPS = 5
ARGV = ["--arch", "skipvit", "--pipeline", "--devices", "2",
        "--microbatches", "4", "--global-batch", "8", "--steps", str(STEPS),
        "--wire-dtype", "float32", "--log-every", "100"]


def _jax_draw(shape):
    def draw(step):
        rt, rn = jax.random.split(jax.random.fold_in(KEY, step))
        return (np.array(jax.random.uniform(rt, (shape[0],))),
                np.array(jax.random.normal(rn, shape, jnp.float32)))
    return draw


def test_skipvit_trainer_matches_jax(tmp_path):
    out = tmp_path / "jax.json"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro.launch.train", *ARGV, "--dp", "1",
         "--out-json", str(out)], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    want = {int(k): v for k, v in json.loads(out.read_text())["losses"].items()}
    cfg = train._model_config(train._parse_args(ARGV))
    jcfg = jdm.SkipViTConfig(
        cfg.name, img_size=8, in_ch=4, patch=2, d_model=64, n_heads=4,
        d_ff=128, n_classes=10, n_enc=4, n_mid=2, n_dec=4)
    params = jax.device_get(jdm.init_skipvit(KEY, jcfg))
    before = launch_counts()
    res = train.run(train._parse_args(ARGV + ["--device", "cpu"]),
                    init_params=params, draw=_jax_draw((8, 8, 8, 4)))
    assert launch_counts() == before
    assert "S=4 stages over D=2 devices" in res.plan
    assert res.compiled.model_fns.num_param_stacks == 1
    assert sorted(res.losses) == list(range(STEPS))
    for s in range(STEPS):
        np.testing.assert_allclose(res.losses[s], want[s], rtol=RTOL,
                                   err_msg=f"step {s}")


def test_skipvit_trainer_config():
    cfg = train._model_config(train._parse_args(["--arch", "skipvit",
                                                 "--pipeline"]))
    assert isinstance(cfg, tdm.SkipViTConfig) and cfg.use_flash
    assert (cfg.d_model, cfg.n_heads, cfg.d_ff, cfg.n_enc, cfg.n_mid,
            cfg.n_dec, cfg.n_blocks) == (64, 4, 128, 4, 2, 4, 10)
    with pytest.raises(ValueError, match="trains only with --pipeline"):
        train.run(train._parse_args(["--arch", "skipvit", "--device",
                                     "cpu"]))


def test_skipvit_checkpoint_resumes_elastically_d2_to_d4(tmp_path):
    ck = str(tmp_path / "ck")
    base = ["--arch", "skipvit", "--pipeline", "--microbatches", "4",
            "--global-batch", "8", "--wire-dtype", "float32", "--log-every",
            "100", "--device", "cpu", "--ckpt-dir", ck]
    ref = train.run(train._parse_args(base[:-2] + ["--devices", "2",
                                                   "--steps", "4"]))
    a = train.run(train._parse_args(base + ["--devices", "2", "--steps",
                                            "4", "--ckpt-every", "2",
                                            "--faults", "stop@2"]))
    assert sorted(a.losses) == [0, 1]
    b = train.run(train._parse_args(base + ["--devices", "4", "--steps",
                                            "4", "--resume"]))
    assert b.resumed.step == 2 and b.resumed.elastic
    assert b.compiled.state_spec()["num_param_stacks"] == 1
    assert b.compiled.partition.num_devices == 4
    for s in (2, 3):
        np.testing.assert_allclose(b.losses[s], ref.losses[s], rtol=RTOL)
    for k, v in tree_paths(b.logical_params):
        np.testing.assert_allclose(v.numpy(),
                                   dict(tree_paths(ref.logical_params))[k]
                                   .numpy(), rtol=RTOL, atol=1e-6,
                                   err_msg=k)
