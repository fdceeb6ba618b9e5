"""The port's closed-form executors, the paper's skip-carry baseline and the
linear (skip-free) executors held to the JAX package's.

Every JAX executor runs in one subprocess on four forced host devices
(``python tests/test_torch_closed_form.py jax-executors OUT``), which saves
its params, microbatches, loss and merged gradients; the port runs the
same plan from those params (``convert.params_from_jax``) on the CPU, the
kernels' plain versions, at fp32, and must match loss and gradients at
rtol 1e-4:

- the closed-form wave (``auto_pipeline(..., executor="closed_form")``,
  and ``DiffusionPipelineAdapter.build`` on its even stacks) against the
  JAX ``make_wave_pipeline`` and against the port's table executor, for
  small UViT and Hunyuan-DiT at D=2 and 4, M=4, and for SkipViT on the
  JAX package's ``wave-asym`` plan (an asymmetric fold);
- the skip-carry baseline
  (``DiffusionPipelineAdapter.build_skip_carry_baseline``) against the
  JAX one for UViT and Hunyuan-DiT at D=4, M=4, and against the
  single-device model;
- the linear table and closed-form executors against the JAX linear
  executors on a hand-built skip-free graph of UViT blocks (``t`` read
  from the microbatch, both packages' block callables the same function):
  D=2 and 4 with uneven cuts, and V=2 interleaved for the table executor;
- the refusals (``M >= D``, closed-form V=2, an unknown executor, a linear
  plan without ``block_fn``, a skip graph on a linear plan), and the hop
  byte counts against the closed forms' arithmetic and the wave's live
  count against ``partition_comm_volume``.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import graph as jax_graph
from repro.core import hw as jax_hw
from repro.models import diffusion as jdm
from repro.runtime import adapters as jax_adapters
from repro.runtime.compile import PipelineModelFns as JaxModelFns
from repro.runtime.compile import auto_pipeline as jax_auto_pipeline
from repro_torch.convert import params_from_jax
from repro_torch.core import comm_model as tcm
from repro_torch.core import graph as torch_graph
from repro_torch.core import hw as torch_hw
from repro_torch.core.partition import blockwise_partition
from repro_torch.kernels import launch_counts
from repro_torch.models import diffusion as tdm
from repro_torch.runtime import pipeline as tpipe
from repro_torch.runtime.adapters import (DiffusionPipelineAdapter,
                                          diffusion_model_fns,
                                          make_diffusion_microbatches,
                                          skipvit_model_fns)
from repro_torch.runtime.compile import PipelineModelFns, auto_pipeline
from repro_torch.tree import tree_leaves, tree_map, tree_paths

REPO = pathlib.Path(__file__).resolve().parents[1]
RTOL = 1e-4
TPU = torch_hw.Hardware(**dataclasses.asdict(jax_hw.TPU_V5E))
M = 4
UVIT_KW = dict(img_size=8, in_ch=4, patch=2, d_model=32, n_layers=8,
               n_heads=4, d_ff=64, n_classes=10)
HUNYUAN_KW = dict(img_size=8, in_ch=4, patch=2, d_model=32, n_layers=8,
                  n_heads=4, d_ff=64, ctx_dim=16, ctx_len=4)
# the JAX package's wave-asym differential: its block costs pull the
# fold's turnaround cut off-centre (D=2, lam 0)
ASYM_KW = dict(n_enc=3, n_mid=2, n_dec=3)
ASYM_TIMES = [1, 1, 4, 0.5, 0.5, 0.5, 1, 1]
# the linear model: the 8 encoder blocks of a 16-layer UViT (no skip
# projections), with costs that cut it unevenly at D=2 and at D=4
LINEAR_KW = dict(UVIT_KW, n_layers=16)
LINEAR_TIMES = [4, 2, 1, 1, 1, 1, 1, 1]

# name -> (model, D, auto_pipeline keywords)
WAVE_CASES = {f"wave-{kind}-D{D}": (kind, D, {})
              for kind in ("uvit", "hunyuan") for D in (2, 4)}
WAVE_CASES["wave-asym"] = ("skipvit", 2, {})
SKIP_CARRY_KINDS = ("uvit", "hunyuan")
LINEAR_CASES = {
    "linear-D2-table": (2, dict(executor="table")),
    "linear-D2-closed_form": (2, dict(executor="closed_form")),
    "linear-D4-table": (4, dict(executor="table")),
    "linear-D4-closed_form": (4, dict(executor="closed_form")),
    "linear-D2-V2-table": (2, dict(executor="table", interleave=2)),
}


def _flatten(tree, prefix=""):
    """Nested dicts / tuples of arrays -> {"a/b/c": array}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _unflatten(flat):
    out: dict = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


# ---------------------------------------------------------------------------
# the models, in each package
# ---------------------------------------------------------------------------

def _diffusion_cfg(dm, kind):
    if kind == "uvit":
        return dm.UViTConfig("t", **UVIT_KW)
    if kind == "hunyuan":
        return dm.HunyuanDiTConfig("t", **HUNYUAN_KW)
    return dm.SkipViTConfig("t", **ASYM_KW)


def _diffusion_graph(dm, kind, cfg, hw):
    if kind == "uvit":
        return dm.uvit_pipeline_graph(cfg, batch=2, hw=hw)
    if kind == "hunyuan":
        return dm.hunyuan_pipeline_graph(cfg, batch=2, hw=hw)
    return dm.skipvit_pipeline_graph(cfg, fwd_times=ASYM_TIMES, hw=hw)


def _linear_graph(g):
    """A skip-free graph with one block per linear-model row."""
    return g.BlockGraph(tuple(
        g.Block(f"b{i}", float(t), param_bytes=1 << 10, act_bytes=1 << 10)
        for i, t in enumerate(LINEAR_TIMES)))


def _linear_fns(dm, fns_cls, mean_square):
    """Skip-free block-level callables of the linear model: UViT's
    embedding (``t`` read from the microbatch), its encoder blocks, its
    output head.  ``aux`` is None on the linear path."""
    cfg = dm.UViTConfig("t", **LINEAR_KW)

    def embed_fn(edge_p, mb, aux):
        return dm.uvit_embed(edge_p, mb["xt"], mb["t"], mb, cfg)

    def block_fn(bp, x, aux):
        return dm._apply_vit_block(bp, x, cfg)

    def loss_fn(edge_p, x, mb, aux):
        return mean_square(dm.uvit_output(edge_p, x, cfg) - mb["noise"])

    def split_blocks(params):
        edge = {k: v for k, v in params.items() if k != "enc_blocks"}
        return (params["enc_blocks"],), edge

    def merge_blocks(stacks, edge):
        return {**edge, "enc_blocks": stacks[0]}

    return cfg, fns_cls(init_fn=None, embed_fn=embed_fn, loss_fn=loss_fn,
                        split_blocks=split_blocks, merge_blocks=merge_blocks,
                        block_fn=block_fn, num_param_stacks=1)


# ---------------------------------------------------------------------------
# the JAX side, in a subprocess on four host devices
# ---------------------------------------------------------------------------

def _jax_main(out_path):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.runtime.compat import tree_to_host
    from repro.runtime.pipeline import PipelineConfig, shard_pipeline

    key = jax.random.PRNGKey(0)
    hw = jax_hw.TPU_V5E
    out = {}

    def mesh(D):
        return Mesh(np.array(jax.devices()[:D]).reshape(1, D),
                    ("data", "model"))

    def save(name, **trees):
        for part, tree in trees.items():
            for k, v in _flatten(jax.device_get(tree)).items():
                out[f"{name}|{part}|{k}"] = v

    def batch_of(kind, cfg):
        B = 2 * M
        batch = {"latents": jax.random.normal(key, (B, 8, 8, 4))}
        if kind == "hunyuan":
            batch["text_embeds"] = jax.random.normal(key, (B, 4, 16))
        else:
            batch["labels"] = jax.random.randint(key, (B,), 0, 10)
        return batch

    def diffusion(kind):
        cfg = _diffusion_cfg(jdm, kind)
        init = {"uvit": jdm.init_uvit, "hunyuan": jdm.init_hunyuan,
                "skipvit": jdm.init_skipvit}[kind]
        params = init(key, cfg)
        mkind = "hunyuan" if kind == "hunyuan" else "uvit"
        mb, aux = jax_adapters.make_diffusion_microbatches(
            batch_of(kind, cfg), key, M, cfg, mkind, params=params)
        return cfg, params, mb, aux

    for name, (kind, D, kw) in WAVE_CASES.items():
        cfg, params, mb, aux = diffusion(kind)
        fns = (jax_adapters.skipvit_model_fns(cfg) if kind == "skipvit"
               else jax_adapters.diffusion_model_fns(cfg, kind))
        cp = jax_auto_pipeline(_diffusion_graph(jdm, kind, cfg, hw), fns, D,
                               hw, pipeline_devices=D, microbatches=M,
                               lam=0.0, executor="closed_form", **kw)
        loss, grads = jax.jit(jax.value_and_grad(cp.bind(mesh(D))))(
            cp.split_params(params), mb, aux)
        save(name, params=params, mb=mb, aux=aux,
             grads=cp.merge_params(*tree_to_host(grads)))
        out[f"{name}|loss"] = np.asarray(float(loss))
        out[f"{name}|cuts"] = np.asarray(cp.partition.cuts)

    for kind in SKIP_CARRY_KINDS:
        name, D = f"skip-carry-{kind}", 4
        cfg, params, mb, aux = diffusion(kind)
        ad = jax_adapters.DiffusionPipelineAdapter(
            cfg, PipelineConfig(num_devices=D, num_microbatches=M), kind)
        run = shard_pipeline(ad.build_skip_carry_baseline(), mesh(D),
                             stacked_args=2)

        def loss_of(state, mb, aux):
            (enc, dec), edge = state
            return run(enc, dec, edge, mb, aux)

        loss, grads = jax.jit(jax.value_and_grad(loss_of))(
            ad.split_params_skip_carry(params), mb, aux)
        save(name, params=params, mb=mb, aux=aux, grads=tree_to_host(grads))
        out[f"{name}|loss"] = np.asarray(float(loss))

    lcfg, lfns = _linear_fns(jdm, JaxModelFns,
                             lambda x: jnp.mean(jnp.square(x)))
    params = {k: v for k, v in jdm.init_uvit(key, lcfg).items()
              if k != "dec_blocks"}
    mb, aux = jax_adapters.make_diffusion_microbatches(
        batch_of("uvit", lcfg), key, M, lcfg, "uvit")
    mb = {**mb, "t": aux["t"]}
    for name, (D, kw) in LINEAR_CASES.items():
        cp = jax_auto_pipeline(_linear_graph(jax_graph), lfns, D, hw,
                               pipeline_devices=D, microbatches=M, lam=0.0,
                               wire_dtype="float32", **kw)
        loss, grads = jax.jit(jax.value_and_grad(cp.bind(mesh(D))))(
            cp.split_params(params), mb)
        save(name, params=params, mb=mb,
             grads=cp.merge_params(*tree_to_host(grads)))
        out[f"{name}|loss"] = np.asarray(float(loss))
        out[f"{name}|cuts"] = np.asarray(cp.partition.cuts)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_closed_form") / "out.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO / "src")]
                   + [p for p in os.environ.get("PYTHONPATH", "").split(
                       os.pathsep) if p]))
    proc = subprocess.run(
        [sys.executable, __file__, "jax-executors", str(out)],
        capture_output=True, text=True, timeout=600, env=env, cwd=str(REPO))
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def _saved(res, name, part):
    pre = f"{name}|{part}|"
    return _unflatten({k[len(pre):]: v for k, v in res.items()
                       if k.startswith(pre)})


# ---------------------------------------------------------------------------
# the port's side
# ---------------------------------------------------------------------------

def _grads_of(p):
    return tree_map(
        lambda x: x.grad if x.grad is not None else torch.zeros_like(x), p)


def _assert_close(loss, grads: dict, want_loss, want: dict, name: str):
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=RTOL, err_msg=name)
    assert sorted(grads) == sorted(want), name
    for k, v in grads.items():
        np.testing.assert_allclose(v.numpy(), want[k], rtol=RTOL, atol=1e-6,
                                   err_msg=f"{name}: {k}")


def _run_folded(cp, params, mb, aux):
    """(loss, merged grads by path) of one step of ``cp`` (a compiled
    pipeline or an adapter)."""
    p = tree_map(lambda x: x.detach().clone().requires_grad_(True),
                 cp.split_params(params))
    (enc, dec), edge = p
    before = launch_counts()
    loss = cp.build()(enc, dec, edge, mb, aux)
    loss.backward()
    assert launch_counts() == before            # CPU: plain versions only
    return loss, dict(tree_paths(cp.merge_params(*_grads_of(p))))


def _port_diffusion(kind):
    cfg = dataclasses.replace(_diffusion_cfg(tdm, kind), use_flash=True)
    if kind != "skipvit":
        cfg = dataclasses.replace(cfg, use_skip_kernel=True)
    fns = (skipvit_model_fns(cfg) if kind == "skipvit"
           else diffusion_model_fns(cfg, kind))
    return cfg, fns, _diffusion_graph(tdm, kind, cfg, TPU)


@pytest.mark.parametrize("name", sorted(WAVE_CASES))
def test_closed_form_wave_matches_jax_and_the_table_executor(jax_runs, name):
    kind, D, kw = WAVE_CASES[name]
    cfg, fns, graph = _port_diffusion(kind)
    params = params_from_jax(_saved(jax_runs, name, "params"), "cpu")
    mb, aux = params_from_jax((_saved(jax_runs, name, "mb"),
                               _saved(jax_runs, name, "aux")), "cpu")
    plan = dict(pipeline_devices=D, microbatches=M, lam=0.0,
                wire_dtype="float32", **kw)
    cf = auto_pipeline(graph, fns, D, TPU, executor="closed_form", **plan)
    assert list(cf.partition.cuts) == list(jax_runs[f"{name}|cuts"])
    assert cf.layout.V == 1 and "executor: closed_form" in cf.describe()
    if name == "wave-asym":
        assert not cf.partition.mirror_symmetric(), cf.partition.cuts
    loss, grads = _run_folded(cf, params, mb, aux)
    want = {k: v for k, v in _flatten(_saved(jax_runs, name,
                                             "grads")).items()}
    _assert_close(loss, grads, jax_runs[f"{name}|loss"], want, name)
    table = auto_pipeline(graph, fns, D, TPU, **plan)
    t_loss, t_grads = _run_folded(table, params, mb, aux)
    _assert_close(t_loss, t_grads, float(loss.detach()),
                  {k: v.numpy() for k, v in grads.items()}, f"{name} table")
    if kind != "skipvit":
        # the adapter's closed-form wave on its even regrouped stacks
        a_loss, a_grads = _run_folded(
            DiffusionPipelineAdapter(cfg, cf.pcfg, kind), params, mb, aux)
        _assert_close(a_loss, a_grads, jax_runs[f"{name}|loss"], want,
                      f"{name} adapter")


def _skip_carry_grads(ad, p):
    """The padded baseline stacks' grads, and the merged model's by path."""
    (enc, dec), edge = _grads_of(p)
    half = ad.pcfg.num_devices // 2
    merged = {**edge,
              "enc_blocks": tree_map(lambda x: x[:half].flatten(0, 1), enc),
              "dec_blocks": tree_map(lambda x: x[half:].flatten(0, 1), dec)}
    return ((enc, dec), edge), dict(tree_paths(merged))


def _single_device(kind, cfg, params, mb, aux):
    """The mean over microbatches of the model's own loss (no pipeline)."""
    losses = []
    for m in range(M):
        if kind == "uvit":
            pred = tdm.uvit_apply(params, mb["xt"][m], aux["t"][m],
                                  {"labels": mb["labels"][m]}, cfg)
        else:
            pred = tdm.hunyuan_apply(params, mb["xt"][m], aux["t"][m],
                                     {"text_embeds": aux["ctx"][m]}, cfg)
        losses.append(torch.mean(torch.square(pred - mb["noise"][m])))
    return torch.stack(losses).mean()


@pytest.mark.parametrize("kind", SKIP_CARRY_KINDS)
def test_skip_carry_baseline_matches_jax_and_the_model(jax_runs, kind):
    name, D = f"skip-carry-{kind}", 4
    cfg, _, _ = _port_diffusion(kind)
    ad = DiffusionPipelineAdapter(cfg, tpipe.PipelineConfig(D, M), kind)
    params = params_from_jax(_saved(jax_runs, name, "params"), "cpu")
    mb, aux = params_from_jax((_saved(jax_runs, name, "mb"),
                               _saved(jax_runs, name, "aux")), "cpu")
    p = tree_map(lambda x: x.detach().clone().requires_grad_(True),
                 ad.split_params_skip_carry(params))
    (enc, dec), edge = p
    assert tree_leaves(enc)[0].shape[:2] == (D, cfg.half // (D // 2))
    before = launch_counts()
    loss = ad.build_skip_carry_baseline()(enc, dec, edge, mb, aux)
    loss.backward()
    assert launch_counts() == before
    stacked, merged = _skip_carry_grads(ad, p)
    _assert_close(loss, dict(tree_paths(stacked)), jax_runs[f"{name}|loss"],
                  _flatten(_saved(jax_runs, name, "grads")), name)
    # the padded rows (encoder rows on decoder devices and back) stay zero
    for k, g in tree_paths(stacked[0][0]):
        assert not g[D // 2:].any(), k
    # against the whole model on one device
    q = tree_map(lambda x: x.detach().clone().requires_grad_(True), params)
    ref = _single_device(kind, cfg, q, mb, aux)
    ref.backward()
    want = {k: v.numpy() for k, v in tree_paths(_grads_of(q))}
    if kind == "hunyuan":
        # temb enters the pipeline as data: time_mlp gets no gradient
        # there (as in the JAX package's compile path)
        for k in [k for k in want if k.startswith("time_mlp/")]:
            assert not merged[k].any(), k
            del want[k]
    got = {k: v for k, v in merged.items() if k in want}
    _assert_close(loss, got, float(ref.detach()), want, f"{name} vs model")


def _linear_port():
    cfg, fns = _linear_fns(tdm, PipelineModelFns,
                           lambda x: torch.mean(torch.square(x)))
    return cfg, fns, _linear_graph(torch_graph)


@pytest.mark.parametrize("name", sorted(LINEAR_CASES))
def test_linear_executors_match_jax(jax_runs, name):
    D, kw = LINEAR_CASES[name]
    _, fns, graph = _linear_port()
    cp = auto_pipeline(graph, fns, D, TPU, pipeline_devices=D,
                       microbatches=M, lam=0.0, wire_dtype="float32", **kw)
    assert not cp.folded and "linear 1F1B" in cp.describe()
    assert list(cp.partition.cuts) == list(jax_runs[f"{name}|cuts"])
    assert cp.layout.V == kw.get("interleave", 1)
    if cp.layout.V == 1:
        sizes = cp.partition.stage_sizes()
        assert len(set(sizes)) > 1, sizes                 # uneven cuts
    assert cp.certify().ok
    params = params_from_jax(_saved(jax_runs, name, "params"), "cpu")
    mb = params_from_jax(_saved(jax_runs, name, "mb"), "cpu")
    p = tree_map(lambda x: x.detach().clone().requires_grad_(True),
                 cp.split_params(params))
    (stack,), edge = p
    loss = cp.build()(stack, edge, mb)
    loss.backward()
    grads = dict(tree_paths(cp.merge_params(*_grads_of(p))))
    _assert_close(loss, grads, jax_runs[f"{name}|loss"],
                  _flatten(_saved(jax_runs, name, "grads")), name)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_refusals():
    _, fns, graph = _port_diffusion("uvit")
    with pytest.raises(ValueError, match="M >= D"):
        auto_pipeline(graph, fns, 4, TPU, pipeline_devices=4, microbatches=2,
                      executor="closed_form").build()
    with pytest.raises(ValueError, match="closed-form"):
        auto_pipeline(graph, fns, 2, TPU, pipeline_devices=2, interleave=2,
                      microbatches=4, executor="closed_form").build()
    with pytest.raises(ValueError, match="executor"):
        auto_pipeline(graph, fns, 2, TPU, pipeline_devices=2,
                      executor="ring").build()
    _, lfns, lgraph = _linear_port()
    with pytest.raises(ValueError, match="linear pipeline needs "
                                         "model_fns.block_fn"):
        auto_pipeline(lgraph, dataclasses.replace(lfns, block_fn=None), 2,
                      TPU, pipeline_devices=2).build()
    with pytest.raises(ValueError, match="skip edges but the plan is linear"):
        auto_pipeline(graph, fns, 2, TPU, pipeline_devices=2,
                      force_wave=False)
    cfg, _, _ = _port_diffusion("uvit")
    with pytest.raises(AssertionError, match="half enc / half dec"):
        DiffusionPipelineAdapter(cfg, tpipe.PipelineConfig(3, M),
                                 "uvit").build_skip_carry_baseline()
    with pytest.raises(AssertionError):      # half = 4 over D/2 = 3 stages
        DiffusionPipelineAdapter(cfg, tpipe.PipelineConfig(6, M),
                                 "uvit").build_skip_carry_baseline()


# ---------------------------------------------------------------------------
# hop accounting
# ---------------------------------------------------------------------------

def _inputs(cfg, B):
    gen = torch.Generator().manual_seed(1)
    params = diffusion_model_fns(cfg).init_fn(gen, "cpu")
    batch = {"latents": torch.randn(B, 8, 8, 4, generator=gen),
             "labels": torch.randint(0, 10, (B,), generator=gen)}
    return params, make_diffusion_microbatches(
        batch, M, cfg, "uvit", t=torch.rand(B, generator=gen),
        noise=torch.randn(B, 8, 8, 4, generator=gen))


def _hops_of(fn, *args) -> dict:
    tpipe.reset_hop_bytes()
    with torch.no_grad():
        fn(*args)
    return tpipe.hop_bytes()


def test_hop_bytes_follow_the_closed_forms():
    D, T = 4, M + 4 - 1
    cfg, fns, graph = _port_diffusion("uvit")
    params, (mb, aux) = _inputs(cfg, 2 * M)
    act = 2 * cfg.n_tokens * cfg.d_model * 4            # one fp32 activation
    half = cfg.half
    cf = auto_pipeline(graph, fns, D, TPU, pipeline_devices=D,
                       microbatches=M, executor="closed_form")
    (enc, dec), edge = cf.split_params(params)
    wave = _hops_of(cf.build(), enc, dec, edge, mb, aux)
    assert wave == {"dense": 2 * T * (D - 1) * act,
                    "live": 2 * M * (D - 1) * act}
    # the live count is the analytic volume of the PULSE partition
    vol = tcm.partition_comm_volume(graph, cf.partition)
    assert vol.skip_bytes == 0
    assert wave["live"] / M / act == vol.boundary_bytes / \
        graph.blocks[0].act_bytes == 2 * (D - 1)
    ad = DiffusionPipelineAdapter(cfg, tpipe.PipelineConfig(D, M), "uvit")
    (enc, dec), edge = ad.split_params_skip_carry(params)
    base = _hops_of(ad.build_skip_carry_baseline(), enc, dec, edge, mb, aux)
    assert base == {"dense": T * (D - 1) * (1 + half) * act,
                    "live": M * (D - 1) * (1 + half) * act}
    # the sequential partition's analytic volume carries fewer skips than
    # the payload: a skip rides only the hops between its two ends
    seq = tcm.partition_comm_volume(graph, blockwise_partition(graph, D))
    assert (seq.boundary_bytes + seq.skip_bytes) / \
        graph.blocks[0].act_bytes < base["live"] / M / act
    # the table executor hops both closed rings on every forward step, in
    # its wire dtype; the live hops are the tables' own
    table = auto_pipeline(graph, fns, D, TPU, pipeline_devices=D,
                          microbatches=M, wire_dtype="bfloat16")
    (enc, dec), edge = table.split_params(params)
    tab = _hops_of(table.build(), enc, dec, edge, mb, aux)
    tabs = table.step_tables()
    assert tab == {"dense": tabs.dense_hops * act // 2,
                   "live": sum(tabs.live_hops) * act // 2}
    assert sum(tabs.live_hops) == 2 * M * (D - 1)
    # the linear executors: one open (closed form) or closed (table) ring
    lcfg, lfns, lgraph = _linear_port()
    lp = {k: v for k, v in tdm.init_uvit(torch.Generator().manual_seed(2),
                                         lcfg, "cpu").items()
          if k != "dec_blocks"}
    for executor, dense in (("closed_form", T * (D - 1)),
                            ("table", None)):
        lcp = auto_pipeline(lgraph, lfns, D, TPU, pipeline_devices=D,
                            microbatches=M, executor=executor,
                            wire_dtype="float32")
        (stack,), edge = lcp.split_params(lp)
        lmb = {**mb, "t": aux["t"]}
        got = _hops_of(lcp.build(), stack, edge, lmb)
        ltabs = lcp.step_tables()
        if dense is None:
            dense = ltabs.dense_hops
        assert got == {"dense": dense * act, "live": M * (D - 1) * act}
        assert sum(ltabs.live_hops) == M * (D - 1)


if __name__ == "__main__" and sys.argv[1:2] == ["jax-executors"]:
    _jax_main(sys.argv[2])
