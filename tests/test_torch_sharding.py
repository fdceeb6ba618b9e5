"""The sharding rules as data (``repro_torch.runtime.sharding``,
``repro_torch.train.steps.param_specs_for``/``opt_specs_like``) held to the
JAX package's ``PartitionSpec``s, leaf for leaf (no processes).

- For every ``get_arch`` bundle and each of its plans, on the
  ``(data=2, model=2)`` sizes and on the production 16 x 16 sizes: the
  param specs, the optimizer state's (fp32 and int8 moments), the batch
  specs of every supported train or prefill shape and the cache specs of
  every supported decode shape, against JAX's on ``eval_shape`` structs
  (the port's on its meta structs).  A JAX spec is compared as
  ``tuple(PartitionSpec)``.
- ``fit_spec``'s fallbacks, ``build_param_specs``'s rules (tp, fsdp, ep
  over stacked experts, literal axes, small leaves), ``zero_stack_specs``
  and the layout helpers' block order.
- A rank's adapter from ``make_adapter`` over a ``RankGrid``, and what the
  steps over ranks still refuse.
"""
import dataclasses
import functools
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.configs import base as jbase
from repro.runtime import sharding as jsharding
from repro.train import steps as jsteps
from repro_torch import configs as tconfigs
from repro_torch.configs import base as tbase
from repro_torch.configs import hunyuan_dit as thunyuan
from repro_torch.configs import uvit_h as tuvit
from repro_torch.launch.mesh import RankGrid
from repro_torch.optim import adamw as tadamw
from repro_torch.runtime import sharding as tsharding
from repro_torch.runtime.sharding import Spec
from repro_torch.train import steps as tsteps

ARCHS = jconfigs.list_archs()
SIZES = {"2x2": (2, 2), "16x16": (16, 16)}
KEY = jax.random.PRNGKey(0)


def _mesh(shape):
    """What the JAX builders read of a mesh: its axis names and shape."""
    return types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=np.empty(shape))


def _jax_specs(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(s) for path, s in flat}


def _port_specs(tree, prefix="") -> dict:
    if isinstance(tree, Spec):
        return {prefix: tuple(tree)}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_port_specs(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _same(got, want, what):
    g, w = _port_specs(got), _jax_specs(want)
    assert sorted(g) == sorted(w), (what, sorted(set(g) ^ set(w))[:5])
    bad = {k: (g[k], w[k]) for k in g if g[k] != w[k]}
    assert not bad, (what, list(bad.items())[:5])


@functools.lru_cache(maxsize=None)
def _bundles(arch):
    jb, tb = jconfigs.get_arch(arch), tconfigs.get_arch(arch)
    return jb, tb, jax.eval_shape(jb.init_fn, KEY), tb.init_fn(None, "meta")


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("arch", ARCHS)
def test_every_bundles_specs_equal_jax(arch, size):
    """Each plan's param, optimizer, batch and cache specs on a mesh of
    ``size``, equal to JAX's leaf for leaf."""
    jb, tb, jparams, tparams = _bundles(arch)
    shape = SIZES[size]
    mesh = _mesh(shape)
    sizes = dict(zip(("data", "model"), shape))
    for name, plan in jb.plans.items():
        tplan = tb.plans[name]
        assert dataclasses.asdict(tplan) == dataclasses.asdict(plan)
        what = f"{arch} {name} {size}"
        jp = jsteps.param_specs_for(jparams, mesh, plan)
        tp = tsteps.param_specs_for(tparams, sizes, tplan)
        _same(tp, jp, f"{what} params")
        fsdp = tuple(a for a in plan.fsdp_axes if a in sizes)
        for int8 in (False, True):
            _same(tsteps.opt_specs_like(tp, int8, fsdp),
                  jsteps.opt_specs_like(jp, int8, fsdp),
                  f"{what} optimizer int8={int8}")
        shp = jbase.SHAPES[name]
        if not jb.supported(name):
            continue
        dp_axes = tuple(a for a in plan.batch_axes if a in sizes)
        if shp.kind in ("train", "prefill"):
            jbs = jb.batch_struct(shp, plan)
            tbs = tb.batch_struct(tbase.SHAPES[name], tplan)
            _same(tsharding.batch_specs(tbs, dp_axes, sizes),
                  jsharding.batch_specs(jbs, dp_axes, mesh),
                  f"{what} batch")
        elif jb.cache_struct is not None:
            kw = dict(dp_axes=dp_axes,
                      tp_axis=plan.tp_axis if plan.tp_axis in sizes
                      else None, seq_shard_axis=plan.seq_shard_axis)
            _same(tsharding.cache_specs(tb.cache_struct(tbase.SHAPES[name]),
                                        axis_sizes=sizes, **kw),
                  jsharding.cache_specs(jb.cache_struct(shp), mesh=mesh,
                                        **kw),
                  f"{what} caches")


FITS = [
    # spec, shape, axis sizes
    (P(None, "model"), (96, 96), {"data": 5, "model": 3}),
    (P("data", "model"), (96, 96), {"data": 5, "model": 3}),
    (P(("data", "model"), None), (96, 8), {"data": 5, "model": 3}),
    (P(("model", "data")), (16,), {"data": 2, "model": 2}),
    (P(("model", "data")), (18,), {"data": 2, "model": 2}),
    (P("pod", "data"), (8, 8), {"data": 2}),
    (P("data"), (4, 4), {"data": 1, "model": 2}),
    (P(), (4, 4), {"data": 2}),
    (P(("data",), None), (6, 4), {"data": 2}),
    (P("data", None), (6, 4), None),
]


@pytest.mark.parametrize("spec,shape,sizes", FITS)
def test_fit_spec_falls_back_as_jax_does(spec, shape, sizes):
    assert tuple(tsharding.fit_spec(tuple(spec), shape, sizes)) == tuple(
        jsharding.fit_spec(spec, shape, sizes))


def _leaf(*shape):
    return np.zeros(shape, np.float32)


RULE_TREE = {
    "embed": _leaf(256, 64), "wq": _leaf(64, 128), "wo": _leaf(128, 64),
    "norm": _leaf(64), "scale": _leaf(),
    "layers": {"ffn": {"w_gate": _leaf(4, 8, 64, 128),
                       "w_down": _leaf(4, 8, 128, 64),
                       "router": _leaf(64, 8)},
               "mix": [_leaf(32, 64), _leaf(3, 64, 64)]},
}
RULE_CASES = [
    dict(),
    dict(tp_axis=None, fsdp_axes=("model", "data")),
    dict(ep_axis="model"),
    dict(min_fsdp_size=1, axis_sizes={"data": 5, "model": 3}),
    dict(rules={"wq": (None, "pod"), "mix": (("data", "model"), None)},
         axis_sizes={"data": 2, "model": 2, "pod": 2}),
    dict(fsdp_axes="data", axis_sizes={"data": 16, "model": 16}),
]


@pytest.mark.parametrize("kw", RULE_CASES)
def test_build_param_specs_rules_equal_jax(kw):
    tparams = jax.tree.map(lambda x: torch.from_numpy(x), RULE_TREE)
    _same(tsharding.build_param_specs(tparams, **kw),
          jsharding.build_param_specs(RULE_TREE, **kw), str(kw))


@pytest.mark.parametrize("dp", [2, 4])
def test_zero_stack_specs_equal_jax(dp):
    stacks = {"wq": _leaf(2, 1, 3, 64, 64), "w_up": _leaf(2, 2, 1, 64, 256),
              "b": _leaf(2, 1, 3, 8), "w_down": _leaf(2, 1, 1, 256, 6)}
    want = jsharding.zero_stack_specs(stacks, dp=dp)[0]
    got = tsharding.zero_stack_specs(
        jax.tree.map(lambda x: torch.from_numpy(x), stacks), dp=dp)
    _same(got, want, f"dp={dp}")


def test_block_order_is_the_named_shardings():
    """``block_index``/``spec_view``: a dim over ("model", "data") splits
    model-major, as a ``NamedSharding`` places it; each grid point's
    blocks tile the leaf exactly once."""
    sizes = {"data": 2, "model": 3}
    x = torch.arange(6 * 4).reshape(6, 4)
    spec = Spec([("model", "data"), None])
    seen = []
    for d in range(2):
        for m in range(3):
            at = {"data": d, "model": m}
            assert tsharding.block_index(spec[0], at, sizes) == (m * 2 + d, 6)
            v = tsharding.spec_view(x, spec, at, sizes)
            assert v.shape == (1, 4)
            assert torch.equal(v, x[m * 2 + d:m * 2 + d + 1])
            seen.append(v)
    assert torch.equal(torch.cat(sorted(seen, key=lambda t: int(t[0, 0]))),
                       x)
    assert tsharding.sharded_dims(spec, sizes) == [(0, ("model", "data"))]


def test_axis_groups_list_their_members_in_block_order():
    grid = RankGrid(world=6, dp=2, pp=3, rank=4)     # data 1, pipe 1
    assert grid.coords == {"data": 1, "model": 1}
    assert grid.axis_group(("data",))[1] == [1, 4]
    assert grid.axis_group(("model",))[1] == [3, 4, 5]
    assert grid.axis_group(("pod",))[1] == [4]


@pytest.mark.parametrize("mod", [tuvit, thunyuan])
def test_diffusion_adapters_over_a_grid_are_a_ranks(mod):
    plan = mod.PLANS["train_4k"]
    adapter = mod.make_adapter(plan, RankGrid(world=4, dp=2, pp=2, rank=3))
    assert (adapter.pcfg.num_devices, adapter.pcfg.dp_size) == (2, 2)
    with pytest.raises(ValueError, match="dp_size=2"):
        adapter.build()


PLAN = tsteps.ParallelPlan
RANK_REFUSALS = [
    # plan, pipeline, the words the error names (the ids the cases had
    # when tensor parallelism was the first of them)
    pytest.param(PLAN(ep=True), False, "expert and tensor parallelism",
                 id="plan1-False-expert and tensor parallelism"),
    pytest.param(PLAN(tp_axis=None, seq_shard_axis="data"), False,
                 "sequence sharding", id="plan2-False-sequence sharding"),
    pytest.param(PLAN(tp_axis=None, int8_optimizer=True), False,
                 "int8 AdamW moments with FSDP",
                 id="plan3-False-int8 AdamW moments with FSDP"),
    pytest.param(PLAN(strategy="pp_wave", int8_optimizer=True), True,
                 "int8 AdamW moments under the pipeline",
                 id="plan4-True-int8 AdamW moments under the pipeline"),
    pytest.param(PLAN(strategy="pp_wave", fsdp_axes=("model",)), True,
                 "extra_stack_fsdp", id="plan5-True-extra_stack_fsdp"),
]


@pytest.mark.parametrize("build", ["train", "forward", "serve"])
def test_tp_over_ranks_builds_and_names_its_specs(build):
    """Tensor parallelism over ``model`` on a grid of ranks builds (it was
    refused before it was ported): each builder's param specs are JAX's
    rules, ``wq``'s columns and ``wo``'s rows over the TP axis beside FSDP
    over data, ``wk``/``wv`` whole under the plan's custom rules, and the
    step carries the rank's TP context (index 1 of 2 here)."""
    grid = RankGrid(world=4, dp=2, pp=2, rank=3)
    tb = tconfigs.get_arch("h2o-danube-1.8b")
    shape = {"train": "train_4k", "forward": "prefill_32k",
             "serve": "decode_32k"}[build]
    plan = tb.plans[shape]
    assert tsteps.check_ranks(grid, plan) == {"data": 2, "model": 2}
    if build == "serve":
        step, _ = tsteps.build_sharded_serve_step(
            tb.make_decode_fn(tbase.SHAPES[shape]), tb.init_fn,
            tb.cache_struct(tbase.SHAPES[shape]),
            tbase.meta((tbase.SHAPES[shape].global_batch, 1), torch.int32),
            grid, plan)
        assert step.in_specs[2]["layers"]["k"] == Spec(
            [None, "data", None, "model", None])
    else:
        builder = (tsteps.build_sharded_train_step if build == "train"
                   else tsteps.build_forward_step)
        step, _ = builder(tb.loss_fn, tb.init_fn,
                          tb.batch_struct(tbase.SHAPES[shape]), grid, plan)
    specs = step.in_specs[0]
    fsdp = "data"           # every danube plan's FSDP axes
    assert specs["layers"]["attn"]["wq"] == Spec([None, fsdp, "model"])
    assert specs["layers"]["attn"]["wo"] == Spec([None, "model", fsdp])
    assert specs["layers"]["attn"]["wk"] == Spec([None, None, None])
    assert specs["head"] == Spec([fsdp, "model"])
    assert (step.tp.index, step.tp.size) == (1, 2)
    assert step.comm.tp_axis == "model" and step.comm.row_axes == ("data",)
    fs, tps = tsharding.split_kinds(specs["layers"]["attn"]["wq"],
                                    {"data": 2, "model": 2}, "model",
                                    grid.coords)
    assert (fs, tps) == ([(1, ("data",))], [(2, 1, 2)])


@pytest.mark.parametrize("plan,pipeline,words", RANK_REFUSALS)
def test_what_the_ranks_still_refuse(plan, pipeline, words):
    grid = RankGrid(world=4, dp=2, pp=2, rank=0)
    with pytest.raises(NotImplementedError, match=words):
        tsteps.check_ranks(grid, plan,
                           pipeline_axis="model" if pipeline else None)
    if pipeline:
        return
    struct = {"tokens": tbase.meta((4, 8), torch.int32)}
    init = lambda gen, device: {"w": torch.empty((64, 64), device=device)}
    with pytest.raises(NotImplementedError, match=words):
        tsteps.build_sharded_train_step(lambda p, b, r=None: 0, init, struct,
                                        grid, plan)


def test_int8_moments_over_data_alone_are_whole():
    """FSDP of size 1 over the grid: int8 moments stay whole on each rank
    (their specs still name the FSDP axes, as JAX's)."""
    plan = PLAN(tp_axis=None, fsdp_axes=("pod",), int8_optimizer=True)
    grid = RankGrid(world=4, dp=2, pp=2, rank=0)
    step, (p_struct, o_struct, _) = tsteps.build_sharded_train_step(
        lambda p, b, r=None: 0,
        lambda gen, device: {"w": torch.empty((64, 64), device=device)},
        {"x": tbase.meta((4, 8), torch.float32)}, grid, plan)
    assert step.in_specs[0] == {"w": Spec([None, None])}
    assert step.in_specs[1]["m"]["w"] == {"q": Spec(), "s": Spec()}
    assert tuple(o_struct["m"]["w"]["q"].shape) == tuple(
        tadamw.int8_adamw_init(p_struct)["m"]["w"]["q"].shape)


def test_one_process_specs_are_the_same_rules():
    """In one process (axes of size 1) every spec fits to whole."""
    tb = tconfigs.get_arch("sdv2-unet")
    step, _ = tsteps.build_sharded_train_step(
        tb.loss_fn, tb.init_fn, tb.batch_struct(tbase.SHAPES["train_4k"]),
        {"data": 1, "model": 1}, tb.plans["train_4k"])
    for k, s in _port_specs(step.in_specs).items():
        assert all(e is None for e in s), (k, s)
    assert step.comm is None
    x = {"a": torch.zeros(3)}
    assert step.local(x, {"a": Spec()}) is x


def test_spec_tree_walks():
    specs = {"a": Spec(["data", None]), "b": [Spec(), Spec([None])]}
    tree = {"a": 1, "b": [2, 3]}
    assert tsharding.spec_map(lambda s, x: (tuple(s), x), specs, tree) == {
        "a": (("data", None), 1), "b": [((), 2), ((None,), 3)]}
    assert Spec([("data",), ["model", "data"], ()]) == (
        "data", ("model", "data"), None)
