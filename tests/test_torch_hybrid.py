"""Data parallelism and ZeRO over the rank grid -- data-parallel replicas
of the pipeline, one process per (data, model) index, at ZeRO stages 0, 1
and 2 -- held to the JAX package's ``shard_map`` executors on the same
``(data=2, model=2)`` mesh shape and to the port's one-process executor.

Processes, started by one module fixture:

- the JAX trainer (``repro.launch.train --pipeline --dp 2 --pp 2
  --zero-stage 2``, ``uvit-pp``, 5 steps, fp32 wire) in a subprocess on
  four forced host devices, and beside it ``torchrun`` running the port's
  trainer with the same flags over four gloo ranks from the JAX trainer's
  params and DDPM draws (``python tests/test_torch_hybrid.py trainer``);
- one JAX subprocess on four forced host devices (``... jax-executors
  OUT``) that runs every case of :data:`CASES` under ``shard_map``
  (``CompiledPipeline.bind``; the skip-carry baseline under
  ``shard_pipeline``) with ``use_skip_kernel=False`` and saves params,
  microbatches, loss and gradients;
- then one world of four gloo ranks (``... ranks JAX OUT``, torch on one
  thread): the grid ``make_rank_grid(2, dp=2)``, a ring over its model
  group and a ``DataGroup`` over its data group, every case from the JAX
  params, and a ZeRO-1 and a ZeRO-2 AdamW step after the wave case of
  that stage.

Held: loss and gradients, gathered back whole, against JAX at fp32 rtol
1e-4 (atol 1e-6) and against the port's one-process dp=1 executor on the
whole batch at rtol 1e-5 (atol 1e-7: the batch's sums taken per replica
and then over the replicas); the data group's bytes and calls, by
collective, against their arithmetic from the step tables and the leaves'
shapes; the AdamW steps against the unsharded ``adamw_update`` at rtol
1e-6 with moments of exactly the rank's shard of each sharded leaf; the
port's ZeRO dims against JAX's ``zero_stack_specs`` gather dims, leaf for
leaf, and ``state_spec()`` against JAX's; the trainer's five losses
against the JAX trainer's at rtol 1e-4; the refusals that remain.
"""
import dataclasses
import json
import os
import pathlib
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import hunyuan_dit as jax_hunyuan_dit
from repro.configs import uvit_h as jax_uvit_h
from repro.core import graph as jax_graph
from repro.core import hw as jax_hw
from repro.models import diffusion as jdm
from repro.runtime import adapters as jax_adapters
from repro.runtime.compile import PipelineModelFns as JaxModelFns
from repro.runtime.compile import auto_pipeline as jax_auto_pipeline
from repro.runtime.sharding import zero_stack_specs
from repro_torch.configs import hunyuan_dit as torch_hunyuan_dit
from repro_torch.configs import uvit_h as torch_uvit_h
from repro_torch.convert import params_from_jax
from repro_torch.core import graph as torch_graph
from repro_torch.core import hw as torch_hw
from repro_torch.launch import train
from repro_torch.models import diffusion as tdm
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.runtime import pipeline as tpipe
from repro_torch.runtime.adapters import (DiffusionPipelineAdapter,
                                          diffusion_model_fns)
from repro_torch.runtime.compile import PipelineModelFns, auto_pipeline
from repro_torch.runtime.sharding import leaf_dims, zero_stack_dims
from repro_torch.tree import tree_leaves, tree_map, tree_paths

REPO = pathlib.Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-4, 1e-6              # against JAX
RTOL_PORT, ATOL_PORT = 1e-5, 1e-7    # against the one-process dp=1 executor
RTOL_ADAMW = 1e-6                    # sharded AdamW against the unsharded
TRAINER_RTOL = 1e-4
TPU = torch_hw.Hardware(**dataclasses.asdict(jax_hw.TPU_V5E))
KEY = jax.random.PRNGKey(0)
M, DP, D = 4, 2, 2
B = 2 * M * DP                       # two samples a replica's microbatch
UVIT_KW = dict(img_size=8, in_ch=4, patch=2, d_model=32, n_layers=8,
               n_heads=4, d_ff=64, n_classes=10)
HUNYUAN_KW = dict(img_size=8, in_ch=4, patch=2, d_model=32, n_layers=8,
                  n_heads=4, d_ff=64, ctx_dim=16, ctx_len=4)
# the linear model: the 8 encoder blocks of a 16-layer UViT, cut unevenly
LINEAR_KW = dict(UVIT_KW, n_layers=16)
LINEAR_TIMES = [4, 2, 1, 1, 1, 1, 1, 1]

# name -> (model, ZeRO stage, auto_pipeline keywords), all at D=2, dp=2
CASES = {
    "wave-uvit-z0": ("uvit", 0, {}),
    "wave-uvit-z1": ("uvit", 1, {}),
    "wave-uvit-z2": ("uvit", 2, {}),
    "wave-uvit-V2-z2": ("uvit", 2, {"interleave": 2}),
    "wave-hunyuan-z2": ("hunyuan", 2, {}),
    "linear-z2": ("linear", 2, {}),
    "skip-carry-z1": ("skip-carry", 1, {}),
}
ADAMW_CASES = {1: "wave-uvit-z1", 2: "wave-uvit-z2"}
TRAIN_STEPS = 5
TRAIN_ARGV = ["--arch", "uvit-pp", "--pipeline", "--dp", "2", "--pp", "2",
              "--zero-stage", "2", "--steps", str(TRAIN_STEPS),
              "--microbatches", "4", "--global-batch", "8", "--wire-dtype",
              "float32", "--log-every", "1"]
TRAIN_CFG = dict(img_size=8, in_ch=4, patch=2, d_model=64, n_layers=8,
                 n_heads=4, d_ff=128, n_classes=10)


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


def _saved(res, name, part):
    pre = f"{name}|{part}|"
    return _unflatten({k[len(pre):]: v for k, v in res.items()
                       if k.startswith(pre)})


# ---------------------------------------------------------------------------
# the models, in each package
# ---------------------------------------------------------------------------

def _cfg(dm, kind):
    if kind == "hunyuan":
        return dm.HunyuanDiTConfig("t", **HUNYUAN_KW)
    if kind == "linear":
        return dm.UViTConfig("t", **LINEAR_KW)
    return dm.UViTConfig("t", **UVIT_KW)


def _graph(dm, kind, cfg, hw):
    if kind == "hunyuan":
        return dm.hunyuan_pipeline_graph(cfg, batch=2, hw=hw)
    return dm.uvit_pipeline_graph(cfg, batch=2, hw=hw)


def _linear_graph(g):
    return g.BlockGraph(tuple(
        g.Block(f"b{i}", float(t), param_bytes=1 << 10, act_bytes=1 << 10)
        for i, t in enumerate(LINEAR_TIMES)))


def _linear_fns(dm, fns_cls, mean_square, init):
    """Skip-free callables of the linear model (``t`` read from the
    microbatch; ``aux`` is None on the linear path); ``init`` draws the
    16-layer UViT and keeps its encoder half, which ZeRO's layout reads
    the leaves' shapes from."""
    cfg = _cfg(dm, "linear")

    def embed_fn(edge_p, mb, aux):
        return dm.uvit_embed(edge_p, mb["xt"], mb["t"], mb, cfg)

    def block_fn(bp, x, aux):
        return dm._apply_vit_block(bp, x, cfg)

    def loss_fn(edge_p, x, mb, aux):
        return mean_square(dm.uvit_output(edge_p, x, cfg) - mb["noise"])

    def split_blocks(params):
        edge = {k: v for k, v in params.items()
                if k not in ("enc_blocks", "dec_blocks")}
        return (params["enc_blocks"],), edge

    def merge_blocks(stacks, edge):
        return {**edge, "enc_blocks": stacks[0]}

    return fns_cls(init_fn=lambda *a: init(*a, cfg), embed_fn=embed_fn,
                   loss_fn=loss_fn, split_blocks=split_blocks,
                   merge_blocks=merge_blocks, block_fn=block_fn,
                   num_param_stacks=1)


def _port_plan(name, dp=DP):
    """The port's plan of case ``name`` (fp32 wire) at ``dp`` replicas:
    ``(compiled or adapter, model kind)``."""
    kind, z, kw = CASES[name]
    kw = dict(kw, dp_size=dp, zero_stage=z if dp > 1 else 0)
    if kind == "linear":
        fns = _linear_fns(tdm, PipelineModelFns,
                          lambda x: torch.mean(torch.square(x)),
                          lambda gen, dev, cfg: tdm.init_uvit(gen, cfg, dev))
        return auto_pipeline(_linear_graph(torch_graph), fns, D * dp, TPU,
                             pipeline_devices=D, microbatches=M, lam=0.0,
                             wire_dtype="float32", **kw), kind
    mkind = "hunyuan" if kind == "hunyuan" else "uvit"
    cfg = dataclasses.replace(_cfg(tdm, mkind), use_flash=True,
                              use_skip_kernel=True)
    if kind == "skip-carry":
        return DiffusionPipelineAdapter(cfg, tpipe.PipelineConfig(
            D, M, wire_dtype="float32", dp_size=dp,
            zero_stage=kw["zero_stage"]), mkind), kind
    return auto_pipeline(_graph(tdm, mkind, cfg, TPU),
                         diffusion_model_fns(cfg, mkind), D * dp, TPU,
                         pipeline_devices=D, microbatches=M, lam=0.0,
                         wire_dtype="float32", **kw), kind


# ---------------------------------------------------------------------------
# the JAX side, in a subprocess on four host devices
# ---------------------------------------------------------------------------

def _jax_main(out_path):
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from repro.runtime.compat import tree_to_host
    from repro.runtime.pipeline import PipelineConfig, shard_pipeline

    hw = jax_hw.TPU_V5E
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(DP, D),
                ("data", "model"))
    out = {}

    def save(name, **trees):
        for part, tree in trees.items():
            for k, v in _flatten(jax.device_get(tree)).items():
                out[f"{name}|{part}|{k}"] = v

    def inputs(kind, cfg):
        batch = {"latents": jax.random.normal(KEY, (B, 8, 8, 4))}
        if kind == "hunyuan":
            batch["text_embeds"] = jax.random.normal(KEY, (B, 4, 16))
        else:
            batch["labels"] = jax.random.randint(KEY, (B,), 0, 10)
        init = jdm.init_hunyuan if kind == "hunyuan" else jdm.init_uvit
        params = init(KEY, cfg)
        mb, aux = jax_adapters.make_diffusion_microbatches(
            batch, KEY, M, cfg, "hunyuan" if kind == "hunyuan" else "uvit",
            params=params)
        return params, mb, aux

    def batch_spec(t):
        return jax.tree.map(lambda x: P(None, "data") if x.ndim >= 2
                            else P(), t)

    for name, (kind, z, kw) in CASES.items():
        cfg = _cfg(jdm, kind)
        params, mb, aux = inputs(kind, cfg)
        if kind == "skip-carry":
            ad = jax_adapters.DiffusionPipelineAdapter(
                cfg, PipelineConfig(num_devices=D, num_microbatches=M,
                                    dp_size=DP, zero_stage=z), "uvit")
            stacks, edge = ad.split_params_skip_carry(params)
            run = shard_pipeline(
                ad.build_skip_carry_baseline(), mesh, stacked_args=2,
                batch_specs=(jax.tree.map(lambda _: P(), edge),
                             batch_spec(mb), batch_spec(aux)))
            loss, grads = jax.jit(jax.value_and_grad(
                lambda st, mb, aux: run(*st[0], st[1], mb, aux)))(
                (stacks, edge), mb, aux)
            save(name, params=params, mb=mb, aux=aux,
                 grads=tree_to_host(grads))
        elif kind == "linear":
            fns = _linear_fns(jdm, JaxModelFns,
                              lambda x: jnp.mean(jnp.square(x)),
                              lambda key, cfg: jdm.init_uvit(key, cfg))
            params = {k: v for k, v in params.items() if k != "dec_blocks"}
            mb = {**mb, "t": aux["t"]}
            cp = jax_auto_pipeline(_linear_graph(jax_graph), fns, D * DP, hw,
                                   pipeline_devices=D, microbatches=M,
                                   lam=0.0, wire_dtype="float32",
                                   dp_size=DP, zero_stage=z, **kw)
            loss, grads = jax.jit(jax.value_and_grad(cp.bind(mesh)))(
                cp.split_params(params), mb)
            save(name, params=params, mb=mb,
                 grads=cp.merge_params(*tree_to_host(grads)))
        else:
            cp = jax_auto_pipeline(
                _graph(jdm, kind, cfg, hw),
                jax_adapters.diffusion_model_fns(cfg, kind), D * DP, hw,
                pipeline_devices=D, microbatches=M, lam=0.0,
                wire_dtype="float32", dp_size=DP, zero_stage=z, **kw)
            loss, grads = jax.jit(jax.value_and_grad(cp.bind(mesh)))(
                cp.split_params(params), mb, aux)
            save(name, params=params, mb=mb, aux=aux,
                 grads=cp.merge_params(*tree_to_host(grads)))
        out[f"{name}|loss"] = np.asarray(float(loss))
    np.savez(out_path, **out)


# ---------------------------------------------------------------------------
# the rank world: four gloo processes on the (data=2, model=2) grid
# ---------------------------------------------------------------------------

def _inputs(res, name):
    return tuple(params_from_jax(_saved(res, name, part), "cpu")
                 for part in ("params", "mb", "aux"))


def _rank_step(plan, kind, params, mb, aux, ring, data):
    """This rank's plan, params (autograd leaves, their ``.grad`` filled)
    and loss."""
    pipe, di = ring.index, data.index
    if kind == "skip-carry":
        p = plan.split_params_skip_carry(params, pipe)
        fn = plan.build_skip_carry_baseline(ring, data)
    else:
        plan = plan.for_rank(pipe, di)
        p = plan.split_params(params)
        fn = plan.build(ring, data)
    p = tree_map(lambda x: x.detach().clone().requires_grad_(True), p)
    stacks, edge = p
    loss = (fn(stacks[0], edge, mb) if kind == "linear"
            else fn(*stacks, edge, mb, aux))
    return plan, p, loss


def _adamw_step(plan, p, loss, grid, ring, data):
    """One AdamW step of a ZeRO rank: the norm over the grid (the
    trainer's ``Ranks.reduce``), the update of the rank's shard
    (``optimizer_view``), ZeRO-1's gather back.  Returns the updated
    params, the norm and the moments' element count."""
    grads = tree_map(lambda x: x.grad, p)
    ranks = train.Ranks(grid, ring, torch.device("cpu"), "gloo", data)
    finite, norm = ranks.reduce(loss, grads, plan)
    assert finite
    view = plan.optimizer_view
    state = adamw_init(view(p))
    adamw_update(view(p), view(grads), state, AdamWConfig(), norm=norm)
    plan.gather_params_(p, data)
    n_moments = sum(x.numel() for x in tree_leaves(state["m"][0]))
    return p, float(norm), n_moments


def _rank_main(jax_path, out_dir):
    import datetime

    import torch.distributed as dist

    from repro_torch.launch.mesh import (dp_size, make_rank_grid,
                                         mesh_axis_sizes)
    from repro_torch.runtime.ring import DataGroup, Ring

    torch.set_num_threads(1)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dist.init_process_group("gloo", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    grid = make_rank_grid(D, dp=DP)
    ring = Ring(grid.model_group, grid.pipe_index, D, "cpu")
    data = DataGroup(grid.data_group, grid.data_index, DP, "cpu")
    with np.load(jax_path) as z:
        res = {k: z[k] for k in z.files}
    out, doc = {}, {"grid": dict(axes=mesh_axis_sizes(grid), dp=dp_size(grid),
                                 pipe=grid.pipe_index, data=grid.data_index),
                    "bytes": {}, "calls": {}, "ring": {}, "adamw": {}}
    for name, (kind, z, kw) in CASES.items():
        plan, kind = _port_plan(name)
        params, mb, aux = _inputs(res, name)
        ring.reset_bytes()
        data.reset_bytes()
        plan, p, loss = _rank_step(plan, kind, params, mb, aux, ring, data)
        out[f"{name}|loss"] = np.asarray(float(loss))
        for k, v in _flatten(tree_map(lambda x: x.grad.detach().numpy(),
                                      p)).items():
            out[f"{name}|grads|{k}"] = v
        doc["bytes"][name] = dict(data.bytes)
        doc["calls"][name] = dict(data.calls)
        doc["ring"][name] = json.loads(json.dumps(ring.bytes))
        if name in ADAMW_CASES.values():
            p, norm, n_m = _adamw_step(plan, p, loss, grid, ring, data)
            doc["adamw"][name] = dict(norm=norm, moments=n_m)
            for k, v in _flatten(tree_map(lambda x: x.detach().numpy(),
                                          p)).items():
                out[f"{name}|updated|{k}"] = v
    doc["branches"] = _branches(grid.data_group, grid.data_index, DP)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(doc, f)
    dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the port's trainer under torchrun, from the JAX trainer's params and draws
# ---------------------------------------------------------------------------

def _trainer_inputs(path):
    """The JAX trainer's initial params (``init_uvit(PRNGKey(0))``, which
    its ``init_pipeline_params`` splits) and each step's DDPM draws
    (``fold_in(PRNGKey(0), step)`` split into a uniform t and a normal
    noise over the global batch)."""
    cfg = jdm.UViTConfig("uvit-pp", **TRAIN_CFG)
    out = {f"params|{k}": v for k, v in
           _flatten(jax.device_get(jdm.init_uvit(KEY, cfg))).items()}
    for step in range(TRAIN_STEPS):
        rt, rn = jax.random.split(jax.random.fold_in(KEY, step))
        out[f"t|{step}"] = np.asarray(jax.random.uniform(rt, (8,)))
        out[f"noise|{step}"] = np.asarray(
            jax.random.normal(rn, (8, 8, 8, 4), jnp.float32))
    np.savez(path, **out)


def _trainer_main(inputs, out_dir):
    torch.set_num_threads(1)
    with np.load(inputs) as z:
        res = {k: z[k] for k in z.files}
    params = _unflatten({k[7:]: v for k, v in res.items()
                         if k.startswith("params|")})
    args = train._parse_args(TRAIN_ARGV + [
        "--device", "cpu", "--out-json",
        os.path.join(out_dir, "port{rank}.json")])
    train.run(args, init_params=params,
              draw=lambda s: (res[f"t|{s}"], res[f"noise|{s}"]))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env(**over):
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO / "src")] + [p for p in os.environ.get(
            "PYTHONPATH", "").split(os.pathsep) if p]),
        OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="", **over)


def _jax_env():
    return _env(JAX_PLATFORMS="cpu",
                XLA_FLAGS="--xla_force_host_platform_device_count=4")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("hybrid")
    _trainer_inputs(base / "train_inputs.npz")
    log = subprocess.STDOUT
    jax_trainer = subprocess.Popen(
        [sys.executable, "-m", "repro.launch.train", *TRAIN_ARGV,
         "--devices", "4", "--out-json", str(base / "jax_train.json")],
        env=_jax_env(), cwd=str(REPO), stdout=subprocess.PIPE, stderr=log,
        text=True)
    port_trainer = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", __file__, "trainer",
         str(base / "train_inputs.npz"), str(base)],
        env=_env(), cwd=str(REPO), stdout=subprocess.PIPE, stderr=log,
        text=True)
    jax_out = base / "jax.npz"
    proc = subprocess.run(
        [sys.executable, __file__, "jax-executors", str(jax_out)],
        capture_output=True, text=True, timeout=600, cwd=str(REPO),
        env=_jax_env())
    assert proc.returncode == 0, proc.stderr[-4000:]
    port = str(_free_port())
    ranks = [subprocess.Popen(
        [sys.executable, __file__, "ranks", str(jax_out), str(base)],
        env=_env(RANK=str(r), WORLD_SIZE="4", MASTER_ADDR="localhost",
                 MASTER_PORT=port), cwd=str(REPO), stdout=subprocess.PIPE,
        stderr=log, text=True) for r in range(4)]
    for r, p in enumerate(ranks):
        out, _ = p.communicate(timeout=600)
        assert p.returncode == 0, f"rank {r}:\n{out[-4000:]}"
    for what, p in (("JAX trainer", jax_trainer),
                    ("port trainer", port_trainer)):
        out, _ = p.communicate(timeout=600)
        assert p.returncode == 0, f"{what}:\n{out[-4000:]}"
    with np.load(jax_out) as z:
        jax_res = {k: z[k] for k in z.files}
    rank_res, docs = {}, {}
    for r in range(4):
        with np.load(base / f"rank{r}.npz") as z:
            rank_res[r] = {k: z[k] for k in z.files}
        with open(base / f"rank{r}.json") as f:
            docs[r] = json.load(f)
    trained = dict(
        jax=json.loads((base / "jax_train.json").read_text()),
        port=[json.loads((base / f"port{r}.json").read_text())
              for r in range(4)])
    return dict(jax=jax_res, ranks=rank_res, docs=docs, trained=trained)


# ---------------------------------------------------------------------------
# gathering the ranks' results back whole
# ---------------------------------------------------------------------------

def _rank_of(pipe, data):
    return data * D + pipe                  # the grid's row-major order


def _stage_dims(name):
    """Per param stack, each stage leaf's ZeRO dim (``-1`` everywhere
    below ZeRO-1)."""
    plan, kind = _port_plan(name)
    if kind == "skip-carry" or plan.zero_dims() is None:
        return None
    return plan.zero_dims()


def _whole(name, runs, part):
    """Rank results ``part`` ("grads" or "updated") of case ``name``
    gathered back whole: per pipeline index the data replicas' stage
    leaves (bitwise equal where whole: every leaf at ZeRO-0 and ZeRO-1's
    updated rows; summed for ZeRO-1's gradients, each replica's shard and
    zeros elsewhere; concatenated along their ZeRO dim at ZeRO-2),
    stacked over the pipeline indices; the edge leaves, which every rank
    must hold bitwise, from rank 0."""
    kind, z, _ = CASES[name]
    pre = f"{name}|{part}|"
    per = {r: {k[len(pre):]: v for k, v in runs["ranks"][r].items()
               if k.startswith(pre)} for r in range(4)}
    edge = {k: v for k, v in per[0].items() if k.startswith("1/")}
    for r in range(1, 4):
        for k, v in edge.items():
            np.testing.assert_array_equal(per[r][k], v, err_msg=k)
    dims = _stage_dims(name)
    flat_dims = ({} if dims is None else
                 {f"0/{i}/{k}": d for i, ds in enumerate(dims)
                  for k, d in _flatten(ds).items()})
    stage = {}
    for k in per[0]:
        if not k.startswith("0/"):
            continue
        rows = []
        for pipe in range(D):
            a, b = (per[_rank_of(pipe, i)][k] for i in range(DP))
            d = int(flat_dims.get(k, -1))
            if d < 0:
                np.testing.assert_array_equal(a, b, err_msg=k)
                rows.append(a)
            elif z == 1 and part == "grads":
                rows.append(a + b)
            elif z == 1:                    # gathered back whole on both
                np.testing.assert_array_equal(a, b, err_msg=k)
                rows.append(a)
            else:
                rows.append(np.concatenate([a, b], d + 1))
        stage[k] = np.stack(rows)
    stacks = _unflatten({k[2:]: v for k, v in stage.items()})
    stacks = tuple(stacks[str(i)] for i in range(len(stacks)))
    edge = _unflatten({k[2:]: v for k, v in edge.items()})
    return stacks, edge


def _merged(runs, name):
    """Loss and whole gradients, flattened as the JAX side saved them."""
    kind = CASES[name][0]
    losses = [float(runs["ranks"][r][f"{name}|loss"]) for r in range(4)]
    assert len(set(losses)) == 1, losses      # reduced over the grid
    stacks, edge = _whole(name, runs, "grads")
    if kind == "skip-carry":
        return losses[0], _flatten((stacks, edge))
    one, _ = _port_plan(name, dp=1)
    t = params_from_jax((stacks, edge), "cpu")
    return losses[0], {k: v.numpy() for k, v in
                       tree_paths(one.merge_params(*t))}


def _assert_close(loss, grads, want_loss, want, rtol, atol, what):
    np.testing.assert_allclose(loss, float(want_loss), rtol=rtol,
                               err_msg=what)
    assert sorted(grads) == sorted(want), what
    for k, v in grads.items():
        np.testing.assert_allclose(v, want[k], rtol=rtol, atol=atol,
                                   err_msg=f"{what}: {k}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_hybrid_executor_matches_jax(runs, name):
    loss, grads = _merged(runs, name)
    want = _flatten(_saved(runs["jax"], name, "grads"))
    _assert_close(loss, grads, runs["jax"][f"{name}|loss"], want, RTOL,
                  ATOL, name)


def _one_process(name, jax_res):
    """The port's one-process dp=1 executor on the whole batch: loss and
    gradients (flattened as :func:`_merged` gives them)."""
    plan, kind = _port_plan(name, dp=1)
    params, mb, aux = _inputs(jax_res, name)
    split = (plan.split_params_skip_carry if kind == "skip-carry"
             else plan.split_params)
    p = tree_map(lambda x: x.detach().clone().requires_grad_(True),
                 split(params))
    stacks, edge = p
    if kind == "skip-carry":
        loss = plan.build_skip_carry_baseline()(*stacks, edge, mb, aux)
    elif kind == "linear":
        loss = plan.build()(stacks[0], edge, mb)
    else:
        loss = plan.build()(*stacks, edge, mb, aux)
    loss.backward()
    grads = tree_map(lambda x: (x.grad if x.grad is not None
                                else torch.zeros_like(x)), p)
    if kind != "skip-carry":
        grads = plan.merge_params(*grads)
    return float(loss.detach()), {k: v.numpy() for k, v in
                                  tree_paths(grads)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_hybrid_executor_matches_one_process(runs, name):
    loss, grads = _merged(runs, name)
    want_loss, want = _one_process(name, runs["jax"])
    _assert_close(loss, grads, want_loss, want, RTOL_PORT, ATOL_PORT, name)


def _data_bytes(name, pipe):
    """The data group's bytes and calls of one forward+backward of
    pipeline index ``pipe``, from the step tables and the leaves' shapes:
    one fp32 all-reduce each of the loss, the edge gradients and, per
    stack, the stage leaves ZeRO keeps whole (all of them at ZeRO-0);
    ZeRO-1 reduce-scatters each stack's sharded leaves in one call; ZeRO-2
    all-gathers the sharded leaves of the slot every step runs, in one
    call, in the forward and again in its recompute, and reduce-scatters
    their gradients once, in one call.  Gathers and gloo's reduce-scatters
    move the params' dtype (fp32 here)."""
    _, z, _ = CASES[name]
    plan, kind = _port_plan(name)
    meta = torch.Generator().manual_seed(0), "meta"
    if kind == "skip-carry":
        stacks, edge = plan.split_params_skip_carry(
            tdm.init_uvit(meta[0], _cfg(tdm, "uvit"), "meta"), pipe)
        dims = None
    else:
        stacks, edge = plan.model_fns.split_blocks(
            plan.model_fns.init_fn(*meta))
        stacks = plan.layout.split(tuple(stacks), pipe)     # whole rows
        dims = plan.zero_dims()
    if dims is None:
        dims = [tree_map(lambda _: -1, st) for st in stacks]
    edge_n = [x.numel() for x in tree_leaves(edge)]
    nb = {"all_reduce": 4 * (1 + sum(edge_n)), "all_gather": 0,
          "reduce_scatter": 0}
    calls = {"all_reduce": 1 + (1 if edge_n else 0), "all_gather": 0,
             "reduce_scatter": 0}
    # the steps that run each stack's slots: encoder, decoder (the linear
    # walk runs its one stack as encoder steps)
    sel = plan.step_tables().sel[pipe] if z == 2 else None
    for i, (st, ds) in enumerate(zip(stacks, dims)):
        whole = sharded = slot = 0      # slot: sharded bytes of [pad, ...]
        for x, d in leaf_dims(st, ds):
            if d < 0:
                whole += 4 * x.numel()
            elif z == 1:
                sharded += x.element_size() * x.numel()
            else:
                slot += x.element_size() * x[0].numel()
        if whole:
            nb["all_reduce"] += whole
            calls["all_reduce"] += 1
        if sharded:
            nb["reduce_scatter"] += sharded
            calls["reduce_scatter"] += 1
        if slot:
            steps = int((sel == i + 1).sum())
            nb["all_gather"] += 2 * steps * slot
            nb["reduce_scatter"] += steps * slot
            calls["all_gather"] += 2 * steps
            calls["reduce_scatter"] += steps
    return nb, calls


@pytest.mark.parametrize("name", sorted(CASES))
def test_data_group_bytes_are_their_arithmetic(runs, name):
    """Each collective moved what the plan says, on every rank: the
    bytes in the wire dtype and the number of calls."""
    for r in range(4):
        pipe = runs["docs"][r]["grid"]["pipe"]
        nb, calls = _data_bytes(name, pipe)
        assert runs["docs"][r]["bytes"][name] == nb, (name, r)
        assert runs["docs"][r]["calls"][name] == calls, (name, r)


def test_ring_bytes_are_a_replicas_half_of_the_live_hops(runs):
    """Each replica's pipeline ring moves half of what the one-process
    walk of the whole batch hands its hops: every payload is a replica's
    half of a microbatch."""
    name = "wave-uvit-z2"
    one, _ = _port_plan(name, dp=1)
    params, mb, aux = _inputs(runs["jax"], name)
    tpipe.reset_hop_bytes()
    with torch.no_grad():
        stacks, edge = one.split_params(params)
        one.build()(*stacks, edge, mb, aux)
    live = tpipe.hop_bytes()["live"]
    for data in range(DP):
        by = {(p, k): sum(runs["docs"][_rank_of(pipe, data)]["ring"][name][p][k]
                          for pipe in range(D))
              for p in ("fwd", "bwd") for k in ("sent", "received")}
        assert set(by.values()) == {live // DP}, (data, by, live)


# ---------------------------------------------------------------------------
# AdamW over ZeRO shards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("zero", sorted(ADAMW_CASES))
def test_zero_adamw_step_matches_the_unsharded_update(runs, zero):
    name = ADAMW_CASES[zero]
    flat = _flatten(_whole(name, runs, "grads"))
    one, _ = _port_plan(name, dp=1)
    params, _, _ = _inputs(runs["jax"], name)
    p = one.split_params(params)
    it = iter([torch.as_tensor(flat[k]) for k, _ in tree_paths(p)])
    grads = tree_map(lambda _: next(it), p)
    norm = torch.sqrt(sum(torch.linalg.vector_norm(
        g, dtype=torch.float32).square() for g in tree_leaves(grads)))
    adamw_update(p, grads, adamw_init(p), AdamWConfig())
    got_stacks, got_edge = _whole(name, runs, "updated")
    got = _flatten((got_stacks, got_edge))
    want = _flatten(tree_map(lambda x: x.detach().numpy(), p))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=RTOL_ADAMW, atol=1e-9,
                                   err_msg=f"ZeRO-{zero}: {k}")
    # the norm over the grid counted every element once; a rank's moments
    # cover its shard of each sharded leaf and every other leaf whole
    plan, _ = _port_plan(name)
    dims = plan.zero_dims()
    stacks, _ = plan.model_fns.split_blocks(plan.model_fns.init_fn(
        torch.Generator().manual_seed(0), "meta"))
    for r in range(4):
        doc = runs["docs"][r]["adamw"][name]
        np.testing.assert_allclose(doc["norm"], float(norm), rtol=1e-6)
        rows = plan.layout.split(tuple(stacks), runs["docs"][r]["grid"]["pipe"])
        sharded = sum(x.numel() for st, ds in zip(rows, dims)
                      for x, d in leaf_dims(st, ds) if d >= 0)
        whole = sum(x.numel() for x in tree_leaves(rows))
        assert sharded % DP == 0 and sharded > 0
        assert doc["moments"] == whole - sharded + sharded // DP, (r, doc)


# ---------------------------------------------------------------------------
# the ZeRO layout and the state spec, against the JAX package's
# ---------------------------------------------------------------------------

def _model_pair(model):
    if model == "uvit-h":
        return jax_uvit_h.CFG, torch_uvit_h.CFG, "uvit"
    if model == "hunyuan-dit":
        return jax_hunyuan_dit.CFG, torch_hunyuan_dit.CFG, "hunyuan"
    return _cfg(jdm, model), _cfg(tdm, model), model


@pytest.mark.parametrize("model, V", [("uvit", 1), ("uvit", 2),
                                      ("hunyuan", 1), ("uvit-h", 2),
                                      ("hunyuan-dit", 2)])
def test_zero_dims_equal_jax_gather_dims(model, V):
    jcfg, tcfg, kind = _model_pair(model)
    hw = jax_hw.TPU_V5E
    kw = dict(pipeline_devices=D, microbatches=M, lam=0.0, interleave=V,
              dp_size=DP, zero_stage=2)
    jcp = jax_auto_pipeline(_graph(jdm, kind, jcfg, hw),
                            jax_adapters.diffusion_model_fns(jcfg, kind),
                            D * DP, hw, **kw)
    tcp = auto_pipeline(_graph(tdm, kind, tcfg, TPU),
                        diffusion_model_fns(tcfg, kind), D * DP, TPU, **kw)
    stacks, _ = jax.eval_shape(
        lambda k: jcp.split_params(jcp.model_fns.init_fn(k)), KEY)
    want = [zero_stack_specs(st, dp=DP)[1] for st in stacks]
    got = tcp.zero_dims()
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert _flatten(g) == {k: int(v) for k, v in _flatten(w).items()}
    # the layout the JAX executor gathers on, and some leaves of each kind
    assert [_flatten(d) for d in got] == [
        {k: int(v) for k, v in _flatten(d).items()}
        for d in jcp._zero_layout()[1]]
    flat = _flatten(got[0])
    assert {int(v) for v in flat.values()} >= {1, 2}
    # the rule itself, on the port's own [D, V, pad, ...] stacks
    stacks, _ = tcp.model_fns.split_blocks(tcp.model_fns.init_fn(
        torch.Generator().manual_seed(0), "meta"))
    assert [_flatten(zero_stack_dims(st, dp=DP))
            for st in tcp.layout.split(tuple(stacks))] == [
        {k: int(v) for k, v in _flatten(w).items()} for w in want]


@pytest.mark.parametrize("zero", [0, 1, 2])
def test_state_spec_equals_jax(zero):
    jcfg, tcfg, kind = _model_pair("uvit")
    hw = jax_hw.TPU_V5E
    kw = dict(pipeline_devices=D, microbatches=M, lam=0.0, dp_size=DP,
              zero_stage=zero)
    jcp = jax_auto_pipeline(_graph(jdm, kind, jcfg, hw),
                            jax_adapters.diffusion_model_fns(jcfg, kind),
                            D * DP, hw, **kw)
    tcp = auto_pipeline(_graph(tdm, kind, tcfg, TPU),
                        diffusion_model_fns(tcfg, kind), D * DP, TPU, **kw)
    assert tcp.state_spec() == jcp.state_spec()
    assert tcp.state_spec()["dp"] == DP
    assert tcp.state_spec()["zero_stage"] == zero
    assert tcp.fingerprint() == jcp.fingerprint()
    line = f"  hybrid: dp={DP} over ('data',), zero_stage={zero}"
    assert line in tcp.describe().splitlines()
    assert line in jcp.describe().splitlines()


def test_what_the_hybrid_path_still_refuses():
    plan, _ = _port_plan("wave-uvit-z2")
    # one process runs one replica: data replicas are ranks
    with pytest.raises(ValueError, match="data replicas as ranks"):
        plan.build()
    with pytest.raises(ValueError, match="data index 2 outside"):
        plan.for_rank(0, 2)
    # the closed forms keep the rows whole, as the JAX package's do
    cf = dataclasses.replace(plan, executor="closed_form")
    with pytest.raises(ValueError, match="closed-form executors keep"):
        cf.build()
    cfg = _cfg(tdm, "uvit")
    with pytest.raises(ValueError, match="skip-carry baseline keeps"):
        DiffusionPipelineAdapter(cfg, tpipe.PipelineConfig(
            D, M, dp_size=DP, zero_stage=2)).build_skip_carry_baseline()


# ---------------------------------------------------------------------------
# the trainer over the grid
# ---------------------------------------------------------------------------

def test_trainer_zero2_over_ranks_matches_the_jax_trainer(runs):
    want = {int(k): v for k, v in runs["trained"]["jax"]["losses"].items()}
    assert sorted(want) == list(range(TRAIN_STEPS))
    for r, doc in enumerate(runs["trained"]["port"]):
        got = {int(k): v for k, v in doc["losses"].items()}
        assert sorted(got) == list(range(TRAIN_STEPS)), r
        for s in range(TRAIN_STEPS):
            np.testing.assert_allclose(got[s], want[s], rtol=TRAINER_RTOL,
                                       err_msg=f"rank {r} step {s}")
        assert doc["skipped_steps"] == 0


def _branches(group, index, size):
    """The data group's collectives on bf16 tensors through its gloo
    branch and through its NCCL branch (whose ``all_gather_into_tensor``
    and ``reduce_scatter_tensor`` gloo runs too on CPU tensors), against
    the fp32 sums of every data peer's tensors."""
    import torch.distributed as dist

    from repro_torch.runtime.ring import DataGroup
    gen = torch.Generator().manual_seed(index)
    xs = [torch.randn(6, 4, generator=gen).to(torch.bfloat16),
          torch.randn(3, 6, 2, generator=gen).to(torch.bfloat16)]
    dims = [0, 1]
    every = []
    for x in xs:
        got = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(got, x, group=group)
        every.append(sum(y.float() for y in got))
    want = [e.narrow(d, index * (e.shape[d] // size), e.shape[d] // size)
            .to(torch.bfloat16) for e, d in zip(every, dims)]
    doc = {}
    for backend in ("gloo", "nccl"):
        data = DataGroup(group, index, size, "cpu")
        data.backend = backend          # the branch under test
        shards = data.reduce_scatter(xs, dims)
        whole = data.all_gather(shards, dims)
        into = [torch.zeros_like(x) for x in xs]
        data.all_gather(shards, dims, out=into)
        own = [x.clone() for x in xs]
        data.reduce_scatter(own, dims, out=[
            x.narrow(d, index * w.shape[d], w.shape[d])
            for x, d, w in zip(own, dims, want)])
        summed = [x.float() for x in xs]
        data.all_reduce_(summed)
        doc[backend] = dict(
            shards=all(torch.equal(a, w) for a, w in zip(shards, want)),
            own=all(torch.equal(x.narrow(d, index * w.shape[d], w.shape[d]),
                                w) for x, d, w in zip(own, dims, want)),
            gathered=all(torch.equal(a, e.to(torch.bfloat16))
                         and torch.equal(b, a)
                         for a, b, e in zip(whole, into, every)),
            all_reduce=all(torch.equal(a, e) for a, e in zip(summed, every)),
            bytes=dict(data.bytes), calls=dict(data.calls))
    return doc


@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_data_group_branches_agree(runs, backend):
    """Each branch of the data group gives every rank the fp32 sum of its
    data peers' bf16 tensors, cast once, and the gathers give the shards
    back whole; the bytes are the branch's wire: the reduce-scatter's
    input in bf16 over gloo (point to point), in fp32 over NCCL."""
    n = 6 * 4 + 3 * 6 * 2              # elements of the two tensors
    rs = {"gloo": 2 * n, "nccl": 4 * n}[backend]
    for r in range(4):
        got = runs["docs"][r]["branches"][backend]
        assert got["shards"] and got["own"] and got["gathered"] \
            and got["all_reduce"], got
        assert got["bytes"] == dict(all_reduce=4 * n, all_gather=4 * n,
                                    reduce_scatter=2 * rs), got
        assert got["calls"] == dict(all_reduce=1, all_gather=2,
                                    reduce_scatter=2), got


if __name__ == "__main__" and sys.argv[1:2] == ["jax-executors"]:
    _jax_main(sys.argv[2])
elif __name__ == "__main__" and sys.argv[1:2] == ["ranks"]:
    _rank_main(sys.argv[2], sys.argv[3])
elif __name__ == "__main__" and sys.argv[1:2] == ["trainer"]:
    _trainer_main(sys.argv[2], sys.argv[3])
