"""The rank executors -- one process per pipeline device, the ring hops as
point-to-point sends over a gloo process group, the backward as an
explicit reverse walk of the step tables -- held to the JAX package's
``shard_map`` executors and to the port's one-process executors.

Three kinds of process, started together by one module fixture:

- one JAX subprocess on four forced host devices
  (``python tests/test_torch_ranks.py jax-executors OUT``) runs the JAX
  table executors under ``shard_map`` (``CompiledPipeline.bind``) and the
  skip-carry baseline under ``shard_pipeline``, at fp32 wire, and saves
  params, microbatches, loss and gradients;
- then one world of four gloo ranks on the CPU (``... ranks JAX OUT``,
  torch on one thread) runs every case from those params
  (``convert.params_from_jax``), the D=2 cases on a subgroup of ranks 0
  and 1, each with ``overlap`` on and off, and records each rank's loss,
  gradients and ring bytes, and the ring's refusals;
- meanwhile ``torchrun`` runs the trainer over two ranks (``uvit-pp``, 5
  steps, fp32 wire), once clean and once with ``nan@2``.

Held: loss and gradients against JAX at rtol 1e-4 (atol 1e-6), against the
port's one-process executor at rtol 1e-6 (atol 1e-7: the same fp32 sums
in another order), ``overlap`` on and off bitwise; the ring's bytes, by
direction, against the one-process ``HOP_BYTES`` live count, and PULSE's
cut of them against the skip-carry baseline above the JAX helper's 30 %;
the tables' agreement on UViT, Hunyuan-DiT and SkipViT plans and an ILP
schedule; the refusals; the trainer's losses against the one-process
trainer's at the trainer tests' rtol 1e-4, and the NaN step skipped on
both ranks.
"""
import dataclasses
import functools
import json
import os
import pathlib
import socket
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
from repro_torch.core import graph as torch_graph
from repro_torch.core import hw as torch_hw
from repro_torch.launch import train
from repro_torch.models import diffusion as tdm
from repro_torch.runtime import pipeline as tpipe
from repro_torch.runtime.adapters import (DiffusionPipelineAdapter,
                                          diffusion_model_fns,
                                          skipvit_model_fns)
from repro_torch.runtime.compile import PipelineModelFns, auto_pipeline
from repro_torch.runtime.schedule_exec import PlanError, check_ring_agreement
from repro_torch.tree import tree_map, tree_paths

REPO = pathlib.Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-4, 1e-6              # against JAX
RTOL_PORT, ATOL_PORT = 1e-6, 1e-7    # against the one-process executor
TRAINER_RTOL = 1e-4                  # tests/test_torch_trainer.py's
TPU = torch_hw.Hardware(**dataclasses.asdict(jax_hw.TPU_V5E))
M = 4
UVIT_KW = dict(img_size=8, in_ch=4, patch=2, d_model=32, n_layers=8,
               n_heads=4, d_ff=64, n_classes=10)
HUNYUAN_KW = dict(img_size=8, in_ch=4, patch=2, d_model=32, n_layers=8,
                  n_heads=4, d_ff=64, ctx_dim=16, ctx_len=4)
# the linear model: the 8 encoder blocks of a 16-layer UViT, cut unevenly
LINEAR_KW = dict(UVIT_KW, n_layers=16)
LINEAR_TIMES = [4, 2, 1, 1, 1, 1, 1, 1]

# name -> (model, D, auto_pipeline keywords); "skip-carry" is the paper's
# baseline through DiffusionPipelineAdapter
CASES = {
    "wave-uvit-D2": ("uvit", 2, {}),
    "wave-uvit-D4": ("uvit", 4, {}),
    "wave-uvit-D2-V2": ("uvit", 2, {"interleave": 2}),
    "wave-hunyuan-D4": ("hunyuan", 4, {}),
    "linear-D2": ("linear", 2, {}),
    "linear-D2-V2": ("linear", 2, {"interleave": 2}),
    "skip-carry-D4": ("skip-carry", 4, {}),
}
TRAIN_ARGV = ["--arch", "uvit-pp", "--pipeline", "--devices", "2",
              "--steps", "5", "--microbatches", "4", "--global-batch", "8",
              "--wire-dtype", "float32", "--log-every", "1", "--device",
              "cpu"]
NAN_STEP = 2


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


def _linear_fns(dm, fns_cls, mean_square):
    """Skip-free callables of the linear model (``t`` read from the
    microbatch; ``aux`` is None on the linear path)."""
    cfg = _cfg(dm, "linear")

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

    return fns_cls(init_fn=None, embed_fn=embed_fn, loss_fn=loss_fn,
                   split_blocks=split_blocks, merge_blocks=merge_blocks,
                   block_fn=block_fn, num_param_stacks=1)


def _port_plan(name):
    """The port's plan of case ``name`` (fp32 wire): ``(compiled or
    adapter, model kind)``."""
    kind, D, kw = CASES[name]
    if kind == "linear":
        fns = _linear_fns(tdm, PipelineModelFns,
                          lambda x: torch.mean(torch.square(x)))
        return auto_pipeline(_linear_graph(torch_graph), fns, D, TPU,
                             pipeline_devices=D, microbatches=M, lam=0.0,
                             wire_dtype="float32", **kw), kind
    mkind = "hunyuan" if kind == "hunyuan" else "uvit"
    cfg = dataclasses.replace(_cfg(tdm, mkind), use_flash=True,
                              use_skip_kernel=True)
    if kind == "skip-carry":
        return DiffusionPipelineAdapter(cfg, tpipe.PipelineConfig(
            D, M, wire_dtype="float32"), mkind), kind
    return auto_pipeline(_graph(tdm, mkind, cfg, TPU),
                         diffusion_model_fns(cfg, mkind), D, TPU,
                         pipeline_devices=D, microbatches=M, lam=0.0,
                         wire_dtype="float32", **kw), kind


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

    def inputs(kind, cfg):
        B = 2 * M
        batch = {"latents": jax.random.normal(key, (B, 8, 8, 4))}
        if kind == "hunyuan":
            batch["text_embeds"] = jax.random.normal(key, (B, 4, 16))
        else:
            batch["labels"] = jax.random.randint(key, (B,), 0, 10)
        init = jdm.init_hunyuan if kind == "hunyuan" else jdm.init_uvit
        params = init(key, cfg)
        mb, aux = jax_adapters.make_diffusion_microbatches(
            batch, key, M, cfg, "hunyuan" if kind == "hunyuan" else "uvit",
            params=params)
        return params, mb, aux

    for name, (kind, D, kw) in CASES.items():
        cfg = _cfg(jdm, kind)
        params, mb, aux = inputs(kind, cfg)
        if kind == "skip-carry":
            ad = jax_adapters.DiffusionPipelineAdapter(
                cfg, PipelineConfig(num_devices=D, num_microbatches=M),
                "uvit")
            run = shard_pipeline(ad.build_skip_carry_baseline(), mesh(D),
                                 stacked_args=2)
            loss, grads = jax.jit(jax.value_and_grad(
                lambda st, mb, aux: run(*st[0], st[1], mb, aux)))(
                ad.split_params_skip_carry(params), mb, aux)
            save(name, params=params, mb=mb, aux=aux,
                 grads=tree_to_host(grads))
        elif kind == "linear":
            fns = _linear_fns(jdm, JaxModelFns,
                              lambda x: jnp.mean(jnp.square(x)))
            params = {k: v for k, v in params.items() if k != "dec_blocks"}
            mb = {**mb, "t": aux["t"]}
            cp = jax_auto_pipeline(_linear_graph(jax_graph), fns, D, hw,
                                   pipeline_devices=D, microbatches=M,
                                   lam=0.0, wire_dtype="float32", **kw)
            loss, grads = jax.jit(jax.value_and_grad(cp.bind(mesh(D))))(
                cp.split_params(params), mb)
            save(name, params=params, mb=mb,
                 grads=cp.merge_params(*tree_to_host(grads)))
            out[f"{name}|cuts"] = np.asarray(cp.partition.cuts)
        else:
            cp = jax_auto_pipeline(
                _graph(jdm, kind, cfg, hw),
                jax_adapters.diffusion_model_fns(cfg, kind), D, hw,
                pipeline_devices=D, microbatches=M, lam=0.0,
                wire_dtype="float32", **kw)
            loss, grads = jax.jit(jax.value_and_grad(cp.bind(mesh(D))))(
                cp.split_params(params), mb, aux)
            save(name, params=params, mb=mb, aux=aux,
                 grads=cp.merge_params(*tree_to_host(grads)))
            out[f"{name}|cuts"] = np.asarray(cp.partition.cuts)
        out[f"{name}|loss"] = np.asarray(float(loss))
    np.savez(out_path, **out)


# ---------------------------------------------------------------------------
# the rank world: four gloo processes
# ---------------------------------------------------------------------------

def _inputs(res, name):
    return tuple(params_from_jax(_saved(res, name, part), "cpu")
                 for part in ("params", "mb", "aux"))


class _BlockCalls:
    """Counts the model's block applications (``_apply_vit_block``, which
    every block function of both models here calls at call time): a
    forward and one recompute under ``remat`` make two a block and
    microbatch; a nested recompute would make three."""

    def __init__(self):
        self.n = 0
        self._inner = tdm._apply_vit_block

    def __call__(self, *a, **k):
        self.n += 1
        return self._inner(*a, **k)

    def __enter__(self):
        tdm._apply_vit_block = self
        return self

    def __exit__(self, *exc):
        tdm._apply_vit_block = self._inner


def _rank_step(plan, kind, params, mb, aux, ring, overlap: bool):
    """This rank's loss, gradients (flattened), ring bytes and block
    applications."""
    rank = ring.index
    if kind == "skip-carry":
        plan = dataclasses.replace(plan, pcfg=dataclasses.replace(
            plan.pcfg, overlap=overlap))
        p = plan.split_params_skip_carry(params, rank)
        fn = plan.build_skip_carry_baseline(ring)
    else:
        plan = plan.for_rank(rank)
        plan = dataclasses.replace(plan, pcfg=dataclasses.replace(
            plan.pcfg, overlap=overlap))
        p = plan.split_params(params)
        fn = plan.build(ring)
    p = tree_map(lambda x: x.detach().clone().requires_grad_(True), p)
    ring.reset_bytes()
    stacks, edge = p
    with _BlockCalls() as calls:
        loss = (fn(stacks[0], edge, mb) if kind == "linear"
                else fn(*stacks, edge, mb, aux))
    grads = tree_map(lambda x: x.grad.detach().numpy(), p)
    return (float(loss), _flatten(grads), json.loads(json.dumps(ring.bytes)),
            calls.n)


def _rank_main(jax_path, out_dir):
    import datetime

    import torch.distributed as dist

    from repro_torch.launch.mesh import (dp_size, make_rank_grid,
                                         mesh_axis_sizes)
    from repro_torch.runtime.ring import Ring, refuse_shared_cards

    torch.set_num_threads(1)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dist.init_process_group("gloo", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    grid = make_rank_grid(4)
    groups = {4: grid.model_group, 2: dist.new_group([0, 1])}
    with np.load(jax_path) as z:
        res = {k: z[k] for k in z.files}
    out, doc = {}, {"bytes": {}, "refusals": {},
                    "grid": dict(axes=mesh_axis_sizes(grid),
                                 dp=dp_size(grid), pipe=grid.pipe_index,
                                 data=grid.data_index)}
    for name, (kind, D, kw) in CASES.items():
        plan, kind = _port_plan(name)
        params, mb, aux = _inputs(res, name)
        if rank >= D:
            continue
        ring = Ring(groups[D], rank, D, "cpu")
        runs = {ov: _rank_step(plan, kind, params, mb, aux, ring, ov)
                for ov in (True, False)}
        loss, grads, nbytes, calls = runs[True]
        out[f"{name}|loss"] = np.asarray(loss)
        for k, v in grads.items():
            out[f"{name}|grads|{k}"] = v
        doc["bytes"][name] = nbytes
        doc.setdefault("block_calls", {})[name] = calls
        off_loss, off_grads, off_bytes, _ = runs[False]
        doc.setdefault("overlap", {})[name] = dict(
            loss_equal=off_loss == loss, bytes_equal=off_bytes == nbytes,
            grads_equal=sorted(off_grads) == sorted(grads) and all(
                np.array_equal(off_grads[k], grads[k]) for k in grads))

    def refusal(what, fn):
        try:
            fn()
        except (ValueError, RuntimeError) as e:
            doc["refusals"][what] = f"{type(e).__name__}: {e}"
        else:
            doc["refusals"][what] = None

    refusal("shared card", lambda: refuse_shared_cards(
        groups[4], "host/one-card"))
    refusal("distinct cards", lambda: refuse_shared_cards(
        groups[4], f"host/card-{rank}"))
    refusal("unstaged cuda", lambda: Ring(groups[4], rank, 4, "cuda"))
    refusal("staged cpu", lambda: Ring(groups[4], rank, 4, "cpu",
                                       staged=True))
    refusal("wrong index", lambda: Ring(groups[4], (rank + 1) % 4, 4, "cpu"))
    g2 = make_rank_grid(2, dp=2)
    doc["refusals"]["dp 2"] = dict(
        axes=mesh_axis_sizes(g2), dp=dp_size(g2), pipe=g2.pipe_index,
        data=g2.data_index,
        model_group=dist.get_process_group_ranks(g2.model_group),
        data_group=dist.get_process_group_ranks(g2.data_group))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(doc, f)
    dist.barrier()
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env(**over):
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO / "src")] + [p for p in os.environ.get(
            "PYTHONPATH", "").split(os.pathsep) if p]),
        OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="", **over)


def _torchrun(out_dir, extra):
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         *TRAIN_ARGV, "--out-json", str(out_dir / "out{rank}.json"), *extra],
        env=_env(), cwd=str(REPO), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("ranks")
    trainers = {}
    for name, extra in (("clean", []), ("nan", ["--faults",
                                                f"nan@{NAN_STEP}"])):
        (base / name).mkdir()
        trainers[name] = _torchrun(base / name, extra)
    jax_out = base / "jax.npz"
    proc = subprocess.run(
        [sys.executable, __file__, "jax-executors", str(jax_out)],
        capture_output=True, text=True, timeout=600, cwd=str(REPO),
        env=_env(JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_force_host_platform_device_count=4"))
    assert proc.returncode == 0, proc.stderr[-4000:]
    port = str(_free_port())
    ranks = [subprocess.Popen(
        [sys.executable, __file__, "ranks", str(jax_out), str(base)],
        env=_env(RANK=str(r), WORLD_SIZE="4", MASTER_ADDR="localhost",
                 MASTER_PORT=port), cwd=str(REPO), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(4)]
    for r, p in enumerate(ranks):
        log, _ = p.communicate(timeout=600)
        assert p.returncode == 0, f"rank {r}:\n{log[-4000:]}"
    for name, p in trainers.items():
        log, _ = p.communicate(timeout=600)
        assert p.returncode == 0, f"trainer {name}:\n{log[-4000:]}"
    with np.load(jax_out) as z:
        jax_res = {k: z[k] for k in z.files}
    rank_res, docs = {}, {}
    for r in range(4):
        with np.load(base / f"rank{r}.npz") as z:
            rank_res[r] = {k: z[k] for k in z.files}
        with open(base / f"rank{r}.json") as f:
            docs[r] = json.load(f)
    trained = {name: [json.loads((base / name / f"out{r}.json").read_text())
                      for r in range(2)] for name in trainers}
    return dict(jax=jax_res, ranks=rank_res, docs=docs, trained=trained)


# ---------------------------------------------------------------------------
# the rank executors against JAX, the one-process executor, themselves
# ---------------------------------------------------------------------------

def _merged(runs, name):
    """The ranks' loss and gradients, merged as the JAX side saved them:
    the stage rows of every rank stacked over the device axis (the
    compile path's through ``merge_params``), the edge params rank 0's,
    which every rank must hold bitwise."""
    kind, D, _ = CASES[name]
    per = [{k[len(name) + 7:]: v for k, v in runs["ranks"][r].items()
            if k.startswith(f"{name}|grads|")} for r in range(D)]
    losses = [float(runs["ranks"][r][f"{name}|loss"]) for r in range(D)]
    assert len(set(losses)) == 1, losses           # reduced over the group
    edge = {k: v for k, v in per[0].items() if k.startswith("1/")}
    for r in range(1, D):
        for k, v in edge.items():
            np.testing.assert_array_equal(per[r][k], v, err_msg=k)
    stacks = _unflatten({k: np.stack([p[k] for p in per])
                         for k in per[0] if k.startswith("0/")})["0"]
    stacks = tuple(stacks[str(i)] for i in range(len(stacks)))
    edge = _unflatten({k[2:]: v for k, v in edge.items()})
    if kind == "skip-carry":
        return losses[0], _flatten((stacks, edge))
    plan, _ = _port_plan(name)
    t = params_from_jax((stacks, edge), "cpu")
    return losses[0], {k: v.numpy() for k, v in
                       tree_paths(plan.merge_params(*t))}


def _assert_close(loss, grads, want_loss, want, rtol, atol, what):
    np.testing.assert_allclose(loss, float(want_loss), rtol=rtol,
                               err_msg=what)
    assert sorted(grads) == sorted(want), what
    for k, v in grads.items():
        np.testing.assert_allclose(v, want[k], rtol=rtol, atol=atol,
                                   err_msg=f"{what}: {k}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_rank_executor_matches_jax(runs, name):
    loss, grads = _merged(runs, name)
    want = _flatten(_saved(runs["jax"], name, "grads"))
    _assert_close(loss, grads, runs["jax"][f"{name}|loss"], want, RTOL,
                  ATOL, name)
    if f"{name}|cuts" in runs["jax"]:
        plan, _ = _port_plan(name)
        assert list(plan.partition.cuts) == list(runs["jax"][f"{name}|cuts"])


def _one_process(name, jax_res):
    """The port's one-process executor on the same params: loss,
    gradients (flattened as :func:`_merged` gives them) and block
    applications."""
    plan, kind = _port_plan(name)
    params, mb, aux = _inputs(jax_res, name)
    split = (plan.split_params_skip_carry if kind == "skip-carry"
             else plan.split_params)
    p = tree_map(lambda x: x.detach().clone().requires_grad_(True),
                 split(params))
    stacks, edge = p
    with _BlockCalls() as calls:
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
                                  tree_paths(grads)}, calls.n


@pytest.mark.parametrize("name", sorted(CASES))
def test_rank_executor_matches_one_process(runs, name):
    loss, grads = _merged(runs, name)
    want_loss, want, _ = _one_process(name, runs["jax"])
    _assert_close(loss, grads, want_loss, want, RTOL_PORT, ATOL_PORT, name)


@pytest.mark.parametrize("name", sorted(CASES))
def test_rank_walk_runs_each_block_as_often_as_one_process(runs, name):
    """Each op is back-propagated once: the ranks' block applications
    (forward without autograd, then one recompute) sum to the one-process
    executor's under ``torch.utils.checkpoint`` -- two a block and
    microbatch -- where a recompute nested in the step's recompute would
    make three."""
    kind, D, _ = CASES[name]
    got = sum(runs["docs"][r]["block_calls"][name] for r in range(D))
    want = _one_process(name, runs["jax"])[2]
    blocks = (_cfg(tdm, "linear").n_layers // 2 if kind == "linear"
              else _cfg(tdm, kind).n_layers)
    assert got == want == 2 * blocks * M, (got, want)


@pytest.mark.parametrize("name", sorted(CASES))
def test_overlap_on_and_off_are_bitwise_equal(runs, name):
    D = CASES[name][1]
    for r in range(D):
        assert runs["docs"][r]["overlap"][name] == dict(
            loss_equal=True, bytes_equal=True, grads_equal=True), (name, r)


def _hop_bytes(name, jax_res):
    """The one-process forward walk's ``HOP_BYTES`` on the same inputs."""
    plan, kind = _port_plan(name)
    params, mb, aux = _inputs(jax_res, name)
    tpipe.reset_hop_bytes()
    with torch.no_grad():
        if kind == "skip-carry":
            stacks, edge = plan.split_params_skip_carry(params)
            plan.build_skip_carry_baseline()(*stacks, edge, mb, aux)
        else:
            stacks, edge = plan.split_params(params)
            plan.build()(*stacks, edge, mb, aux)
    return tpipe.hop_bytes()


def test_ring_bytes_are_the_live_hops_and_pulse_cuts_them(runs):
    """The comm-volume check of ``tests/helpers/comm_volume_hlo.py`` on
    the rank executors: each direction of the gloo ring moved exactly the
    one-process walk's live ``HOP_BYTES`` (forward sends = forward
    receives = backward sends = backward receives), and PULSE's table
    wave moves less than the skip-carry baseline by more than the JAX
    helper's 30 %."""
    total = {}
    for name in ("wave-uvit-D4", "skip-carry-D4"):
        live = _hop_bytes(name, runs["jax"])["live"]
        by = {(p, k): sum(runs["docs"][r]["bytes"][name][p][k]
                          for r in range(4))
              for p in ("fwd", "bwd") for k in ("sent", "received")}
        assert by == dict.fromkeys(by, live), (name, by, live)
        total[name] = by[("fwd", "sent")] + by[("bwd", "sent")]
        assert total[name] == 2 * live
    cut = 1 - total["wave-uvit-D4"] / total["skip-carry-D4"]
    assert cut > 0.30, cut
    # 2(D-1) = 6 activations a microbatch against (1 + 4 skips)(D-1) = 15
    assert cut == pytest.approx(1 - 6 / 15)


def test_rank_grid_and_ring_refusals(runs):
    for r in range(4):
        doc = runs["docs"][r]
        assert doc["grid"] == dict(axes={"data": 1, "model": 4}, dp=1,
                                   pipe=r, data=0)
        ref = doc["refusals"]
        assert "share the card host/one-card" in ref["shared card"]
        assert "Duplicate GPU" in ref["shared card"]
        assert ref["distinct cards"] is None
        assert "need staged=True" in ref["unstaged cuda"]
        assert "stages CUDA payloads" in ref["staged cpu"]
        assert "does not match the group" in ref["wrong index"]
        # dp=2 over the same world: rank = data index x pp + pipe index
        assert ref["dp 2"] == dict(
            axes={"data": 2, "model": 2}, dp=2, pipe=r % 2, data=r // 2,
            model_group=[r // 2 * 2, r // 2 * 2 + 1],
            data_group=[r % 2, r % 2 + 2])


# ---------------------------------------------------------------------------
# the tables' agreement
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _plans():
    uvit = dataclasses.replace(_cfg(tdm, "uvit"), use_flash=True,
                               use_skip_kernel=True)
    hun = dataclasses.replace(_cfg(tdm, "hunyuan"), use_flash=True,
                              use_skip_kernel=True)
    sv = tdm.SkipViTConfig("t", n_enc=3, n_mid=2, n_dec=3)
    ugraph = tdm.uvit_pipeline_graph(uvit, batch=2, hw=TPU)
    kw = dict(lam=0.0)
    return {
        "uvit-D4": auto_pipeline(ugraph, diffusion_model_fns(uvit), 4, TPU,
                                 pipeline_devices=4, microbatches=8, **kw),
        "uvit-D2-V2": auto_pipeline(ugraph, diffusion_model_fns(uvit), 2,
                                    TPU, pipeline_devices=2, interleave=2,
                                    microbatches=4, **kw),
        "uvit-D4-short": auto_pipeline(ugraph, diffusion_model_fns(uvit), 4,
                                       TPU, pipeline_devices=4,
                                       microbatches=3, **kw),
        "hunyuan-D4": auto_pipeline(
            tdm.hunyuan_pipeline_graph(hun, batch=2, hw=TPU),
            diffusion_model_fns(hun, "hunyuan"), 4, TPU, pipeline_devices=4,
            microbatches=4, **kw),
        "skipvit-asym-D2": auto_pipeline(
            tdm.skipvit_pipeline_graph(sv, fwd_times=[1, 1, 4, 0.5, 0.5,
                                                      0.5, 1, 1], hw=TPU),
            skipvit_model_fns(sv), 2, TPU, pipeline_devices=2,
            microbatches=4, **kw),
        "uvit-ilp-D2": auto_pipeline(ugraph, diffusion_model_fns(uvit), 2,
                                     TPU, pipeline_devices=2, microbatches=2,
                                     use_ilp=True, **kw),
        "linear-D2-V2": auto_pipeline(
            _linear_graph(torch_graph),
            _linear_fns(tdm, PipelineModelFns, None), 2, TPU,
            pipeline_devices=2, interleave=2, microbatches=4, **kw),
    }


@pytest.mark.parametrize("plan", ["uvit-D4", "uvit-D2-V2", "uvit-D4-short",
                                  "hunyuan-D4", "skipvit-asym-D2",
                                  "uvit-ilp-D2", "linear-D2-V2"])
def test_tables_agree_on_every_hop(plan):
    cp = _plans()[plan]
    tabs = cp.step_tables()
    check_ring_agreement(tabs)
    down, up = tabs.live_hops
    assert int(tabs.down_valid.sum()) == down
    assert int(tabs.up_valid.sum()) == up
    # a planted disagreement: one flagged send nobody stores, then one
    # stored arrival nobody sends
    d, t = (int(x) for x in np.argwhere(tabs.down_send)[0])
    send = tabs.down_send.copy()
    send[d, t] = False
    with pytest.raises(PlanError, match="send-recv-pairing") as e:
        check_ring_agreement(dataclasses.replace(tabs, down_send=send))
    assert e.value.check == "send-recv-pairing"
    valid = tabs.down_valid.copy()
    valid[(d + 1) % tabs.D, t + 1] = False
    with pytest.raises(PlanError, match="does not send|sends at"):
        check_ring_agreement(dataclasses.replace(tabs, down_valid=valid))
    last = tabs.down_send.copy()
    last[0, -1] = True
    with pytest.raises(PlanError):
        check_ring_agreement(dataclasses.replace(tabs, down_send=last))


# ---------------------------------------------------------------------------
# the trainer over ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def one_process_runs():
    out = {}
    for name, extra in (("clean", []), ("nan", ["--faults",
                                                f"nan@{NAN_STEP}"])):
        res = train.run(train._parse_args(TRAIN_ARGV + extra))
        out[name] = res
    return out


def test_trainer_over_ranks_matches_the_one_process_trainer(
        runs, one_process_runs):
    want = one_process_runs["clean"].losses
    for r, doc in enumerate(runs["trained"]["clean"]):
        got = {int(k): v for k, v in doc["losses"].items()}
        assert sorted(got) == list(range(5)), r
        for s in range(5):
            np.testing.assert_allclose(got[s], want[s], rtol=TRAINER_RTOL,
                                       err_msg=f"rank {r} step {s}")
        assert doc["skipped_steps"] == 0


def test_trainer_over_ranks_skips_a_nan_step_on_every_rank(
        runs, one_process_runs):
    ref = one_process_runs["nan"]
    assert ref.skipped_steps == 1
    for r, doc in enumerate(runs["trained"]["nan"]):
        got = {int(k): v for k, v in doc["losses"].items()}
        assert doc["skipped_steps"] == 1, r
        assert not np.isfinite(got[NAN_STEP]), r
        for s in range(5):
            if s != NAN_STEP:
                np.testing.assert_allclose(got[s], ref.losses[s],
                                           rtol=TRAINER_RTOL,
                                           err_msg=f"rank {r} step {s}")


@pytest.mark.parametrize("extra, env, match", [
    # hosts of ranks (ROADMAP A1) run: what stays refused is a world that
    # is not --num-hosts hosts of LOCAL_WORLD_SIZE ranks
    pytest.param(["--num-hosts", "2"], {}, "not --num-hosts 2 hosts",
                 id="extra0-env0-ROADMAP A1"),
    ([], {"WORLD_SIZE": "4"}, "ROADMAP A3"),
])
def test_trainer_refuses_what_ranks_do_not_do_yet(monkeypatch, extra, env,
                                                  match):
    """Refused before any process group is joined.  Data parallelism
    (ROADMAP A3) runs: what stays refused there is one process with
    ``--dp > 1`` and a world that is not ``--dp x --pp``."""
    if match == "ROADMAP A3":
        with pytest.raises(ValueError, match="data replicas as ranks") as e:
            train.run(train._parse_args(TRAIN_ARGV + ["--dp", "2"]))
        # --devices 2 over --dp 2 is a (2, 1) grid: the JAX trainer's rule
        assert "--nproc-per-node 2" in str(e.value)
        assert "--dp 2 --pp 1" in str(e.value)
    for k, v in {**dict(RANK="0", WORLD_SIZE="2", LOCAL_RANK="0",
                        MASTER_ADDR="localhost"), **env}.items():
        monkeypatch.setenv(k, v)
    if match == "ROADMAP A3":
        with pytest.raises(ValueError, match="the world is --dp x --pp = 2"):
            train.run(train._parse_args(TRAIN_ARGV + extra))
    else:
        with pytest.raises(ValueError, match=match):
            train.run(train._parse_args(TRAIN_ARGV + extra))
    world = int(env.get("WORLD_SIZE", 2))
    assert train.rank_env() == {"rank": 0, "world": world, "local_rank": 0,
                                "local_world": world}
    monkeypatch.setenv("WORLD_SIZE", "3")
    with pytest.raises(ValueError, match="cannot run a 2-device"):
        train.run(train._parse_args(TRAIN_ARGV))


if __name__ == "__main__" and sys.argv[1:2] == ["jax-executors"]:
    _jax_main(sys.argv[2])
elif __name__ == "__main__" and sys.argv[1:2] == ["ranks"]:
    _rank_main(sys.argv[2], sys.argv[3])
