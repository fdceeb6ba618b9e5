"""The closed-form executors over ranks -- the wave (PULSE's fold) and the
linear 1F1B walk, one process per pipeline device -- held to the port's
one-process closed forms, which ``test_torch_closed_form.py`` holds to the
JAX package's, and the wave's cases also straight to the JAX package's
single-device UViT: the mean over the microbatches of ``uvit_apply``'s
squared error to the noise, its loss and ``jax.grad`` on the same params
and draws, at fp32 rtol 1e-4 (atol 1e-6), the bar of
``test_torch_closed_form.py``.

One world of four gloo processes (``python
tests/test_torch_closed_form_ranks.py ranks OUT``, torch on one thread)
runs every case of :data:`CASES` from the same seed-0 params and seeded
microbatches as the one-process run in the test process: the wave on a
small UViT at D = 4 (overlapped hops and the synchronous reference) and at
D = 2 (ranks 0-1), the linear walk on a small tied-embedding LM at D = 4,
and both at dp = 2 under ZeRO-1 on the ``(data=2, model=2)`` grid.  Held
at rtol 1e-6 (atol 1e-7, the bar of ``test_torch_ranks.py``): the loss
and every gradient, gathered back whole (edge gradients bitwise equal on
every rank); the ring bytes, forward and backward, against the
one-process walk's ``HOP_BYTES`` live count; the refusals that stay
(``M < D``, V > 1, ZeRO-2 with data replicas).
"""
import dataclasses
import datetime
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

from repro_torch.models import diffusion as tdm
from repro_torch.models import lm as tlm
from repro_torch.models.layers import AttnConfig
from repro_torch.runtime import pipeline as tpipe
from repro_torch.runtime.adapters import (diffusion_model_fns, lm_model_fns,
                                          make_diffusion_microbatches)
from repro_torch.runtime.compile import auto_pipeline
from repro_torch.tree import tree_map, tree_paths

REPO = pathlib.Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-6, 1e-7     # test_torch_ranks.py's bar against one process
JAX_RTOL, JAX_ATOL = 1e-4, 1e-6   # test_torch_closed_form.py's against JAX
WORLD = 4
UVIT = tdm.UViTConfig("t", img_size=8, in_ch=4, patch=2, d_model=32,
                      n_layers=8, n_heads=4, d_ff=64, n_classes=10)
LM = tlm.LMConfig(name="t", vocab=64, d_model=32, n_layers=8,
                  attn=AttnConfig(32, 4, 2, 8), d_ff=64,
                  tied_embeddings=True)
M = 4
# name -> (model, D, dp, ZeRO stage, overlap)
CASES = {
    "wave-uvit-d4": ("uvit", 4, 1, 0, True),
    "wave-uvit-d4-sync": ("uvit", 4, 1, 0, False),
    "wave-uvit-d2": ("uvit", 2, 1, 0, True),
    "linear-lm-d4": ("lm", 4, 1, 0, True),
    "wave-uvit-d2-dp2-z1": ("uvit", 2, 2, 1, True),
    "linear-lm-d2-dp2-z1": ("lm", 2, 2, 1, True),
}
# refusals over ranks: name -> (model, D, dp, ZeRO, auto_pipeline keywords)
REFUSALS = {
    "wave M < D": ("uvit", 4, 1, 0, {"microbatches": 3}),
    "wave V > 1": ("uvit", 2, 2, 0, {"interleave": 2}),
    "wave ZeRO-2 dp 2": ("uvit", 2, 2, 2, {}),
    "linear ZeRO-2 dp 2": ("lm", 2, 2, 2, {}),
}


def _plan(model, D, dp, zero, overlap=True, **kw):
    """The closed-form plan of a case (``lam=0``: cuts from the graph's
    costs alone), at ``dp`` replicas."""
    if model == "uvit":
        graph = tdm.uvit_pipeline_graph(UVIT, batch=2)
        fns = diffusion_model_fns(UVIT, "uvit")
    else:
        graph = tlm.lm_pipeline_graph(LM, batch=2, seq=16)
        fns = lm_model_fns(LM)
    cp = auto_pipeline(graph, fns, D * dp, pipeline_devices=D,
                       microbatches=kw.pop("microbatches", M), lam=0.0,
                       dp_size=dp, zero_stage=zero, executor="closed_form",
                       **kw)
    if not overlap:
        cp = dataclasses.replace(
            cp, pcfg=dataclasses.replace(cp.pcfg, overlap=False))
    return cp


def _inputs(model, dp):
    """Seed-0 params and the microbatches of a case (each microbatch two
    samples a data replica), the same in every process."""
    rng = np.random.default_rng(7)
    B = 2 * M * dp
    if model == "lm":
        params = tlm.init_lm(torch.Generator().manual_seed(0), LM, "cpu")
        tok = torch.from_numpy(rng.integers(0, LM.vocab, (B, 16)))
        return params, {"tokens": tok.reshape(M, B // M, 16)}, None
    params = tdm.init_uvit(torch.Generator().manual_seed(0), UVIT, "cpu")
    batch = {"latents": torch.from_numpy(
                 rng.standard_normal((B, 8, 8, 4)).astype(np.float32)),
             "labels": torch.from_numpy(rng.integers(0, 10, (B,)))}
    t = torch.from_numpy(rng.uniform(size=(B,)).astype(np.float32))
    noise = torch.from_numpy(
        rng.standard_normal((B, 8, 8, 4)).astype(np.float32))
    mb, aux = make_diffusion_microbatches(batch, M, UVIT, "uvit", t=t,
                                          noise=noise)
    return params, mb, aux


def _run(cp, model, p, mb, aux, ring=None, data=None):
    fn = cp.build(ring, data)
    stacks, edge = p
    if model == "lm":
        return fn(stacks[0], edge, mb)
    return fn(*stacks, edge, mb, aux)


def _leaves(params):
    return tree_map(lambda x: x.detach().clone().requires_grad_(True),
                    params)


def _flat(tree):
    return {k: v.detach().numpy() for k, v in tree_paths(tree)}


# ---------------------------------------------------------------------------
# the rank world
# ---------------------------------------------------------------------------

def _rank_main(out_dir):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_rank_grid
    from repro_torch.runtime.ring import DataGroup, Ring

    torch.set_num_threads(1)
    rank = int(os.environ["RANK"])
    dist.init_process_group("gloo", rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=120))
    grid4 = make_rank_grid(4)
    grid22 = make_rank_grid(2, dp=2)
    pair = dist.new_group([0, 1])
    out, doc = {}, {"ring": {}, "refusals": {}}
    for name, (model, D, dp, zero, overlap) in CASES.items():
        if dp > 1:
            ring = Ring(grid22.model_group, grid22.pipe_index, D, "cpu")
            data = DataGroup(grid22.data_group, grid22.data_index, dp, "cpu")
            pipe, di = grid22.pipe_index, grid22.data_index
        elif D == 4:
            ring, data, pipe, di = Ring(grid4.model_group, rank, 4,
                                        "cpu"), None, rank, 0
        elif rank < D:
            ring, data, pipe, di = Ring(pair, rank, D, "cpu"), None, rank, 0
        else:
            continue
        cp = _plan(model, D, dp, zero, overlap).for_rank(pipe, di)
        params, mb, aux = _inputs(model, dp)
        p = _leaves(cp.split_params(params))
        loss = _run(cp, model, p, mb, aux, ring, data)
        out[f"{name}|loss"] = np.asarray(float(loss))
        for k, v in _flat(tree_map(lambda x: x.grad, p)).items():
            out[f"{name}|grads|{k}"] = v
        doc["ring"][name] = ring.bytes
    for what, (model, D, dp, zero, kw) in REFUSALS.items():
        g = grid22 if dp > 1 else grid4
        ring = Ring(g.model_group, g.pipe_index, D, "cpu")
        data = (DataGroup(g.data_group, g.data_index, dp, "cpu")
                if dp > 1 else None)
        try:
            cp = _plan(model, D, dp, zero, **kw)
            cp.for_rank(g.pipe_index, g.data_index).build(ring, data)
        except ValueError as e:
            doc["refusals"][what] = str(e)
        else:
            doc["refusals"][what] = None
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(doc, f)
    dist.barrier()
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("closed_form_ranks")
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO / "src")] + [p for p in os.environ.get(
            "PYTHONPATH", "").split(os.pathsep) if p]),
        OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="",
        WORLD_SIZE=str(WORLD), MASTER_ADDR="localhost", MASTER_PORT=port)
    procs = [subprocess.Popen(
        [sys.executable, __file__, "ranks", str(base)],
        env=dict(env, RANK=str(r)), cwd=str(REPO), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    for r, p in enumerate(procs):
        out, _ = p.communicate(timeout=600)
        assert p.returncode == 0, f"rank {r}:\n{out[-4000:]}"
    res, docs = {}, {}
    for r in range(WORLD):
        with np.load(base / f"rank{r}.npz") as z:
            res[r] = {k: z[k] for k in z.files}
        docs[r] = json.loads((base / f"rank{r}.json").read_text())
    return dict(res=res, docs=docs)


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------

def _ranks_of(name):
    """``{(pipe, data): world rank}`` of a case (the grid's row-major
    order)."""
    _, D, dp, _, _ = CASES[name]
    return {(pipe, di): di * D + pipe for di in range(dp)
            for pipe in range(D)}


def _merged(runs, name):
    """The ranks' loss (the same on every rank) and their gradients
    gathered back whole: per pipeline index the data replicas' stage
    gradients (at ZeRO-1 a sharded leaf's are each replica's shard and
    zeros elsewhere: summed), stacked over the pipeline indices; the edge
    gradients, bitwise equal on every rank, from rank 0."""
    model, D, dp, zero, _ = CASES[name]
    where = _ranks_of(name)
    per = {k: {g[len(f"{name}|grads|"):]: v
               for g, v in runs["res"][r].items()
               if g.startswith(f"{name}|grads|")}
           for k, r in where.items()}
    losses = {float(runs["res"][r][f"{name}|loss"]) for r in where.values()}
    assert len(losses) == 1, (name, losses)
    one = _plan(model, D, 1, 0)
    dims = _plan(model, D, dp, zero).zero_dims()
    flat_dims = ({} if dims is None else
                 {f"0/{i}/{k}": d for i, ds in enumerate(dims)
                  for k, d in tree_paths(ds)})
    edge = {k: v for k, v in per[(0, 0)].items() if k.startswith("1/")}
    for k in where:
        for e, v in edge.items():
            np.testing.assert_array_equal(per[k][e], v, err_msg=e)
    stage = {}
    for leaf in per[(0, 0)]:
        if not leaf.startswith("0/"):
            continue
        rows = []
        for pipe in range(D):
            gs = [per[(pipe, di)][leaf] for di in range(dp)]
            if flat_dims.get(leaf, -1) >= 0:
                rows.append(sum(gs))
            else:
                for g in gs[1:]:
                    np.testing.assert_array_equal(g, gs[0], err_msg=leaf)
                rows.append(gs[0])
        stage[leaf] = torch.from_numpy(np.stack(rows))
    n_stacks = len({k.split("/")[1] for k in stage})
    stacks = tuple(_unflatten({k[len(f"0/{i}/"):]: v
                               for k, v in stage.items()
                               if k.startswith(f"0/{i}/")})
                   for i in range(n_stacks))
    edge_t = _unflatten({k[2:]: torch.from_numpy(v) for k, v in edge.items()})
    return losses.pop(), _flat(one.merge_params(stacks, edge_t))


def _unflatten(flat):
    out: dict = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


@functools.lru_cache(maxsize=None)
def _one_process(name):
    """The port's one-process closed form on the whole batch: loss,
    gradients and the walk's ``HOP_BYTES`` live count."""
    model, D, dp, _, _ = CASES[name]
    cp = _plan(model, D, 1, 0)
    params, mb, aux = _inputs(model, dp)
    p = _leaves(cp.split_params(params))
    tpipe.reset_hop_bytes()
    loss = _run(cp, model, p, mb, aux)
    live = tpipe.hop_bytes()["live"]
    loss.backward()
    grads = tree_map(lambda x: (x.grad if x.grad is not None
                                else torch.zeros_like(x)), p)
    return float(loss.detach()), _flat(cp.merge_params(*grads)), live


@pytest.mark.parametrize("name", list(CASES))
def test_closed_form_over_ranks_matches_one_process(runs, name):
    loss, grads = _merged(runs, name)
    want_loss, want, _ = _one_process(name)
    np.testing.assert_allclose(loss, want_loss, rtol=RTOL, err_msg=name)
    assert sorted(grads) == sorted(want), name
    for k, v in grads.items():
        # fp32 sums in another order: the walk back-propagates step by
        # step, and the data replicas' halves are summed after
        np.testing.assert_allclose(v, want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=f"{name}: {k}")


@functools.lru_cache(maxsize=None)
def _jax_uvit(dp):
    """JAX's single-device UViT on a case's params and draws: the mean over
    the microbatches of ``uvit_apply``'s squared error to the noise, and
    ``jax.grad`` of it, by path."""
    import jax
    import jax.numpy as jnp

    from repro.models import diffusion as jdm

    cfg = jdm.UViTConfig("t", **{f.name: getattr(UVIT, f.name) for f in
                                 dataclasses.fields(jdm.UViTConfig)
                                 if f.name not in ("name", "dtype",
                                                   "param_dtype",
                                                   "use_skip_kernel")})
    params, mb, aux = tree_map(lambda x: x.detach().numpy(),
                               _inputs("uvit", dp))

    def loss_fn(p):
        return jnp.mean(jnp.stack([jnp.mean(jnp.square(
            jdm.uvit_apply(p, mb["xt"][m], aux["t"][m],
                           {"labels": mb["labels"][m]}, cfg)
            - mb["noise"][m])) for m in range(M)]))

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    grads = tree_map(torch.from_numpy, jax.tree_util.tree_map(
        np.array, jax.device_get(grads)))
    return float(loss), _flat(grads)


@pytest.mark.parametrize("name", [n for n, c in CASES.items()
                                  if c[0] == "uvit"])
def test_closed_form_wave_over_ranks_matches_jax(runs, name):
    """The wave over ranks -- its skip stashes kept on their ranks, the
    turnaround on the last, the data replicas' gradients averaged -- against
    the JAX package's UViT on one device."""
    loss, grads = _merged(runs, name)
    want_loss, want = _jax_uvit(CASES[name][2])
    np.testing.assert_allclose(loss, want_loss, rtol=JAX_RTOL, err_msg=name)
    assert sorted(grads) == sorted(want), name
    for k, v in grads.items():
        np.testing.assert_allclose(v, want[k], rtol=JAX_RTOL, atol=JAX_ATOL,
                                   err_msg=f"{name}: {k}")


@pytest.mark.parametrize("name", list(CASES))
def test_closed_form_ring_bytes_are_the_live_hops(runs, name):
    """Each replica's ring moves, forward and back, what the one-process
    walk hands its hops live, in the replica's share of the batch: the
    stash never crosses the ring."""
    _, D, dp, _, _ = CASES[name]
    _, _, live = _one_process(name)
    for di in range(dp):
        ranks = [r for (pipe, d), r in _ranks_of(name).items() if d == di]
        for p in ("fwd", "bwd"):
            for k in ("sent", "received"):
                got = sum(runs["docs"][r]["ring"][name][p][k] for r in ranks)
                assert got * dp == live, (name, di, p, k, got, live)


def test_overlapped_and_synchronous_hops_are_bitwise_equal(runs):
    a, b = "wave-uvit-d4", "wave-uvit-d4-sync"
    for r in range(WORLD):
        res = runs["res"][r]
        for k, v in res.items():
            if k.startswith(f"{a}|"):
                np.testing.assert_array_equal(
                    res[k.replace(f"{a}|", f"{b}|", 1)], v, err_msg=k)


@pytest.mark.parametrize("what,match", [
    ("wave M < D", "requires M >= D"),
    ("wave V > 1", "interleaves V=2"),
    ("wave ZeRO-2 dp 2", "zero_stage=2"),
    ("linear ZeRO-2 dp 2", "zero_stage=2")])
def test_closed_form_refusals_over_ranks(runs, what, match):
    for r in range(WORLD):
        got = runs["docs"][r]["refusals"][what]
        assert got is not None and match in got, (r, got)


def test_the_makers_refuse_what_a_plan_would():
    """The makers themselves refuse ZeRO-2 over data replicas and a ring
    of another size, before any message."""
    class FakeRing:
        index, size = 0, 2
    cfg = tpipe.PipelineConfig(2, 4, dp_size=2, zero_stage=2)
    kw = dict(embed_fn=None, stage_fn=None, loss_fn=None)
    with pytest.raises(ValueError, match="zero_stage=2"):
        tpipe.make_linear_pipeline(cfg, ring=FakeRing(), **kw)
    with pytest.raises(ValueError, match="2-rank ring"):
        tpipe.make_linear_pipeline(tpipe.PipelineConfig(3, 4),
                                   ring=FakeRing(), **kw)
    with pytest.raises(ValueError, match="dp_size=2"):
        tpipe.make_linear_pipeline(cfg, **kw)


if __name__ == "__main__":
    if sys.argv[1] == "ranks":
        _rank_main(sys.argv[2])
