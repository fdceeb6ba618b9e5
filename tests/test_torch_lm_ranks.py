"""The decoder LM over the port's rank executors: the seven LM
differentials of the JAX package's ``tests/helpers/auto_pipeline_equiv.py``
(``linear-even``, ``linear-uneven``, ``linear-interleaved``,
``linear-zero2``, ``wave-zero1``, ``wave-zero2``, ``wave-lm-uneven``),
each ``lm_model_fns`` through ``auto_pipeline(...).for_rank(pipe,
data).build(ring, data)``, held to JAX's single-device ``lm_loss`` and
``jax.grad`` on the same params at the helper's own bar (fp32, rtol 1e-4,
atol 1e-6).

The configs keep the helper's model (a tied-embedding LM of 8 layers,
d_model 32, GQA 4/2), batch (8 x 16 tokens, M = 4), ``fwd_times``,
``pipeline_devices``, ``zero_stage``, ``interleave`` and ``force_wave``,
the fp32 wire and ``lam=0``.  They run in one world of four gloo
processes (``python tests/test_torch_lm_ranks.py ranks JAX OUT``): the
P = 2 configs at the helper's dp = 2 on the ``(data=2, model=2)`` grid,
the P = 4 ones (``linear-even``, ``linear-uneven``) at dp = 1, the four
processes being their pipeline (the helper's dp = 2 there would take
eight).  The two P = 4 configs also run the closed-form linear walk over
the ranks, as the helper compares its closed forms on them.  The JAX
params, tokens, loss and gradients come from one single-device
``value_and_grad`` in the test process: every config shares them.
"""
import datetime
import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.convert import params_from_jax
from repro_torch.models import lm as tlm
from repro_torch.models.layers import AttnConfig
from repro_torch.runtime.adapters import lm_model_fns
from repro_torch.runtime.compile import auto_pipeline
from repro_torch.tree import tree_map, tree_paths

REPO = pathlib.Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-4, 1e-6          # tests/helpers/auto_pipeline_equiv.py's
WORLD = 4
B, S, M = 8, 16, 4
LM_KW = dict(name="t", vocab=64, d_model=32, n_layers=8, d_ff=64,
             tied_embeddings=True)
UNEVEN = [4, 1, 1, 1, 1, 1, 1, 4]
# name -> (fwd_times, pipeline_devices, dp, zero_stage, interleave,
#          force_wave, executor, uneven): the helper's configs, and whether
#          it expects uneven stage counts
CASES = {
    "linear-even": (None, 4, 1, None, None, None, "table", False),
    "linear-uneven": (UNEVEN, 4, 1, None, None, None, "table", True),
    "linear-interleaved": (UNEVEN, 2, 2, None, 2, None, "table", True),
    "linear-zero2": (UNEVEN, 2, 2, 2, None, None, "table", False),
    "wave-zero1": (UNEVEN, 2, 2, 1, None, True, "table", True),
    "wave-zero2": (UNEVEN, 2, 2, 2, None, True, "table", True),
    "wave-lm-uneven": (UNEVEN, 2, 2, None, None, True, "table", True),
    "linear-even closed-form": (None, 4, 1, None, None, None,
                                "closed_form", False),
    "linear-uneven closed-form": (UNEVEN, 4, 1, None, None, None,
                                  "closed_form", True),
}


def _cfg():
    return tlm.LMConfig(attn=AttnConfig(32, 4, 2, 8), **LM_KW)


def _plan(name, dp=None):
    """The port's plan of config ``name`` (at ``dp`` replicas, default
    the config's)."""
    times, P, dpc, zero, V, wave, executor, _ = CASES[name]
    dp = dpc if dp is None else dp
    cfg = _cfg()
    return auto_pipeline(tlm.lm_pipeline_graph(cfg, fwd_times=times),
                         lm_model_fns(cfg), P * dp, pipeline_devices=P,
                         microbatches=M, lam=0.0, dp_size=dp,
                         force_wave=wave, interleave=V,
                         wire_dtype="float32",
                         zero_stage=zero if dp > 1 else None,
                         executor=executor)


def _flatten(tree, prefix=""):
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
# the JAX reference, in the test process
# ---------------------------------------------------------------------------

def _jax_reference(path):
    """JAX's params (``init_fn(PRNGKey(0))``), the helper's tokens and the
    single-device loss and gradients, saved to ``path``."""
    import jax
    import jax.numpy as jnp

    from repro.models.layers import AttnConfig as JaxAttn
    from repro.models.lm import LMConfig as JaxLM
    from repro.models.lm import lm_loss
    from repro.runtime.adapters import lm_model_fns as jax_lm_model_fns

    key = jax.random.PRNGKey(0)
    cfg = JaxLM(attn=JaxAttn(32, 4, 2, 8), **LM_KW)
    params = jax_lm_model_fns(cfg).init_fn(key)
    tokens = jax.random.randint(key, (B, S), 0, 64).reshape(M, B // M, S)

    def ref(p):
        return jnp.mean(jnp.asarray(
            [lm_loss(p, {"tokens": tokens[m]}, cfg) for m in range(M)]))

    loss, grads = jax.jit(jax.value_and_grad(ref))(params)
    out = {f"params|{k}": v for k, v in
           _flatten(jax.device_get(params)).items()}
    out.update({f"grads|{k}": v for k, v in
                _flatten(jax.device_get(grads)).items()})
    out["tokens"] = np.asarray(tokens)
    out["loss"] = np.asarray(float(loss))
    np.savez(path, **out)


# ---------------------------------------------------------------------------
# the rank world
# ---------------------------------------------------------------------------

def _rank_main(jax_path, out_dir):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_rank_grid
    from repro_torch.runtime.ring import DataGroup, Ring

    torch.set_num_threads(1)
    rank = int(os.environ["RANK"])
    dist.init_process_group("gloo", rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=120))
    grids = {1: make_rank_grid(4), 2: make_rank_grid(2, dp=2)}
    with np.load(jax_path) as z:
        res = {k: z[k] for k in z.files}
    params = params_from_jax(_unflatten(
        {k[7:]: v for k, v in res.items() if k.startswith("params|")}),
        "cpu")
    mbs = {"tokens": torch.from_numpy(res["tokens"])}
    out, doc = {}, {"ring": {}, "data": {}}
    for name, (_, P, dp, *_rest) in CASES.items():
        g = grids[dp]
        ring = Ring(g.model_group, g.pipe_index, P, "cpu")
        data = (DataGroup(g.data_group, g.data_index, dp, "cpu")
                if dp > 1 else None)
        cp = _plan(name).for_rank(g.pipe_index, g.data_index)
        p = tree_map(lambda x: x.detach().clone().requires_grad_(True),
                     cp.split_params(params))
        fn = cp.build(ring, data)
        stacks, edge = p          # folded: (enc, dec); linear: one
        loss = (fn(*stacks, edge, mbs, {}) if cp.folded
                else fn(stacks[0], edge, mbs))
        out[f"{name}|loss"] = np.asarray(float(loss))
        for k, v in _flatten(tree_map(lambda x: x.grad.numpy(), p)).items():
            out[f"{name}|grads|{k}"] = v
        doc["ring"][name] = ring.bytes
        doc["data"][name] = dict(data.bytes) if data else None
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
    base = tmp_path_factory.mktemp("lm_ranks")
    jax_path = base / "jax.npz"
    _jax_reference(jax_path)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO / "src")] + [p for p in os.environ.get(
            "PYTHONPATH", "").split(os.pathsep) if p]),
        OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="",
        WORLD_SIZE=str(WORLD), MASTER_ADDR="localhost",
        MASTER_PORT=str(_free_port()))
    procs = [subprocess.Popen(
        [sys.executable, __file__, "ranks", str(jax_path), str(base)],
        env=dict(env, RANK=str(r)), cwd=str(REPO), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    for r, p in enumerate(procs):
        out, _ = p.communicate(timeout=600)
        assert p.returncode == 0, f"rank {r}:\n{out[-4000:]}"
    with np.load(jax_path) as z:
        jax_res = {k: z[k] for k in z.files}
    ranks, docs = {}, {}
    for r in range(WORLD):
        with np.load(base / f"rank{r}.npz") as z:
            ranks[r] = {k: z[k] for k in z.files}
        docs[r] = json.loads((base / f"rank{r}.json").read_text())
    return dict(jax=jax_res, ranks=ranks, docs=docs)


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------

def _merged(runs, name):
    """The ranks' loss and their gradients gathered back whole through
    the one-replica plan's ``merge_params``: per pipeline index the data
    replicas' stage gradients (equal where whole; a ZeRO-1 sharded leaf's
    summed, each replica's shard and zeros elsewhere; a ZeRO-2 leaf's
    shards concatenated along its dim), stacked over the pipeline
    indices; the edge gradients (bitwise equal on every rank) from rank
    0."""
    _, P, dp, zero, *_ = CASES[name]
    where = {(pipe, di): di * P + pipe for di in range(dp)
             for pipe in range(P)}
    pre = f"{name}|grads|"
    per = {k: {g[len(pre):]: v for g, v in runs["ranks"][r].items()
               if g.startswith(pre)} for k, r in where.items()}
    losses = {float(runs["ranks"][r][f"{name}|loss"]) for r in where.values()}
    assert len(losses) == 1, (name, losses)
    dims = _plan(name).zero_dims()
    flat_dims = ({} if dims is None else
                 {f"0/{i}/{k}": d for i, ds in enumerate(dims)
                  for k, d in _flatten(ds).items()})
    edge = {k: v for k, v in per[(0, 0)].items() if k.startswith("1/")}
    for k in where:
        for e, v in edge.items():
            np.testing.assert_array_equal(per[k][e], v, err_msg=(name, e))
    stage = {}
    for leaf in per[(0, 0)]:
        if not leaf.startswith("0/"):
            continue
        rows = []
        for pipe in range(P):
            gs = [per[(pipe, di)][leaf] for di in range(dp)]
            d = int(flat_dims.get(leaf, -1))
            if d >= 0 and zero == 2:
                rows.append(np.concatenate(gs, d + 1))
            elif d >= 0:
                rows.append(sum(gs))
            else:
                for g in gs[1:]:
                    np.testing.assert_array_equal(g, gs[0], err_msg=leaf)
                rows.append(gs[0])
        stage[leaf[2:]] = torch.from_numpy(np.stack(rows))
    stacks = _unflatten(stage)
    one = _plan(name, dp=1)
    merged = one.merge_params(
        tuple(stacks[str(i)] for i in range(len(stacks))),
        _unflatten({k[2:]: torch.from_numpy(v) for k, v in edge.items()}))
    return losses.pop(), {k: v.numpy() for k, v in tree_paths(merged)}


@pytest.mark.parametrize("name", list(CASES))
def test_lm_over_ranks_matches_jax_lm_loss(runs, name):
    loss, grads = _merged(runs, name)
    np.testing.assert_allclose(loss, float(runs["jax"]["loss"]), rtol=RTOL,
                               err_msg=name)
    want = {k[len("grads|"):]: v for k, v in runs["jax"].items()
            if k.startswith("grads|")}
    assert sorted(grads) == sorted(want), name
    for k, v in grads.items():
        np.testing.assert_allclose(v, want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=f"{name}: {k}")


@pytest.mark.parametrize("name", list(CASES))
def test_lm_plans_keep_the_helpers_shape(name):
    """Each plan is the helper's: linear S = VD or folded S = 2VD, even or
    uneven as the helper asserts, and the ZeRO stage asked for."""
    _, P, dp, zero, V, wave, _, uneven = CASES[name]
    cp = _plan(name)
    V = V or 1
    assert cp.folded == bool(wave)
    assert cp.partition.num_stages == (2 if wave else 1) * V * P
    assert cp.layout.V == V
    assert (len(set(cp.layout.counts)) > 1) == uneven, cp.layout.counts
    assert cp.pcfg.zero_stage == (zero or 0)
    if zero == 2:
        assert any(d >= 0 for d in _flatten(cp.zero_dims()).values())


def test_tied_embeddings_gradient_is_reduced_over_the_ring(runs):
    """The tied embedding is read by the first stage (embedding) and the
    last (readout), which sit on different ranks of a linear plan: every
    rank ends with the sum of both, the JAX gradient."""
    name = "linear-uneven"
    want = runs["jax"]["grads|embed"]
    for r in range(WORLD):
        got = runs["ranks"][r][f"{name}|grads|1/embed"]
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_lm_ring_and_data_bytes_move(runs):
    """Every rank of every config sent and received on its ring, and the
    data replicas of the dp = 2 configs all-reduced their loss and edge
    gradients at least (ZeRO-2 also gathers and scatters its rows)."""
    for r in range(WORLD):
        doc = runs["docs"][r]
        for name, (_, P, dp, zero, *_) in CASES.items():
            ring = doc["ring"][name]
            assert ring["fwd"]["sent"] + ring["fwd"]["received"] > 0, name
            assert ring["fwd"] == {"sent": ring["bwd"]["received"],
                                   "received": ring["bwd"]["sent"]}, name
            data = doc["data"][name]
            if dp == 1:
                assert data is None
                continue
            assert data["all_reduce"] > 0, name
            assert (data["all_gather"] > 0) == (zero == 2), (name, data)


if __name__ == "__main__":
    if sys.argv[1] == "ranks":
        _rank_main(sys.argv[2], sys.argv[3])
