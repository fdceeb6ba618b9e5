"""Checkpoints over ranks -- every rank of a ``torchrun`` world writes its
share of one JAX-format checkpoint, and a resume on the same plan or
another restores into each rank only what it holds -- held to the JAX
package's trainer, reader and drills (``tests/helpers/resilience_drill.py``'s
``shrink`` and ``vchange``, over ranks).

Processes, started by one module fixture, all on the CPU over gloo, fp32
wire, the JAX drill's flags (M=2, global batch 4, 6 steps, a save every 2,
lr 1e-3):

- one JAX subprocess on four forced host devices: the JAX trainer's two
  uninterrupted runs, UViT at P=2 dp=2 ZeRO-2 and SkipViT at V=2 P=2
  dp=2 ZeRO-0, their losses and final model-space params;
- beside it, four chains of ``torchrun`` worlds of the port's trainer
  (``python tests/test_torch_rank_checkpoint.py trainer SPEC``), from the
  JAX trainer's initial params and DDPM draws:
  ``shrink``: P=2 dp=2 ZeRO-2 ``stop@4`` (leaf pieces sent in 16 KiB
  messages), a resume onto P=1 dp=2 ZeRO-0 over two ranks, a corrupted
  step 6, a resume on the first plan; ``vchange``: SkipViT V=2 ZeRO-0
  ``stop@4``, a resume onto V=1 ZeRO-2; ``faults``: P=2 over two ranks,
  ``iofail@4:4`` on rank 1 alone and ``kill@5`` on both, then a resume;
  ``across``: a one-process checkpoint (written here, by the one-process
  manager, with random AdamW moments) resumed as ranks at ZeRO-1 and at
  ZeRO-2.

Held: losses at rtol 1e-4 and final params (read from the last
checkpoint through ``state_to_logical``) at rtol 1e-4 against JAX; what
each rank held at the save, and what each resumed rank holds, against
the checkpoint's leaves bitwise, cut by ``split_params`` and
``optimizer_view``; the members against the one-process writer's bytes;
the JAX package's ``verify_step`` and ``restore_training_state`` on a
rank world's checkpoint; the bytes each rank reads.
"""
import json
import os
import pathlib
import subprocess
import sys
import threading
import time
import warnings
import zipfile

import numpy as np
import pytest
import torch

# the ranks run this file: JAX and the JAX package are imported where they
# are used, in this process and in the JAX subprocess, never in a rank
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    read_manifest, restore_checkpoint,
                                    save_checkpoint, verify_step)
from repro_torch.checkpoint import store
from repro_torch.core.hw import H100_SXM
from repro_torch.launch import train
from repro_torch.models.diffusion import (skipvit_pipeline_graph,
                                          uvit_pipeline_graph)
from repro_torch.runtime.adapters import model_fns
from repro_torch.runtime.compile import auto_pipeline
from repro_torch.runtime.resilience import (block_homes, corrupt_checkpoint,
                                            rank_rows_sources,
                                            state_to_logical)
from repro_torch.tree import tree_flatten, tree_map

REPO = pathlib.Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-4, 1e-6            # the JAX drill's
STEPS, BATCH = 6, 4
BASE = ["--pipeline", "--microbatches", "2", "--global-batch", str(BATCH),
        "--steps", str(STEPS), "--ckpt-every", "2", "--log-every", "2",
        "--lr", "1e-3", "--wire-dtype", "float32"]
JAX_BASE = BASE + ["--devices", "4", "--dp", "2"]
# the JAX drill's plans, and the ranks' dp (the port's --dp defaults to 1)
PLAN_A = ["--arch", "uvit", "--pp", "2", "--zero-stage", "2"]
PLAN_P1 = ["--arch", "uvit", "--pp", "1", "--zero-stage", "0"]
VPLAN_A = ["--arch", "skipvit", "--pp", "2", "--interleave", "2",
           "--zero-stage", "0"]
VPLAN_B = ["--arch", "skipvit", "--pp", "2", "--interleave", "1",
           "--zero-stage", "2"]
DP2 = ["--dp", "2"]
# the fault drills' plan: P=2, one replica (two ranks)
FPLAN = ["--arch", "uvit", "--pp", "2"]
CHUNK = 16 << 10                   # the shrink save's message size
CFG = {"uvit": dict(img_size=8, in_ch=4, patch=2, d_model=64, n_layers=8,
                    n_heads=4, d_ff=128, n_classes=10),
       "skipvit": dict(img_size=8, in_ch=4, patch=2, d_model=64, n_heads=4,
                       d_ff=128, n_classes=10, n_enc=4, n_mid=2, n_dec=4)}
TIMEOUT = 400


def _flatten(tree, prefix=""):
    """Nested dicts / tuples of arrays -> {"a/b/c": numpy array}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        x = tree.detach().numpy() if isinstance(tree, torch.Tensor) \
            else np.asarray(tree)
        return {prefix: x}
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


def _bits(x) -> bytes:
    if isinstance(x, torch.Tensor):
        return x.detach().contiguous().reshape(-1).view(torch.uint8) \
            .numpy().tobytes()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


# ---------------------------------------------------------------------------
# the processes
# ---------------------------------------------------------------------------

def _inputs(path):
    """The JAX trainer's initial params of both models and each step's
    DDPM draws (``fold_in(PRNGKey(0), step)``: a uniform t and a normal
    noise over the global batch)."""
    import jax
    import jax.numpy as jnp

    from repro.models import diffusion as jdm
    KEY = jax.random.PRNGKey(0)
    out = {}
    for arch, init, cls in (("uvit", jdm.init_uvit, jdm.UViTConfig),
                            ("skipvit", jdm.init_skipvit, jdm.SkipViTConfig)):
        params = jax.device_get(init(KEY, cls(f"{arch}-pp", **CFG[arch])))
        out.update({f"{arch}|{k}": v for k, v in _flatten(params).items()})
    for step in range(STEPS):
        rt, rn = jax.random.split(jax.random.fold_in(KEY, step))
        out[f"t|{step}"] = np.asarray(jax.random.uniform(rt, (BATCH,)))
        out[f"noise|{step}"] = np.asarray(
            jax.random.normal(rn, (BATCH, 8, 8, 4), jnp.float32))
    np.savez(path, **out)


def _jax_main(out):
    """The JAX trainer's uninterrupted runs of both drills' first plans,
    in two threads (each run's compile is most of its time)."""
    from repro.launch.train import _parse_args, run
    got = {}

    def one(arch, plan):
        got[arch] = run(_parse_args(JAX_BASE + plan))

    threads = [threading.Thread(target=one, args=a)
               for a in (("uvit", PLAN_A), ("skipvit", VPLAN_A))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    res = {}
    for arch, r in got.items():
        res[f"{arch}|losses"] = np.array([r.losses[s] for s in range(STEPS)])
        res.update({f"{arch}|final|{k}": v for k, v in
                    _flatten(r.logical_params).items()})
    np.savez(out, **res)


def _trainer_main(spec_path):
    """One rank of a port world: ``train.run`` with the spec's argv (and
    its faults for this rank), from the JAX params when ``init``, with the
    JAX draws; dumps the restored state (``dump_restored``) and the state
    at the end (``dump_final``), leaf by leaf in checkpoint order."""
    from repro_torch.runtime import ring
    torch.set_num_threads(1)
    spec = json.loads(pathlib.Path(spec_path).read_text())
    rank = int(os.environ["RANK"])
    out = pathlib.Path(spec["out"])
    if spec.get("chunk"):
        ring.CHUNK_BYTES = spec["chunk"]
    faults = spec.get("faults", {})
    faults = faults.get(str(rank), faults.get("*"))
    args = train._parse_args(
        spec["argv"] + (["--faults", faults] if faults else [])
        + ["--device", "cpu", "--out-json", str(out / "r{rank}.json")])
    with np.load(spec["inputs"]) as z:
        res = {k: z[k] for k in z.files}
    pre = f"{spec['arch']}|"
    params = _unflatten({k[len(pre):]: v for k, v in res.items()
                         if k.startswith(pre)}) if spec.get("init") else None

    def dump(name, state):
        np.savez(out / f"{name}{rank}.npz", **{
            str(i): x.detach().numpy()
            for i, x in enumerate(tree_flatten(state)[0])})

    got = train.run(
        args, init_params=params,
        draw=lambda s: (res[f"t|{s}"], res[f"noise|{s}"]),
        on_restore=(lambda state, info: dump("restored", state))
        if spec.get("dump_restored") else None)
    if spec.get("dump_final"):
        dump("final", {"params": got.params, "opt": got.opt_state})


def _env():
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO / "src")] + [p for p in os.environ.get(
            "PYTHONPATH", "").split(os.pathsep) if p]),
        OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")


def _torchrun(base, name, n, **spec) -> dict:
    """One world of ``n`` ranks: its exit code, output and each rank's
    ``--out-json`` document."""
    out = base / name
    out.mkdir()
    path = base / f"{name}.json"
    path.write_text(json.dumps(dict(spec, out=str(out),
                                    inputs=str(base / "inputs.npz"))))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(n), __file__, "trainer", str(path)],
        env=_env(), cwd=str(REPO), capture_output=True, text=True,
        timeout=TIMEOUT)
    docs = {r: json.loads((out / f"r{r}.json").read_text())
            for r in range(n) if (out / f"r{r}.json").exists()}
    return dict(rc=proc.returncode, log=proc.stdout + proc.stderr,
                docs=docs, out=out)


def _ok(run, what):
    assert run["rc"] == 0, f"{what}:\n{run['log'][-4000:]}"
    return run


def _shrink(base, got):
    d = str(base / "ck_shrink")
    ck = ["--ckpt-dir", d]
    got["a"] = _ok(_torchrun(
        base, "shrink_a", 4, arch="uvit", init=True, chunk=CHUNK,
        dump_final=True, argv=BASE + PLAN_A + DP2 + ck,
        faults={"*": "stop@4"}), "shrink P=2 dp=2 ZeRO-2, stop@4")
    got["latest_a"] = latest_step(d)
    got["b"] = _ok(_torchrun(base, "shrink_b", 2, arch="uvit",
                             argv=BASE + PLAN_P1 + DP2 + ck + ["--resume"]),
                   "shrink resume onto P=1 dp=2")
    # step 6 is written again below: its params as the resume left them
    got["final_b"] = _final_params(d, 6, BASE + PLAN_P1)
    got["corrupted"] = corrupt_checkpoint(d)
    got["latest_c"] = latest_step(d)
    got["c"] = _ok(_torchrun(base, "shrink_c", 4, arch="uvit",
                             argv=BASE + PLAN_A + DP2 + ck + ["--resume"]),
                   "shrink corrupt-shard fallback")
    got["dir"] = d


def _vchange(base, got):
    d = str(base / "ck_vchange")
    ck = ["--ckpt-dir", d]
    got["a"] = _ok(_torchrun(base, "vchange_a", 4, arch="skipvit", init=True,
                             argv=BASE + VPLAN_A + DP2 + ck,
                             faults={"*": "stop@4"}),
                   "vchange V=2 P=2 dp=2 ZeRO-0, stop@4")
    got["b"] = _ok(_torchrun(base, "vchange_b", 4, arch="skipvit",
                             argv=BASE + VPLAN_B + DP2 + ck + ["--resume"]),
                   "vchange resume onto V=1 ZeRO-2")
    got["dir"] = d


def _faults(base, got):
    d = str(base / "ck_faults")
    ck = ["--ckpt-dir", d]
    got["a"] = _torchrun(base, "faults_a", 2, arch="uvit", init=True,
                         argv=BASE + FPLAN + ck,
                         faults={"*": "kill@5", "1": "iofail@4:4,kill@5"})
    got["latest_a"] = latest_step(d)
    got["step4"] = sorted(os.listdir(os.path.join(d, "step_000000004")))
    got["b"] = _ok(_torchrun(base, "faults_b", 2, arch="uvit",
                             argv=BASE + FPLAN + ck + ["--resume"]),
                   "faults resume")


ACROSS_ARGV = ["--arch", "uvit", "--pipeline", "--pp", "2", "--microbatches",
               "2", "--global-batch", str(BATCH), "--steps", "2",
               "--ckpt-every", "2", "--lr", "1e-3", "--wire-dtype", "float32"]


def _one_process_checkpoint(d):
    """Step 2 of the one-process plan of ``ACROSS_ARGV``, as the trainer's
    one-process manager writes it: its params and random AdamW moments."""
    from repro_torch.optim import adamw_init
    cp = _plan(ACROSS_ARGV)
    gen = torch.Generator().manual_seed(5)
    params = cp.init_pipeline_params(gen, "cpu")
    opt = adamw_init(params)
    opt["m"], opt["v"] = (tree_map(lambda x: torch.rand(
        x.shape, generator=gen), opt[k]) for k in ("m", "v"))
    opt["step"] += 2
    CheckpointManager(d, plan=cp.state_spec()).save(
        2, {"params": params, "opt": opt})


def _across(base, got):
    d = str(base / "ck_across")
    _one_process_checkpoint(d)
    threads = []
    for z in (1, 2):
        def one(z=z):
            got[z] = _ok(_torchrun(
                base, f"across_z{z}", 4, arch="uvit", dump_restored=True,
                argv=ACROSS_ARGV + DP2 + ["--zero-stage", str(z),
                                          "--ckpt-dir", d, "--resume"]),
                f"one-process checkpoint resumed at ZeRO-{z}")
        threads.append(threading.Thread(target=one))
        threads[-1].start()
    for t in threads:
        t.join()
    got["dir"] = d


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    t0 = time.perf_counter()
    base = tmp_path_factory.mktemp("rank_ckpt")
    _inputs(base / "inputs.npz")
    jax_out = base / "jax.npz"
    jax_proc = subprocess.Popen(
        [sys.executable, __file__, "jax", str(jax_out)],
        env=dict(_env(), JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        cwd=str(REPO), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    chains = {name: {} for name in ("shrink", "vchange", "faults", "across")}
    errors = {}

    def chain(name, fn):
        t0 = time.perf_counter()
        try:
            fn(base, chains[name])
        except Exception as e:          # raised below, in the fixture
            errors[name] = e
        chains[name]["seconds"] = time.perf_counter() - t0

    threads = [threading.Thread(target=chain, args=(n, f)) for n, f in
               (("shrink", _shrink), ("vchange", _vchange),
                ("faults", _faults), ("across", _across))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    out, _ = jax_proc.communicate(timeout=TIMEOUT)
    assert jax_proc.returncode == 0, out[-4000:]
    print("seconds:", {k: round(v["seconds"], 1) for k, v in chains.items()},
          "JAX", round(time.perf_counter() - t0, 1))
    for name, e in errors.items():
        raise AssertionError(f"chain {name}: {e}") from e
    with np.load(jax_out) as z:
        chains["jax"] = {k: z[k] for k in z.files}
    return chains


# ---------------------------------------------------------------------------
# what the tests read back
# ---------------------------------------------------------------------------

def _plan(argv):
    """The plan ``train.build_trainer`` builds from ``argv`` (dp > 1 too),
    and the model's config and kind."""
    args = train._parse_args(argv + ["--device", "cpu"])
    cfg, kind = train._model_config(args), train._kind(args)
    graph_fn = skipvit_pipeline_graph if kind == "skipvit" \
        else uvit_pipeline_graph
    M, P = args.microbatches, train._pipeline_degree(args)
    graph = graph_fn(cfg, batch=args.global_batch // M, hw=H100_SXM)
    return auto_pipeline(graph, model_fns(cfg, kind), P * args.dp,
                         hw=H100_SXM, pipeline_devices=P, microbatches=M,
                         interleave=args.interleave,
                         wire_dtype=args.wire_dtype, dp_size=args.dp,
                         zero_stage=args.zero_stage)


def _whole_state(d, step, argv):
    """Step ``step`` of ``d`` whole, in the port, on the one-process plan
    of ``argv`` (dp 1): ``(state, manifest)``."""
    cp = _plan(argv)
    params = cp.init_pipeline_params(torch.Generator().manual_seed(0), "cpu")
    from repro_torch.optim import adamw_init
    like = {"params": params, "opt": adamw_init(params)}
    state, got = restore_checkpoint(d, like, step=step, expect_shapes=False)
    assert got == step
    man = read_manifest(d, step)
    assert man["plan"]["fingerprint"] == cp.fingerprint()
    return state, man


def _model_space(logical_pt, cp):
    return _flatten(cp.model_fns.merge_blocks(tuple(logical_pt["stacks"]),
                                              logical_pt["edge"]))


def _final_params(d, step, argv):
    """The model-space params of step ``step``, through
    ``state_to_logical`` and the saved spec."""
    state, man = _whole_state(d, step, argv)
    logical = state_to_logical(state, man["plan"])
    return _model_space(logical["params"], _plan(argv))


def _losses(run):
    """Each rank's losses; every rank's must be the same."""
    got = [{int(k): v for k, v in doc["losses"].items()}
           for doc in run["docs"].values()]
    assert got and all(g == got[0] for g in got), got
    return got[0]


def _assert_losses(got, want, steps, what):
    assert sorted(got) == list(steps), (what, got)
    for s in steps:
        np.testing.assert_allclose(got[s], want[s], rtol=RTOL, atol=1e-6,
                                   err_msg=f"{what}: step {s}")


def _assert_params(got, jax_res, arch, what):
    pre = f"{arch}|final|"
    want = {k[len(pre):]: v for k, v in jax_res.items() if k.startswith(pre)}
    assert sorted(got) == sorted(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what}: {k}")


def _rank_expected(cp, d, j, state):
    """Rank (``d``, ``j``)'s state cut from the whole ``state`` by the
    plan's own placement: ``split_params`` (ZeRO-2 shards the rows) and
    ``optimizer_view`` (ZeRO-1 shards the moments)."""
    spec = cp.state_spec()
    logical = state_to_logical(state, spec)
    r = cp.for_rank(d, j)

    def rows(pt):
        return r.split_params(cp.model_fns.merge_blocks(
            tuple(pt["stacks"]), pt["edge"]))

    o = logical["opt"]
    return {"params": rows(logical["params"]),
            "opt": {"m": r.optimizer_view(rows(o["m"])),
                    "v": r.optimizer_view(rows(o["v"])), "step": o["step"]}}


def _assert_rank_bitwise(cp, state, dumps, what):
    P = cp.partition.num_devices
    for r, leaves in dumps.items():
        want = tree_flatten(_rank_expected(cp, r % P, r // P, state))[0]
        assert sorted(leaves, key=int) == [str(i) for i in range(len(want))]
        for i, w in enumerate(want):
            g = leaves[str(i)]
            assert g.shape == tuple(w.shape), (what, r, i)
            assert _bits(g) == _bits(w), f"{what}: rank {r} leaf {i}"


def _dumps(run, name):
    out = {}
    for f in sorted(run["out"].glob(f"{name}*.npz")):
        with np.load(f) as z:
            out[int(f.stem[len(name):])] = {k: z[k] for k in z.files}
    return out


# ---------------------------------------------------------------------------
# shrink: UViT P=2 dp=2 ZeRO-2 -> P=1 dp=2 ZeRO-0, then a corrupt shard
# ---------------------------------------------------------------------------

def test_shrink_saves_every_rank_share_and_stops(runs):
    s, want = runs["shrink"], runs["jax"]["uvit|losses"]
    _assert_losses(_losses(s["a"]), want, range(4), "P=2 dp=2 ZeRO-2")
    assert s["latest_a"] == 4
    man = read_manifest(s["dir"], 4)
    assert man["num_hosts"] == 4 and man["shards"] == [
        f"shard_{r:05d}.npz" for r in range(4)]
    assert (man["plan"]["P"], man["plan"]["dp"],
            man["plan"]["zero_stage"]) == (2, 2, 2)
    for doc in s["a"]["docs"].values():
        assert [(x["step"], x["landed"]) for x in doc["saves"]] == [
            (2, True), (4, True)]
    # the writers' bytes: balanced, whatever the leaves' sizes
    sizes = [os.path.getsize(os.path.join(s["dir"], "step_000000004", sh))
             for sh in man["shards"]]
    biggest = max(np.prod(x["shape"]) * 4 for x in man["leaves"])
    assert max(sizes) - min(sizes) <= biggest, sizes


def test_shrink_resume_onto_p1_is_elastic_and_continues_jax(runs):
    s = runs["shrink"]
    for doc in s["b"]["docs"].values():
        assert doc["resumed_step"] == 4 and doc["elastic"]
    assert "elastic restore" in s["b"]["log"]
    _assert_losses(_losses(s["b"]), runs["jax"]["uvit|losses"], (4, 5),
                   "shrink P=2->P=1")


def test_shrink_final_params_equal_jax(runs):
    _assert_params(runs["shrink"]["final_b"], runs["jax"], "uvit",
                   "shrink P=2->P=1 final params")


def test_corrupt_shard_falls_back_and_reproduces_the_trajectory(runs):
    s = runs["shrink"]
    assert "step_000000006" in s["corrupted"] and s["latest_c"] == 4
    for doc in s["c"]["docs"].values():
        assert doc["resumed_step"] == 4 and not doc["elastic"]
    assert "fell back to step 4" in s["c"]["log"]
    _assert_losses(_losses(s["c"]), runs["jax"]["uvit|losses"], (4, 5),
                   "corrupt-shard fallback")
    _assert_params(_final_params(s["dir"], 6, PLAN_A + BASE), runs["jax"],
                   "uvit", "corrupt-shard fallback final params")


def test_rank_checkpoint_holds_what_each_rank_held(runs):
    """The ``stop@4`` run ends on the state it saved at step 4: each
    rank's pieces, cut from the checkpoint's whole leaves by the plan's
    own placement, are what the rank held, bitwise."""
    s = runs["shrink"]
    state, _ = _whole_state(s["dir"], 4, PLAN_A + BASE)
    dumps = _dumps(s["a"], "final")
    assert sorted(dumps) == [0, 1, 2, 3]
    _assert_rank_bitwise(_plan(PLAN_A + DP2 + BASE), state, dumps,
                         "P=2 dp=2 ZeRO-2 at step 4")


def test_rank_members_are_the_one_process_writers(runs, tmp_path):
    """Given the same state, every npz member (header and payload) and the
    manifest's leaves and plan are what one process writes."""
    s = runs["shrink"]
    state, man = _whole_state(s["dir"], 4, PLAN_A + BASE)
    save_checkpoint(str(tmp_path), 4, state, plan=man["plan"])
    one = read_manifest(str(tmp_path), 4)
    assert one["leaves"] == man["leaves"] and one["plan"] == man["plan"]
    step = os.path.join(s["dir"], "step_000000004")
    ranks = {}
    for sh in man["shards"]:
        with zipfile.ZipFile(os.path.join(step, sh)) as zf:
            ranks.update({n: zf.read(n) for n in zf.namelist()})
    with zipfile.ZipFile(tmp_path / "step_000000004" / "shard_00000.npz") \
            as zf:
        assert sorted(zf.namelist()) == sorted(ranks)
        for n in zf.namelist():
            assert zf.read(n) == ranks[n], n


def test_rank_checkpoint_restores_in_jax(runs):
    """The JAX package verifies a rank world's checkpoint and restores it
    elastically onto a JAX plan of another shape (P=1): the logical state
    is the port's, bitwise."""
    import jax

    from repro.checkpoint import verify_step as jax_verify_step
    from repro.models import diffusion as jdm
    from repro.optim import adamw_init as jax_adamw_init
    from repro.runtime.adapters import diffusion_model_fns as jax_model_fns
    from repro.runtime.compile import auto_pipeline as jax_auto_pipeline
    from repro.runtime.resilience import \
        restore_training_state as jax_restore_training_state
    from repro.runtime.resilience import \
        state_to_logical as jax_state_to_logical
    s = runs["shrink"]
    jax_verify_step(s["dir"], 4)
    jcfg = jdm.UViTConfig("uvit-pp", **CFG["uvit"])
    jcp = jax_auto_pipeline(jdm.uvit_pipeline_graph(jcfg, batch=2),
                            jax_model_fns(jcfg, "uvit"), 1,
                            pipeline_devices=1, microbatches=2)
    params = jcp.init_pipeline_params(jax.random.PRNGKey(0))
    got, info = jax_restore_training_state(
        s["dir"], jcp, {"params": params, "opt": jax_adamw_init(params)},
        step=4)
    assert info.step == 4 and info.elastic
    jl = _flatten(jax.device_get(jax_state_to_logical(got,
                                                      jcp.state_spec())))
    state, man = _whole_state(s["dir"], 4, PLAN_A + BASE)
    tl = _flatten(state_to_logical(state, man["plan"]))
    assert sorted(jl) == sorted(tl)
    for k in jl:
        assert _bits(jl[k]) == _bits(tl[k]), k


# ---------------------------------------------------------------------------
# vchange: SkipViT V=2 P=2 dp=2 ZeRO-0 -> V=1 P=2 dp=2 ZeRO-2
# ---------------------------------------------------------------------------

def test_vchange_over_ranks_is_elastic_and_continues_jax(runs):
    v, want = runs["vchange"], runs["jax"]["skipvit|losses"]
    _assert_losses(_losses(v["a"]), want, range(4), "SkipViT V=2")
    for doc in v["b"]["docs"].values():
        assert doc["resumed_step"] == 4 and doc["elastic"]
    _assert_losses(_losses(v["b"]), want, (4, 5), "SkipViT V=2->V=1")
    _assert_params(_final_params(v["dir"], 6, VPLAN_B + BASE), runs["jax"],
                   "skipvit", "V=2->V=1 final params")


# ---------------------------------------------------------------------------
# a one-process checkpoint resumed as ranks; the bytes a rank reads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("zero", [1, 2])
def test_one_process_checkpoint_resumes_as_ranks_bitwise(runs, zero):
    a = runs["across"]
    state, _ = _whole_state(a["dir"], 2, ACROSS_ARGV)
    for doc in a[zero]["docs"].values():
        assert doc["resumed_step"] == 2 and not doc["elastic"]
    dumps = _dumps(a[zero], "restored")
    assert sorted(dumps) == [0, 1, 2, 3]
    _assert_rank_bitwise(_plan(ACROSS_ARGV + DP2 + ["--zero-stage",
                                                    str(zero)]),
                         state, dumps, f"resumed at ZeRO-{zero}")


def _share_bound(man, new_argv, rank):
    """The bytes rank ``rank`` of the plan of ``new_argv`` may read of a
    checkpoint with manifest ``man``: at the saved fingerprint its rows
    ``x[d]`` of every stage leaf, else the blocks its new rows hold; every
    other leaf whole."""
    cp = _plan(new_argv)
    d = rank % cp.partition.num_devices
    same = man["plan"]["fingerprint"] == cp.fingerprint()
    lay = cp.layout
    counts = (lay.enc_counts[d], lay.dec_counts[d])
    total = 0
    # the rank's own tree tells the stage leaves from the others
    from repro_torch.optim import adamw_init
    from repro_torch.runtime.resilience import rank_leaves
    rp = cp.for_rank(d, rank // cp.partition.num_devices)
    params = rp.init_pipeline_params(torch.Generator().manual_seed(0), "cpu")
    for leaf, p in zip(man["leaves"], rank_leaves(
            rp, {"params": params, "opt": adamw_init(
                rp.optimizer_view(params))})):
        n = int(np.prod(leaf["shape"])) * (2 if leaf["dtype"] == "bfloat16"
                                           else np.dtype(leaf["dtype"])
                                           .itemsize)
        if p.stack is None:
            total += n
        elif same:
            total += n // leaf["shape"][0]
        else:
            block = n // int(np.prod(leaf["shape"][:3]))
            total += block * sum(counts[p.stack])
    return total


@pytest.mark.parametrize("case", ["same plan", "elastic P=1", "elastic V=1"])
def test_a_rank_reads_only_its_share(runs, case):
    if case == "same plan":
        run, d, step = runs["across"][2], runs["across"]["dir"], 2
        argv = ACROSS_ARGV + DP2 + ["--zero-stage", "2"]
    elif case == "elastic P=1":
        run, d, step = runs["shrink"]["b"], runs["shrink"]["dir"], 4
        argv = BASE + PLAN_P1 + DP2
    else:
        run, d, step = runs["vchange"]["b"], runs["vchange"]["dir"], 4
        argv = BASE + VPLAN_B + DP2
    man = read_manifest(d, step)
    for r, doc in run["docs"].items():
        rest = doc["restore"]
        assert rest["bytes_read"] == _share_bound(man, argv, r), (case, r)
        # every shard hashed once over the world
    hashed = sum(doc["restore"]["hashed_bytes"]
                 for doc in run["docs"].values())
    assert hashed == sum(os.path.getsize(os.path.join(
        d, f"step_{step:09d}", sh)) for sh in man["shards"])


# ---------------------------------------------------------------------------
# iofail on one rank; kill over ranks
# ---------------------------------------------------------------------------

def test_iofail_on_one_rank_leaves_the_step_incomplete(runs):
    f, want = runs["faults"], runs["jax"]["uvit|losses"]
    # every rank trained on past the failed save (step 4) until the kill
    _assert_losses(_losses(f["a"]), want, range(5), "iofail run")
    assert f["a"]["log"].count("checkpoint step 4 is incomplete") == 2
    assert "shard_00001.npz" not in f["step4"] and "manifest.json" in \
        f["step4"]
    assert f["latest_a"] == 2
    for doc in f["b"]["docs"].values():
        assert doc["resumed_step"] == 2 and not doc["elastic"]
    assert "fell back to step 2" in f["b"]["log"]
    _assert_losses(_losses(f["b"]), want, range(2, STEPS), "after iofail")


def test_kill_over_ranks_exits_and_resumes_from_the_last_complete_step(runs):
    f = runs["faults"]
    assert f["a"]["rc"] != 0
    assert f["a"]["log"].count("os._exit(42)") == 2        # every rank
    assert f["latest_a"] == 2 and f["b"]["rc"] == 0
    ends = [doc["losses"] for doc in f["b"]["docs"].values()]
    assert all(sorted(map(int, e)) == list(range(2, STEPS)) for e in ends)


# ---------------------------------------------------------------------------
# the pieces, in this process
# ---------------------------------------------------------------------------

def test_assign_writers_balances_bytes():
    sizes = [100, 7, 60, 60, 3, 40, 1, 90]
    w = store.assign_writers(sizes, 3)
    load = [sum(n for n, h in zip(sizes, w) if h == k) for k in range(3)]
    assert sorted(set(w)) == [0, 1, 2]
    assert max(load) - min(load) <= max(sizes)
    assert w == store.assign_writers(sizes, 3)      # every rank agrees
    assert store.assign_writers(sizes, 1) == [0] * len(sizes)


def test_npz_reader_reads_row_ranges_and_counts_them(tmp_path):
    gen = torch.Generator().manual_seed(0)
    tree = {"a": torch.randn(3, 2, 4, 5, generator=gen),
            "b": torch.randn(6, generator=gen).to(torch.bfloat16)}
    save_checkpoint(str(tmp_path), 1, tree)
    z = store._NpzReader(str(tmp_path / "step_000000001" /
                             "shard_00000.npz"))
    try:
        a = tree["a"].numpy()
        np.testing.assert_array_equal(z.read_rows("a0", 1, 1, 2)[0], a[1])
        np.testing.assert_array_equal(z.read_rows("a0", 3, 5, 9),
                                      a.reshape(24, 5)[5:9])
        assert z.bytes_read == (a[1].nbytes + 4 * 5 * 4)
        assert _bits(z["a1"]) == _bits(tree["b"])
        assert z.bytes_read == a[1].nbytes + 4 * 5 * 4 + 12
        with pytest.raises(ValueError, match="rows 2:4"):
            z.read_rows("a0", 1, 2, 4)
    finally:
        z.close()


def test_verify_step_hashes_only_the_callers_shards(tmp_path, monkeypatch):
    tree = {f"x{i}": torch.full((4,), float(i)) for i in range(4)}
    for h in range(2):
        save_checkpoint(str(tmp_path), 3, tree, host_id=h, num_hosts=2)
    corrupt_checkpoint(str(tmp_path), step=3, shard="shard_00001")
    hashed = []
    real = store._sha256
    monkeypatch.setattr(store, "_sha256",
                        lambda p: hashed.append(p) or real(p))
    verify_step(str(tmp_path), 3, mine=lambda k: k == 0)
    assert [os.path.basename(p) for p in hashed] == ["shard_00000.npz"]
    with pytest.raises(store.CheckpointError, match="SHA-256"):
        verify_step(str(tmp_path), 3, mine=lambda k: k == 1)


def test_gc_hashes_a_step_once(tmp_path, monkeypatch):
    """GC trusts a step its manager saw land whole, or one verified once;
    a trusted step whose files change is hashed again."""
    hashed = []
    real = store._sha256
    monkeypatch.setattr(store, "_sha256",
                        lambda p: hashed.append(os.path.basename(
                            os.path.dirname(p))) or real(p))
    tree = {"x": torch.ones(3)}
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(2, tree)
    mgr.save(4, tree)
    # the sidecars' digests at the writes, nothing at GC
    assert hashed == ["step_000000002", "step_000000004"]
    save_checkpoint(str(tmp_path), 5, tree)          # another writer's
    hashed.clear()
    mgr.save(6, tree)
    mgr.save(8, tree)
    # 6 and 8 at their writes, 5 once at the first GC that met it
    assert hashed == ["step_000000006", "step_000000005", "step_000000008"]
    assert [r["gc_hashed"] for r in mgr.history] == [[], [], [5], []]
    assert sorted(os.listdir(tmp_path)) == ["step_000000006",
                                            "step_000000008"]
    corrupt_checkpoint(str(tmp_path), step=8, truncate=True)
    hashed.clear()
    mgr.save(10, tree)
    assert hashed == ["step_000000010", "step_000000008"]
    assert sorted(os.listdir(tmp_path)) == ["step_000000006",
                                            "step_000000010"]


@pytest.mark.parametrize("saved, new", [
    (PLAN_A, PLAN_P1), (VPLAN_A, VPLAN_B),
    (VPLAN_B, ["--arch", "skipvit", "--pp", "4", "--interleave", "1"])])
def test_rank_rows_sources_are_the_elastic_relayout(saved, new):
    """Each new rank's rows, read block by block where
    ``rank_rows_sources`` says, are the new plan's ``split_params`` of the
    model the saved plan's ``merge_params`` gives: for SkipViT's one stack
    too, whose turnaround moves between the plans."""
    old_cp, new_cp = _plan(saved + BASE), _plan(new + BASE)
    gen = torch.Generator().manual_seed(3)
    params = old_cp.init_pipeline_params(gen, "cpu")
    stacks = tuple(tree_map(lambda x: torch.randn(x.shape, generator=gen),
                            st) for st in params[0])
    want = new_cp.split_params(old_cp.merge_params(stacks, params[1]))[0]
    old_spec, new_spec = old_cp.state_spec(), new_cp.state_spec()
    assert block_homes(old_spec).keys() == block_homes(new_spec).keys()
    for k, st in enumerate(want):
        for path, x in _flatten(st).items():
            for d in range(new_cp.partition.num_devices):
                for v, srcs in enumerate(rank_rows_sources(
                        old_spec, new_spec, k, d)):
                    for r, (s, ds, vs, rs) in enumerate(srcs):
                        src = _flatten(stacks[s])[path]
                        assert np.array_equal(x[d, v, r], src[ds, vs, rs])


def test_rank_piece_is_the_plans_own_placement():
    """``rank_piece`` of a whole leaf's rows is ``split_params``' piece at
    ZeRO-2 and ``optimizer_view``'s at ZeRO-1, for every grid point."""
    for zero in (1, 2):
        cp = _plan(PLAN_A[:-1] + [str(zero)] + DP2 + BASE)
        gen = torch.Generator().manual_seed(0)
        whole = cp.model_fns.init_fn(gen, "cpu")
        stacks = cp.layout.split(tuple(cp.model_fns.split_blocks(whole)[0]))
        for d in range(2):
            for j in range(2):
                r = cp.for_rank(d, j)
                got_p, _ = r.split_params(whole)
                got_m = r.optimizer_view(r.split_params(whole))[0]
                for k, st in enumerate(stacks):
                    flat_p, flat_m = _flatten(got_p[k]), _flatten(got_m[k])
                    for path, x in _flatten(st).items():
                        x = torch.from_numpy(x)
                        assert torch.equal(r.rank_piece(x[d], k, path),
                                           torch.from_numpy(flat_p[path]))
                        assert torch.equal(
                            r.rank_piece(x[d], k, path, moments=True),
                            torch.from_numpy(np.ascontiguousarray(
                                flat_m[path])))


def test_trainer_takes_checkpoints_over_ranks(monkeypatch):
    """``--ckpt-dir`` and ``--resume`` pass the refusals over ranks, and
    with ``--num-hosts > 1`` too when the world is that many hosts of
    ``LOCAL_WORLD_SIZE`` ranks."""
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    for k, v in dict(RANK="0", WORLD_SIZE="4", LOCAL_RANK="0",
                     MASTER_ADDR="localhost").items():
        monkeypatch.setenv(k, v)
    env = train.rank_env()
    args = train._parse_args(PLAN_A + DP2 + BASE + ["--ckpt-dir", "x",
                                                    "--resume"])
    train._refuse_rank_options(args, env)
    args.num_hosts = 2
    with pytest.raises(ValueError, match="LOCAL_WORLD_SIZE 4"):
        train._refuse_rank_options(args, env)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    train._refuse_rank_options(args, train.rank_env())


if __name__ == "__main__" and sys.argv[1:2] == ["jax"]:
    _jax_main(sys.argv[2])
elif __name__ == "__main__" and sys.argv[1:2] == ["trainer"]:
    warnings.simplefilter("default")
    _trainer_main(sys.argv[2])
