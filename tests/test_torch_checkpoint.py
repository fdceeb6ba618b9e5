"""The port's checkpoints, state specs and elastic restore held to the JAX
package's.

- leaf order: ``repro_torch.tree.tree_flatten`` numbers the trainer's
  state ``{"params": (stage_stacks, edge), "opt": {"m", "v", "step"}}``
  as ``jax.tree_util`` does, and the JAX trainer's state of the same
  config has the same leaf paths and shapes in that order;
- format: fp32, bf16 and int32-scalar leaves round-trip bitwise; a JAX
  checkpoint (bf16 leaves included) restores in the port bitwise; a port
  checkpoint restores through JAX's ``restore_checkpoint`` bitwise, and
  its npz members (header and payload) and manifest equal the JAX
  writer's for the same values (members, not file hashes: the zip
  timestamps differ);
- the async save snapshots before it returns; corrupt and truncated
  shards are detected and ``strict=False`` falls back; GC keeps ``keep``
  verified steps; ``iofail`` retries, then degrades to a warning;
- ``state_spec``/``fingerprint`` equal JAX's ``compiled_state_spec`` for
  UViT and Hunyuan-DiT plans; de-stack/re-stack across D and V, and a
  JAX D=4 checkpoint restored onto a port D=2 plan, give the JAX logical
  params exactly.
"""
import dataclasses
import functools
import json
import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as jax_restore
from repro.checkpoint import save_checkpoint as jax_save
from repro.core import hw as jax_hw
from repro.models import diffusion as jdm
from repro.optim import adamw_init as jax_adamw_init
from repro.runtime.adapters import diffusion_model_fns as jax_model_fns
from repro.runtime.compile import auto_pipeline as jax_auto_pipeline
from repro.runtime.resilience import compiled_state_spec as jax_spec
from repro.runtime.resilience import state_to_logical as jax_state_to_logical
from repro_torch.checkpoint import (CheckpointError, CheckpointManager,
                                    complete_steps, latest_step,
                                    read_manifest, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.convert import params_from_jax
from repro_torch.core import hw as torch_hw
from repro_torch.models import diffusion as tdm
from repro_torch.optim import adamw_init
from repro_torch.runtime.adapters import diffusion_model_fns
from repro_torch.runtime.compile import auto_pipeline
from repro_torch.runtime.resilience import (corrupt_checkpoint,
                                            plan_fingerprint,
                                            restore_training_state,
                                            state_to_logical)
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

# the JAX package's default hardware in the port's record: both planners
# cost the graph identically
TPU = torch_hw.Hardware(**dataclasses.asdict(jax_hw.TPU_V5E))
# 16 blocks: D=4 with V=2 cuts them into 16 stages
SMALL = {"uvit": dict(img_size=8, in_ch=4, patch=2, d_model=16,
                      n_layers=16, n_heads=2, d_ff=32, n_classes=10),
         "hunyuan": dict(img_size=8, in_ch=4, patch=2, d_model=16,
                         n_layers=16, n_heads=2, d_ff=32, ctx_dim=8,
                         ctx_len=4)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes gain nothing from more threads, and tier-1 runs six
    test processes on the host's cores at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _plans(kind, D, V=1, M=4):
    """(JAX plan, port plan) of the same small config and plan."""
    if kind == "uvit":
        jcfg = jdm.UViTConfig("t", **SMALL[kind])
        tcfg = tdm.UViTConfig("t", **SMALL[kind])
        jg = jdm.uvit_pipeline_graph(jcfg, batch=2, hw=jax_hw.TPU_V5E)
        tg = tdm.uvit_pipeline_graph(tcfg, batch=2, hw=TPU)
    else:
        jcfg = jdm.HunyuanDiTConfig("t", **SMALL[kind])
        tcfg = tdm.HunyuanDiTConfig("t", **SMALL[kind])
        jg = jdm.hunyuan_pipeline_graph(jcfg, batch=2, hw=jax_hw.TPU_V5E)
        tg = tdm.hunyuan_pipeline_graph(tcfg, batch=2, hw=TPU)
    kw = dict(pipeline_devices=D, microbatches=M,
              interleave=V if V > 1 else None)
    jcp = jax_auto_pipeline(jg, jax_model_fns(jcfg, kind), D,
                            jax_hw.TPU_V5E, **kw)
    tcp = auto_pipeline(tg, diffusion_model_fns(tcfg, kind), D, TPU, **kw)
    return jcp, tcp


def _jax_state(jcp, seed=0):
    params = jcp.init_pipeline_params(jax.random.PRNGKey(seed))
    return jax.device_get({"params": params, "opt": jax_adamw_init(params)})


def _port_state(tcp, seed=0):
    params = tcp.init_pipeline_params(torch.Generator().manual_seed(seed),
                                      "cpu")
    return {"params": params, "opt": adamw_init(params)}


def _np(x):
    """A leaf as numpy, bf16 as its raw 16-bit words (bitwise compares)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.view(torch.int16).numpy() if x.dtype == torch.bfloat16
                else x.numpy())
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _assert_bitwise(got_leaves, want_leaves):
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        g, w = _np(g), _np(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def _mixed_tree():
    """fp32, bf16 and an int32 scalar, in a dict whose insertion order is
    not JAX's sorted order."""
    g = torch.Generator().manual_seed(5)
    return {"w": torch.randn(3, 4, generator=g),
            "b": [torch.randn(5, generator=g).to(torch.bfloat16), None,
                  torch.randn(2, 3, generator=g)],
            "a": {"step": torch.tensor(7, dtype=torch.int32),
                  "h": torch.randn(4, 2, generator=g).to(torch.bfloat16)}}


def _to_jax_np(tree):
    """The same values as numpy for the JAX package (bf16 as ml_dtypes)."""
    def f(x):
        if x.dtype == torch.bfloat16:
            return np.asarray(jnp.asarray(x.float().numpy(), jnp.bfloat16))
        return x.numpy().copy()
    return tree_map(f, tree)


# ---------------------------------------------------------------------------
# leaf order
# ---------------------------------------------------------------------------

def test_tree_flatten_is_jax_order():
    t = _mixed_tree()
    leaves, td = tree_flatten(t)
    want = jax.tree_util.tree_flatten(t)[0]
    assert [id(x) for x in leaves] == [id(x) for x in want]
    back = tree_unflatten(td, leaves)
    assert list(back) == list(t) and back["b"][1] is None
    assert [id(x) for x in tree_flatten(back)[0]] == [id(x) for x in leaves]
    with pytest.raises(ValueError, match="leaves"):
        tree_unflatten(td, leaves[:-1])


def test_tree_flatten_leaves_no_reference_cycle():
    """A flattened or rebuilt tree frees its leaves as soon as the caller
    drops them, without a cyclic collection (a resume rebuilds the whole
    training state; a cycle would hold a second copy on the card)."""
    import gc
    import weakref
    t = _mixed_tree()
    gc.disable()
    try:
        leaves, td = tree_flatten(t)
        back = tree_unflatten(td, [x.clone() for x in leaves])
        refs = [weakref.ref(x) for x in tree_flatten(back)[0]]
        del back
        assert all(r() is None for r in refs)
    finally:
        gc.enable()


@pytest.mark.parametrize("kind", ["uvit", "hunyuan"])
def test_trainer_state_leaf_order_matches_jax(kind):
    jcp, tcp = _plans(kind, 2)
    port = _port_state(tcp)
    leaves = tree_flatten(port)[0]
    # jax.tree_util flattens the port's tree (tensors are leaves to it) in
    # the same order ...
    assert [id(x) for x in leaves] == \
        [id(x) for x in jax.tree_util.tree_flatten(port)[0]]
    # ... and the JAX trainer's state of the same config has the same leaf
    # paths and shapes, leaf for leaf
    jpaths = jax.tree_util.tree_flatten_with_path(_jax_state(jcp))[0]
    tpaths = jax.tree_util.tree_flatten_with_path(port)[0]
    assert [jax.tree_util.keystr(p) for p, _ in tpaths] == \
        [jax.tree_util.keystr(p) for p, _ in jpaths]
    assert [tuple(x.shape) for x in leaves] == \
        [tuple(np.shape(x)) for _, x in jpaths]


# ---------------------------------------------------------------------------
# format: round trip, JAX -> port, port -> JAX
# ---------------------------------------------------------------------------

def test_round_trip_bitwise(tmp_path):
    t = _mixed_tree()
    save_checkpoint(str(tmp_path), 3, t)
    like = tree_map(torch.zeros_like, t)
    got, step = restore_checkpoint(str(tmp_path), like)
    assert step == 3
    _assert_bitwise(tree_flatten(got)[0], tree_flatten(t)[0])
    man = read_manifest(str(tmp_path), 3)
    assert [d["dtype"] for d in man["leaves"]] == \
        ["bfloat16", "int32", "bfloat16", "float32", "float32"]
    with pytest.raises(CheckpointError) as ei:
        restore_checkpoint(str(tmp_path), {"x": torch.zeros(1)})
    assert ei.value.reason == "structure"


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    t = _mixed_tree()
    jax_save(str(tmp_path), 4, _to_jax_np(t))
    got, step = restore_checkpoint(str(tmp_path),
                                   tree_map(torch.zeros_like, t))
    assert step == 4
    want = tree_flatten(t)[0]
    assert [x.dtype for x in tree_flatten(got)[0]] == [x.dtype for x in want]
    _assert_bitwise(tree_flatten(got)[0], want)


def test_port_checkpoint_restores_in_jax(tmp_path):
    t = {"w": torch.randn(3, 4), "b": [torch.randn(5), torch.randn(2, 2)]}
    save_checkpoint(str(tmp_path), 2, t)
    like = tree_map(lambda x: jnp.zeros(x.shape, jnp.float32), t)
    got, step = jax_restore(str(tmp_path), like)
    assert step == 2
    _assert_bitwise(jax.tree_util.tree_flatten(got)[0], tree_flatten(t)[0])


def test_port_writes_the_jax_writers_members_and_manifest(tmp_path):
    t = _mixed_tree()
    jcp, tcp = _plans("uvit", 2)
    spec = tcp.state_spec()
    save_checkpoint(str(tmp_path / "port"), 1, t, plan=spec,
                    extra={"note": "x"})
    jax_save(str(tmp_path / "jax"), 1, _to_jax_np(t), plan=jax_spec(jcp),
             extra={"note": "x"})
    step = "step_000000001"
    members = {}
    for who in ("port", "jax"):
        with zipfile.ZipFile(tmp_path / who / step / "shard_00000.npz") as z:
            members[who] = {n: z.read(n) for n in z.namelist()}
    assert list(members["port"]) == list(members["jax"])
    for name, raw in members["jax"].items():
        assert members["port"][name] == raw, name
    for f in ("manifest.json", "shard_00000.json"):
        got = json.loads((tmp_path / "port" / step / f).read_text())
        want = json.loads((tmp_path / "jax" / step / f).read_text())
        if f == "shard_00000.json":         # zip timestamps differ
            got.pop("sha256"), want.pop("sha256")
        assert got == want, f
    assert (tmp_path / "port" / step / "manifest.json").read_text() == \
        (tmp_path / "jax" / step / "manifest.json").read_text()


# ---------------------------------------------------------------------------
# the manager: snapshot, corruption, GC, retries
# ---------------------------------------------------------------------------

def test_save_async_snapshots_before_returning(tmp_path):
    t = {"p": torch.arange(6.0), "m": torch.ones(2, 3),
         "s": torch.tensor(1, dtype=torch.int32)}
    want = tree_map(torch.clone, t)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_async(5, t)
    with torch.no_grad():           # the in-place optimizer step
        t["p"].add_(100.0)
        t["m"].mul_(-3.0)
        t["s"] += 1
    mgr.wait()
    got, _ = restore_checkpoint(str(tmp_path), tree_map(torch.zeros_like, t))
    _assert_bitwise(tree_flatten(got)[0], tree_flatten(want)[0])
    (rec,) = mgr.history
    assert rec["step"] == 5 and rec["path"] and rec["bytes"] > 0
    assert rec["total_s"] >= rec["snapshot_s"] >= 0.0


@pytest.mark.parametrize("truncate", [False, True])
def test_corrupt_shard_detected_and_fallback(tmp_path, truncate):
    t = {"w": torch.randn(64, 8), "b": torch.randn(8)}
    save_checkpoint(str(tmp_path), 1, t)
    t2 = tree_map(lambda x: x + 1, t)
    save_checkpoint(str(tmp_path), 2, t2)
    corrupt_checkpoint(str(tmp_path), truncate=truncate)
    assert latest_step(str(tmp_path)) == 1
    like = tree_map(torch.zeros_like, t)
    with pytest.raises(CheckpointError) as ei:
        restore_checkpoint(str(tmp_path), like, step=2)
    assert ei.value.reason == "checksum-mismatch"
    assert ei.value.step == 2 and ei.value.shard == "shard_00000.npz"
    got, step = restore_checkpoint(str(tmp_path), like, strict=False)
    assert step == 1
    _assert_bitwise(tree_flatten(got)[0], tree_flatten(t)[0])


def test_gc_keeps_verified_steps(tmp_path):
    t = {"w": torch.ones(3)}
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3):
        mgr.save(s, t)
    os.makedirs(tmp_path / "step_000000000")
    os.makedirs(tmp_path / "step_000000002.tmp1")
    (tmp_path / ".manifest.json.tmp99").write_text("{}")
    os.makedirs(tmp_path / "step_000000009")        # newer, in flight
    mgr.save(4, t)
    assert complete_steps(str(tmp_path)) == [3, 4]
    assert sorted(os.listdir(tmp_path)) == \
        ["step_000000003", "step_000000004", "step_000000009"]


def test_iofail_retries_then_degrades(tmp_path):
    from repro_torch.runtime.resilience import FaultPlan
    fp = FaultPlan.parse("iofail@1:2")
    mgr = CheckpointManager(str(tmp_path), retries=3, backoff=0.001,
                            io_fault=fp.io_fault)
    assert mgr.save(1, {"w": torch.ones(2)}) is not None
    assert mgr.history[-1]["attempts"] == 3 and latest_step(str(tmp_path)) == 1
    fp = FaultPlan.parse("iofail@2:5")
    mgr = CheckpointManager(str(tmp_path), retries=1, backoff=0.001,
                            io_fault=fp.io_fault)
    with pytest.warns(RuntimeWarning, match="training continues"):
        assert mgr.save(2, {"w": torch.ones(2)}) is None
    assert mgr.history[-1]["path"] is None
    assert latest_step(str(tmp_path)) == 1


# ---------------------------------------------------------------------------
# state specs, fingerprints, elastic restore
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,D,V", [("uvit", 2, 1), ("uvit", 4, 1),
                                      ("uvit", 4, 2), ("hunyuan", 2, 1),
                                      ("hunyuan", 4, 1), ("hunyuan", 4, 2)])
def test_state_spec_and_fingerprint_match_jax(kind, D, V):
    jcp, tcp = _plans(kind, D, V)
    spec = tcp.state_spec()
    assert spec == jax_spec(jcp)
    assert tcp.fingerprint() == jcp.fingerprint() == spec["fingerprint"]
    assert plan_fingerprint(json.loads(json.dumps(spec))) == \
        spec["fingerprint"]
    assert (spec["P"], spec["V"], spec["dp"], spec["zero_stage"],
            spec["num_param_stacks"]) == (D, V, 1, 0, 2)


def test_fingerprint_tracks_layout_only():
    fp = _plans("uvit", 2)[1].fingerprint()
    assert _plans("uvit", 4)[1].fingerprint() != fp
    assert _plans("uvit", 2, 2)[1].fingerprint() != fp
    assert _plans("uvit", 2, 1, 8)[1].fingerprint() == fp      # M


@pytest.mark.parametrize("src,dst", [((4, 1), (2, 1)), ((4, 2), (4, 1)),
                                     ((2, 2), (2, 1))])
def test_destack_restack_matches_merge(src, dst, tmp_path):
    """A checkpoint of plan A restored onto plan B (the elastic reader)
    holds the model plan A held; the logical view is the JAX package's."""
    (jcp_a, tcp_a), (_, tcp_b) = _plans("uvit", *src), _plans("uvit", *dst)
    a = _port_state(tcp_a, seed=3)
    save_checkpoint(str(tmp_path), 1, a, plan=tcp_a.state_spec())
    b, info = restore_training_state(str(tmp_path), tcp_b,
                                     _port_state(tcp_b, seed=4))
    assert info.elastic
    for key in ("params", "m", "v"):
        pa = a["params"] if key == "params" else a["opt"][key]
        pb = b["params"] if key == "params" else b["opt"][key]
        _assert_bitwise(tree_flatten(tcp_b.merge_params(*pb))[0],
                        tree_flatten(tcp_a.merge_params(*pa))[0])
    # the JAX de-stack of the same values gives the same logical view
    jl = jax_state_to_logical(tree_map(lambda x: x.detach().numpy(), a),
                              jcp_a.state_spec())
    _assert_bitwise(tree_flatten(state_to_logical(a, tcp_a.state_spec()))[0],
                    jax.tree_util.tree_flatten(jl)[0])


def test_jax_d4_checkpoint_restores_elastically_onto_port_d2(tmp_path):
    jcp4, _ = _plans("uvit", 4)
    _, tcp2 = _plans("uvit", 2)
    state = _jax_state(jcp4, seed=7)
    jax_save(str(tmp_path), 9, state, plan=jax_spec(jcp4))
    got, info = restore_training_state(str(tmp_path), tcp2,
                                       _port_state(tcp2, seed=1))
    assert info.step == 9 and info.elastic
    assert info.saved_fingerprint == jcp4.fingerprint()
    assert info.fingerprint == tcp2.fingerprint()
    want = jax.device_get(jcp4.merge_params(*state["params"]))
    _assert_bitwise(tree_flatten(tcp2.merge_params(*got["params"]))[0],
                    jax.tree_util.tree_flatten(want)[0])
    for mom in ("m", "v"):
        want = jax.device_get(jcp4.merge_params(*state["opt"][mom]))
        _assert_bitwise(
            tree_flatten(tcp2.merge_params(*got["opt"][mom]))[0],
            jax.tree_util.tree_flatten(want)[0])
    assert int(got["opt"]["step"]) == int(state["opt"]["step"])


def test_restore_training_state_fast_path_and_missing_spec(tmp_path):
    _, tcp = _plans("uvit", 2)
    state = _port_state(tcp, seed=2)
    save_checkpoint(str(tmp_path), 3, state, plan=tcp.state_spec())
    got, info = restore_training_state(str(tmp_path), tcp,
                                       _port_state(tcp, seed=4))
    assert not info.elastic and info.step == 3
    _assert_bitwise(tree_flatten(got)[0], tree_flatten(state)[0])
    save_checkpoint(str(tmp_path), 5, state)
    with pytest.raises(CheckpointError) as ei:
        restore_training_state(str(tmp_path), tcp, state, step=5)
    assert ei.value.reason == "no-plan-spec"


def test_npz_reader_matches_np_load_and_refuses_other_formats(tmp_path):
    """The reader's straight-from-the-file path gives ``np.load``'s arrays;
    a member no writer here makes (compressed) is refused."""
    from repro_torch.checkpoint.store import _NpzReader
    arrays = {"a0": np.arange(12, dtype=np.float32).reshape(3, 4),
              "a1": np.array(7, np.int32),
              "a2": np.arange(6, dtype=np.uint16).view("V2")}
    np.savez(tmp_path / "x.npz", **arrays)
    np.savez_compressed(tmp_path / "z.npz", **arrays)
    r, z = _NpzReader(str(tmp_path / "x.npz")), \
        _NpzReader(str(tmp_path / "z.npz"))
    try:
        assert sorted(r.keys()) == sorted(arrays)
        for k, want in arrays.items():
            got = r[k]
            assert got.dtype == want.dtype and got.shape == want.shape
            assert got.tobytes() == want.tobytes()
        with pytest.raises(CheckpointError, match="compressed") as ei:
            z["a0"]
        assert ei.value.reason == "format"
    finally:
        r.close()
        z.close()


def test_port_bf16_params_round_trip_through_jax_params(tmp_path):
    """The trainer's bf16 params: a JAX tree converted by params_from_jax
    saves and restores bitwise, and the JAX reader sees the same words."""
    jt = {"w": np.asarray(jnp.linspace(-3, 3, 12, dtype=jnp.bfloat16)
                          .reshape(3, 4))}
    t = params_from_jax(jt, "cpu")
    save_checkpoint(str(tmp_path), 1, t)
    got, _ = restore_checkpoint(str(tmp_path), tree_map(torch.zeros_like, t))
    _assert_bitwise([got["w"]], [jt["w"]])
    with np.load(tmp_path / "step_000000001" / "shard_00000.npz") as z:
        np.testing.assert_array_equal(z["a0"].view(np.int16),
                                      jt["w"].view(np.int16))
