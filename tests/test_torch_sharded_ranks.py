"""The sharded strategy over ranks held to the JAX builders executed under
a real ``(data=2, model=2)`` mesh (fp32, rtol 1e-4, atol 1e-6).

One JAX subprocess on four forced host devices
(``python tests/test_torch_sharded_ranks.py jax OUT``) runs:

- ``build_sharded_train_step`` on the ``sdv2-unet`` smoke config under
  the bundle's own ``train_4k`` plan (FSDP over model x data, batch over
  data), global batch 8, two AdamW steps, each step's DDPM draws saved;
- ``build_forward_step`` and four greedy ``build_sharded_serve_step``
  steps of the ``whisper-base`` smoke config under its ``prefill_32k``
  and ``decode_32k`` plans (FSDP over model, batch over data), batch 4;
- ``build_pp_train_step`` of the ``smollm-360m`` smoke config (its
  ``d_ff`` raised to 256, so that ZeRO's rules shard a leaf of the
  ``[D, L/D, ...]`` stacks) on a ``pp_wave`` plan, P = 2 pipeline
  devices x dp = 2, M = 4, at ZeRO 0 and 2 (the optimizer state sharded
  over data), two steps each (the merged moments too);
- tensor parallelism over ``model`` (``TP_CASES``), each LM smoke config
  on its bundle's own TP plans: h2o-danube-1.8b's ``train_4k`` (two
  AdamW steps, remat), ``prefill_32k`` forward and four ``decode_32k``
  serve steps after a prompt prefilled in one process; a head cut
  through (3 heads of 16, 1.5 a rank; tied embeddings): forward and
  serve; internvl2-2b with a vocab of 255 (its head whole over model)
  and its vision prefix: ``train_4k``; granite-34b (MQA, the GELU MLP):
  forward.

It saves the losses, the params and moments after each step (whole, and
every device's ``addressable_shards``), the tokens, and the steps'
``in_shardings``/``out_shardings`` as spec tuples.  Then one gloo world
of four ranks (``python tests/test_torch_sharded_ranks.py ranks JAX OUT``,
torch on one thread) runs the port's builders on a ``RankGrid`` of the
same shape from JAX's params, batches and draws.  Held: the losses,
params, moments and tokens against JAX, each rank's blocks against the
shards of its mesh device (d, m), the specs against JAX's, and each
group's bytes and calls by collective against their arithmetic.  The
port's one-process builders on the same inputs (in the test process) are
held to the ranks at rtol 1e-5.
"""
import dataclasses
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

REPO = pathlib.Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-4, 1e-6
ONE_RTOL = 1e-5
WORLD, DP, PP = 4, 2, 2
STEPS = 2
UNET_B = 8
WH_B, WH_FRAMES, WH_PROMPT, WH_GEN, WH_MAX = 4, 12, 3, 4, 8
LM_B, LM_S, LM_M = 8, 16, 4
LM_FF = 256         # the smoke LM's d_ff raised so that ZeRO shards a leaf
LR, EPS = 1e-3, 1e-6
# tensor parallelism over model: the LM smoke cases on their bundles' own
# plans, (key, config module, config changes, what runs) -- danube (GQA
# 4:2 aligned on heads, window 8, remat); a head cut through (3 heads of 16 over model=2: 24
# columns a rank, 1.5 heads; MQA; tied embeddings); internvl2 with an odd
# vocab of 255 (head whole over model) and its vision prefix; granite
# (MQA, the GELU MLP with its biases)
TP_CASES = {
    "danube": ("h2o-danube-1.8b", "h2o_danube_1_8b", {"remat": True},
               ("train", "forward", "serve")),
    "cut": ("smollm-360m", "smollm_360m", {"attn": (64, 3, 1, 16)},
            ("forward", "serve")),
    "vl": ("internvl2-2b", "internvl2_2b", {"vocab": 255}, ("train",)),
    "granite": ("granite-34b", "granite_34b", {"mlp_gelu": True},
                ("forward",)),
}
# 24 tokens: the tied head's 2 x 23 rows a rank take the matrix's gather
# (a serve step's 2 rows, the partial logits' all-reduce)
TP_B, TP_S, TP_PROMPT, TP_GEN, TP_MAX = 4, 24, 5, 4, 12
TP_RUNS = {"train": "train_4k", "forward": "prefill_32k",
           "serve": "decode_32k"}
# the pipeline's params after an AdamW step: an entry whose gradient is
# near zero (|g| ~ eps) takes an update m / (sqrt(v) + eps) that fp32
# summation order moves by a fraction of lr (one entry of 65,536 here:
# 3.2e-6 away, with lr 1e-3); held within 1 % of lr there
UPDATE_ATOL = ATOL + 1e-2 * LR
# the pipeline's moments after a step (and the TP caches), held at rtol
# 1e-4 and this share of the leaf's largest entry: one entry of 65,536 of ``m`` after step 0 is
# 8.7e-10 off (6.5e-4 relative), 2.5e-6 of its leaf's largest -- a
# gradient entry near zero, its rows' terms summed in another order (the
# cause of the params' one entry above); a wrong or missing contribution
# moves an entry by about the gradient's own scale
MOMENT_ATOL = 1e-5


def _flatten(tree, prefix=""):
    """``{path: leaf}`` of a dict/list/tuple tree ("/"-joined keys)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
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


def _spec_json(entries):
    return [list(e) if isinstance(e, tuple) else e for e in entries]


def _tp_cfg(factories, attn_config, name):
    """The smoke config of a TP case (JAX's or the port's, from their
    smoke factories and ``AttnConfig``)."""
    key, _, over, _ = TP_CASES[name]
    cfg = factories[key]()[3]
    over = dict(over)
    if "attn" in over:
        over["attn"] = attn_config(*over["attn"])
    return dataclasses.replace(cfg, **over)


def _tp_batch(rng, cfg):
    batch = {"tokens": rng.integers(0, cfg.vocab, (TP_B, TP_S)).astype(
        np.int32)}
    if cfg.vision_prefix:
        batch["prefix_embeds"] = rng.standard_normal(
            (TP_B, cfg.vision_prefix, cfg.d_model)).astype(np.float32)
    return batch


# ---------------------------------------------------------------------------
# the JAX builders under a (data=2, model=2) mesh, in a subprocess
# ---------------------------------------------------------------------------

def _jax_main(out_dir):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    from repro.configs import sdv2_unet as jsd
    from repro.configs import whisper_base as jwh
    from repro.configs.smoke import SMOKE_FACTORIES as JS
    from repro.models import whisper as wh
    from repro.optim import adamw as jadamw
    from repro.runtime.adapters import LMPipelineAdapter
    from repro.runtime.pipeline import PipelineConfig
    from repro.train import steps as jsteps

    mesh = jax.sharding.Mesh(np.array(jax.devices()[:DP * PP]).reshape(
        DP, PP), ("data", "model"))
    coords = {mesh.devices[d, m]: (d, m) for d in range(DP)
              for m in range(PP)}
    opt = jadamw.AdamWConfig(lr=LR, eps=EPS)
    arrays, specs = {}, {}
    is_ns = lambda x: isinstance(x, NamedSharding)

    def put(name, tree, shards=False):
        for k, v in _flatten(jax.device_get(tree)).items():
            arrays[f"{name}|{k}"] = np.asarray(v)
        if shards:
            for k, v in _flatten(tree).items():
                for sh in v.addressable_shards:
                    d, m = coords[sh.device]
                    arrays[f"{name}@{d}{m}|{k}"] = np.asarray(sh.data)

    def put_specs(name, sh):
        flat = jax.tree_util.tree_flatten_with_path(sh, is_leaf=is_ns)[0]
        specs[name] = {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                                for p in path): _spec_json(tuple(s.spec))
                       for path, s in flat}

    rng = np.random.default_rng(0)
    # 1. sdv2-unet smoke, its train_4k plan, two steps
    loss_fn, init_fn, _, cfg = JS["sdv2-unet"]()
    batch = {"latents": rng.standard_normal((UNET_B, 16, 16, 4)).astype(
        np.float32),
        "text_embeds": rng.standard_normal((UNET_B, 7, 16)).astype(
            np.float32)}
    struct = {k: jax.ShapeDtypeStruct(v.shape, jnp.float32)
              for k, v in batch.items()}
    step, _, in_sh, out_sh = jsteps.build_sharded_train_step(
        loss_fn, init_fn, struct, mesh, jsd.PLANS["train_4k"], opt)
    put_specs("unet in", in_sh)
    put_specs("unet out", out_sh)
    params = init_fn(jax.random.PRNGKey(0))
    put("unet init", params)
    for k, v in batch.items():
        arrays[f"unet batch|{k}"] = v
    p = jax.device_put(params, in_sh[0])
    o = jax.device_put(jadamw.adamw_init(params), in_sh[1])
    b = jax.device_put(batch, in_sh[2])
    for i in range(STEPS):
        key = jax.random.fold_in(jax.random.PRNGKey(1), i)
        rt, rn = jax.random.split(key)
        arrays[f"unet t{i}"] = np.asarray(jax.random.uniform(rt, (UNET_B,)))
        arrays[f"unet noise{i}"] = np.asarray(jax.random.normal(
            rn, batch["latents"].shape, jnp.float32))
        p, o, loss = step(p, o, b, key)
        arrays[f"unet loss{i}"] = np.asarray(float(loss))
        put(f"unet params{i}", p, shards=True)
        put(f"unet opt{i}", {"m": o["m"], "v": o["v"]}, shards=True)

    # 2. whisper-base smoke: the prefill plan's forward, the decode plan's
    # greedy steps
    wloss, winit, _, wcfg = JS["whisper-base"]()
    wparams = winit(jax.random.PRNGKey(2))
    put("whisper init", wparams)
    frames = rng.standard_normal((WH_B, WH_FRAMES, 32)).astype(np.float32)
    tokens = rng.integers(0, 256, (WH_B, 10)).astype(np.int32)
    arrays["whisper frames"], arrays["whisper tokens"] = frames, tokens
    wbatch = {"frames": frames, "tokens": tokens}
    fstep, _, in_sh, out_sh = jsteps.build_forward_step(
        wloss, winit, {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
                       for k, v in wbatch.items()}, mesh,
        jwh.PLANS["prefill_32k"])
    put_specs("forward in", in_sh)
    put_specs("forward out", out_sh)
    args = (jax.device_put(wparams, in_sh[0]),
            jax.device_put(wbatch, in_sh[1]), jax.random.PRNGKey(0))
    arrays["whisper loss"] = np.asarray(float(fstep(*args)))

    def decode(params, token, cache):
        logits, dec = wh.decode_step(params, token, cache["enc_out"],
                                     cache["dec"], wcfg)
        return logits, {"enc_out": cache["enc_out"], "dec": dec}

    logits, enc, caches = wh.prefill(wparams, frames, tokens[:, :WH_PROMPT],
                                     wcfg, WH_MAX)
    cache = {"enc_out": enc, "dec": caches}
    sstep, _, in_sh, out_sh = jsteps.build_sharded_serve_step(
        decode, winit, jax.eval_shape(lambda: cache),
        jax.ShapeDtypeStruct((WH_B, 1), jnp.int32), mesh,
        jwh.PLANS["decode_32k"])
    put_specs("serve in", in_sh)
    put_specs("serve out", out_sh)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    sp = jax.device_put(wparams, in_sh[0])
    cache = jax.device_put(cache, in_sh[2])
    toks = [np.asarray(tok)]
    for _ in range(WH_GEN):
        tok, cache = sstep(sp, jax.device_put(tok, in_sh[1]), cache)
        toks.append(np.asarray(tok))
    arrays["whisper serve tokens"] = np.concatenate(toks, 1)

    # 3. smollm-360m smoke on a pp_wave plan, P=2 x dp=2, ZeRO 0 and 2
    from repro.models import lm as jlm
    lcfg = dataclasses.replace(JS["smollm-360m"]()[3], d_ff=LM_FF)
    lparams = jlm.init_lm(jax.random.PRNGKey(3), lcfg)
    put("lm init", lparams)
    ltok = rng.integers(0, lcfg.vocab, (LM_M, LM_B // LM_M, LM_S)).astype(
        np.int32)
    arrays["lm tokens"] = ltok
    for zero in (0, 2):
        plan = jsteps.ParallelPlan(strategy="pp_wave", pp_degree=PP,
                                   microbatches=LM_M, zero_stage=zero)
        adapter = LMPipelineAdapter(lcfg, PipelineConfig(
            num_devices=PP, num_microbatches=LM_M, data_axes=("data",),
            dp_size=DP, remat=True), wave=True)
        pstep, _, in_sh, out_sh = jsteps.build_pp_train_step(
            adapter, mesh, {"tokens": jax.ShapeDtypeStruct(ltok.shape,
                                                           jnp.int32)},
            plan, lambda batch, rng, edge: (batch,), opt)
        put_specs(f"pp{zero} in", in_sh)
        put_specs(f"pp{zero} out", out_sh)
        split = adapter.split_params(lparams)
        p = jax.device_put(split, in_sh[0])
        o = jax.device_put(jadamw.adamw_init(split), in_sh[1])
        for i in range(STEPS):
            p, o, loss = pstep(p, o, {"tokens": ltok}, jax.random.PRNGKey(0))
            arrays[f"pp{zero} loss{i}"] = np.asarray(float(loss))
            put(f"pp{zero} params{i}", adapter.merge_params(*p))
            put(f"pp{zero} opt{i}", {"m": adapter.merge_params(*o["m"]),
                                     "v": adapter.merge_params(*o["v"])})

    # 4. tensor parallelism over model: the TP cases on their plans
    import importlib

    from repro.models.layers import AttnConfig as JAttn
    for c, name in enumerate(TP_CASES):
        _, mod, _, runs_ = TP_CASES[name]
        plans = importlib.import_module(f"repro.configs.{mod}").PLANS
        cfg = _tp_cfg(JS, JAttn, name)
        tloss = lambda p, b, r, cfg=cfg: jlm.lm_loss(p, b, cfg)
        tinit = lambda k, cfg=cfg: jlm.init_lm(k, cfg)
        tparams = tinit(jax.random.PRNGKey(10 + c))
        put(f"tp {name} init", tparams)
        tbatch = _tp_batch(rng, cfg)
        for k, v in tbatch.items():
            arrays[f"tp {name} batch|{k}"] = v
        tstruct = {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
                   for k, v in tbatch.items()}
        if "train" in runs_:
            step, _, in_sh, out_sh = jsteps.build_sharded_train_step(
                tloss, tinit, tstruct, mesh, plans["train_4k"], opt)
            put_specs(f"tp {name} train in", in_sh)
            put_specs(f"tp {name} train out", out_sh)
            p = jax.device_put(tparams, in_sh[0])
            o = jax.device_put(jadamw.adamw_init(tparams), in_sh[1])
            b = jax.device_put(tbatch, in_sh[2])
            for i in range(STEPS):
                p, o, loss = step(p, o, b, jax.random.PRNGKey(0))
                arrays[f"tp {name} loss{i}"] = np.asarray(float(loss))
                put(f"tp {name} params{i}", p, shards=True)
                put(f"tp {name} opt{i}", {"m": o["m"], "v": o["v"]},
                    shards=True)
        if "forward" in runs_:
            fstep, _, in_sh, out_sh = jsteps.build_forward_step(
                tloss, tinit, tstruct, mesh, plans["prefill_32k"])
            put_specs(f"tp {name} forward in", in_sh)
            put_specs(f"tp {name} forward out", out_sh)
            arrays[f"tp {name} forward loss"] = np.asarray(float(fstep(
                jax.device_put(tparams, in_sh[0]),
                jax.device_put(tbatch, in_sh[1]), jax.random.PRNGKey(0))))
        if "serve" in runs_:
            logits, caches = jlm.prefill(
                tparams, tbatch["tokens"][:, :TP_PROMPT], cfg, TP_MAX)
            sstep, _, in_sh, out_sh = jsteps.build_sharded_serve_step(
                lambda p, t, c, cfg=cfg: jlm.decode_step(p, t, c, cfg),
                tinit, jax.eval_shape(lambda: caches),
                jax.ShapeDtypeStruct((TP_B, 1), jnp.int32), mesh,
                plans["decode_32k"])
            put_specs(f"tp {name} serve in", in_sh)
            put_specs(f"tp {name} serve out", out_sh)
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            sp = jax.device_put(tparams, in_sh[0])
            cache = jax.device_put(caches, in_sh[2])
            toks = [np.asarray(tok)]
            for _ in range(TP_GEN):
                tok, cache = sstep(sp, jax.device_put(tok, in_sh[1]), cache)
                toks.append(np.asarray(tok))
            arrays[f"tp {name} serve tokens"] = np.concatenate(toks, 1)
            put(f"tp {name} cache", {k: cache["layers"][k] for k in "kv"},
                shards=True)

    np.savez(os.path.join(out_dir, "jax.npz"), **arrays)
    with open(os.path.join(out_dir, "jax_specs.json"), "w") as f:
        json.dump(specs, f)


# ---------------------------------------------------------------------------
# the port: one gloo world of four ranks, and the one-process builders
# ---------------------------------------------------------------------------

def _port_fns():
    """The port's smoke losses, inits, configs and plans, as the JAX
    subprocess takes them."""
    from repro_torch.configs import sdv2_unet, whisper_base
    from repro_torch.configs.smoke import LM_FACTORIES, RECURRENT_FACTORIES
    from repro_torch.configs.smoke import SMOKE_FACTORIES
    from repro_torch.models import diffusion as dm
    from repro_torch.models import whisper as wh

    ucfg = SMOKE_FACTORIES["sdv2-unet"]()[3]
    wcfg = RECURRENT_FACTORIES["whisper-base"]()[3]
    lcfg = dataclasses.replace(LM_FACTORIES["smollm-360m"]()[3], d_ff=LM_FF)

    def unet_loss(p, b, rng=None, *, t, noise):
        return dm.unet_loss(p, b, t, noise, ucfg)

    def decode(params, token, cache):
        logits, dec = wh.decode_step(params, token, cache["enc_out"],
                                     cache["dec"], wcfg)
        return logits, {"enc_out": cache["enc_out"], "dec": dec}

    return dict(
        ucfg=ucfg, wcfg=wcfg, lcfg=lcfg, unet_loss=unet_loss,
        unet_init=lambda gen, device="cpu": dm.init_unet(gen, ucfg, device),
        unet_plan=sdv2_unet.PLANS["train_4k"],
        wh_loss=lambda p, b, rng=None: wh.whisper_loss(p, b, wcfg),
        wh_init=lambda gen, device="cpu": wh.init_whisper(gen, wcfg, device),
        wh_plans=whisper_base.PLANS, decode=decode)


def _load_jax(jax_dir):
    with np.load(os.path.join(jax_dir, "jax.npz")) as z:
        return {k: z[k] for k in z.files}


def _tree(res, name, struct):
    """JAX's saved tree ``name`` in the structure of the port's ``struct``
    (its lists as lists)."""
    from repro_torch.tree import tree_map_paths
    return tree_map_paths(lambda k, x: torch.from_numpy(
        res[f"{name}|{k}"].copy()).to(x.dtype), struct)


def _meta(x):
    if not isinstance(x, torch.Tensor):
        return x                       # a cache's host pos
    return torch.empty(x.shape, dtype=x.dtype, device="meta")


def _lm_plan(zero):
    from repro_torch.train.steps import ParallelPlan
    return ParallelPlan(strategy="pp_wave", pp_degree=PP, microbatches=LM_M,
                        zero_stage=zero)


def _lm_compiled(dp):
    """smollm smoke on the folded wave of ``auto_pipeline`` (P = 2, fp32
    wire), with ``dp`` replicas at ZeRO-2 (the rows rest sharded)."""
    from repro_torch.models import lm as tlm
    from repro_torch.runtime.adapters import lm_model_fns
    from repro_torch.runtime.compile import auto_pipeline
    cfg = _port_fns()["lcfg"]
    return auto_pipeline(tlm.lm_pipeline_graph(cfg), lm_model_fns(cfg),
                         PP * dp, pipeline_devices=PP, microbatches=LM_M,
                         lam=0.0, dp_size=dp, force_wave=True,
                         wire_dtype="float32",
                         zero_stage=2 if dp > 1 else None)


def _run_builders(mesh, pp_mesh, res, out, doc):
    """The port's four builders on ``mesh`` (a RankGrid, or one process's
    axis sizes; the pipeline's on ``pp_mesh``), from JAX's params, batches
    and draws; each step's loss, the params (the rank's blocks) and
    moments after it, the tokens, the specs and the groups' bytes into
    ``out`` and ``doc``."""
    from repro_torch.configs import lm_common
    from repro_torch.models import whisper as wh
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.runtime.sharding import Spec
    from repro_torch.train import steps as tsteps
    from repro_torch.tree import tree_map

    f = _port_fns()
    opt = AdamWConfig(lr=LR, eps=EPS)

    def specs_json(tree, prefix=""):
        if isinstance(tree, Spec):
            return {prefix: _spec_json(tuple(tree))}
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        out_ = {}
        for k, v in items:
            out_.update(specs_json(v, f"{prefix}/{k}" if prefix else str(k)))
        return out_

    def save(name, tree):
        for k, v in _flatten(tree).items():
            if isinstance(v, torch.Tensor):
                out[f"{name}|{k}"] = v.detach().numpy().copy()

    def counts(step):
        if step.comm is None:
            return None
        return {",".join(k): dict(bytes=dict(g.bytes), calls=dict(g.calls))
                for k, g in step.comm.groups.items()}

    # 1. the UNet's train_4k step
    batch = {k: torch.from_numpy(res[f"unet batch|{k}"])
             for k in ("latents", "text_embeds")}
    step, (p_struct, o_struct, _) = tsteps.build_sharded_train_step(
        f["unet_loss"], f["unet_init"], tree_map(_meta, batch), mesh,
        f["unet_plan"], opt)
    doc["unet in"] = specs_json(step.in_specs)
    doc["unet out"] = specs_json(step.out_specs)
    p = step.shard(_tree(res, "unet init", p_struct), step.in_specs[0])
    o = adamw_init(p)
    doc["unet bytes"] = []
    for i in range(STEPS):
        if step.comm is not None:
            for g in step.comm.groups.values():
                g.reset_bytes()
        p, o, loss = step(p, o, batch, t=torch.from_numpy(res[f"unet t{i}"]),
                          noise=torch.from_numpy(res[f"unet noise{i}"]))
        out[f"unet loss{i}"] = np.asarray(float(loss))
        save(f"unet params{i}", p)
        save(f"unet opt{i}", {"m": o["m"], "v": o["v"]})
        doc["unet bytes"].append(counts(step))

    # 2. whisper's forward (prefill plan) and greedy serve steps
    wp = _tree(res, "whisper init", f["wh_init"](None, "meta"))
    wbatch = {"frames": torch.from_numpy(res["whisper frames"]),
              "tokens": torch.from_numpy(res["whisper tokens"])}
    fstep, _ = tsteps.build_forward_step(
        f["wh_loss"], f["wh_init"], tree_map(_meta, wbatch), mesh,
        f["wh_plans"]["prefill_32k"])
    doc["forward in"] = specs_json(fstep.in_specs)
    doc["forward out"] = specs_json(fstep.out_specs)
    out["whisper loss"] = np.asarray(float(fstep(
        fstep.shard(wp, fstep.in_specs[0]), wbatch)))
    doc["forward bytes"] = counts(fstep)
    with torch.inference_mode():
        logits, enc, dec = wh.prefill(wp, wbatch["frames"],
                                      wbatch["tokens"][:, :WH_PROMPT],
                                      f["wcfg"], WH_MAX)
    cache = {"enc_out": enc, "dec": dec}
    sstep, _ = tsteps.build_sharded_serve_step(
        f["decode"], f["wh_init"], tree_map(_meta, cache),
        torch.empty((WH_B, 1), dtype=torch.int32, device="meta"), mesh,
        f["wh_plans"]["decode_32k"])
    doc["serve in"] = specs_json(sstep.in_specs)
    doc["serve out"] = specs_json(sstep.out_specs)
    sp = sstep.shard(wp, sstep.in_specs[0])
    cache = sstep.shard(cache, sstep.in_specs[2])
    tok = torch.argmax(logits, -1).to(torch.int32)
    toks = [tok]
    rows = []
    for _ in range(WH_GEN):
        mine, cache = sstep(sp, tok, cache)
        rows.append(mine)
        tok = sstep.gather_rows(mine)
        toks.append(tok)
    out["whisper serve tokens"] = torch.cat(toks, 1).numpy()
    out["whisper serve rows"] = torch.cat(rows, 1).numpy()
    save("whisper cache", cache)

    # 3. smollm smoke on pp_wave, ZeRO 0 and 2 (the plan's)
    bundle = lm_common.lm_bundle("smollm-smoke", f["lcfg"], {})
    lp = _tree(res, "lm init", bundle.init_fn(None, "meta"))
    tokens = {"tokens": torch.from_numpy(res["lm tokens"])}
    for zero in (0, 2, "cp"):
        plan = _lm_plan(2 if zero == "cp" else zero)
        if zero == "cp":
            adapter = _lm_compiled(1 if isinstance(pp_mesh, dict) else DP)
            mbs = lambda batch, rng, edge: (batch, {})
        else:
            adapter = bundle.make_adapter(plan, pp_mesh)
            mbs = bundle.make_microbatches
        pstep, _ = tsteps.build_pp_train_step(
            adapter, pp_mesh, tree_map(_meta, tokens), plan, mbs, opt)
        doc[f"pp{zero} in"] = specs_json(pstep.in_specs)
        doc[f"pp{zero} out"] = specs_json(pstep.out_specs)
        if not hasattr(pstep, "split_params"):     # one process
            pp = adapter.split_params(tree_map(torch.clone, lp))
            view = pp
        else:
            pp = pstep.split_params(lp)
            view = pstep.optimizer_view(pp)
        po = adamw_init(view)
        for i in range(STEPS):
            pp, po, loss = pstep(pp, po, tokens)
            out[f"pp{zero} loss{i}"] = np.asarray(float(loss))
            save(f"pp{zero} params{i}", pp)
            save(f"pp{zero} opt{i}", {"m": po["m"], "v": po["v"]})
        if hasattr(pstep, "state"):
            data = pstep.state["data"]
            doc[f"pp{zero} data"] = dict(data.bytes)

    # 4. tensor parallelism over model: the TP cases on their plans
    _run_tp(mesh, res, out, doc, specs_json, save, counts)
    return out, doc


def _run_tp(mesh, res, out, doc, specs_json, save, counts):
    """The TP cases through the port's three sharded builders on ``mesh``
    from JAX's params and batches: losses, the rank's blocks after each
    train step, greedy tokens and cache blocks, specs, and the groups'
    bytes and calls (each train step's, the forward's, the serve loop's)."""
    import importlib

    from repro_torch.configs import lm_common
    from repro_torch.configs.smoke import LM_FACTORIES
    from repro_torch.models import lm as tlm
    from repro_torch.models.layers import AttnConfig
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import steps as tsteps
    from repro_torch.tree import tree_map

    opt = AdamWConfig(lr=LR, eps=EPS)

    def reset(step):
        for g in (step.comm.groups.values() if step.comm else ()):
            g.reset_bytes()

    for name, (key, mod, _, runs_) in TP_CASES.items():
        plans = importlib.import_module(f"repro_torch.configs.{mod}").PLANS
        cfg = _tp_cfg(LM_FACTORIES, AttnConfig, name)
        bundle = lm_common.lm_bundle(key, cfg, plans)
        params = _tree(res, f"tp {name} init", bundle.init_fn(None, "meta"))
        batch = {k: torch.from_numpy(res[f"tp {name} batch|{k}"])
                 for k in ("tokens", "prefix_embeds")
                 if f"tp {name} batch|{k}" in res}
        meta = tree_map(_meta, batch)
        if "train" in runs_:
            step, _ = tsteps.build_sharded_train_step(
                bundle.loss_fn, bundle.init_fn, meta, mesh,
                plans["train_4k"], opt)
            doc[f"tp {name} train in"] = specs_json(step.in_specs)
            doc[f"tp {name} train out"] = specs_json(step.out_specs)
            p = step.shard(tree_map(torch.clone, params), step.in_specs[0])
            o = adamw_init(p)
            doc[f"tp {name} train bytes"] = []
            for i in range(STEPS):
                reset(step)
                p, o, loss = step(p, o, batch)
                out[f"tp {name} loss{i}"] = np.asarray(float(loss))
                save(f"tp {name} params{i}", p)
                save(f"tp {name} opt{i}", {"m": o["m"], "v": o["v"]})
                doc[f"tp {name} train bytes"].append(counts(step))
        if "forward" in runs_:
            fstep, _ = tsteps.build_forward_step(
                bundle.loss_fn, bundle.init_fn, meta, mesh,
                plans["prefill_32k"])
            doc[f"tp {name} forward in"] = specs_json(fstep.in_specs)
            doc[f"tp {name} forward out"] = specs_json(fstep.out_specs)
            out[f"tp {name} forward loss"] = np.asarray(float(fstep(
                fstep.shard(params, fstep.in_specs[0]), batch)))
            doc[f"tp {name} forward bytes"] = counts(fstep)
        if "serve" in runs_:
            with torch.inference_mode():
                logits, caches = tlm.prefill(
                    params, batch["tokens"][:, :TP_PROMPT], cfg, TP_MAX)
            sstep, _ = tsteps.build_sharded_serve_step(
                bundle.make_decode_fn(None), bundle.init_fn,
                tree_map(_meta, caches),
                torch.empty((TP_B, 1), dtype=torch.int32, device="meta"),
                mesh, plans["decode_32k"])
            doc[f"tp {name} serve in"] = specs_json(sstep.in_specs)
            doc[f"tp {name} serve out"] = specs_json(sstep.out_specs)
            sp = sstep.shard(params, sstep.in_specs[0])
            cache = sstep.shard(caches, sstep.in_specs[2])
            tok = torch.argmax(logits, -1).to(torch.int32)
            toks, rows = [tok], []
            for i in range(TP_GEN):
                reset(sstep)
                mine, cache = sstep(sp, tok, cache)
                if i == 0:
                    doc[f"tp {name} serve bytes"] = counts(sstep)
                rows.append(mine)
                tok = sstep.gather_rows(mine)
                toks.append(tok)
            out[f"tp {name} serve tokens"] = torch.cat(toks, 1).numpy()
            out[f"tp {name} serve rows"] = torch.cat(rows, 1).numpy()
            save(f"tp {name} cache", {k: cache["layers"][k] for k in "kv"})


def _rank_main(jax_dir, out_dir):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_rank_grid

    torch.set_num_threads(1)
    rank = int(os.environ["RANK"])
    dist.init_process_group("gloo", rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=120))
    grid = make_rank_grid(PP, dp=DP)
    out, doc = _run_builders(grid, grid, _load_jax(jax_dir), {}, {})
    doc["coords"] = [grid.data_index, grid.pipe_index]
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
        json.dump(doc, fh)
    dist.barrier()
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's run, the four ranks' and the one-process builders'."""
    base = tmp_path_factory.mktemp("sharded_ranks")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO / "src")] + [p for p in os.environ.get(
            "PYTHONPATH", "").split(os.pathsep) if p]),
        OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="", JAX_PLATFORMS="cpu")
    jax_env = dict(env, XLA_FLAGS=" ".join(
        [os.environ.get("XLA_FLAGS", ""),
         f"--xla_force_host_platform_device_count={WORLD}"]).strip())
    jax_run = subprocess.run([sys.executable, __file__, "jax", str(base)],
                             env=jax_env, cwd=str(REPO), capture_output=True,
                             text=True, timeout=900)
    assert jax_run.returncode == 0, jax_run.stderr[-4000:]
    env.update(WORLD_SIZE=str(WORLD), MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()))
    procs = [subprocess.Popen(
        [sys.executable, __file__, "ranks", str(base), str(base)],
        env=dict(env, RANK=str(r)), cwd=str(REPO), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    for r, p in enumerate(procs):
        out, _ = p.communicate(timeout=600)
        assert p.returncode == 0, f"rank {r}:\n{out[-4000:]}"
    res = _load_jax(base)
    with open(base / "jax_specs.json") as fh:
        specs = json.load(fh)
    ranks, docs = {}, {}
    for r in range(WORLD):
        with np.load(base / f"rank{r}.npz") as z:
            ranks[r] = {k: z[k] for k in z.files}
        docs[r] = json.loads((base / f"rank{r}.json").read_text())
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one, one_doc = _run_builders({"data": 1, "model": 1},
                                     {"data": 1, "model": PP}, res, {}, {})
    finally:
        torch.set_num_threads(n)
    return dict(jax=res, specs=specs, ranks=ranks, docs=docs, one=one,
                one_doc=one_doc)


def _close(got, want, what, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=what)


def _leaves(res, name):
    pre = f"{name}|"
    return {k[len(pre):]: v for k, v in res.items() if k.startswith(pre)}


def _coords(runs, r):
    return tuple(runs["docs"][r]["coords"])


def _one_block(runs, name, r, step_specs):
    """The one-process run's whole ``name`` cut to rank r's blocks."""
    from repro_torch.runtime.sharding import spec_view
    d, m = _coords(runs, r)
    whole = _leaves(runs["one"], name)
    return {k: np.asarray(spec_view(torch.from_numpy(v), step_specs[k],
                                    {"data": d, "model": m},
                                    {"data": DP, "model": PP}))
            for k, v in whole.items()}


@pytest.mark.parametrize("step", range(STEPS))
def test_unet_train_step_over_ranks_matches_jax(runs, step):
    """Every rank's loss equals JAX's global loss; each rank's param and
    moment blocks equal the ``addressable_shards`` of its mesh device
    (d, m) after the step."""
    want = float(runs["jax"][f"unet loss{step}"])
    for r in range(WORLD):
        _close(float(runs["ranks"][r][f"unet loss{step}"]), want,
               f"rank {r} loss")
        d, m = _coords(runs, r)
        for name in (f"unet params{step}", f"unet opt{step}"):
            got = _leaves(runs["ranks"][r], name)
            shards = _leaves(runs["jax"], f"{name}@{d}{m}")
            assert sorted(got) == sorted(shards), name
            for k, v in got.items():
                assert v.shape == shards[k].shape, (r, k)
                _close(v, shards[k], f"rank {r} {name} {k}")


def _spec_tuple(entries):
    return tuple(tuple(e) if isinstance(e, list) else e for e in entries)


def test_unet_blocks_over_ranks_match_the_one_process_step(runs):
    """The ranks' blocks, cut from the one-process step's whole params and
    moments by the same specs, at rtol 1e-5; the losses too."""
    specs = {k: _spec_tuple(v) for k, v in
             runs["specs"]["unet in"].items()}
    for step in range(STEPS):
        want = float(runs["one"][f"unet loss{step}"])
        for r in range(WORLD):
            _close(float(runs["ranks"][r][f"unet loss{step}"]), want,
                   f"rank {r} loss", rtol=ONE_RTOL)
            for name, pre in ((f"unet params{step}", "0/"),
                              (f"unet opt{step}", "1/")):
                sp = {k[len(pre):]: v for k, v in specs.items()
                      if k.startswith(pre)}
                blocks = _one_block(runs, name, r, sp)
                for k, v in _leaves(runs["ranks"][r], name).items():
                    _close(v, blocks[k], f"rank {r} {name} {k}",
                           rtol=ONE_RTOL)


SPEC_SETS = ["unet in", "unet out", "forward in", "forward out", "serve in",
             "serve out", "pp0 in", "pp0 out", "pp2 in", "pp2 out"] + [
    f"tp {name} {run} {io}" for name, case in TP_CASES.items()
    for run in case[3] for io in ("in", "out")]


@pytest.mark.parametrize("name", SPEC_SETS)
def test_step_specs_equal_jax_shardings(runs, name):
    """``step.in_specs``/``out_specs`` over the grid equal the JAX
    builder's ``in_shardings``/``out_shardings``, leaf for leaf, on every
    rank (the one-process specs have the same leaves)."""
    want = runs["specs"][name]
    for r in range(WORLD):
        assert runs["docs"][r][name] == want, (r, name)
    assert sorted(runs["one_doc"][name]) == sorted(want)


def test_whisper_forward_and_serve_over_ranks_match_jax(runs):
    """The prefill plan's loss on every rank against JAX's and the one
    process's; the decode plan's greedy tokens equal JAX's and the one
    process's, each rank returning its data replica's rows."""
    want = float(runs["jax"]["whisper loss"])
    toks = runs["jax"]["whisper serve tokens"]
    np.testing.assert_array_equal(runs["one"]["whisper serve tokens"], toks)
    for r in range(WORLD):
        got = runs["ranks"][r]
        _close(float(got["whisper loss"]), want, f"rank {r} forward")
        _close(float(got["whisper loss"]), float(runs["one"]["whisper loss"]),
               f"rank {r} forward", rtol=ONE_RTOL)
        np.testing.assert_array_equal(got["whisper serve tokens"], toks)
        d, _ = _coords(runs, r)
        rows = slice(d * WH_B // DP, (d + 1) * WH_B // DP)
        np.testing.assert_array_equal(got["whisper serve rows"],
                                      toks[rows, 1:])
        # the caches hold the rank's rows only
        assert got["whisper cache|enc_out"].shape[0] == WH_B // DP
        _close(got["whisper cache|dec/k"],
               runs["one"]["whisper cache|dec/k"][:, rows],
               f"rank {r} k cache", rtol=ONE_RTOL)


def _merge_lm(runs, name):
    """The pp ranks' ``[1, rows, ...]`` stacks (data index 0's) put back
    over the pipeline and merged with the edge into whole LM params."""
    from repro_torch.runtime.adapters import LMPipelineAdapter
    from repro_torch.runtime.pipeline import PipelineConfig
    leaves = {r: _leaves(runs["ranks"][r], name) for r in range(PP)}
    stacks, edge = [{}, {}], {}
    for k, v in leaves[0].items():
        top, *rest = k.split("/")
        if top == "0":
            stacks[int(rest[0])]["/".join(rest[1:])] = torch.from_numpy(
                np.concatenate([leaves[p][k] for p in range(PP)], 0))
        else:
            edge["/".join(rest)] = torch.from_numpy(v)
    adapter = LMPipelineAdapter(_port_fns()["lcfg"], PipelineConfig(
        num_devices=PP, num_microbatches=LM_M), wave=True)
    return adapter.merge_params(tuple(_unflatten(s) for s in stacks),
                                _unflatten(edge))


def _merge_lm_moments(runs, name):
    """``{"m/<path>": whole, "v/<path>": whole}``: the pp ranks' moments
    merged back into whole LM trees.  At ZeRO-2 of the plan a sharded
    leaf's moments are its data replica's shard of the rank's rows (along
    the dim where they are narrower than the rows): put back over the data
    replicas first."""
    from repro_torch.tree import tree_paths
    pname = name.replace(" opt", " params")
    out = {}
    for mv in ("m", "v"):
        ranks = {}
        for r in range(PP):
            rows = _leaves(runs["ranks"][r], pname)
            mine = {}
            for k, x in _leaves(runs["ranks"][r], name).items():
                if not k.startswith(f"{mv}/"):
                    continue
                k = k[2:]
                dims = [i for i in range(x.ndim)
                        if x.shape[i] != rows[k].shape[i]]
                if dims:
                    x = np.concatenate(
                        [_leaves(runs["ranks"][d * PP + r], name)[f"{mv}/{k}"]
                         for d in range(DP)], dims[0])
                mine[f"{pname}|{k}"] = x
            ranks[r] = mine
        for k, v in tree_paths(_merge_lm({"ranks": ranks}, pname)):
            out[f"{mv}/{k}"] = v.numpy()
    return out


@pytest.mark.parametrize("zero", [0, 2, "cp"])
def test_pp_train_step_over_ranks_matches_jax(runs, zero):
    """``build_pp_train_step`` over the grid (``make_adapter``'s rank
    adapter at the plan's ZeRO 0 and 2, and a ``CompiledPipeline`` at
    ZeRO-2 with its rows at rest sharded) against JAX's under the mesh:
    every rank's loss, and (the adapters) the params merged back from the
    ranks after each step, and the AdamW moments ``m`` and ``v`` at rtol
    1e-4 (``MOMENT_ATOL`` of the leaf's largest entry), so that a wrong
    update cannot hide under the params' ``UPDATE_ATOL``; against the
    one-process step's losses at rtol 1e-5."""
    from repro_torch.tree import tree_paths
    jz = 2 if zero == "cp" else zero
    for step in range(STEPS):
        want = float(runs["jax"][f"pp{jz} loss{step}"])
        for r in range(WORLD):
            got = float(runs["ranks"][r][f"pp{zero} loss{step}"])
            _close(got, want, f"rank {r} loss {step}")
            _close(got, float(runs["one"][f"pp{zero} loss{step}"]),
                   f"rank {r} loss {step}", rtol=ONE_RTOL)
        if zero == "cp":
            continue
        merged = dict(tree_paths(_merge_lm(runs, f"pp{zero} params{step}")))
        jp = _leaves(runs["jax"], f"pp{zero} params{step}")
        assert sorted(merged) == sorted(jp)
        for k, v in merged.items():
            _close(v.numpy(), jp[k], f"step {step} {k}", atol=UPDATE_ATOL)
        moments = _merge_lm_moments(runs, f"pp{zero} opt{step}")
        jm = _leaves(runs["jax"], f"pp{zero} opt{step}")
        assert sorted(moments) == sorted(jm)
        for k, v in moments.items():
            _close(v, jm[k], f"step {step} {k}",
                   atol=MOMENT_ATOL * float(np.abs(jm[k]).max()))


def _bytes_want(specs: dict, shapes: dict, esize: int = 4):
    """(whole bytes of the split leaves, of the whole ones)."""
    split = whole = 0
    for k, sp in specs.items():
        n = int(np.prod(shapes[k])) * esize
        if any(e is not None for e in sp):
            split += n
        else:
            whole += n
    return split, whole


def test_group_bytes_match_their_arithmetic(runs):
    """The UNet step's FSDP group (model x data, the world): one
    all-gather of the split leaves' whole bytes, one reduce-scatter of
    their gradients', two all-reduces (the whole leaves' gradients in
    fp32, the loss and the squared norm); whisper's forward: one
    all-gather over ``model``, the loss's all-reduce over the world;
    ZeRO-2 of the plan moves the updated moment shards' rows back over
    ``data``."""
    specs = {k[2:]: _spec_tuple(v) for k, v in
             runs["specs"]["unet in"].items() if k.startswith("0/")}
    shapes = {k: v.shape for k, v in _leaves(runs["jax"],
                                             "unet init").items()}
    split, whole = _bytes_want(specs, shapes)
    want = {"model,data": {
        "bytes": {"all_gather": split, "reduce_scatter": split,
                  "all_reduce": whole + 8},
        "calls": {"all_gather": 1, "reduce_scatter": 1, "all_reduce": 2}}}
    wspecs = {k[2:]: _spec_tuple(v) for k, v in
              runs["specs"]["forward in"].items() if k.startswith("0/")}
    wshapes = {k: v.shape for k, v in _leaves(runs["jax"],
                                              "whisper init").items()}
    wsplit, _ = _bytes_want(wspecs, wshapes)
    fwant = {"model": {"bytes": {"all_gather": wsplit, "reduce_scatter": 0,
                                 "all_reduce": 0},
                       "calls": {"all_gather": 1, "reduce_scatter": 0,
                                 "all_reduce": 0}},
             "data,model": {"bytes": {"all_gather": 0, "reduce_scatter": 0,
                                      "all_reduce": 4},
                            "calls": {"all_gather": 0, "reduce_scatter": 0,
                                      "all_reduce": 1}}}
    for r in range(WORLD):
        doc = runs["docs"][r]
        assert doc["unet bytes"] == [want] * STEPS, r
        assert doc["forward bytes"] == fwant, r
        assert doc["pp0 data"]["all_gather"] == 0, r
        assert doc["pp2 data"]["all_gather"] > 0, r
        # ZeRO-2 of the plan: a sharded leaf's moments are its data
        # replica's half of the rank's rows
        m = runs["ranks"][r]["pp2 opt0|m/0/0/ffn/w_up"]
        p = runs["ranks"][r]["pp2 params0|0/0/ffn/w_up"]
        assert m.shape == p.shape[:-1] + (LM_FF // DP,), (m.shape, p.shape)
    assert runs["one_doc"]["unet bytes"] == [None] * STEPS


# ---------------------------------------------------------------------------
# tensor parallelism over model
# ---------------------------------------------------------------------------

def _tp_runs(run):
    return [n for n, case in TP_CASES.items() if run in case[3]]


def _tp_specs(runs, name, run, pre):
    return {k[len(pre):]: _spec_tuple(v) for k, v in
            runs["specs"][f"tp {name} {run} in"].items() if k.startswith(pre)}


@pytest.mark.parametrize("step", range(STEPS))
@pytest.mark.parametrize("name", _tp_runs("train"))
def test_tp_train_step_over_ranks_matches_jax(runs, name, step):
    """The train_4k plan (TP over model, FSDP over data): every rank's
    loss equals JAX's global loss; each rank's param and moment blocks --
    TP blocks of ``wq/wk/wv/wo``, the FFN, ``embed``/``head``, their FSDP
    dims over data -- equal the ``addressable_shards`` of its mesh device
    (d, m) after the step, and the one-process step's whole params and
    moments cut by the same specs (its loss at rtol 1e-5).  The blocks at
    rtol 1e-4, the params at ``UPDATE_ATOL`` (the AdamW update of a
    near-zero gradient entry moves with the sums' order: one entry of
    4,096 of ``wo`` 1.9e-6 off), the moments at ``MOMENT_ATOL`` of the
    leaf's largest entry."""
    want = float(runs["jax"][f"tp {name} loss{step}"])
    for r in range(WORLD):
        got = runs["ranks"][r]
        _close(float(got[f"tp {name} loss{step}"]), want, f"rank {r} loss")
        _close(float(got[f"tp {name} loss{step}"]),
               float(runs["one"][f"tp {name} loss{step}"]),
               f"rank {r} loss", rtol=ONE_RTOL)
        d, m = _coords(runs, r)
        for what, pre in (("params", "0/"), ("opt", "1/")):
            key = f"tp {name} {what}{step}"
            mine = _leaves(got, key)
            shards = _leaves(runs["jax"], f"{key}@{d}{m}")
            assert sorted(mine) == sorted(shards), key
            blocks = _one_block(runs, key, r,
                                _tp_specs(runs, name, "train", pre))
            for k, v in mine.items():
                assert v.shape == shards[k].shape, (r, k)
                atol = (UPDATE_ATOL if what == "params" else
                        MOMENT_ATOL * float(np.abs(shards[k]).max()))
                _close(v, shards[k], f"rank {r} {key} {k}", atol=atol)
                _close(v, blocks[k], f"rank {r} {key} {k}", atol=atol)


@pytest.mark.parametrize("name", _tp_runs("forward"))
def test_tp_forward_over_ranks_matches_jax(runs, name):
    """The prefill_32k plan's loss on every rank against JAX's under the
    mesh and the one process's."""
    want = float(runs["jax"][f"tp {name} forward loss"])
    for r in range(WORLD):
        got = float(runs["ranks"][r][f"tp {name} forward loss"])
        _close(got, want, f"rank {r} forward")
        _close(got, float(runs["one"][f"tp {name} forward loss"]),
               f"rank {r} forward", rtol=ONE_RTOL)


@pytest.mark.parametrize("name", _tp_runs("serve"))
def test_tp_serve_over_ranks_matches_jax(runs, name):
    """The decode_32k plan's greedy tokens (the vocab-parallel argmax, or
    the tied head's whole logits) equal JAX's and the one process's, each
    rank returning its data replica's rows; each rank's K/V cache block
    (its rows, and its kv heads where the cache splits over model) equals
    its mesh device's ``addressable_shards`` after the steps (atol
    ``MOMENT_ATOL`` of the largest entry: an entry is a sum of ``d``
    products, one of 1,536 near zero is 2.4e-6 off)."""
    toks = runs["jax"][f"tp {name} serve tokens"]
    np.testing.assert_array_equal(runs["one"][f"tp {name} serve tokens"],
                                  toks)
    for r in range(WORLD):
        got = runs["ranks"][r]
        np.testing.assert_array_equal(got[f"tp {name} serve tokens"], toks)
        d, m = _coords(runs, r)
        rows = slice(d * TP_B // DP, (d + 1) * TP_B // DP)
        np.testing.assert_array_equal(got[f"tp {name} serve rows"],
                                      toks[rows, 1:])
        for k in "kv":
            shard = runs["jax"][f"tp {name} cache@{d}{m}|{k}"]
            mine = got[f"tp {name} cache|{k}"]
            assert mine.shape == shard.shape, (r, k, mine.shape)
            _close(mine, shard, f"rank {r} cache {k}",
                   atol=MOMENT_ATOL * float(np.abs(shard).max()))


@pytest.mark.parametrize("name", list(TP_CASES))
def test_tp_model_group_bytes_match_their_arithmetic(runs, name):
    """Each run's ``model`` group (the TP collectives) against
    ``tensor_parallel.lm_traffic``, on every rank; no all-gather of a
    weight's TP dim (the tied matrix aside: the arithmetic has no other),
    and the FSDP gathers stay on the ``data`` group."""
    from repro_torch.configs.smoke import LM_FACTORIES
    from repro_torch.models.layers import AttnConfig
    from repro_torch.runtime.tensor_parallel import lm_traffic
    cfg = _tp_cfg(LM_FACTORIES, AttnConfig, name)
    B = TP_B // DP
    for r in range(WORLD):
        doc = runs["docs"][r]
        for run in TP_CASES[name][3]:
            got = doc[f"tp {name} {run} bytes"]
            steps_ = got if run == "train" else [got]
            for st in steps_:
                want = lm_traffic(
                    cfg, run, B=B, S=TP_S, tp=PP, esize=4,
                    prefix=cfg.vision_prefix if run == "train" else 0)
                assert st["model"] == want, (r, run, st["model"])
                assert st["data"]["calls"]["all_gather"] >= 1, (r, run)


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        _jax_main(sys.argv[2])
    elif sys.argv[1] == "ranks":
        _rank_main(sys.argv[2], sys.argv[3])
