"""The port's wave executor and trainer held to the JAX package's UViT and
Hunyuan-DiT.

The JAX package draws the parameters and the DDPM microbatches; the port
runs them through ``auto_pipeline`` and its table-driven wave executor
(all D pipeline devices in one process, kernels switched on, which on the
CPU run their plain versions), and its loss and merged gradients must
equal the single-device JAX UViT loss and gradients: fp32 wire at rtol
1e-4, the bar of the JAX package's own differentials, and the bf16 wire
against the fp32 wire at rtol 5e-2 / atol 1e-3 (every hop rounds the
activation, and its cotangent, to bf16).

Hunyuan-DiT's loss is held to the end-to-end JAX ``hunyuan_apply``, and
its gradients, every leaf including the zero ones, to a JAX block loop
that takes the adaLN ``temb`` and the text ``ctx`` as data, as the
executor does (the JAX package's ``wave-hunyuan`` differential: ``temb``
is computed outside the loss, so ``time_mlp`` gets no gradient there).

Also here: the trainer for a few steps on the CPU, the import
boundary of the port (no jax, nothing of ``repro``), and ``chip_smoke.py``
refusing to run without a card.
"""
import dataclasses
import functools
import json
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import diffusion as jdm
from repro.runtime.adapters import make_diffusion_microbatches as jax_mbs
from repro_torch.convert import params_from_jax
from repro_torch.kernels import launch_counts
from repro_torch.models.diffusion import (HunyuanDiTConfig, ddpm_draw,
                                          hunyuan_pipeline_graph, UViTConfig,
                                          uvit_pipeline_graph)
from repro_torch.runtime.adapters import (diffusion_model_fns,
                                          make_diffusion_microbatches)
from repro_torch.runtime.compile import auto_pipeline
from repro_torch.tree import tree_map, tree_paths

REPO = pathlib.Path(__file__).resolve().parents[1]
RTOL = 1e-4
WIRE_RTOL, WIRE_ATOL = 5e-2, 1e-3
KEY = jax.random.PRNGKey(0)

# (D, fwd_times, M, V, use_ilp): the wave-even / wave-uneven shapes of the
# JAX package's auto_pipeline differentials (UViT, 8 blocks) at D = 2, the
# even and M < D (wave-short) shapes at D = 4, the interleaved wave (V = 2:
# two (enc, dec) stage-slot pairs per device, the plan the tuner picks on
# two devices) and the exact ILP schedule (the JAX package's wave-ilp)
WAVES = {
    "wave-even-D2": (2, None, 4, 1, False),
    "wave-uneven-D2": (2, [3, 1, 1, 1, 1, 1, 1, 3], 4, 1, False),
    "wave-even-D4": (4, None, 4, 1, False),
    "wave-short-D4": (4, None, 3, 1, False),
    "wave-interleaved-D2": (2, None, 4, 2, False),
    "wave-ilp-D2": (2, None, 2, 1, True),
}
CFG_KW = dict(img_size=8, in_ch=4, patch=2, d_model=32, n_layers=8,
              n_heads=4, d_ff=64, n_classes=10)
JCFG = jdm.UViTConfig("t", **CFG_KW)


@functools.lru_cache(maxsize=None)
def _jax_microbatch_step():
    """One microbatch's JAX loss and grads, jitted once for every plan."""
    def one(p, xt, t, labels, noise):
        pred = jdm.uvit_apply(p, xt, t, {"labels": labels}, JCFG)
        return jnp.mean(jnp.square(pred - noise))
    return jax.jit(jax.value_and_grad(one))


@functools.lru_cache(maxsize=None)
def _jax_params():
    return jax.jit(lambda k: jdm.init_uvit(k, JCFG))(KEY)


@functools.lru_cache(maxsize=None)
def _jax_reference(M):
    """JAX params, microbatches and the single-device loss + grads: the mean
    over microbatches of each one's loss."""
    params = _jax_params()
    B = 2 * M
    batch = {"latents": jax.random.normal(KEY, (B, 8, 8, 4)),
             "labels": jax.random.randint(KEY, (B,), 0, 10)}
    mb, aux = jax.jit(lambda b: jax_mbs(b, KEY, M, JCFG, "uvit"))(batch)
    step = _jax_microbatch_step()
    outs = [step(params, mb["xt"][m], aux["t"][m], mb["labels"][m],
                 mb["noise"][m]) for m in range(M)]
    loss = sum(float(o[0]) for o in outs) / M
    grads = jax.tree.map(lambda *g: sum(g) / M, *(o[1] for o in outs))
    flat = jax.tree_util.tree_flatten_with_path(grads)[0]
    grads = {"/".join(str(k.key) for k in path): np.asarray(v)
             for path, v in flat}
    return jax.device_get(params), jax.device_get((mb, aux)), loss, grads


def _port_step(cp, params_np, mb_aux):
    """Loss and model-space grads of one port executor step (a leaf the
    step never reads gets a zero gradient, as under jax.grad)."""
    stacks, edge = cp.split_params(params_from_jax(params_np, "cpu"))
    p = tree_map(lambda x: x.requires_grad_(True), (stacks, edge))
    mb, aux = params_from_jax(mb_aux, "cpu")
    (enc, dec), edge = p
    loss = cp.build()(enc, dec, edge, mb, aux)
    loss.backward()
    grads = cp.merge_params(*tree_map(
        lambda x: x.grad if x.grad is not None else torch.zeros_like(x), p))
    return float(loss.detach()), dict(tree_paths(grads))


@pytest.fixture(scope="module", params=sorted(WAVES))
def wave(request):
    """The JAX reference, the port's plan and its fp32-wire step."""
    D, ft, M, V, ilp = WAVES[request.param]
    params, mb_aux, loss, grads = _jax_reference(M)
    cfg = UViTConfig("t", use_skip_kernel=True, use_flash=True, **CFG_KW)
    cp = auto_pipeline(uvit_pipeline_graph(cfg, fwd_times=ft),
                       diffusion_model_fns(cfg), D, pipeline_devices=D,
                       microbatches=M, lam=0.0, wire_dtype="float32",
                       interleave=V, use_ilp=ilp)
    assert cp.partition.num_stages == 2 * V * D and cp.layout.V == V
    assert (len(set(cp.layout.counts)) > 1) == (ft is not None)
    before = launch_counts()
    port = _port_step(cp, params, mb_aux)
    assert launch_counts() == before          # CPU: plain versions only
    return dict(name=request.param, cp=cp, params=params, mb_aux=mb_aux,
                loss=loss, grads=grads, port=port)


def _variant(w, **pcfg):
    cp = w["cp"]
    return _port_step(dataclasses.replace(
        cp, pcfg=dataclasses.replace(cp.pcfg, **pcfg)), w["params"],
        w["mb_aux"])


def test_wave_executor_matches_jax_single_device(wave):
    name, (got_loss, got) = wave["name"], wave["port"]
    np.testing.assert_allclose(got_loss, wave["loss"], rtol=RTOL,
                               err_msg=name)
    assert sorted(got) == sorted(wave["grads"])
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), wave["grads"][k], rtol=RTOL,
                                   atol=1e-6, err_msg=f"{name}: {k}")


def test_wave_bf16_wire_close_to_fp32_wire(wave):
    name, (lf, gf) = wave["name"], wave["port"]
    lb, gb = _variant(wave, wire_dtype="bfloat16")
    np.testing.assert_allclose(lb, lf, rtol=WIRE_RTOL, err_msg=name)
    for k in gf:
        np.testing.assert_allclose(gb[k].numpy(), gf[k].numpy(),
                                   rtol=WIRE_RTOL, atol=WIRE_ATOL,
                                   err_msg=f"{name}[bf16-vs-fp32]: {k}")


# ---------------------------------------------------------------------------
# Hunyuan-DiT: the wave-hunyuan differential of the JAX package
# ---------------------------------------------------------------------------

HCFG_KW = dict(img_size=8, in_ch=4, patch=2, d_model=32, n_layers=8,
               n_heads=4, d_ff=64, ctx_dim=16, ctx_len=4)
HJCFG = jdm.HunyuanDiTConfig("t", **HCFG_KW)
HUNYUAN_M = 4


def _flat_grads(grads):
    flat = jax.tree_util.tree_flatten_with_path(grads)[0]
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in flat}


@functools.lru_cache(maxsize=None)
def _jax_hunyuan_reference():
    """JAX params and microbatches (temb and ctx in aux), the end-to-end
    loss (``ref_true``: temb recomputed from the params) and the loss and
    grads of the same dataflow as the executor (``ref_aux``: temb and ctx
    enter as data), each the mean over microbatches."""
    from repro.models.layers import rms_norm
    cfg, M = HJCFG, HUNYUAN_M
    params = jax.jit(lambda k: jdm.init_hunyuan(k, cfg))(KEY)
    B = 2 * M
    batch = {"latents": jax.random.normal(KEY, (B, 8, 8, 4)),
             "text_embeds": jax.random.normal(KEY, (B, 4, 16))}
    mb, aux = jax.jit(lambda b, p: jax_mbs(b, KEY, M, cfg, "hunyuan",
                                           params=p))(batch, params)

    @jax.jit
    def ref_true(p, xt, t, ctx, noise):
        pred = jdm.hunyuan_apply(p, xt, t, {"text_embeds": ctx}, cfg)
        return jnp.mean(jnp.square(pred - noise))

    @jax.jit
    @jax.value_and_grad
    def ref_aux(p, xt, noise, ctx, temb):
        x = (jdm._patchify(xt, cfg.patch) @ p["patch_embed"]
             + p["pos_embed"][None])
        kw = {"ctx": ctx, "temb": temb}
        skips = []
        for r in range(cfg.half):
            bp = jax.tree.map(lambda a: a[r], p["enc_blocks"])
            x = jdm._apply_vit_block(bp, x, cfg, **kw)
            skips.append(x)
        for r in range(cfg.half):
            bp = jax.tree.map(lambda a: a[r], p["dec_blocks"])
            x = jdm._apply_vit_block(bp, x, cfg, skip=skips[cfg.half - 1 - r],
                                     **kw)
        h = rms_norm(x, p["out_norm"], cfg.norm_eps)
        pred = jdm._unpatchify(h @ p["out_proj"], cfg.patch, cfg.img_size,
                               cfg.in_ch)
        return jnp.mean(jnp.square(pred - noise))

    true = [ref_true(params, mb["xt"][m], aux["t"][m], aux["ctx"][m],
                     mb["noise"][m]) for m in range(M)]
    outs = [ref_aux(params, mb["xt"][m], mb["noise"][m], aux["ctx"][m],
                    aux["temb"][m]) for m in range(M)]
    grads = jax.tree.map(lambda *g: sum(g) / M, *(o[1] for o in outs))
    return (jax.device_get(params), jax.device_get(batch),
            jax.device_get((mb, aux)), sum(float(x) for x in true) / M,
            sum(float(o[0]) for o in outs) / M, _flat_grads(grads))


# (D, V): two and four pipeline devices, and the interleaved wave at D = 2
@pytest.fixture(scope="module", params=[(2, 1), (4, 1), (2, 2)],
                ids=lambda p: f"D{p[0]}" + (f"-V{p[1]}" if p[1] > 1 else ""))
def hunyuan_wave(request):
    D, V = request.param
    params, _, mb_aux, loss_true, loss_aux, grads = _jax_hunyuan_reference()
    cfg = HunyuanDiTConfig("t", use_skip_kernel=True, use_flash=True,
                           **HCFG_KW)
    cp = auto_pipeline(hunyuan_pipeline_graph(cfg),
                       diffusion_model_fns(cfg, "hunyuan"), D,
                       pipeline_devices=D, microbatches=HUNYUAN_M, lam=0.0,
                       wire_dtype="float32", interleave=V)
    assert cp.partition.num_stages == 2 * V * D and cp.layout.V == V
    before = launch_counts()
    port = _port_step(cp, params, mb_aux)
    assert launch_counts() == before          # CPU: plain versions only
    name = f"hunyuan-D{D}" + (f"-V{V}" if V > 1 else "")
    return dict(name=name, cp=cp, params=params, mb_aux=mb_aux,
                loss_true=loss_true, loss_aux=loss_aux, grads=grads,
                port=port)


def test_hunyuan_wave_executor_matches_jax(hunyuan_wave):
    w = hunyuan_wave
    name, (got_loss, got) = w["name"], w["port"]
    np.testing.assert_allclose(got_loss, w["loss_true"], rtol=RTOL,
                               err_msg=name)
    np.testing.assert_allclose(got_loss, w["loss_aux"], rtol=RTOL,
                               err_msg=name)
    assert sorted(got) == sorted(w["grads"])
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), w["grads"][k], rtol=RTOL,
                                   atol=1e-6, err_msg=f"{name}: {k}")
    # temb enters as data: time_mlp gets no gradient, as in the reference
    assert not any(got[k].any() for k in got if k.startswith("time_mlp/"))


def test_hunyuan_wave_bf16_wire_close_to_fp32_wire(hunyuan_wave):
    name, (lf, gf) = hunyuan_wave["name"], hunyuan_wave["port"]
    lb, gb = _variant(hunyuan_wave, wire_dtype="bfloat16")
    np.testing.assert_allclose(lb, lf, rtol=WIRE_RTOL, err_msg=name)
    for k in gf:
        np.testing.assert_allclose(gb[k].numpy(), gf[k].numpy(),
                                   rtol=WIRE_RTOL, atol=WIRE_ATOL,
                                   err_msg=f"{name}[bf16-vs-fp32]: {k}")


def test_hunyuan_microbatches_match_jax():
    """Given the JAX draw of t and noise, the port's split, xt, ctx and its
    temb (from the edge params' time_mlp) equal the JAX package's."""
    params, batch, (mb, aux), *_ = _jax_hunyuan_reference()
    cfg = HunyuanDiTConfig("t", **HCFG_KW)
    M = HUNYUAN_M
    t = torch.tensor(np.asarray(aux["t"]).reshape(-1))
    noise = torch.tensor(np.asarray(mb["noise"]).reshape(
        (-1,) + mb["noise"].shape[2:]))
    tp = params_from_jax(params, "cpu")
    edge = {k: v for k, v in tp.items()
            if k not in ("enc_blocks", "dec_blocks")}
    got_mb, got_aux = make_diffusion_microbatches(
        params_from_jax(batch, "cpu"), M, cfg, "hunyuan", t=t, noise=noise,
        params=edge)
    assert sorted(got_mb) == sorted(mb) and sorted(got_aux) == sorted(aux)
    for got, want in ((got_mb, mb), (got_aux, aux)):
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
    assert not got_aux["temb"].requires_grad
    with pytest.raises(ValueError, match="time_mlp"):
        make_diffusion_microbatches(params_from_jax(batch, "cpu"), M, cfg,
                                    "hunyuan", t=t, noise=noise)


def test_microbatches_take_given_or_drawn_noise():
    lat = torch.randn(4, 8, 8, 4)
    batch = {"latents": lat, "labels": torch.arange(4)}
    t = torch.rand(4)
    noise = torch.randn(4, 8, 8, 4)
    mb, aux = make_diffusion_microbatches(batch, 2, t=t, noise=noise)
    assert mb["xt"].shape == (2, 2, 8, 8, 4) and aux["t"].shape == (2, 2)
    torch.testing.assert_close(mb["noise"].reshape(4, 8, 8, 4), noise)
    # the trainer's draw: step-seeded, so a resumed step draws it again
    t3, n3 = ddpm_draw(lat, 3)
    assert t3.shape == (4,) and n3.shape == lat.shape
    assert bool(((t3 >= 0) & (t3 < 1)).all())
    t3b, n3b = ddpm_draw(lat, 3)
    assert torch.equal(t3, t3b) and torch.equal(n3, n3b)
    assert not torch.equal(ddpm_draw(lat, 4)[1], n3)
    mb, _ = make_diffusion_microbatches(batch, 2, t=t3, noise=n3)
    torch.testing.assert_close(mb["noise"].reshape(4, 8, 8, 4), n3)


# ---------------------------------------------------------------------------
# (g) the trainer on the CPU
# ---------------------------------------------------------------------------

def test_train_runs_hunyuan_three_steps_on_cpu():
    from repro_torch.launch import train
    args = train._parse_args([
        "--arch", "hunyuan-pp", "--pipeline", "--devices", "2", "--steps",
        "3", "--global-batch", "8", "--microbatches", "4", "--device", "cpu",
        "--log-every", "1"])
    before = launch_counts()
    res = train.run(args)
    assert launch_counts() == before
    assert sorted(res.losses) == [0, 1, 2]
    assert all(np.isfinite(v) for v in res.losses.values())
    assert res.skipped_steps == 0
    assert "S=4 stages over D=2 devices" in res.plan


def test_train_runs_three_steps_on_cpu(tmp_path):
    from repro_torch.launch import train
    out, prof = tmp_path / "run.json", tmp_path / "profile.json"
    args = train._parse_args([
        "--arch", "uvit-nano", "--pipeline", "--devices", "2", "--steps",
        "3", "--global-batch", "8", "--microbatches", "4", "--device", "cpu",
        "--log-every", "1", "--out-json", str(out), "--profile", str(prof)])
    before = launch_counts()
    res = train.run(args)
    assert launch_counts() == before
    assert sorted(res.losses) == [0, 1, 2]
    assert all(np.isfinite(v) for v in res.losses.values())
    assert res.skipped_steps == 0 and res.peak_bytes is None
    assert "S=4 stages over D=2 devices" in res.plan
    assert out.exists()
    # a CPU run records no device metric
    assert json.loads(prof.read_text()) == {
        "device": "cpu", "steps": 2, "wall_s": pytest.approx(
            res.step_seconds[1] + res.step_seconds[2])}


@pytest.mark.parametrize("extra", [["--dp", "2"], ["--zero-stage", "1"],
                                   []])
def test_train_refuses_unported_paths(extra):
    from repro_torch.launch import train
    # []: --pipeline on a smoke arch the JAX trainer trains only without it
    arch = "uvit-nano" if extra else "zamba2-2.7b"
    argv = ["--arch", arch, "--devices", "2", "--steps", "1",
            "--device", "cpu", "--pipeline"] + extra
    args = train._parse_args(argv)
    if extra == ["--dp", "2"]:
        # one process runs one replica: data replicas are ranks, and the
        # message says how to launch them
        with pytest.raises(ValueError, match="data replicas as ranks") as e:
            train.run(args)
        assert "torch.distributed.run --standalone --nproc-per-node 2" \
            in str(e.value) and "--dp 2 --pp 1" in str(e.value)
    elif extra:
        # ZeRO over one replica is the replicated plan (the JAX rule)
        res = train.run(args)
        assert res.compiled.pcfg.zero_stage == 0
        assert res.compiled.state_spec()["zero_stage"] == 0
        assert np.isfinite(res.losses[0])
    else:
        with pytest.raises(ValueError, match="has no pipeline path"):
            train.run(args)


@pytest.mark.parametrize("arch,d", [("uvit-h", 2560), ("uvit-pp", 64),
                                   ("uvit-nano", 32), ("hunyuan-dit", 2048),
                                   ("hunyuan-pp", 32)])
def test_train_arch_configs(arch, d):
    from repro_torch.launch import train
    argv = ["--arch", arch, "--pipeline"]
    cfg = train._model_config(train._parse_args(argv))
    assert cfg.d_model == d and cfg.use_skip_kernel and cfg.use_flash
    if arch == "uvit-h":
        assert (cfg.n_layers, cfg.n_heads, cfg.d_ff, cfg.n_tokens) == \
            (32, 20, 10240, 258)
        assert cfg.dtype == cfg.param_dtype == torch.bfloat16
    if arch == "hunyuan-dit":
        assert (cfg.n_layers, cfg.n_heads, cfg.d_ff, cfg.n_tokens,
                cfg.ctx_dim, cfg.ctx_len) == (32, 16, 8192, 1024, 1024, 77)
        assert cfg.dtype == cfg.param_dtype == torch.bfloat16
        assert cfg.param_count() == 3_221_225_472
    if arch == "hunyuan-pp":
        assert (cfg.n_layers, cfg.n_heads, cfg.d_ff, cfg.ctx_dim,
                cfg.ctx_len) == (8, 4, 64, 16, 4)


def test_train_layers_cuts_the_depth():
    """``--layers`` cuts a pipeline model to that many blocks, its widths
    kept, and trains it; the non-pipeline path and SkipViT refuse it."""
    import dataclasses

    from repro_torch.launch import train
    full = train._model_config(train._parse_args(["--arch", "uvit-h",
                                                  "--pipeline"]))
    cut = train._model_config(train._parse_args(
        ["--arch", "uvit-h", "--pipeline", "--layers", "16"]))
    assert cut == dataclasses.replace(full, n_layers=16)
    res = train.run(train._parse_args(
        ["--arch", "uvit-pp", "--pipeline", "--devices", "2", "--layers",
         "4", "--steps", "1", "--global-batch", "4", "--microbatches", "2",
         "--device", "cpu"]))
    assert res.compiled.partition.cuts[-1] == 4
    assert np.isfinite(res.losses[0])
    for argv in (["--arch", "sdv2-unet"], ["--arch", "skipvit",
                                           "--pipeline"]):
        with pytest.raises(ValueError, match="--layers"):
            train.run(train._parse_args(argv + ["--layers", "2", "--steps",
                                                "1", "--device", "cpu"]))


def test_train_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.run(train._parse_args(["--arch", "uvit-nano", "--pipeline",
                                     "--devices", "2", "--steps", "1"]))


# ---------------------------------------------------------------------------
# (h) the import boundary, and chip_smoke.py without a card
# ---------------------------------------------------------------------------

def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys, repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(len(mods), bad)\n"
        "print(' '.join(mods))\n"
        "sys.exit(1 if bad or len(mods) < 20 else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    walked = proc.stdout.split()
    for mod in ("repro_torch.configs.hunyuan_dit",
                "repro_torch.kernels.linear_scan.ops",
                "repro_torch.runtime.adapters",
                "repro_torch.models.diffusion",
                "repro_torch.checkpoint.store",
                "repro_torch.runtime.resilience",
                "repro_torch.configs.sdv2_unet",
                "repro_torch.configs.smoke",
                "repro_torch.launch.mesh",
                "repro_torch.launch.supervisor",
                "repro_torch.models.lm",
                "repro_torch.configs.qwen3_moe_30b_a3b",
                "repro_torch.models.whisper",
                "repro_torch.models.xlstm",
                "repro_torch.models.mamba",
                "repro_torch.configs.whisper_base",
                "repro_torch.configs.xlstm_125m",
                "repro_torch.configs.zamba2_2_7b",
                "repro_torch.launch.serve",
                "repro_torch.runtime.collectives",
                "repro_torch.configs.base",
                "repro_torch.configs.lm_common",
                "repro_torch.train.steps",
                "repro_torch.runtime.sharding",
                "repro_torch.runtime.ring",
                "repro_torch.analysis.verify",
                "repro_torch.analysis.kernel_check",
                "repro_torch.analysis.lint"):
        assert mod in walked, mod
    # chip_smoke.py imports none of them either
    src = (REPO / "chip_smoke.py").read_text()
    for word in ("import jax", "from jax", "import repro\n", "from repro ",
                 "from repro.", "import repro."):
        assert word not in src, word


def test_chip_smoke_fails_without_a_card(tmp_path):
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          env=_env(), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert '"ok": true' not in proc.stdout
    # alone in a directory, without the repo, it fails as well
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=_env(), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
