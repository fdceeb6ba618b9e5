"""The port's trainer held to the JAX package's, loop for loop.

Both trainers train from the same params with the same DDPM draws: the
JAX trainer draws its params with ``PRNGKey(0)`` and each step's ``(t,
noise)`` from ``fold_in(PRNGKey(0), step)``; the test takes the same
numbers from ``jax.random`` and injects them into the port's trainer
(``run(args, init_params=, draw=)``), whose data, schedule, GradGuard and
AdamW are its own.  Five steps of losses at fp32 rtol 1e-4:

- without ``--pipeline``: the three diffusion smoke archs (``uvit-h``,
  ``hunyuan-dit``, ``sdv2-unet``), the JAX trainer in this process;
- with ``--pipeline``: ``uvit-pp`` at D=2 over an fp32 wire, the JAX
  trainer in a subprocess with two host devices.

Also here, on the non-pipeline path: a checkpoint the JAX trainer writes
mid-run resumes in the port's trainer and continues the JAX trajectory; a
JAX-written UNet state with bf16 leaves beside fp32 norm leaves restores
in the port bitwise, and a port-written one round-trips; ``--ckpt-every 3
--faults stop@3`` then ``--resume`` reproduces steps 3-5 of an
uninterrupted run bitwise; the arch keys and their configs.
"""
import dataclasses
import functools
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import save_checkpoint as jax_save
from repro.configs.smoke import SMOKE_FACTORIES as JAX_SMOKE
from repro.launch import train as jax_train
from repro.models import diffusion as jdm
from repro.optim import adamw_init as jax_adamw_init
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.kernels import launch_counts
from repro_torch.launch import train
from repro_torch.models import diffusion as tdm
from repro_torch.optim import adamw_init
from repro_torch.tree import tree_flatten, tree_map, tree_paths

REPO = pathlib.Path(__file__).resolve().parents[1]
RTOL = 1e-4
STEPS, B = 5, 4
KEY = jax.random.PRNGKey(0)
SMOKE = ("uvit-h", "hunyuan-dit", "sdv2-unet")
# the JAX trainer's uvit-pp pipeline at D=2, M=4, over an exact wire
PP_ARGV = ["--arch", "uvit-pp", "--pipeline", "--devices", "2",
           "--microbatches", "4", "--global-batch", "8", "--steps",
           str(STEPS), "--wire-dtype", "float32", "--log-every", "100"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes gain nothing from more threads, and tier-1 runs six
    test processes on the host's cores at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _argv(arch, steps=STEPS, *extra):
    return ["--arch", arch, "--steps", str(steps), "--global-batch", str(B),
            "--log-every", "100", *extra]


def _jax_draw(shape):
    """The JAX trainer's ``(t, noise)`` of a step: ``ddpm_loss`` (and the
    pipeline's ``make_diffusion_microbatches``) split ``fold_in(PRNGKey(0),
    step)`` into a uniform t and a normal noise."""
    def draw(step):
        rt, rn = jax.random.split(jax.random.fold_in(KEY, step))
        return (np.array(jax.random.uniform(rt, (shape[0],))),
                np.array(jax.random.normal(rn, shape, jnp.float32)))
    return draw


@functools.lru_cache(maxsize=None)
def _jax_smoke(arch):
    """The JAX trainer's losses over ``STEPS`` steps, its initial params and
    the latents' shape."""
    res = jax_train.run(jax_train._parse_args(_argv(arch)))
    _, init_fn, make_batch, _ = JAX_SMOKE[arch]()
    shape = (B,) + tuple(make_batch(KEY)["latents"].shape[1:])
    return (dict(res.losses), jax.device_get(init_fn(KEY)), shape)


def _port(argv, params, shape, **kw):
    return train.run(train._parse_args(argv + ["--device", "cpu"]),
                     init_params=params, draw=_jax_draw(shape), **kw)


def _assert_losses(got: dict, want: dict, steps):
    assert sorted(got) == list(steps)
    for s in steps:
        np.testing.assert_allclose(got[s], want[s], rtol=RTOL,
                                   err_msg=f"step {s}")


# ---------------------------------------------------------------------------
# five steps, port against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", SMOKE)
def test_smoke_trainer_matches_jax(arch):
    want, params, shape = _jax_smoke(arch)
    before = launch_counts()
    res = _port(_argv(arch), params, shape)
    assert launch_counts() == before          # CPU: plain versions only
    assert res.compiled is None and res.plan.startswith("non-pipeline")
    assert res.skipped_steps == 0
    _assert_losses(res.losses, want, range(STEPS))


def test_pipeline_trainer_matches_jax(tmp_path):
    out = tmp_path / "jax.json"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro.launch.train", *PP_ARGV, "--dp", "1",
         "--out-json", str(out)], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    want = {int(k): v for k, v in json.loads(out.read_text())["losses"].items()}
    cfg = jdm.UViTConfig("uvit-pp", img_size=8, in_ch=4, patch=2, d_model=64,
                         n_layers=8, n_heads=4, d_ff=128, n_classes=10)
    # the JAX pipeline's initial params: init_pipeline_params(PRNGKey(0))
    # splits init_uvit(PRNGKey(0))
    params = jax.device_get(jdm.init_uvit(KEY, cfg))
    res = train.run(train._parse_args(PP_ARGV + ["--device", "cpu"]),
                    init_params=params, draw=_jax_draw((8, 8, 8, 4)))
    assert "S=4 stages over D=2 devices" in res.plan
    _assert_losses(res.losses, want, range(STEPS))


# ---------------------------------------------------------------------------
# checkpoints on the non-pipeline path
# ---------------------------------------------------------------------------

def test_jax_trainer_checkpoint_resumes_in_the_port(tmp_path):
    """The JAX trainer trains steps 0-2 of sdv2-unet and saves step 3 (the
    UNet's nested lists, its AdamW moments and step); the port's trainer
    resumes there and its steps 3-4 continue the uninterrupted JAX run."""
    want, params, shape = _jax_smoke("sdv2-unet")
    ck = str(tmp_path / "ck")
    jax_train.run(jax_train._parse_args(_argv(
        "sdv2-unet", STEPS, "--ckpt-dir", ck, "--ckpt-every", "3",
        "--faults", "stop@3")))
    res = _port(_argv("sdv2-unet", STEPS, "--ckpt-dir", ck, "--resume"),
                None, shape)
    assert res.start == 3 and res.resumed.step == 3
    _assert_losses(res.losses, want, range(3, STEPS))


def _bf16_unet_cfgs():
    kw = dict(img_size=16, in_ch=4, base_ch=16, ch_mults=(1, 2),
              blocks_per_level=2, attn_levels=(1,), ctx_dim=16, n_heads=4)
    return (jdm.UNetConfig("t", dtype=jnp.bfloat16, param_dtype=jnp.bfloat16,
                           **kw),
            tdm.UNetConfig("t", dtype=torch.bfloat16,
                           param_dtype=torch.bfloat16, **kw))


def _bits(x):
    a = np.asarray(x.detach().cpu().view(torch.int16) if isinstance(
        x, torch.Tensor) and x.dtype == torch.bfloat16 else x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def test_jax_bf16_unet_state_restores_in_the_port_bitwise(tmp_path):
    jcfg, tcfg = _bf16_unet_cfgs()
    jp = jdm.init_unet(jax.random.PRNGKey(4), jcfg)
    jstate = jax.device_get({"params": jp, "opt": jax_adamw_init(jp)})
    jax_save(str(tmp_path), 7, jstate)
    tp = tdm.init_unet(torch.Generator().manual_seed(0), tcfg, "cpu")
    got, step = restore_checkpoint(str(tmp_path),
                                   {"params": tp, "opt": adamw_init(tp)})
    assert step == 7
    dtypes = {k: str(x.dtype) for k, x in tree_paths(got["params"])}
    assert dtypes["down/0/0/res/gn1"] == dtypes["mid/attn/ln2"] == \
        "torch.float32"
    assert dtypes["down/0/0/res/conv1"] == dtypes["up/0/3/upsample"] == \
        "torch.bfloat16"
    want = jax.tree_util.tree_leaves(jstate)
    got = tree_flatten(got)[0]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = _bits(g), _bits(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_port_bf16_unet_state_round_trips(tmp_path):
    _, tcfg = _bf16_unet_cfgs()
    tp = tdm.init_unet(torch.Generator().manual_seed(1), tcfg, "cpu")
    state = {"params": tp, "opt": adamw_init(tp)}
    state["opt"]["m"]["in_conv"].normal_()
    save_checkpoint(str(tmp_path), 2, state)
    like = tree_map(torch.zeros_like, state)
    got, step = restore_checkpoint(str(tmp_path), like)
    assert step == 2
    for g, w in zip(tree_flatten(got)[0], tree_flatten(state)[0]):
        assert g.dtype == w.dtype
        assert torch.equal(g.view(-1).view(torch.uint8) if g.dim() else g,
                           w.view(-1).view(torch.uint8) if w.dim() else w)


def test_stop_then_resume_is_bitwise(tmp_path):
    """``--ckpt-every 3 --faults stop@3`` then ``--resume``: steps 3-5 and
    the final params equal the uninterrupted run's bit for bit (every
    input of a step is a function of the step)."""
    ck = str(tmp_path / "ck")
    argv = _argv("sdv2-unet", 6, "--device", "cpu")
    full = train.run(train._parse_args(argv))
    a = train.run(train._parse_args(argv + ["--ckpt-dir", ck, "--ckpt-every",
                                            "3", "--faults", "stop@3"]))
    assert sorted(a.losses) == [0, 1, 2] and [s["step"] for s in a.saves] == [3]
    b = train.run(train._parse_args(argv + ["--ckpt-dir", ck, "--resume"]))
    assert b.start == 3 and sorted(b.losses) == [3, 4, 5]
    for s in range(6):
        assert (a.losses if s < 3 else b.losses)[s] == full.losses[s], s
    for g, w in zip(tree_flatten(b.logical_params)[0],
                    tree_flatten(full.logical_params)[0]):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# arch keys
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,kind", [
    ("uvit", "UViTConfig"), ("uvit-h", "UViTConfig"),
    ("hunyuan-dit", "HunyuanDiTConfig"), ("sdv2-unet", "UNetConfig"),
    ("sdv2-unet-full", "UNetConfig")])
def test_smoke_arch_configs(arch, kind):
    """Without ``--pipeline`` the arch keys are the JAX smoke configs
    (``uvit`` its alias of ``uvit-h``), kernels on, and ``sdv2-unet-full``
    the full-width UNet in bf16."""
    cfg = train._smoke_bundle(train._parse_args(["--arch", arch]))[3]
    assert type(cfg).__name__ == kind and cfg.use_flash
    if kind != "UNetConfig":
        assert cfg.use_skip_kernel
    if arch == "sdv2-unet-full":
        from repro_torch.configs.sdv2_unet import CFG
        assert cfg == dataclasses.replace(CFG, use_flash=True)
        assert (cfg.base_ch, cfg.ch_mults, cfg.n_heads, cfg.ctx_dim) == \
            (448, (1, 2, 4, 4), 8, 1024)
        assert cfg.dtype == cfg.param_dtype == torch.bfloat16
    else:
        jcfg = JAX_SMOKE[{"uvit": "uvit-h"}.get(arch, arch)]()[3]
        assert cfg.name == jcfg.name


def test_unet_has_no_pipeline_path():
    with pytest.raises(ValueError, match="no pipeline path"):
        train.run(train._parse_args(["--arch", "sdv2-unet", "--pipeline",
                                     "--device", "cpu"]))
