"""The port's decoder-LM trainer and LM pipelines held to the JAX package's.

- Five steps of the non-pipeline trainer (``--arch smollm-360m``,
  ``qwen3-moe-30b-a3b``, ``deepseek-v3-671b``, ``internvl2-2b``: tied, MoE
  scatter + qk-norm, MLA + MoE + MTP, and a vision-prefix config the JAX
  trainer trains on tokens alone) from the JAX trainer's params (``PRNGKey(0)``),
  injected with ``run(args, init_params=)``, on the trainer's own batches,
  which are the JAX trainer's tokens (the same ``SyntheticTokenDataset``,
  checked), against the JAX trainer's losses, the JAX trainer run in this
  process; fp32, rtol 1e-4.
- ``auto_pipeline`` on ``lm_pipeline_graph`` of the smollm smoke config at
  D=2, M=4, fp32 wire: the linear table executor, the linear closed form
  and the folded wave (``force_wave=True``, table and closed form), loss
  and every gradient against the JAX package's whole-model ``lm_loss`` and
  ``jax.grad`` at fp32 rtol 1e-4 (the single-device JAX loss is the
  reference).
- The planner's partitions and step tables for the LM graph against the
  JAX package's, array for array, linear and folded.
- The trainer's arch keys: the LM keys, whisper, xLSTM and Zamba2 train
  without ``--pipeline`` and refuse it.
"""
import dataclasses
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.smoke import SMOKE_FACTORIES as JAX_SMOKE
from repro.core import hw as jax_hw
from repro.data.pipeline import SyntheticTokenDataset as JaxTokens
from repro.launch import train as jax_train
from repro.models import lm as jlm
from repro.runtime.adapters import lm_model_fns as jax_lm_model_fns
from repro.runtime.compile import auto_pipeline as jax_auto_pipeline
from repro_torch.configs.smoke import LM_FACTORIES
from repro_torch.convert import params_from_jax
from repro_torch.core import hw as torch_hw
from repro_torch.kernels import launch_counts
from repro_torch.launch import train
from repro_torch.models import lm as tlm
from repro_torch.runtime.adapters import (lm_model_fns, make_lm_microbatches,
                                          model_fns)
from repro_torch.runtime.compile import auto_pipeline
from repro_torch.runtime.schedule_exec import StepTables
from repro_torch.tree import tree_map, tree_paths

RTOL, ATOL = 1e-4, 1e-6
# XLA's lowest backend optimization level: the test's own JAX references
# compile in about a third of the time (tier-1 pays the compiles)
FAST = {"xla_backend_optimization_level": 0}
STEPS, B = 5, 4
KEY = jax.random.PRNGKey(0)
TRAIN_ARCHS = ("smollm-360m", "qwen3-moe-30b-a3b", "deepseek-v3-671b",
               "internvl2-2b")
TPU = torch_hw.Hardware(**dataclasses.asdict(jax_hw.TPU_V5E))
PIPE_B, PIPE_M, PIPE_D = 8, 4, 2
# (force_wave, executor)
PIPE_CASES = [(False, "table"), (False, "closed_form"), (True, "table"),
              (True, "closed_form")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes gain nothing from more threads, and tier-1 runs six
    test processes on the host's cores at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _argv(arch):
    return ["--arch", arch, "--steps", str(STEPS), "--global-batch", str(B),
            "--log-every", "100"]


def _jax_flat(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(v) for path, v in flat}


def _close(got, want, what=""):
    """rtol 1e-4; an entry near zero may err by 1e-5 of its leaf's largest
    magnitude (fp32 rounding in another summation order)."""
    atol = max(ATOL, 1e-5 * float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol, err_msg=what)


# ---------------------------------------------------------------------------
# five trainer steps, port against JAX
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_trainer(arch):
    """The JAX trainer's losses over ``STEPS`` steps, its initial params
    (read as its ``_build_smoke_trainer`` returns them, so the model is
    drawn once) and its batches (``pack(loader.get(step))``: the tokens of
    its dataset).  Its smoke factory's ``init_fn`` runs compiled
    (``FAST``; eagerly, deepseek's vmapped init took most of the test's
    time): the same function of ``PRNGKey(0)``, which may round
    differently, and the port starts from whatever params it gave."""
    build, seen = jax_train._build_smoke_trainer, {}

    def spy(args, key, opt_cfg):
        out = build(args, key, opt_cfg)
        seen["params"] = jax.device_get(out[0])
        return out

    def jitted_init():
        loss_fn, init_fn, make_batch, cfg = factory()
        init = jax.jit(init_fn).lower(KEY).compile(compiler_options=FAST)
        return loss_fn, init, make_batch, cfg
    factory = JAX_SMOKE[arch]
    with mock.patch.object(jax_train, "_build_smoke_trainer", spy), \
            mock.patch.dict(JAX_SMOKE, {arch: jitted_init}):
        res = jax_train.run(jax_train._parse_args(_argv(arch)))
    seq = JAX_SMOKE[arch]()[2](KEY)["tokens"].shape[1]
    ds = JaxTokens(vocab=256, seq_len=seq)
    batches = {s: ds.batch(s, 0, B) for s in range(STEPS)}
    return dict(res.losses), seen["params"], batches


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_lm_trainer_matches_jax(arch):
    want, params, _ = _jax_trainer(arch)
    before = launch_counts()
    res = train.run(train._parse_args(_argv(arch) + ["--device", "cpu"]),
                    init_params=params)
    assert launch_counts() == before          # CPU: plain versions only
    assert res.compiled is None and res.plan.startswith("non-pipeline")
    assert res.skipped_steps == 0
    assert sorted(res.losses) == list(range(STEPS))
    for s in range(STEPS):
        np.testing.assert_allclose(res.losses[s], want[s], rtol=RTOL,
                                   err_msg=f"step {s}")


def test_lm_trainer_draws_the_jax_tokens():
    """The trainer's own batches are the JAX trainer's tokens (the same
    synthetic language, step-indexed), so the runs agree without
    injection, and its loss takes no draws; internvl2's too, tokens alone,
    as the JAX trainer's ``pack`` keeps only what its dataset yields (its
    smoke config's ``make_batch`` still has the vision prefix)."""
    _, params, batches = _jax_trainer("smollm-360m")
    args = train._parse_args(_argv("smollm-360m") + ["--device", "cpu"])
    tr = train.build_smoke_trainer(args)
    for s in (0, 3):
        batch, draws = train._step_inputs(tr, s, None)
        assert draws == () and sorted(batch) == ["tokens"]
        np.testing.assert_array_equal(batch["tokens"].numpy(),
                                      batches[s]["tokens"])
    tr = train.build_smoke_trainer(train._parse_args(
        _argv("internvl2-2b") + ["--device", "cpu"]))
    b0, draws = train._step_inputs(tr, 2, None)
    assert draws == () and sorted(b0) == ["tokens"]
    np.testing.assert_array_equal(b0["tokens"].numpy(), batches[2]["tokens"])
    _, _, make_batch, cfg = LM_FACTORIES["internvl2-2b"]()
    assert cfg.vision_prefix == 8 and sorted(make_batch(
        torch.Generator().manual_seed(0), "cpu")) == ["prefix_embeds",
                                                      "tokens"]


@pytest.mark.parametrize("arch", train.LM_ARCHS + train.RECURRENT_ARCHS)
def test_lm_arch_keys(arch):
    assert arch in train.SMOKE_ARCHS and arch not in train.PIPELINE_ARCHS
    with pytest.raises(ValueError, match="has no pipeline path"):
        train.run(train._parse_args(["--arch", arch, "--pipeline",
                                     "--device", "cpu"]))


# ---------------------------------------------------------------------------
# the LM on the linear and folded pipelines, against the JAX lm_loss
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_whole_model():
    """The smollm smoke config's JAX params, a batch of ``PIPE_B`` rows and
    the whole model's ``lm_loss`` and grads."""
    _, init_fn, _, cfg = JAX_SMOKE["smollm-360m"]()
    tokens = np.random.default_rng(21).integers(
        0, cfg.vocab, size=(PIPE_B, 32)).astype(np.int32)

    def ref(k):
        p = init_fn(k)
        return p, jax.value_and_grad(lambda p: jlm.lm_loss(
            p, {"tokens": jnp.asarray(tokens)}, cfg))(p)
    params, (loss, grads) = jax.jit(ref).lower(KEY).compile(
        compiler_options=FAST)(KEY)
    return jax.device_get(params), tokens, float(loss), jax.device_get(grads)


@pytest.mark.parametrize("force_wave,executor", PIPE_CASES)
def test_lm_pipeline_matches_jax_lm_loss(force_wave, executor):
    params, tokens, want_loss, want_grads = _jax_whole_model()
    cfg = LM_FACTORIES["smollm-360m"](kernels=True)[3]
    cp = auto_pipeline(tlm.lm_pipeline_graph(cfg, batch=PIPE_B // PIPE_M,
                                             seq=32),
                       model_fns(cfg, "lm"), PIPE_D,
                       pipeline_devices=PIPE_D, microbatches=PIPE_M,
                       force_wave=force_wave or None, executor=executor,
                       wire_dtype="float32")
    assert cp.folded == force_wave
    assert cp.partition.num_stages == (2 if force_wave else 1) * PIPE_D
    stacks, edge = cp.split_params(params_from_jax(params, "cpu"))
    for _, x in tree_paths((stacks, edge)):
        x.requires_grad_(True)
    mbs = make_lm_microbatches({"tokens": torch.from_numpy(tokens)}, PIPE_M)
    fn = cp.build()
    loss = fn(*stacks, edge, mbs, {}) if cp.folded else fn(*stacks, edge,
                                                            mbs)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=RTOL)
    grads = cp.merge_params(tree_map(lambda x: x.grad, stacks),
                            tree_map(lambda x: x.grad, edge))
    want = _jax_flat(want_grads)
    got = dict(tree_paths(grads))
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        _close(v.numpy(), want[k], k)


def test_lm_model_fns_refusals_and_split():
    cfg = LM_FACTORIES["deepseek-v3-671b"]()[3]
    fns = lm_model_fns(cfg)
    params = fns.init_fn(torch.Generator().manual_seed(0), "meta")
    (stack,), edge = fns.split_blocks(params)
    # only the MoE layers pipeline; the dense prelude and MTP are edge
    assert stack["ln1"].shape[0] == cfg.n_layers - cfg.n_dense_layers
    assert {"dense_layers", "mtp", "embed", "head"} <= set(edge)
    assert fns.merge_blocks((stack,), edge).keys() == params.keys()
    with pytest.raises(ValueError, match="does not split"):
        make_lm_microbatches({"tokens": torch.zeros(6, 4)}, 4)


# ---------------------------------------------------------------------------
# the planner on the LM graph, against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D,M,force_wave,times", [
    (2, 4, None, None), (4, 8, None, [3, 1, 1, 1]), (2, 4, True, None),
    (2, 4, True, [2, 1, 1, 1])])
def test_lm_plan_and_step_tables_match_jax(D, M, force_wave, times):
    jcfg = JAX_SMOKE["smollm-360m"]()[3]
    tcfg = LM_FACTORIES["smollm-360m"]()[3]
    jg = jlm.lm_pipeline_graph(jcfg, batch=2, seq=32, fwd_times=times,
                               hw=jax_hw.TPU_V5E)
    tg = tlm.lm_pipeline_graph(tcfg, batch=2, seq=32, fwd_times=times, hw=TPU)
    kw = dict(pipeline_devices=D, microbatches=M, lam=0.0,
              force_wave=force_wave)
    jcp = jax_auto_pipeline(jg, jax_lm_model_fns(jcfg), D, jax_hw.TPU_V5E,
                            **kw)
    tcp = auto_pipeline(tg, lm_model_fns(tcfg), D, TPU, **kw)
    jp, tp = jcp.partition, tcp.partition
    assert (tp.cuts, tp.devices, tp.folded, tp.num_stages) == \
        (jp.cuts, jp.devices, jp.folded, jp.num_stages)
    assert tp.folded == bool(force_wave)
    key = lambda p: (p.virtual, p.microbatch, p.device, p.step)
    assert sorted(map(key, tcp.schedule.placements)) == \
        sorted(map(key, jcp.schedule.placements))
    for f in ("enc_slots", "dec_slots", "enc_counts", "dec_counts",
              "enc_pad", "dec_pad", "skip_rows"):
        assert getattr(tcp.layout, f) == getattr(jcp.layout, f), f
    jt, tt = jcp.step_tables(), tcp.step_tables()
    for f in dataclasses.fields(StepTables):
        a, b = getattr(tt, f.name), getattr(jt, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    assert tcp.certify().ok
