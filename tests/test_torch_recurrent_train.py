"""The port's trainer on whisper, xLSTM and Zamba2 held to the JAX trainer.

Five steps of the non-pipeline trainer (``--arch whisper-base``,
``xlstm-125m``, ``zamba2-2.7b``: the JAX smoke configs) from the JAX
trainer's params (``PRNGKey(0)``), injected with ``run(args,
init_params=)``, on the trainer's own token batches (the JAX trainer's
``SyntheticTokenDataset``), against the JAX trainer's losses, the JAX
trainer run in this process; fp32, rtol 1e-4.  Whisper's ``frames`` are the
JAX trainer's, ``jax.random.normal`` of its init key, the same every step,
injected with ``run(draw=)`` (the port draws its own from its generator,
which cannot give JAX's bits).  Also: the trainer's own batches and
whisper's frames.  (``tests/test_torch_lm_train.py::test_lm_arch_keys``
holds the keys' refusal of ``--pipeline``.)
"""
import functools
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from repro.configs.smoke import SMOKE_FACTORIES as JAX_SMOKE
from repro.data.pipeline import SyntheticTokenDataset as JaxTokens
from repro.launch import train as jax_train
from repro_torch.kernels import launch_counts
from repro_torch.launch import train

RTOL = 1e-4
FAST = {"xla_backend_optimization_level": 0}
STEPS, B = 5, 4
KEY = jax.random.PRNGKey(0)


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


@functools.lru_cache(maxsize=None)
def _jax_trainer(arch):
    """The JAX trainer's losses over ``STEPS`` steps, its initial params
    (as its ``_build_smoke_trainer`` returns them; the smoke factory's
    ``init_fn`` compiled at ``FAST``, the same function of the key), its
    token batches and, for whisper, its frames: ``jax.random.normal`` of
    the key its ``pack`` draws them from, the trainer's init key."""
    build, seen = jax_train._build_smoke_trainer, {}

    def spy(args, key, opt_cfg):
        out = build(args, key, opt_cfg)
        seen["params"], seen["key"] = jax.device_get(out[0]), key
        return out

    def jitted_init():
        loss_fn, init_fn, make_batch, cfg = factory()
        init = jax.jit(init_fn).lower(KEY).compile(compiler_options=FAST)
        return loss_fn, init, make_batch, cfg
    factory = JAX_SMOKE[arch]
    with mock.patch.object(jax_train, "_build_smoke_trainer", spy), \
            mock.patch.dict(JAX_SMOKE, {arch: jitted_init}):
        res = jax_train.run(jax_train._parse_args(_argv(arch)))
    proto = JAX_SMOKE[arch]()[2](KEY)
    frames = None
    if "frames" in proto:
        frames = np.array(jax.random.normal(
            seen["key"], (B,) + proto["frames"].shape[1:]))
    ds = JaxTokens(vocab=256, seq_len=proto["tokens"].shape[1])
    batches = {s: ds.batch(s, 0, B) for s in range(STEPS)}
    return dict(res.losses), seen["params"], frames, batches


@pytest.mark.parametrize("arch", train.RECURRENT_ARCHS)
def test_recurrent_trainer_matches_jax(arch):
    want, params, frames, _ = _jax_trainer(arch)
    draw = None if frames is None else (lambda step: (frames,))
    before = launch_counts()
    res = train.run(train._parse_args(_argv(arch) + ["--device", "cpu"]),
                    init_params=params, draw=draw)
    assert launch_counts() == before          # CPU: plain versions only
    assert res.compiled is None and res.plan.startswith("non-pipeline")
    assert res.skipped_steps == 0
    assert sorted(res.losses) == list(range(STEPS))
    for s in range(STEPS):
        np.testing.assert_allclose(res.losses[s], want[s], rtol=RTOL,
                                   err_msg=f"step {s}")


@pytest.mark.parametrize("arch", train.RECURRENT_ARCHS)
def test_recurrent_trainer_batches(arch):
    """The trainer's own batches are the JAX trainer's tokens; whisper's
    loss takes its frames as its draw, drawn once a run (the same every
    step, and again in another run), the others take none."""
    _, _, frames, batches = _jax_trainer(arch)
    args = train._parse_args(_argv(arch) + ["--device", "cpu"])
    tr = train.build_smoke_trainer(args)
    seen = []
    for s in (0, 3):
        batch, draws = train._step_inputs(tr, s, None)
        assert sorted(batch) == ["tokens"]
        np.testing.assert_array_equal(batch["tokens"].numpy(),
                                      batches[s]["tokens"])
        seen.append(draws)
    if frames is None:
        assert seen == [(), ()]
        return
    (f0,), (f3,) = seen
    assert f0.shape == frames.shape and f0.dtype == torch.float32
    assert torch.equal(f0, f3)
    again = train._step_inputs(train.build_smoke_trainer(args), 1, None)[1]
    assert torch.equal(again[0], f0)

