"""The port's decoding and serving held to the JAX package's.

Parameters are drawn by the JAX package (``jax.random``) and carried into
the port with ``params_from_jax``; a JAX-primed cache or state with
``state_from_jax``; inputs are numpy arrays made from a seed.  fp32, at
rtol 1e-4; an entry near zero may err by 1e-5 of its array's largest
magnitude (atol), fp32 rounding in another summation order:

- ``attention`` and ``attention_plain`` with ``q_offset``,
  ``kv_valid_len``, GQA and a window (no fully masked row: there the
  dense ``-1e30`` fill gives a uniform row, the plain version zeros);
- ``apply_attention`` (flash on: its plain version on CPU tensors; and
  dense) and ``apply_mla`` over caches: outputs and cache contents;
- ``prefill`` and five ``decode_step``s of the seven LM smoke keys
  (logits and caches; the MoE keys decide their capacity from the step's
  tokens), and decoding on from a JAX-primed cache;
- whisper's ``prefill`` and ``decode_step``;
- ``mlstm_recurrent``, ``causal_conv(state=)``, ``ssd_recurrent`` and the
  xLSTM and Zamba2 ``decode_step`` loops (logits and final states);
- ``local_attention_with_lse`` and ``merge_lse``, and
  ``sharded_decode_attention`` over two gloo processes against dense
  attention on the whole cache;
- ``launch.serve.generate`` for smollm, xlstm and zamba2 from the params
  and prompts of JAX's ``serve.main``: its tokens equal ``serve.main``'s,
  each step's logits held to the JAX ``prefill`` / ``decode_step``;
- ``python -m repro_torch.launch.serve --device cpu`` exits 0.
"""
import functools
import os
import pathlib
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.smoke import SMOKE_FACTORIES as JAX_SMOKE
from repro.launch import serve as jserve
from repro.models import layers as JL
from repro.models import lm as jlm
from repro.models import mamba as jm
from repro.models import whisper as jw
from repro.models import xlstm as jx
from repro.runtime import collectives as jc
from repro_torch.configs.smoke import LM_FACTORIES, RECURRENT_FACTORIES
from repro_torch.convert import params_from_jax, state_from_jax
from repro_torch.kernels.flash_attention import attention_plain
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as TL
from repro_torch.models import lm as tlm
from repro_torch.models import mamba as tm
from repro_torch.models import whisper as tw
from repro_torch.models import xlstm as tx
from repro_torch.runtime import collectives as tc
from repro_torch.tree import tree_paths

REPO = pathlib.Path(__file__).resolve().parents[1]
RTOL = 1e-4
KEY = jax.random.PRNGKey(3)
LM_KEYS = tuple(LM_FACTORIES)
PROMPT, STEPS = 8, 5            # prefill 8 tokens, then 5 decode steps

# one jitted JAX step per family, shared by every test
J_PREFILL = jax.jit(jlm.prefill, static_argnums=(2, 3))
J_DECODE = jax.jit(jlm.decode_step, static_argnums=(3,))
J_W_PREFILL = jax.jit(jw.prefill, static_argnums=(3, 4))
J_W_DECODE = jax.jit(jw.decode_step, static_argnums=(4,))
J_X_DECODE = jax.jit(jx.decode_step, static_argnums=(3,))
J_Z_DECODE = jax.jit(jm.decode_step, static_argnums=(3,))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes gain nothing from more threads, and tier-1 runs six
    test processes on the host's cores at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    atol = max(1e-6, 1e-5 * float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol, err_msg=what)


def _close_tree(got, want, what=""):
    """A port cache/state tree against a JAX one, leaf by leaf (``pos``:
    the host int against every entry of JAX's)."""
    want_paths = dict(tree_paths(jax.device_get(want)))
    got_paths = dict(tree_paths(got))
    assert sorted(got_paths) == sorted(want_paths), what
    for k, g in got_paths.items():
        w = np.asarray(want_paths[k])
        if k.split("/")[-1] == "pos":
            assert np.all(w == g), (what, k, g, w)
        else:
            _close(g, w, f"{what} {k}")


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _normal(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _tokens(rng, *shape):
    return rng.integers(0, 256, size=shape).astype(np.int32)


# ---------------------------------------------------------------------------
# attention with q_offset and kv_valid_len
# ---------------------------------------------------------------------------

ATTN_CASES = [  # S, T, Hq, Hkv, causal, window, q_offset, kv_valid_len
    (1, 24, 4, 2, True, None, 13, 14),       # a decode step, GQA
    (1, 24, 4, 1, True, 6, 20, 21),          # MQA, the window inside
    (5, 24, 4, 2, True, None, 7, 12),        # a chunk of 5 at 7
    (5, 24, 6, 2, True, 4, 9, 14),           # window 4, GQA 3
    (3, 16, 2, 2, False, None, 0, 9),        # non-causal, valid prefix
    (8, 8, 4, 2, True, 3, 0, None),          # no cache: the training mask
]


@pytest.mark.parametrize("S,T,Hq,Hkv,causal,window,q_offset,valid",
                         ATTN_CASES)
def test_attention_with_offset_and_valid_length_matches_jax(
        S, T, Hq, Hkv, causal, window, q_offset, valid):
    rng = np.random.default_rng(S * 100 + T)
    q = _normal(rng, 2, S, Hq, 16)
    k, v = _normal(rng, 2, T, Hkv, 16), _normal(rng, 2, T, Hkv, 16)
    want = JL.attention(q, k, v, causal=causal, window=window,
                        q_offset=q_offset, kv_valid_len=valid)
    kw = dict(q_offset=q_offset, kv_valid_len=valid)
    _close(TL.attention(_t(q), _t(k), _t(v), causal=causal, window=window,
                        **kw), want, "attention")
    _close(attention_plain(_t(q), _t(k), _t(v), causal, window, **kw), want,
           "attention_plain")


# ---------------------------------------------------------------------------
# apply_attention and apply_mla over caches
# ---------------------------------------------------------------------------

def _prime_and_step(jfn, tfn, jcache, tcache, xs, positions):
    """Feed each ``x`` of ``xs`` at its positions through both with their
    caches; outputs and caches compared after every call."""
    for i, (x, pos) in enumerate(zip(xs, positions)):
        want, jcache = jfn(jnp.asarray(x), jcache, jnp.asarray(pos))
        got, tcache = tfn(_t(x), tcache, _t(pos))
        _close(got, want, f"call {i} output")
        _close_tree(tcache, jcache, f"call {i} cache")


@pytest.mark.parametrize("flash", [True, False])
@pytest.mark.parametrize("window,qk_norm", [(None, False), (5, False),
                                            (None, True)])
def test_apply_attention_with_cache_matches_jax(flash, window, qk_norm):
    jcfg = JL.AttnConfig(32, 4, 2, 8, window=window, qk_norm=qk_norm)
    tcfg = TL.AttnConfig(32, 4, 2, 8, window=window, qk_norm=qk_norm,
                         use_flash=flash)
    jp = jax.device_get(JL.init_attention(KEY, jcfg))
    tp = params_from_jax(jp, "cpu")
    rng = np.random.default_rng(1)
    xs = [_normal(rng, 2, 6, 32)] + [_normal(rng, 2, 1, 32) for _ in range(3)]
    positions = [np.arange(6)[None]] + [np.full((1, 1), 6 + i)
                                        for i in range(3)]
    _prime_and_step(
        lambda x, c, p: JL.apply_attention(jp, x, jcfg, positions=p,
                                           cache=c),
        lambda x, c, p: TL.apply_attention(tp, x, tcfg, positions=p,
                                           cache=c),
        JL.init_kv_cache(2, 12, jcfg), TL.init_kv_cache(2, 12, tcfg,
                                                        device="cpu"),
        xs, positions)


def test_apply_mla_with_cache_matches_jax():
    cfg_kw = dict(q_lora_rank=16, kv_lora_rank=12, qk_nope_dim=8,
                  qk_rope_dim=4, v_head_dim=8)
    jcfg, tcfg = JL.MLAConfig(32, 4, **cfg_kw), TL.MLAConfig(32, 4, **cfg_kw)
    jp = jax.device_get(JL.init_mla(KEY, jcfg))
    tp = params_from_jax(jp, "cpu")
    rng = np.random.default_rng(2)
    xs = [_normal(rng, 2, 5, 32)] + [_normal(rng, 2, 1, 32) for _ in range(3)]
    positions = [np.arange(5)[None]] + [np.full((1, 1), 5 + i)
                                        for i in range(3)]
    _prime_and_step(
        lambda x, c, p: JL.apply_mla(jp, x, jcfg, positions=p, cache=c),
        lambda x, c, p: TL.apply_mla(tp, x, tcfg, positions=p, cache=c),
        JL.init_mla_cache(2, 10, jcfg),
        TL.init_mla_cache(2, 10, tcfg, device="cpu"), xs, positions)


# ---------------------------------------------------------------------------
# the LM smoke keys: prefill and decode
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lm(key):
    jcfg = JAX_SMOKE[key]()[3]
    tcfg = LM_FACTORIES[key](kernels=True)[3]
    params = jax.device_get(jax.jit(lambda k: jlm.init_lm(k, jcfg))(KEY))
    return jcfg, tcfg, params, params_from_jax(params, "cpu")


@pytest.mark.parametrize("key", LM_KEYS)
def test_lm_prefill_and_decode_steps_match_jax(key):
    jcfg, tcfg, jp, tp = _lm(key)
    rng = np.random.default_rng(4)
    prompt = _tokens(rng, 2, PROMPT)
    max_len = PROMPT + STEPS + 1
    want, jc = J_PREFILL(jp, prompt, jcfg, max_len)
    with torch.inference_mode():
        got, tc_ = tlm.prefill(tp, _t(prompt), tcfg, max_len)
    _close(got, want, f"{key} prefill logits")
    _close_tree(tc_, jc, f"{key} prefill caches")
    for i in range(STEPS):
        tok = _tokens(rng, 2, 1)
        want, jc = J_DECODE(jp, tok, jc, jcfg)
        with torch.inference_mode():
            got, tc_ = tlm.decode_step(tp, _t(tok), tc_, tcfg)
        _close(got, want, f"{key} step {i} logits")
    _close_tree(tc_, jc, f"{key} caches after {STEPS} steps")
    assert tc_["layers"]["pos"] == PROMPT + STEPS


@pytest.mark.parametrize("key", ["smollm-360m", "deepseek-v3-671b"])
def test_lm_decodes_on_from_a_jax_primed_cache(key):
    """``state_from_jax``: the port continues from JAX's prefill."""
    jcfg, tcfg, jp, tp = _lm(key)
    rng = np.random.default_rng(5)
    prompt, tok = _tokens(rng, 2, PROMPT), _tokens(rng, 2, 1)
    _, jc = J_PREFILL(jp, prompt, jcfg, PROMPT + 2)
    tc_ = state_from_jax(jax.device_get(jc), "cpu")
    assert tc_["layers"]["pos"] == PROMPT
    want, jc = J_DECODE(jp, tok, jc, jcfg)
    with torch.inference_mode():
        got, tc_ = tlm.decode_step(tp, _t(tok), tc_, tcfg)
    _close(got, want, key)
    _close_tree(tc_, jc, key)


# ---------------------------------------------------------------------------
# whisper
# ---------------------------------------------------------------------------

def test_whisper_prefill_and_decode_steps_match_jax():
    jcfg = JAX_SMOKE["whisper-base"]()[3]
    tcfg = RECURRENT_FACTORIES["whisper-base"](kernels=True)[3]
    assert tcfg.use_flash
    jp = jax.device_get(jax.jit(lambda k: jw.init_whisper(k, jcfg))(KEY))
    tp = params_from_jax(jp, "cpu")
    rng = np.random.default_rng(6)
    frames, prompt = _normal(rng, 2, 12, 32), _tokens(rng, 2, 4)
    max_len = 4 + STEPS
    want, jenc, jc = J_W_PREFILL(jp, frames, prompt, jcfg, max_len)
    with torch.inference_mode():
        got, tenc, tc_ = tw.prefill(tp, _t(frames), _t(prompt), tcfg,
                                    max_len)
    _close(got, want, "prefill logits")
    _close(tenc, jenc, "enc_out")
    _close_tree(tc_, jc, "prefill caches")
    for i in range(STEPS):
        tok = _tokens(rng, 2, 1)
        want, jc = J_W_DECODE(jp, tok, jenc, jc, jcfg)
        with torch.inference_mode():
            got, tc_ = tw.decode_step(tp, _t(tok), tenc, tc_, tcfg)
        _close(got, want, f"step {i} logits")
    _close_tree(tc_, jc, "caches")


# ---------------------------------------------------------------------------
# the recurrent cells and the xLSTM / Zamba2 decode loops
# ---------------------------------------------------------------------------

def test_mlstm_recurrent_matches_jax():
    rng = np.random.default_rng(7)
    B, H, Dh = 2, 3, 8
    state = {"C": _normal(rng, B, H, Dh, Dh), "n": _normal(rng, B, H, Dh),
             "m": _normal(rng, B, H)}
    q, k, v = (_normal(rng, B, H, Dh) for _ in range(3))
    i_pre, f_pre = _normal(rng, B, H), _normal(rng, B, H, scale=2.0)
    jh, jst = jx.mlstm_recurrent(state, q, k, v, i_pre, f_pre)
    th, tst = tx.mlstm_recurrent({n: _t(a) for n, a in state.items()},
                                 _t(q), _t(k), _t(v), _t(i_pre), _t(f_pre))
    _close(th, jh, "h")
    _close_tree(tst, jst, "state")
    # from the initial state (m = -1e30): the first step of a decode
    jh, jst = jx.mlstm_recurrent(jx.init_mlstm_state(B, H, Dh), q, k, v,
                                 i_pre, f_pre)
    th, tst = tx.mlstm_recurrent(tx.init_mlstm_state(B, H, Dh, "cpu"),
                                 _t(q), _t(k), _t(v), _t(i_pre), _t(f_pre))
    _close(th, jh, "first h")
    _close_tree(tst, jst, "first state")


@pytest.mark.parametrize("S", [1, 3])
def test_causal_conv_with_state_matches_jax(S):
    rng = np.random.default_rng(8)
    x, w, state = _normal(rng, 2, S, 6), _normal(rng, 4, 6), \
        _normal(rng, 2, 3, 6)
    jout, jst = jx.causal_conv(x, w, state)
    tout, tst = tx.causal_conv(_t(x), _t(w), _t(state))
    _close(tout, jout, "out")
    _close(tst, jst, "state")


def test_ssd_recurrent_matches_jax():
    rng = np.random.default_rng(9)
    b, H, N, P = 2, 3, 4, 5
    state, x = _normal(rng, b, H, N, P), _normal(rng, b, H, P)
    dt = np.abs(_normal(rng, b, H)) * 0.5
    a = -np.exp(_normal(rng, H))
    B, C = _normal(rng, b, N), _normal(rng, b, N)
    jy, jst = jm.ssd_recurrent(state, x, dt, a, B, C)
    ty, tst = tm.ssd_recurrent(*(_t(z) for z in (state, x, dt, a, B, C)))
    _close(ty, jy, "y")
    _close(tst, jst, "state")


@functools.lru_cache(maxsize=None)
def _recurrent(key):
    jcfg = JAX_SMOKE[key]()[3]
    tcfg = RECURRENT_FACTORIES[key](kernels=True)[3]
    init = {"xlstm-125m": jx.init_xlstm, "zamba2-2.7b": jm.init_zamba2}[key]
    params = jax.device_get(jax.jit(lambda k: init(k, jcfg))(KEY))
    return jcfg, tcfg, params, params_from_jax(params, "cpu")


@pytest.mark.parametrize("key", ["xlstm-125m", "zamba2-2.7b"])
def test_recurrent_decode_steps_match_jax(key):
    jcfg, tcfg, jp, tp = _recurrent(key)
    n = 7
    if key == "xlstm-125m":
        jst, tst = jx.init_states(jcfg, 2), tx.init_states(tcfg, 2, "cpu")
        jstep, tstep = J_X_DECODE, tx.decode_step
    else:
        assert tcfg.shared_attn.use_flash
        jst = jm.init_states(jcfg, 2, n)
        tst = tm.init_states(tcfg, 2, n, "cpu")
        jstep, tstep = J_Z_DECODE, tm.decode_step
    rng = np.random.default_rng(10)
    for i in range(n):
        tok = _tokens(rng, 2, 1)
        want, jst = jstep(jp, tok, jst, jcfg)
        with torch.inference_mode():
            got, tst = tstep(tp, _t(tok), tst, tcfg)
        _close(got, want, f"{key} step {i} logits")
    _close_tree(tst, jst, f"{key} states")


# ---------------------------------------------------------------------------
# the LSE merge and the sharded decode attention over gloo
# ---------------------------------------------------------------------------

def _lse_inputs(S=12, valid=9):
    rng = np.random.default_rng(12)
    return (_normal(rng, 2, 1, 3, 8), _normal(rng, 2, S, 3, 8),
            _normal(rng, 2, S, 3, 8), valid)


def test_local_attention_with_lse_and_merge_match_jax():
    q, k, v, valid = _lse_inputs()
    jparts, tparts = [], []
    for off in (0, 4, 8):      # three shards; the last holds 1 valid row
        jparts.append(jc.local_attention_with_lse(
            q, k[:, off:off + 4], v[:, off:off + 4], kv_offset=off,
            kv_valid_len=valid))
        tparts.append(tc.local_attention_with_lse(
            _t(q), _t(k[:, off:off + 4]), _t(v[:, off:off + 4]),
            kv_offset=off, kv_valid_len=valid))
    for (to, tmx, tl), (jo, jmx, jl) in zip(tparts, jparts):
        _close(to, jo, "out")
        _close(tmx, jmx, "m")
        _close(tl, jl, "l")
    merged = tc.merge_lse(tparts)
    _close(merged, jc.merge_lse(jparts), "merge")
    # the merge is the dense attention over the valid rows
    _close(merged, JL.attention(q, k, v, causal=False, kv_valid_len=valid),
           "merge vs dense")


_RANK = """
import sys, numpy as np, torch, torch.distributed as dist
from repro_torch.runtime.collectives import sharded_decode_attention
rank, port, path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=2)
z = np.load(path)
S = z["k"].shape[1] // 2
sl = slice(rank * S, (rank + 1) * S)
out = sharded_decode_attention(torch.from_numpy(z["q"]),
                               torch.from_numpy(z["k"][:, sl].copy()),
                               torch.from_numpy(z["v"][:, sl].copy()),
                               kv_valid_len=int(z["valid"]))
np.save(path[:-4] + f".rank{rank}.npy", out.numpy())
dist.destroy_process_group()
"""


def test_sharded_decode_attention_over_two_gloo_ranks(tmp_path):
    q, k, v, valid = _lse_inputs(S=12, valid=9)
    path = str(tmp_path / "in.npz")
    np.savez(path, q=q, k=k, v=v, valid=valid)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(REPO / "src"))
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r), port,
                               path], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    for r, p in enumerate(procs):
        log, _ = p.communicate(timeout=120)
        assert p.returncode == 0, f"rank {r}:\n{log[-3000:]}"
    want = JL.attention(q, k, v, causal=False, kv_valid_len=valid)
    for r in range(2):
        _close(np.load(str(tmp_path / f"in.rank{r}.npy")), want, f"rank {r}")


# ---------------------------------------------------------------------------
# generate and the CLI against JAX serve.main
# ---------------------------------------------------------------------------

SERVE_ARGS = dict(batch=2, prompt_len=6, gen=8)


def _jax_serve_logits(jcfg, jp, prompts, gen):
    """The JAX ``serve.main`` loop on the shared jitted steps: its tokens
    and every step's logits (an LM's prefill first; a recurrent model's
    prompt steps first)."""
    P = prompts.shape[1]
    logits_all, outs = [], []
    if isinstance(jcfg, jlm.LMConfig):
        logits, caches = J_PREFILL(jp, prompts, jcfg, P + gen)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        logits_all.append(logits)
        outs.append(tok)
        for _ in range(gen - 1):
            logits, caches = J_DECODE(jp, tok, caches, jcfg)
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            logits_all.append(logits)
            outs.append(tok)
    else:
        if isinstance(jcfg, jx.XLSTMConfig):
            states, step = jx.init_states(jcfg, prompts.shape[0]), J_X_DECODE
        else:
            states = jm.init_states(jcfg, prompts.shape[0], P + gen)
            step = J_Z_DECODE
        for i in range(P - 1):
            logits, states = step(jp, prompts[:, i:i + 1], states, jcfg)
            logits_all.append(logits)
        tok = prompts[:, :1]
        for _ in range(gen):
            logits, states = step(jp, tok, states, jcfg)
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            logits_all.append(logits)
            outs.append(tok)
    return np.asarray(jnp.concatenate(outs, axis=1)), logits_all


@pytest.mark.parametrize("key", ["smollm-360m", "xlstm-125m", "zamba2-2.7b"])
def test_generate_matches_jax_serve_main(key, capsys):
    B, P, gen = SERVE_ARGS["batch"], SERVE_ARGS["prompt_len"], \
        SERVE_ARGS["gen"]
    want = np.asarray(jserve.main(["--arch", key, "--batch", str(B),
                                   "--prompt-len", str(P), "--gen",
                                   str(gen)]))
    # JAX serve.main's params and prompts, both from PRNGKey(0)
    key0 = jax.random.PRNGKey(0)
    _, jinit, _, jcfg = JAX_SMOKE[key]()
    jp = jax.device_get(jinit(key0))
    prompts = np.array(jax.random.randint(key0, (B, P), 0, 256))
    tcfg = {**LM_FACTORIES, **RECURRENT_FACTORIES}[key](kernels=True)[3]
    out = tserve.generate(params_from_jax(jp, "cpu"), tcfg,
                          torch.from_numpy(prompts), gen, keep_logits=True)
    np.testing.assert_array_equal(out.tokens.numpy(), want)
    jtokens, jlogits = _jax_serve_logits(jcfg, jp, prompts, gen)
    np.testing.assert_array_equal(jtokens, want)
    assert len(out.logits) == len(jlogits)
    for i, (g, w) in enumerate(zip(out.logits, jlogits)):
        _close(g, w, f"{key} step {i}")
    assert out.steps == (gen - 1 if key == "smollm-360m" else gen)


def test_serve_cli_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    for arch in ("smollm-360m", "zamba2-2.7b"):
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
             "--batch", "2", "--prompt-len", "6", "--gen", "4", "--device",
             "cpu"], env=env, capture_output=True, text=True, timeout=120,
            cwd=str(REPO))
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert f"[serve] {arch.split('-')[0]}" in proc.stdout
    # without a card and without --device cpu it refuses to run
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve"], env=env,
        capture_output=True, text=True, timeout=120, cwd=str(REPO))
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
