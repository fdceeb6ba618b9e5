"""Batched serving (the port of ``repro.launch.serve``): prefill a
prompt batch, decode greedily.

Runs on the card, or on the CPU when asked (``--device cpu``), on the
smoke configs, as the JAX ``serve.main`` does; the families share their
decode implementations with the full configs:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
        --batch 4 --prompt-len 16 --gen 32 [--device cpu]

The decoder LMs prime KV caches with the prompt (``lm.prefill``) and then
decode a token a step (``lm.decode_step``); xLSTM and Zamba2 step their
recurrent states (and Zamba2's shared attention its KV caches) one token
at a time.  As in JAX's ``serve.main``, those two feed the prompt's first
``prompt_len - 1`` tokens and then start generating from the prompt's
*first* token again: the last prompt token is never fed, so that the
port's tokens equal JAX's.  Every attention with a cache runs
the flash kernel on the card (the configs' ``use_flash``), the CPU its
plain version.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

VOCAB = 256          # the prompts' token range, JAX serve.main's


@dataclasses.dataclass
class Generation:
    tokens: torch.Tensor        # (B, gen) int32, the greedy tokens
    logits: list                # each step's (B, 1, vocab) logits, if kept
    prefill_s: float            # the prompt: prefill, or its steps
    decode_s: float             # the generated tokens' steps after it
    steps: int                  # forward calls after the prefill


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def generate(params, cfg, prompts: torch.Tensor, gen: int, *,
             keep_logits: bool = False) -> Generation:
    """Greedy decoding of ``gen`` tokens after ``prompts`` (B, P) int,
    the JAX ``serve.main`` loops: an LM prefills a cache of ``P + gen``
    rows and decodes ``gen - 1`` steps; xLSTM and Zamba2 step the first
    ``P - 1`` prompt tokens, then ``gen`` steps from the prompt's first
    token.  Under ``torch.inference_mode``.  ``keep_logits`` keeps every
    step's logits in order (an LM's prefill first; a recurrent model's
    prompt steps first)."""
    from repro_torch.models import lm as lm_mod
    from repro_torch.models import mamba as zm
    from repro_torch.models import xlstm as xm

    B, P = prompts.shape
    dev = prompts.device
    kept: list = []

    def argmax(logits):
        if keep_logits:
            kept.append(logits)
        return torch.argmax(logits, -1).to(torch.int32)

    with torch.inference_mode():
        _sync(dev)
        t0 = time.perf_counter()
        if isinstance(cfg, lm_mod.LMConfig):
            logits, caches = lm_mod.prefill(params, prompts, cfg, P + gen)
            tok = argmax(logits)
            _sync(dev)
            t1 = time.perf_counter()
            outs = [tok]
            for _ in range(gen - 1):
                logits, caches = lm_mod.decode_step(params, tok, caches, cfg)
                tok = argmax(logits)
                outs.append(tok)
            steps = gen - 1
        elif isinstance(cfg, (xm.XLSTMConfig, zm.Zamba2Config)):
            if isinstance(cfg, xm.XLSTMConfig):
                mod, states = xm, xm.init_states(cfg, B, dev)
            else:
                mod, states = zm, zm.init_states(cfg, B, P + gen, dev)
            for i in range(P - 1):
                logits, states = mod.decode_step(params, prompts[:, i:i + 1],
                                                 states, cfg)
                if keep_logits:
                    kept.append(logits)
            _sync(dev)
            t1 = time.perf_counter()
            tok = prompts[:, :1]
            outs = []
            for _ in range(gen):
                logits, states = mod.decode_step(params, tok, states, cfg)
                tok = argmax(logits)
                outs.append(tok)
            steps = gen
        else:
            raise ValueError(f"{cfg.name}: serving not wired for this family")
        tokens = torch.cat(outs, dim=1)
        _sync(dev)
        t2 = time.perf_counter()
    return Generation(tokens, kept, t1 - t0, t2 - t1, steps)


def _parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> torch.Tensor:
    args = _parse_args(argv)
    from repro_torch.configs.smoke import (LM_FACTORIES, RECURRENT_FACTORIES,
                                           SMOKE_FACTORIES)

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("serve: no CUDA device visible; pass --device cpu "
                         "to serve on the CPU")
    factories = {**LM_FACTORIES, **RECURRENT_FACTORIES}
    if args.arch in SMOKE_FACTORIES:
        raise SystemExit(f"{args.arch} is not a token-serving arch")
    if args.arch not in factories:
        raise SystemExit(f"unknown arch {args.arch}")
    name, dev = args.arch, torch.device(args.device)
    # the smoke variant of the arch, its kernels on: flash on the card
    _, init_fn, _, cfg = factories[name](kernels=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        params = init_fn(gen, dev)
    prompts = torch.randint(0, VOCAB, (args.batch, args.prompt_len),
                            generator=gen, device=dev, dtype=torch.int32)
    try:
        out = generate(params, cfg, prompts, args.gen)
    except ValueError as e:
        raise SystemExit(str(e))
    dt = out.prefill_s + out.decode_s
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu")
    print(f"[serve] {name} on {where}: batch={args.batch} generated "
          f"{out.tokens.shape[1]} tokens/seq in {dt:.2f}s "
          f"({args.batch * out.tokens.shape[1] / dt:.1f} tok/s; prefill "
          f"{out.prefill_s:.3f}s, decode {1e3 * out.decode_s / max(out.steps, 1):.2f}"
          " ms/step)")
    print("[serve] sample:", out.tokens[0, :16].tolist())
    return out.tokens


if __name__ == "__main__":
    main()
