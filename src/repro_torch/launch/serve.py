"""Batched serving launcher: prefill + decode loop with the KV-cache machinery.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
        --batch 4 --prompt-len 32 --gen 16
    PYTHONPATH=src python -m repro_torch.launch.serve --no-reduced --device cuda

An attention arch's prompt is prefilled in one pass into ring-buffer
caches sized for the generation; a recurrent arch (mamba2 / rwkv6 blocks,
zamba2's shared block with them) warms its state token by token from
``decode_state_specs`` instead, as the reference does.  Then both decode
token by token.  ``--reduced`` and ``--greedy`` default on and are
disabled with ``--no-reduced`` / ``--no-greedy`` (non-greedy decode samples
from the softmax with a seeded generator).  Runs on the GPU unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_arch
from repro_torch.configs.base import ArchConfig, ShapeCfg
from repro_torch.data.tokens import synthetic_batch
from repro_torch.device import resolve_device
from repro_torch.models import decode_state_specs, decode_step, init_model, prefill


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--greedy", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="argmax decode; --no-greedy samples from the "
                         "logits (seeded)")
    ap.add_argument("--sample-seed", type=int, default=0,
                    help="generator seed for --no-greedy sampling")
    ap.add_argument("--device", default="cuda",
                    help="torch device ('cpu' to run on the CPU)")
    args = ap.parse_args(argv)
    if args.prompt_len < 1:
        # the first generated token conditions on the last prompt logit
        ap.error("--prompt-len must be >= 1: decode is seeded from the last "
                 "prompt position's logits")
    if args.gen < 1:
        ap.error("--gen must be >= 1")
    return args


def select_token(logits: torch.Tensor, *, greedy: bool,
                 generator: torch.Generator | None = None) -> torch.Tensor:
    """Next-token choice from (batch, vocab) logits: argmax when greedy,
    seeded categorical sampling otherwise.  Returns (batch, 1) int64."""
    if greedy:
        return torch.argmax(logits, -1)[:, None]
    if generator is None:
        raise ValueError("non-greedy decoding needs a torch.Generator")
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cfg: ArchConfig, batch: int, prompt_len: int, gen: int, *, greedy: bool = True,
        sample_seed: int = 0, params=None, device=None) -> dict:
    """Prefill a synthetic prompt batch (step 0) of ``batch`` rows and
    ``prompt_len`` tokens -- in one pass for an attention arch, step-wise
    for a recurrent one -- then decode ``gen`` tokens.  ``params`` defaults
    to ``init_model(cfg, 0)``.  Returns the generated ``tokens`` (batch,
    gen) and the host-clock ``prefill_ms`` (the step-wise warm-up's where
    it is one) and ``decode_ms`` (each ended by a synchronize on the card),
    ``ms_per_token`` over the gen - 1 decode steps."""
    device = resolve_device(device)
    if params is None:
        params = init_model(cfg, 0, device=device)
    generator = None if greedy else torch.Generator(device=device).manual_seed(sample_seed)
    prompts = synthetic_batch(cfg, ShapeCfg("serve", prompt_len, batch, "prefill"), 0,
                              device=device)
    cap = prompt_len + gen + (cfg.vlm_image_tokens or 0)

    with torch.no_grad():
        t0 = time.perf_counter()
        if cfg.block_type == "attn":
            logits, st = prefill(params, cfg, prompts, pad_to=cap)
        else:
            # recurrent state: warmed token by token (prompt_len >= 1 is
            # enforced at parse time, so logits is always bound here)
            st = decode_state_specs(cfg, batch, cap, device=device)
            st["pos"] = torch.zeros((), dtype=torch.long, device=device)
            for t in range(prompt_len):
                logits, st = decode_step(params, cfg, prompts["tokens"][:, t:t + 1], st)
        _sync(device)
        t_prefill = time.perf_counter() - t0

        tok = select_token(logits, greedy=greedy, generator=generator)
        out_tokens = [tok]
        t0 = time.perf_counter()
        for _ in range(gen - 1):
            logits, st = decode_step(params, cfg, tok, st)
            tok = select_token(logits, greedy=greedy, generator=generator)
            out_tokens.append(tok)
        _sync(device)
        t_decode = time.perf_counter() - t0

    return {"tokens": torch.cat(out_tokens, dim=1), "prefill_ms": t_prefill * 1e3,
            "decode_ms": t_decode * 1e3,
            "ms_per_token": t_decode / max(gen - 1, 1) * 1e3}


def main(argv=None) -> dict:
    args = parse_args(argv)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    out = run(cfg, args.batch, args.prompt_len, args.gen, greedy=args.greedy,
              sample_seed=args.sample_seed, device=args.device)
    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len} "
          f"gen={args.gen} greedy={args.greedy}")
    print(f"prefill {out['prefill_ms']:.1f} ms | decode {out['decode_ms']:.1f} ms "
          f"({out['ms_per_token']:.2f} ms/token)")
    print("sample generations:", out["tokens"][:2].tolist())
    return out


if __name__ == "__main__":
    main()
