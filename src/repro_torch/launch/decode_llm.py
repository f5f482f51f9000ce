"""LLM batched greedy decode with KV caches — the port of
``repro.launch.decode_llm`` (seed scaffolding, see
``docs/SEED_SCAFFOLDING.md``; it is not the paper system's serving tier).

The prompt is fed token by token through the decode step (the
cache-building pass), then ``new_tokens`` tokens are generated greedily.
An encoder-decoder first encodes ``prompt_len`` zero frames into its
cross-attention caches, as the reference does. Weights come from a seed,
as the reference's do; the SWA layers' attention runs K7 once their ring
is full. Every arch of the registry runs. It runs on the GPU unless
``device="cpu"`` is passed.

  PYTHONPATH=src python -m repro_torch.launch.decode_llm \\
      --arch h2o-danube-1.8b --batch 4 --prompt-len 4096 --new-tokens 64
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import prng
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.device import resolve_device
from repro_torch.models import Model


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(arch: str, *, reduced: bool = False, batch: int = 4, prompt_len: int = 16,
          new_tokens: int = 32, seed: int = 0, device=None):
    """Returns ``(generated (batch, new_tokens) int32, {"prefill_s",
    "decode_s", "tok_per_s"})``, the tokens the reference's ``serve``
    generates from the same seed."""
    dev = resolve_device(device)
    # The default, set explicitly: TF32 matmuls would cost the decode its
    # parity with the reference.
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    with torch.inference_mode():
        model = Model(cfg, prng.PRNGKey(seed), device=dev)
        rng = np.random.default_rng(seed)
        prompts = torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (batch, prompt_len), dtype=np.int32)).to(dev)
        cache_len = prompt_len + new_tokens
        if cfg.attention_window is not None:
            cache_len = min(cache_len, cfg.attention_window)
        enc_len = prompt_len if cfg.encoder_layers else None
        cache = model.init_cache(batch, cache_len, enc_len=enc_len)
        if cfg.encoder_layers:
            # the reference's stand-in audio: zero frames, one a prompt token
            frames = torch.zeros((batch, prompt_len, cfg.d_model), dtype=getattr(torch, cfg.dtype),
                                 device=dev)
            cache = model.prefill_encoder(frames, cache)
        _sync(dev)

        # prefill by decoding the prompt (cache-building pass)
        t0 = time.perf_counter()
        logits = None
        for i in range(prompt_len):
            logits, cache = model.decode_step(cache, prompts[:, i:i + 1], i)
        _sync(dev)
        t_prefill = time.perf_counter() - t0

        out = []
        tok = torch.argmax(logits[:, :, :cfg.vocab_size], dim=-1).to(torch.int32)
        t0 = time.perf_counter()
        for i in range(new_tokens):
            out.append(tok)
            logits, cache = model.decode_step(cache, tok, prompt_len + i)
            tok = torch.argmax(logits[:, :, :cfg.vocab_size], dim=-1).to(torch.int32)
        _sync(dev)
        t_decode = time.perf_counter() - t0
        gen = torch.cat(out, dim=1)
    return gen, {"prefill_s": t_prefill, "decode_s": t_decode,
                 "tok_per_s": batch * new_tokens / t_decode}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)
    gen, stats = serve(args.arch, reduced=args.reduced, batch=args.batch,
                       prompt_len=args.prompt_len, new_tokens=args.new_tokens,
                       device=args.device)
    print(f"generated {tuple(gen.shape)} tokens; "
          f"prefill {stats['prefill_s']:.2f}s decode {stats['decode_s']:.2f}s "
          f"({stats['tok_per_s']:.1f} tok/s)")
    print("first sequence:", gen[0, :16].tolist())


if __name__ == "__main__":
    main()
