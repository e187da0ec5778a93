"""Batched serving driver: prefill a batch of prompts, decode greedily.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-4b \
        [--smoke] --batch 4 --prompt-len 16 --gen 32 [--device cpu]

Parameters and prompts are drawn from a seeded torch.Generator on the
device (the card unless ``--device cpu``); ``--arch`` takes every preset
of `repro_torch.configs.ARCH_IDS`.  For the VLM backbone, N(0, 1) vision
embeddings replace the first min(nv, prompt-len) token embeddings; for
whisper, N(0, 1) frames (B, encoder_seq, d_model) in the model dtype go
through the encoder once, in `start_cache`.  The printed seconds are the device's: the card is
synchronized before each clock read.
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from ..configs import get_config
from ..dist.backends import resolve_device
from ..models import decode as dec
from ..models import params as mparams
from ..models.model import RunConfig
from ..models.steps import build_serve_step


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen1.5-4b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: the card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    run = RunConfig(attn_impl="ref")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = mparams.init_params(cfg, gen, device=dev)

    B = args.batch
    prompts = torch.randint(0, cfg.vocab_size, (B, args.prompt_len),
                            device=dev, generator=gen)
    vision = None
    if cfg.family == "vlm":
        nv = min(cfg.n_vision_tokens, args.prompt_len)
        vision = torch.randn(B, nv, cfg.d_model, device=dev, generator=gen)
    frames = None
    if cfg.is_encoder_decoder:
        frames = torch.randn(B, cfg.encoder_seq, cfg.d_model, device=dev,
                             generator=gen, dtype=cfg.torch_dtype)

    def clock() -> float:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    serve_step = build_serve_step(cfg, run)
    max_seq = args.prompt_len + args.gen
    cache = dec.start_cache(cfg, params, B, max_seq, run,
                            encoder_frames=frames)
    t0 = clock()
    logits, cache = dec.prefill(cfg, params, prompts, cache, run,
                                vision_embeds=vision)
    t_prefill = clock() - t0
    tok = logits.argmax(-1).to(prompts.dtype)
    out = [tok]
    t0 = clock()
    for _ in range(args.gen - 1):
        tok, cache = serve_step(params, cache, tok[:, None])
        out.append(tok)
    gen_ids = torch.stack(out, dim=1)
    dt = clock() - t0
    print(f"[serve] batch={B} prompt={args.prompt_len} gen={args.gen}")
    print(f"[serve] prefill {t_prefill:.2f}s, decode {dt:.2f}s "
          f"({B * (args.gen - 1) / max(dt, 1e-9):.1f} tok/s)")
    print(f"[serve] sample generations (ids): {gen_ids[:2, :12].tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
