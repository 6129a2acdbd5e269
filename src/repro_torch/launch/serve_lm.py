"""Serving launcher: batched greedy decoding against a KV cache (the port
of ``examples/serve_lm.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch qwen2-0.5b \
        [--batch 4] [--prompt-len 16] [--tokens 32] [--full] \
        [--device cuda|cpu]

Builds an arch at its smoke config (``--full``: its published config) with
random weights from seed 0 and a random prompt from seed 1; the
encoder-decoder (whisper) also takes 0.1 x normal frames (b, enc_seq, d)
from seed 2 and runs ``prefill_cross`` on them, as the reference example
does. It prefills the prompt through ``make_prefill`` (the forward, whose
attention is the flash-attention kernel on the card) twice and prints the
time of the second call, the first having built and loaded the kernels;
then, as the reference does, feeds the prompt by teacher-forced decode
steps and decodes ``--tokens`` tokens greedily, and prints the reference's
two lines. The SSM (mamba2) takes only a ``--prompt-len`` that is a
multiple of its ``ssm_chunk``, as its chunked scan does. It runs on the
CUDA device unless --device cpu is given, and stops with an error when no
card is present.
"""

from __future__ import annotations

import argparse
import time


def main(argv=None) -> None:
    from repro_torch.configs import ARCHS

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b", choices=list(ARCHS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--full", action="store_true",
                    help="the arch's published config instead of its smoke "
                         "config")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' runs the kernels; 'cpu' their plain "
                         "PyTorch versions")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.device import resolve_device
    from repro_torch.models import whisper
    from repro_torch.models.registry import build
    from repro_torch.train.serve_step import make_prefill, make_serve_step

    cfg = (get_config if args.full else get_smoke_config)(args.arch)
    if cfg.kind == "ssm" and args.prompt_len % cfg.ssm_chunk:
        ap.error(f"--prompt-len {args.prompt_len}: {args.arch} prefills in "
                 f"chunks of {cfg.ssm_chunk} tokens, so the prompt length "
                 f"must be a multiple of {cfg.ssm_chunk}")
    dev = resolve_device(args.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    model = build(cfg)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    s_max = args.prompt_len + args.tokens + 1
    cache = model.init_cache(args.batch, s_max, dev)
    frames = None
    if cfg.kind == "encdec":
        frames = 0.1 * torch.randn(
            (args.batch, cfg.enc_seq, cfg.d_model), device=dev,
            generator=torch.Generator(device=dev).manual_seed(2))
        cache = whisper.prefill_cross(cfg, params, cache, frames)
    serve = make_serve_step(cfg)
    prompt = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                           generator=torch.Generator(device=dev).manual_seed(1),
                           device=dev)

    # the first call builds and loads the kernels: untimed
    prefill = make_prefill(cfg)
    prefill(params, prompt, frames)
    sync()
    t0 = time.perf_counter()
    hidden, _ = prefill(params, prompt, frames)
    sync()
    wall = time.perf_counter() - t0
    print(f"prefill: {wall * 1e3:.1f} ms, "
          f"{args.batch * args.prompt_len / wall:.1f} tok/s")
    del hidden

    # prefill via decode steps (teacher-forcing the prompt)
    for t in range(args.prompt_len):
        nxt, cache = serve(params, prompt[:, t:t + 1], cache, t)
    generated = [nxt]

    sync()
    t0 = time.perf_counter()
    for t in range(args.prompt_len, args.prompt_len + args.tokens - 1):
        nxt, cache = serve(params, generated[-1], cache, t)
        generated.append(nxt)
    sync()
    wall = time.perf_counter() - t0

    out = torch.cat(generated, dim=1)
    print(f"arch={args.arch} generated {out.shape[1]} tokens x "
          f"batch {args.batch} in {wall:.2f}s "
          f"({args.batch * out.shape[1] / wall:.1f} tok/s)")
    print("first row:", out[0, :16].tolist())


if __name__ == "__main__":
    main()
