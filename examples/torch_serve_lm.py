"""Serving on the PyTorch port: batched greedy decoding against a KV cache
(the port of ``examples/serve_lm.py``).

Builds an assigned arch at its reduced config, feeds a prompt by decode
steps, then decodes tokens step by step through ``make_serve_step`` (the
step the decode_* dry-run cells trace at production shapes). It runs on
the CUDA card unless --device cpu is given.

    PYTHONPATH=src python examples/torch_serve_lm.py --arch qwen2-0.5b \
        --tokens 32 [--device cpu]
"""

import argparse
import time

import torch

from repro_torch.configs import ARCHS, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models.registry import build
from repro_torch.train.serve_step import make_serve_step


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b", choices=list(ARCHS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' runs the kernels; 'cpu' their plain "
                         "PyTorch versions")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch)
    model = build(cfg)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    s_max = args.prompt_len + args.tokens + 1
    cache = model.init_cache(args.batch, s_max, dev)
    if cfg.kind == "encdec":
        from repro_torch.models import whisper
        frames = 0.1 * torch.randn(
            (args.batch, cfg.enc_seq, cfg.d_model), device=dev,
            generator=torch.Generator(device=dev).manual_seed(2))
        cache = whisper.prefill_cross(cfg, params, cache, frames)

    serve = make_serve_step(cfg)
    prompt = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                           device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(1))

    # prefill via decode steps (teacher-forcing the prompt)
    for t in range(args.prompt_len):
        nxt, cache = serve(params, prompt[:, t:t + 1], cache, t)
    generated = [nxt]

    t0 = time.perf_counter()
    for t in range(args.prompt_len, args.prompt_len + args.tokens - 1):
        nxt, cache = serve(params, generated[-1], cache, t)
        generated.append(nxt)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0

    out = torch.cat(generated, dim=1)
    assert out.shape == (args.batch, args.tokens)
    assert bool(((out >= 0) & (out < cfg.vocab)).all())
    print(f"arch={args.arch} generated {out.shape[1]} tokens x "
          f"batch {args.batch} in {wall:.2f}s "
          f"({args.batch * out.shape[1] / wall:.1f} tok/s) on {dev}")
    print("first row:", out[0, :16].tolist())


if __name__ == "__main__":
    main()
