"""Serving launcher: batched greedy decode through the decode cache (a port
of ``repro.launch.serve``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_4b \
      --reduced --batch 4 --prompt-len 16 --gen 8 [--device cpu]

As in the reference, the prompt is fed token by token through
``decode_step`` into a serve-length cache, then decoding is greedy. The
audio and vision frontends are stubs that this path never runs: whisper
decodes from its one-token prompt with zero cross-attention caches, and
pixtral's patch embeddings are not used.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get
from repro_torch.models import build_model


class _StepClock:
    """Milliseconds between consecutive ``mark``s. On the GPU, CUDA events
    recorded on the current stream (read once at the end, so the loop adds
    no host synchronization); on the CPU, the host clock."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []
        self.mark()

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self):
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) for a, b in zip(self.marks,
                                                      self.marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]


@torch.no_grad()
def generate(model, prompt_tokens: torch.Tensor, gen: int, *,
             cache_len: int | None = None):
    """Greedy generation of ``gen`` tokens after ``prompt_tokens`` (B, S).

    Returns (tokens (B, gen), timings) with timings = {"wall_s": host
    seconds to the last token (ending in a synchronize), "step_ms": one
    entry per ``decode_step`` (the S prompt steps first), "prompt_len": S,
    "logits": the (B, vocab) logits after the last prompt token, the ones
    the first generated token is drawn from}. The position stays on the
    model's device and tokens are never read back inside the loop.
    ``cache_len`` defaults to S + gen."""
    dev = model.device
    b, s = prompt_tokens.shape
    prompt = prompt_tokens.to(dev)
    t0 = time.perf_counter()
    cache = model.init_cache(b, cache_len or s + gen)
    pos = torch.zeros((), dtype=torch.int64, device=dev)
    clock = _StepClock(dev)
    logits = None
    for t in range(s):
        logits, cache = model.decode_step(cache, prompt[:, t:t + 1], pos)
        pos = pos + 1
        clock.mark()
    first_logits = logits
    nxt = torch.argmax(logits, dim=-1)[:, None]
    out = [nxt]
    for _ in range(gen - 1):
        logits, cache = model.decode_step(cache, nxt, pos)
        nxt = torch.argmax(logits, dim=-1)[:, None]
        out.append(nxt)
        pos = pos + 1
        clock.mark()
    tokens = torch.cat(out, dim=1)
    step_ms = clock.intervals_ms()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return tokens, dict(wall_s=time.perf_counter() - t0, step_ms=step_ms,
                        prompt_len=s, logits=first_logits)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; fails without a GPU) or 'cpu'")
    args = ap.parse_args(argv)

    cfg = get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg, device=args.device)
    model.init_params(torch.Generator(device=model.device).manual_seed(0))
    b, s = args.batch, args.prompt_len
    total = s + args.gen
    toks = torch.randint(0, cfg.vocab, (b, s),
                         generator=torch.Generator().manual_seed(1))
    if cfg.frontend == "audio":
        toks = toks[:, :1]
    gen, timings = generate(model, toks, args.gen, cache_len=total)
    dt = timings["wall_s"]
    print(f"{cfg.name}: generated {tuple(gen.shape)} in {dt:.2f}s "
          f"({b * args.gen / dt:.1f} tok/s)")
    print("sample:", gen[0].tolist())


if __name__ == "__main__":
    main()
