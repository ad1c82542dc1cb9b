"""Single-engine serving entry point of the port (the single-engine path
of ``repro/launch/serve.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve            # qwen3_1_7b on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu

Weights are random, drawn from seed 0 by a ``torch.Generator`` on the
serving device (the JAX launcher draws its own from ``jax.random``).
Requests: ``--requests`` prompts of ``--prompt-len`` random tokens
(numpy seed 0, as the JAX launcher), ``--max-new`` tokens each, with
temperature alternating 0 and 0.8.
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced_config
from repro_torch.models.model import init_params
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.util import resolve_device


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_1_7b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    return ap


def requests(args, vocab_size: int) -> Iterator[Request]:
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        yield Request(
            rid=i,
            prompt=rng.integers(0, vocab_size,
                                size=args.prompt_len).astype(np.int32),
            max_new_tokens=args.max_new,
            temperature=0.0 if i % 2 == 0 else 0.8)


def build_engine(args) -> ServeEngine:
    """The launcher's engine: config, seeded random params on the
    device, ``max_batch = min(8, requests)``, ``max_seq = prompt + new``."""
    device = resolve_device(args.device)
    cfg = (get_reduced_config if args.reduced else get_config)(args.arch)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = init_params(cfg, gen, device)
    return ServeEngine(cfg, params, max_batch=min(8, args.requests),
                       max_seq=args.prompt_len + args.max_new,
                       device=device)


def serve(eng: ServeEngine, args) -> Tuple[List[Request], Dict[str, Any]]:
    """Submit the launcher's requests to ``eng`` and drain it."""
    reqs = list(requests(args, eng.cfg.vocab_size))
    for r in reqs:
        eng.submit(r)
    return reqs, eng.run()


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    args = parser().parse_args(argv)
    eng = build_engine(args)
    _, stats = serve(eng, args)
    for k, v in stats.items():
        print(f"{k}: {v}")
    return stats


if __name__ == "__main__":
    main()
