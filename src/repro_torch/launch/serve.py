"""Serving steps (prefill, one-token decode) and a greedy-decode launcher.

Port of ``src/repro/launch/serve.py`` and of the greedy loop of
``examples/serve_decode.py::serve``. ``make_serve_step`` returns the
bundle's ``prefill`` or ``decode_step``; :func:`generate` prefills a batch of
prompts into a fresh cache and decodes greedily from it (argmax over all
``vocab_padded`` columns, as the reference does). Serving is not federated:
it never touches the round engines.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b --smoke
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b \\
        --batch 4 --prompt-len 2048 --gen 32

runs on the CUDA card unless ``--device cpu`` is given (``--smoke`` runs the
reduced config, 2 layers of width 128, float32).
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.models.transformer import ModelBundle


def make_serve_step(bundle: ModelBundle, kind: str) -> Callable:
    if kind == "prefill":
        return bundle.prefill
    if kind == "decode":
        return bundle.decode_step
    raise ValueError(kind)


class Generation(NamedTuple):
    tokens: torch.Tensor          # [B, gen] int32, the greedy tokens
    prefill_logits: torch.Tensor  # [B, vocab_padded], logits of the last prompt position
    last_logits: torch.Tensor     # [B, vocab_padded], logits of the last step taken
    prefill_ms: float             # host clock, ends in a device synchronize
    decode_ms: float              # all gen - 1 decode steps together


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(bundle: ModelBundle, params: dict, tokens: torch.Tensor, gen: int) -> Generation:
    """Greedy decoding of ``gen`` tokens after the prompts ``tokens``
    [B, T] (int32, on the params' device): a cache of T + gen positions,
    one prefill, then ``gen - 1`` decode steps, each feeding back the
    argmax of the last logits."""
    if gen < 1:
        raise ValueError(f"gen must be >= 1, got {gen}")
    B, T = tokens.shape
    device = tokens.device
    prefill = make_serve_step(bundle, "prefill")
    decode = make_serve_step(bundle, "decode")
    with torch.no_grad():
        cache = bundle.init_cache(B, T + gen, device=device)
        _sync(device)
        t0 = time.perf_counter()
        logits, cache = prefill(params, {"tokens": tokens}, cache)
        tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        _sync(device)
        t1 = time.perf_counter()
        out, lg = [tok], logits
        for i in range(gen - 1):
            lg, cache = decode(params, {"token": tok, "index": T + i}, cache)
            tok = torch.argmax(lg, dim=-1)[:, None].to(torch.int32)
            out.append(tok)
        _sync(device)
        t2 = time.perf_counter()
    return Generation(torch.cat(out, dim=1), logits, lg, (t1 - t0) * 1e3, (t2 - t1) * 1e3)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="the reduced config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0, help="seed of the random params")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_arch
    from repro_torch.core.device import resolve_device
    from repro_torch.models.transformer import build_model

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    bundle = build_model(cfg)
    params = bundle.init(args.seed, device=dev)
    B, T = args.batch, args.prompt_len
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)).to(dev)
    res = generate(bundle, params, toks, args.gen)
    seq = res.tokens.cpu().numpy()
    print(f"[serve] arch={cfg.name} device={dev} generated {tuple(seq.shape)}: "
          f"{seq[0][:12]}... prefill {res.prefill_ms:.1f} ms, decode "
          f"{res.decode_ms / max(args.gen - 1, 1):.2f} ms/step")


if __name__ == "__main__":
    main()
