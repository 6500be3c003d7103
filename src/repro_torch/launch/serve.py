"""Serving steps (prefill, one-token decode) and a greedy-decode launcher.

Port of ``src/repro/launch/serve.py`` and of the greedy loop of
``examples/serve_decode.py::serve``. ``make_serve_step`` returns the
bundle's ``prefill`` or ``decode_step``; :func:`generate` prefills a batch of
prompts into a fresh cache and decodes greedily from it (argmax over all
``vocab_padded`` columns, as the reference does). An audio request brings
its frames: the encoder runs once at admission and the prefill and every
decode step take its output as ``memory`` (``configs/shapes.py``'s serving
contract; the reference's CLI loop encodes the frames again each step, with
the same logits). A vlm request brings its patches: they go in with the
prompt, so the cache holds P + T + gen positions and decoding starts at
position P + T. Serving is not federated: it never touches the round
engines.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b --smoke
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b \\
        --batch 4 --prompt-len 2048 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-medium \\
        --batch 4 --prompt-len 416 --gen 32

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
    encode_ms: float = 0.0        # the audio encoder at admission (0 without frames)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(bundle: ModelBundle, params: dict, tokens: torch.Tensor, gen: int, *,
             frames: torch.Tensor | None = None,
             patches: torch.Tensor | None = None) -> Generation:
    """Greedy decoding of ``gen`` tokens after the prompts ``tokens``
    [B, T] (int32, on the params' device): a cache of T + gen positions
    (P + T + gen with P ``patches``), one prefill, then ``gen - 1`` decode
    steps, each feeding back the argmax of the last logits. ``frames``
    [B, F, d_model] (audio) are encoded once, before the prefill;
    ``patches`` [B, P, vision_dim] (vlm) go in with the prompt."""
    if gen < 1:
        raise ValueError(f"gen must be >= 1, got {gen}")
    cfg = bundle.cfg
    if (frames is not None and cfg.arch_type != "audio") or \
            (patches is not None and cfg.arch_type != "vlm"):
        raise ValueError(f"{cfg.name}: frames go with the audio family, patches with vlm")
    B, T = tokens.shape
    P = 0 if patches is None else patches.shape[1]
    device = tokens.device
    prefill = make_serve_step(bundle, "prefill")
    decode = make_serve_step(bundle, "decode")
    with torch.no_grad():
        cache = bundle.init_cache(B, P + T + gen, device=device)
        extra, pre = {}, {"tokens": tokens}
        if patches is not None:
            pre["patches"] = patches
        encode_ms = 0.0
        _sync(device)
        if frames is not None:
            t_enc = time.perf_counter()
            extra["memory"] = bundle.memory(params, {"frames": frames})
            _sync(device)
            encode_ms = (time.perf_counter() - t_enc) * 1e3
        t0 = time.perf_counter()
        logits, cache = prefill(params, {**pre, **extra}, cache)
        tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        _sync(device)
        t1 = time.perf_counter()
        out, lg = [tok], logits
        for i in range(gen - 1):
            lg, cache = decode(params, {"token": tok, "index": P + T + i, **extra}, cache)
            tok = torch.argmax(lg, dim=-1)[:, None].to(torch.int32)
            out.append(tok)
        _sync(device)
        t2 = time.perf_counter()
    return Generation(torch.cat(out, dim=1), logits, lg, (t1 - t0) * 1e3, (t2 - t1) * 1e3,
                      encode_ms)


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
    stubs = {}
    if cfg.arch_type == "vlm":
        stubs["patches"] = rng.normal(size=(B, cfg.vision_tokens, cfg.vision_dim))
    if cfg.arch_type == "audio":
        stubs["frames"] = rng.normal(size=(B, cfg.encoder_frames, cfg.d_model))
    res = generate(bundle, params, toks, args.gen, **{
        k: torch.from_numpy(v.astype(np.float32)).to(dev) for k, v in stubs.items()})
    seq = res.tokens.cpu().numpy()
    enc = f", encoder {res.encode_ms:.1f} ms" if "frames" in stubs else ""
    print(f"[serve] arch={cfg.name} device={dev} generated {tuple(seq.shape)}: "
          f"{seq[0][:12]}... prefill {res.prefill_ms:.1f} ms, decode "
          f"{res.decode_ms / max(args.gen - 1, 1):.2f} ms/step{enc}")


if __name__ == "__main__":
    main()
