"""Serving launcher: prefill + batched greedy decode with a KV cache
(counterpart of ``repro.launch.serve``).

``python -m repro_torch.launch.serve --arch qwen3-0.6b --smoke --tokens 32
--device cpu`` runs prompt prefill then autoregressive decode, reporting
tokens/s.  Without ``--device`` it runs on the CUDA device, and raises
where there is none.  Mining-as-a-service (``--mine``) and the recsys
models are not ported yet (ROADMAP.md queue 1).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.registry import get_arch
from repro_torch.device import DeviceSpec, resolve_device


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve_lm(arch, smoke: bool, batch: int, prompt_len: int,
             gen_tokens: int, seed: int, device: DeviceSpec = None,
             prompt=None, stats: dict | None = None) -> torch.Tensor:
    """Prefill a prompt into a cache of ``prompt_len + gen_tokens``, then
    decode greedily; returns the ``[batch, gen_tokens]`` new tokens.

    The weights are ``init_params(cfg, torch.Generator(device)
    .manual_seed(seed))``; the prompt is drawn from that generator next,
    unless ``prompt`` (int ``[batch, prompt_len]``, a tensor or numpy
    array) is given.  ``stats``, when given, receives the prefill and
    decode wall times (each ending in a device sync) and the decoded token
    count.
    """
    from repro_torch.models import transformer as T
    cfg = arch.smoke if smoke else arch.config
    dev = resolve_device(device)
    if gen_tokens < 1:
        raise ValueError(f"gen_tokens={gen_tokens}; decode at least one")
    gen = torch.Generator(dev).manual_seed(seed)
    params = T.init_params(cfg, gen, device=dev)
    if prompt is None:
        prompt = torch.randint(0, cfg.vocab, (batch, prompt_len),
                               generator=gen, device=dev, dtype=torch.int32)
    else:
        prompt = torch.as_tensor(prompt, dtype=torch.int32, device=dev)
        if tuple(prompt.shape) != (batch, prompt_len):
            raise ValueError(f"prompt {tuple(prompt.shape)} is not "
                             f"{(batch, prompt_len)}")
    total = prompt_len + gen_tokens
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = T.prefill(cfg, params, prompt, cache_len=total)
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    out = [tok]
    t0 = time.perf_counter()
    for i in range(gen_tokens - 1):
        logits, cache = T.decode_step(cfg, params, cache, tok,
                                      prompt_len + i)
        tok = torch.argmax(logits[:, 0], -1)[:, None].to(torch.int32)
        out.append(tok)
    _sync(dev)
    dt = time.perf_counter() - t0
    toks = batch * (gen_tokens - 1)
    print(f"[serve] {arch.arch_id}: batch {batch}, prompt {prompt_len}, "
          f"decoded {toks} tokens in {dt:.2f}s "
          f"({toks / max(dt, 1e-9):.1f} tok/s)")
    if stats is not None:
        stats.update(prefill_s=prefill_s, decode_s=dt, decode_tokens=toks)
    return torch.cat(out, dim=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="model arch to serve")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--mine", action="store_true",
                    help="mining-as-a-service (not ported yet)")
    args = ap.parse_args(argv)
    if args.mine:
        raise NotImplementedError("serve --mine is not ported yet (ROADMAP.md "
                                  "queue 1 item 11)")
    if args.arch is None:
        raise SystemExit("--arch is required")
    arch = get_arch(args.arch)
    if arch.family == "lm":
        return serve_lm(arch, args.smoke, args.batch, args.prompt_len,
                        args.tokens, args.seed, device=args.device)
    if arch.family == "recsys":
        raise NotImplementedError("recsys serving is not ported yet "
                                  "(ROADMAP.md queue 1, the ML stack)")
    raise SystemExit("serving applies to lm/recsys archs")


if __name__ == "__main__":
    main()
