"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[...]`` (counterpart of ``repro.launch.train``).

* the step is the cell of ``launch/steps.py`` (``train_4k`` for an LM,
  ``train_batch`` for DIEN), with the weights ``param_init(torch.Generator
  (device).manual_seed(seed))``;
* the data is stateless by step (``data/pipeline.py``), so a restart
  replays the same batches; an LM batch is laid out ``[n_micro, B /
  n_micro, S]`` for a cell with microbatches (the JAX launcher hands such a
  cell ``[B, S]`` unless ``--smoke``, which cannot run);
* checkpoints every ``--ckpt-every`` steps in the JAX package's format,
  and a resume from the latest one in ``--ckpt-dir``;
* ``--fail-at N`` exits with code 42 after step N (the restart test).

Each logged step prints its loss, its wall time (ending in a device sync)
and tokens/s (requests/s for DIEN).  Without ``--device`` it runs on the
CUDA device, and raises where there is none.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.registry import get_arch
from repro_torch.data import pipeline as data_pipe
from repro_torch.device import DeviceSpec, resolve_device
from repro_torch.launch.steps import build_cell
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import init_opt_state


def make_batch(arch, cfg, step: int, batch: int, seq: int, seed: int,
               n_micro: int = 1, device: DeviceSpec = None) -> dict:
    if arch.family == "lm":
        b = data_pipe.lm_batch(seed, step, batch, seq, cfg.vocab,
                               device=device)
        if n_micro > 1:
            if batch % n_micro:
                raise ValueError(f"batch {batch} does not split into "
                                 f"{n_micro} microbatches")
            b = {k: v.reshape(n_micro, batch // n_micro, seq)
                 for k, v in b.items()}
        return b
    if arch.family == "recsys":
        return data_pipe.recsys_batch(seed, step, batch, cfg.seq_len,
                                      cfg.n_items, cfg.n_cats, device=device)
    raise ValueError("train.py drives lm and recsys archs")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None, stats: list | None = None):
    """Train; returns the losses of the steps run.  ``stats``, when given,
    receives one dict a step: ``step``, ``loss``, ``wall_s``, ``rate``
    (tokens or requests a second) and, on the card, ``peak_bytes``
    (``max_memory_allocated`` since the step began)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fail-at", type=int, default=-1,
                    help="simulate a crash after N steps (fault-tolerance "
                         "testing)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: the CUDA device)")
    args = ap.parse_args(argv)

    arch = get_arch(args.arch)
    shape_name = {"lm": "train_4k", "recsys": "train_batch"}[arch.family]
    cell = build_cell(args.arch, shape_name, smoke=args.smoke)
    dev = resolve_device(args.device)
    params = cell.param_init(torch.Generator(dev).manual_seed(args.seed),
                             device=dev)
    opt_state = init_opt_state(params, cell.opt_cfg)
    start_step = 0
    if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        (params, opt_state), start_step, _ = ckpt.restore_checkpoint(
            args.ckpt_dir, (params, opt_state))
        print(f"[train] resumed from step {start_step}")

    unit = "tokens" if arch.family == "lm" else "requests"
    per_step = args.batch * (args.seq if arch.family == "lm" else 1)
    losses = []
    t0 = time.time()
    for step in range(start_step, args.steps):
        batch = make_batch(arch, cell.cfg, step, args.batch, args.seq,
                           args.seed, n_micro=cell.n_micro, device=dev)
        _sync(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t_step = time.perf_counter()
        params, opt_state, loss = cell.fn(params, opt_state, batch)
        loss = float(loss)
        _sync(dev)
        wall = time.perf_counter() - t_step
        losses.append(loss)
        if stats is not None:
            stats.append({"step": step, "loss": loss, "wall_s": wall,
                          "rate": per_step / wall,
                          **({"peak_bytes": torch.cuda.max_memory_allocated(
                              dev)} if dev.type == "cuda" else {})})
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"[train] step {step:5d} loss {loss:.4f} "
                  f"{wall:.3f} s {per_step / wall:.0f} {unit}/s "
                  f"({(time.time() - t0):.1f}s)")
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            ckpt.save_checkpoint(args.ckpt_dir, step + 1,
                                 (params, opt_state))
        if args.fail_at >= 0 and step + 1 >= args.fail_at:
            print(f"[train] simulated failure at step {step + 1}")
            raise SystemExit(42)
    print(f"[train] done: first loss {losses[0]:.4f} "
          f"last loss {losses[-1]:.4f}")
    return losses


if __name__ == "__main__":
    main()
