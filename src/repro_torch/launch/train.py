"""Fault-tolerant training loop: ``python -m repro_torch.launch.train``.

The PyTorch counterpart of ``repro.launch.train``, the loop a real
cluster job runs:

  restore-or-init → [ step × K → async checkpoint → health check ] → …

  * checkpoint/restart — state (params, opt, step) restores bit-exact; the
    seekable data pipeline resumes mid-stream from the step counter alone.
  * crash injection — ``failure_at_step`` raises mid-run; a relaunched
    job resumes from the newest complete checkpoint and reaches the
    same final loss as an uninterrupted run.
  * straggler mitigation — each step has a wall-clock budget (here the
    step's host time up to its loss on the host); persistent overruns are
    logged as a re-layout request.

Works for the LM family (``--arch`` any LM config, the reduced one by
default), on the GPU unless ``device="cpu"`` is asked for.  The step runs
eagerly.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.configs.base import LMConfig
from repro_torch.data.tokens import TokenStream
from repro_torch.models import transformer as tf_mod
from repro_torch.optim import OptConfig, adamw_init


@dataclasses.dataclass
class TrainConfig:
    arch: str = "starcoder2-3b"
    reduced: bool = True  # CPU-scale config
    steps: int = 200
    batch: int = 8
    seq_len: int = 64
    ckpt_every: int = 20
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    lr: float = 1e-3
    failure_at_step: Optional[int] = None  # crash injection (tests)
    step_budget_s: float = 60.0  # straggler threshold
    seed: int = 0
    device: str = "cuda"
    model: Optional[LMConfig] = None  # an LM config in place of the arch's


def train(cfg: TrainConfig, *, log=print):
    if cfg.model is not None:
        model_cfg = cfg.model
    else:
        arch = get_arch(cfg.arch)
        model_cfg = arch.reduced if cfg.reduced else arch.model
    device = torch.device(cfg.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' for the CPU")
    opt_cfg = OptConfig(lr=cfg.lr)

    params = tf_mod.init_params(
        model_cfg, torch.Generator(device=device).manual_seed(cfg.seed))
    opt_state = adamw_init(params, opt_cfg)
    mgr = CheckpointManager(cfg.ckpt_dir)
    start_step = 0
    restored_step, restored = mgr.restore({"params": params, "opt": opt_state})
    if restored is not None:
        params, opt_state = restored["params"], restored["opt"]
        start_step = restored_step + 1
        log(f"[train] resumed from checkpoint at step {restored_step}")

    step_fn = tf_mod.make_train_step(model_cfg, opt_cfg, dp_axes=())
    stream = TokenStream(model_cfg.vocab, cfg.batch, cfg.seq_len, seed=cfg.seed)

    losses = []
    slow_steps = 0
    for step in range(start_step, cfg.steps):
        if cfg.failure_at_step is not None and step == cfg.failure_at_step:
            mgr.wait()
            raise RuntimeError(f"injected failure at step {step}")
        t0 = time.time()
        tokens = torch.from_numpy(stream.batch_at(step)).to(device)
        params, opt_state, loss = step_fn(params, opt_state, tokens)
        losses.append(float(loss))
        dt = time.time() - t0
        if dt > cfg.step_budget_s:
            slow_steps += 1
            log(f"[straggler] step {step} took {dt:.1f}s > {cfg.step_budget_s}s "
                f"({slow_steps} consecutive); requesting re-layout")
        else:
            slow_steps = 0
        if step % cfg.ckpt_every == cfg.ckpt_every - 1:
            mgr.save(step, {"params": params, "opt": opt_state})
        if step % 10 == 0:
            log(f"[train] step {step} loss {losses[-1]:.4f}")
    mgr.wait()
    mgr.save(cfg.steps - 1, {"params": params, "opt": opt_state}, blocking=True)
    return params, opt_state, losses


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="starcoder2-3b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=TrainConfig.ckpt_dir)
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    cfg = TrainConfig(
        arch=args.arch,
        reduced=not args.full_config,
        steps=args.steps,
        batch=args.batch,
        seq_len=args.seq_len,
        ckpt_dir=args.ckpt_dir,
        device=args.device,
    )
    _, _, losses = train(cfg)
    print(f"final loss: {losses[-1]:.4f} (from {losses[0]:.4f})")


if __name__ == "__main__":
    main()
