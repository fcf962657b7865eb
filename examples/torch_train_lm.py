"""End-to-end LM training with fault tolerance, on the PyTorch port.

    PYTHONPATH=src python examples/torch_train_lm.py --preset 100m --steps 300
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu   # tiny, on the CPU

The counterpart of examples/train_lm.py: trains a ~100M-parameter
starcoder2-family model for a few hundred steps on the synthetic token
stream, on the GPU, with async checkpointing every 25 steps.
``--preset tiny`` (default) runs the same loop at smoke scale in seconds.
Checkpoints go to ``--ckpt-dir``; a run finds the newest one there and
resumes from it, so rerunning after killing the process restarts from the
latest checkpoint and converges to the same trajectory.  ``--resume``
insists on that (it fails where there is no checkpoint); without it, a
fresh run should be given an empty directory.
"""

import argparse
import os
import tempfile

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import LMConfig
from repro_torch.launch.train import TrainConfig, train

PRESETS = {
    # ~1M params: CI/smoke scale
    "tiny": LMConfig(
        name="tiny", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
        d_ff=512, vocab=2048,
    ),
    # ~100M params (starcoder2-family block structure)
    "100m": LMConfig(
        name="sc2-100m", n_layers=10, d_model=768, n_heads=12, n_kv_heads=2,
        d_ff=3072, vocab=32768,
    ),
}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--preset", default="tiny", choices=sorted(PRESETS))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_lm"))
    ap.add_argument("--resume", action="store_true",
                    help="resume from the newest checkpoint in --ckpt-dir (fail if none)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    if args.resume and CheckpointManager(args.ckpt_dir).latest_step() is None:
        raise SystemExit(f"--resume: no complete checkpoint in {args.ckpt_dir}")
    model = PRESETS[args.preset]
    print(f"model: {model.name} ({model.params_count() / 1e6:.1f}M params) on {args.device}")
    cfg = TrainConfig(
        steps=args.steps,
        batch=args.batch,
        seq_len=args.seq_len,
        ckpt_every=25,
        ckpt_dir=args.ckpt_dir,
        lr=3e-4,
        device=args.device,
        model=model,
    )
    _, _, losses = train(cfg)
    print(f"loss: {losses[0]:.4f} → {losses[-1]:.4f} over {len(losses)} steps")


if __name__ == "__main__":
    main()
