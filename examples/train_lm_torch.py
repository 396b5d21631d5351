"""End-to-end driver on the PyTorch port: train a ~100M-param qwen2-family
model for a few hundred steps with the full stack — the train step (the
flash attention kernel forward and backward on the card), stamp-guarded
data pipeline, async checkpointing, simulated failure + restart.  It runs
on the card (``--device cuda``, the default) or on the CPU (``--device
cpu``: the kernels' plain versions).

    PYTHONPATH=src python examples/train_lm_torch.py --steps 200
"""

import argparse
import tempfile

from repro_torch.configs import ARCHS, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.models import Model
from repro_torch.training import AdamWConfig, Trainer, inject_failure_at


def run(cfg, shape, steps, *, device, ckpt_dir, ckpt_every=50,
        inject_failure=-1):
    """Train ``cfg`` for ``steps`` steps of ``shape`` on ``device``,
    checkpointing into ``ckpt_dir`` every ``ckpt_every`` steps, with a
    simulated failure before step ``inject_failure`` when it is >= 0.
    Prints what the example prints; returns ``Trainer.run``'s report and
    the checkpoint steps on disk under ``"checkpoints"``."""
    model = Model(cfg, device=device)
    print(f"model: {model.n_params()/1e6:.1f}M params")

    hook = (inject_failure_at({inject_failure})
            if inject_failure >= 0 else None)
    trainer = Trainer(
        model, shape, model.device, ckpt_dir=ckpt_dir,
        ckpt_every=ckpt_every,
        adamw=AdamWConfig(lr=3e-3, warmup_steps=20), seed=0,
        failure_hook=hook,
    )
    out = trainer.run(steps)
    h = out["history"]
    k = max(len(h) // 5, 1)
    first = sum(x["loss"] for x in h[:k]) / k
    last = sum(x["loss"] for x in h[-k:]) / k
    print(f"steps: {out['final_step']}  restarts: {out['restarts']}")
    print(f"loss: first~{first:.3f} last~{last:.3f} "
          f"(final {h[-1]['loss']:.3f})")
    if steps >= 100:
        assert last < first, "loss should decrease over a real run"
    out["checkpoints"] = trainer.ckpt.available_steps()
    print(f"checkpoints: {out['checkpoints']} in {ckpt_dir}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--inject-failure", type=int, default=-1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--small", action="store_true",
                    help="~47M variant (half the default's parameters)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: cuda, the "
                         "CUDA kernels; cpu runs their plain versions)")
    args = ap.parse_args(argv)

    if args.small:  # ~47M
        cfg = ARCHS["qwen2-0.5b"].scaled(
            name="qwen2-47m", num_layers=8, d_model=512, num_heads=8,
            num_kv_heads=2, d_ff=2048, head_dim=64, vocab_size=32768,
            dtype="float32",
        )
    else:  # ~100M (the end-to-end driver scale)
        cfg = ARCHS["qwen2-0.5b"].scaled(
            name="qwen2-100m", num_layers=10, d_model=768, num_heads=12,
            num_kv_heads=2, d_ff=2304, head_dim=64, vocab_size=32768,
            dtype="float32",
        )
    shape = ShapeConfig("train_tiny", "train", seq_len=128, global_batch=8)
    device = resolve_device(args.device)  # before the directory is made
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro-ckpt-")
    return run(cfg, shape, args.steps, device=device,
               ckpt_dir=ckpt_dir, inject_failure=args.inject_failure)


if __name__ == "__main__":
    main()
