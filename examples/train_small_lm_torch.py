"""Train a small LM end to end on the PyTorch/CUDA port (the port's
counterpart of ``train_small_lm.py``).

Defaults are the reference's (a ~1M-param model, 200 steps); pass
``--dmodel 768 --layers 12 --steps 300`` for the ~100M-param
configuration.  Demonstrates: the synthetic data pipeline, AdamW with its
schedule, per-block recomputation, periodic background checkpoints and
resume.  Training runs the plain PyTorch path (no kernel), as the port's
training slice does.

    PYTHONPATH=src python examples/train_small_lm_torch.py [--device cpu]

``--ckpt`` defaults to ``repro_torch_train_small`` in the temporary
directory; ``--device`` defaults to ``cuda`` and raises without a card.
"""
import argparse
import os
import tempfile

import numpy as np

from repro_torch.data import DataConfig, SyntheticPipeline
from repro_torch.device import resolve_device
from repro_torch.models import ModelConfig, build_model
from repro_torch.training import (OptimizerConfig, TrainConfig, Trainer,
                                  TrainerConfig)


def main(argv=None) -> list[str]:
    """Run the example; returns the lines it printed."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--dmodel", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_train_small"))
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (default cuda)")
    a = ap.parse_args(argv)
    device = resolve_device(a.device)
    lines = []

    def say(line=""):
        print(line, flush=True)
        lines.append(line)

    cfg = ModelConfig(name="small-lm", family="dense", n_layers=a.layers,
                      d_model=a.dmodel, n_heads=max(a.dmodel // 64, 2),
                      n_kv_heads=max(a.dmodel // 128, 1),
                      d_ff=4 * a.dmodel, vocab_size=2048,
                      param_dtype="float32")
    model = build_model(cfg, device)
    say(f"model: {cfg.param_count()/1e6:.1f}M params")

    data = SyntheticPipeline(DataConfig(vocab_size=2048, seq_len=a.seq,
                                        global_batch=a.batch), device=device)
    tcfg = TrainConfig(optimizer=OptimizerConfig(
        peak_lr=1e-3, warmup_steps=20, total_steps=a.steps))
    trainer = Trainer(model, tcfg, data, TrainerConfig(
        total_steps=a.steps, checkpoint_every=50, log_every=20,
        ckpt_dir=a.ckpt), log_fn=say)
    trainer.run()
    say(f"loss: {np.mean(trainer.losses[:5]):.3f} -> "
        f"{np.mean(trainer.losses[-5:]):.3f}")
    say(f"checkpoints: {trainer.ckpt.all_steps()} in {a.ckpt}")
    return lines


if __name__ == "__main__":
    main()
