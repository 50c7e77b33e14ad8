"""Fault tolerance on the PyTorch/CUDA port: preemptions, restarts,
elastic restore (the port's counterpart of ``elastic_failover.py``).

1. Trains with deterministic *simulated preemptions* at steps 23 and 57;
   the supervisor restarts from the newest checkpoint each time.
2. Compares with an uninterrupted run (step-keyed data pipeline +
   checkpointed optimizer state = exact resume).
3. Restores the final checkpoint into a freshly built trainer and keeps
   training to step 90.

    PYTHONPATH=src python examples/elastic_failover_torch.py [--device cpu]

The checkpoints go to ``repro_torch_ft_a`` and ``repro_torch_ft_b`` in the
temporary directory.  ``--device`` defaults to ``cuda`` and raises without
a card.
"""
import argparse
import os
import shutil
import tempfile

from repro_torch.data import DataConfig, SyntheticPipeline
from repro_torch.device import resolve_device
from repro_torch.models import ModelConfig, build_model
from repro_torch.training import (FailureInjector, OptimizerConfig,
                                  TrainConfig, Trainer, TrainerConfig,
                                  run_with_restarts)
from repro_torch.training.optimizer import members

CFG = ModelConfig(name="ft-lm", family="dense", n_layers=2, d_model=64,
                  n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=211,
                  param_dtype="float32")


def make_trainer(ckpt_dir, device, injector=None, total=80, log_fn=print):
    model = build_model(CFG, device)
    data = SyntheticPipeline(DataConfig(vocab_size=211, seq_len=32,
                                        global_batch=8), device=device)
    tcfg = TrainConfig(optimizer=OptimizerConfig(peak_lr=2e-3,
                                                 warmup_steps=10,
                                                 total_steps=100))
    return Trainer(model, tcfg, data, TrainerConfig(
        total_steps=total, checkpoint_every=10, log_every=20,
        ckpt_dir=ckpt_dir), failure_injector=injector, log_fn=log_fn)


def main(argv=None) -> list[str]:
    """Run the example; returns the lines it printed."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (default cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    lines = []

    def say(line=""):
        print(line, flush=True)
        lines.append(line)

    dir_a = os.path.join(tempfile.gettempdir(), "repro_torch_ft_a")
    dir_b = os.path.join(tempfile.gettempdir(), "repro_torch_ft_b")
    shutil.rmtree(dir_a, ignore_errors=True)
    shutil.rmtree(dir_b, ignore_errors=True)

    say("== run with preemptions at steps 23 and 57 ==")
    injector = FailureInjector(fail_at_steps=(23, 57))
    state_r, restarts = run_with_restarts(
        lambda: make_trainer(dir_a, device, injector, log_fn=say))
    say(f"survived {restarts} preemptions")

    say("\n== uninterrupted reference run ==")
    state_c = make_trainer(dir_b, device, log_fn=say).run()

    diffs = [float((a.detach().float() - b.detach().float()).abs().max())
             for path in state_r.params
             for a, b in zip(members(state_r.params[path]),
                             members(state_c.params[path]))]
    say(f"max param divergence vs uninterrupted: {max(diffs):.2e} "
        f"(exact resume)")

    say("\n== elastic reshape: restore onto the current topology ==")
    tr = make_trainer(dir_a, device, total=90, log_fn=say)  # new 'cluster'
    tr.run()                                                 # resumes at 80
    say("resumed and extended to step 90 after reshape.")
    return lines


if __name__ == "__main__":
    main()
