"""Time B4 (flash prefill) and B5 (flash decode) of two trees of this repo
on one card, at the shapes ``chip_smoke.py::attn_times`` uses, with both of
its yardsticks: ``ms`` (one synchronized call, ``time_ms``) and
``device_ms`` (calls queued back to back, ``queued_ms``), beside
``scaled_dot_product_attention`` on the same inputs.

    python3 tools/flash_ab.py --other DIR [--out FILE.json]

DIR holds an unpacked tree of another commit, e.g. ``git archive <commit> |
tar -x -C _scratch/parent``.  Each tree runs in a process of its own (both
name their package ``repro_torch``), in the order other, this, this, other,
so that a drift of the card over the call shows as a gap between a tree's
two runs.  Prints one JSON line per run and, last, the summary (each
number the mean of a tree's two runs), which ``--out`` also writes with
every run.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# B5 at the serve shape decodes at the serve phase's seeded prompt lengths
# + 31, as chip_smoke.py's attn_times sets them; the multitier shapes take
# attn_times' positions too
SERVE_POSITIONS = (1042, 1043, 1049, 1054, 1031, 1034, 1051, 1054)


def worker(tree: str) -> dict:
    """Times of ``tree``'s B4 and B5 (imported from ``tree/src``)."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs                   # puts ROOT/src on sys.path
    sys.path.insert(0, os.path.join(tree, "src"))
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.attention import flash, ref
    if not os.path.abspath(flash.__file__).startswith(os.path.abspath(tree)):
        raise RuntimeError(f"imported {flash.__file__}, not from {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    bf = torch.bfloat16
    cases = []
    q, k, v = cs.attn_operands(1, 1024, 1024, 16, 8, 128, bf, seed=5)
    cases.append(("flash_prefill_b1_sq1024",
                  lambda: flash.flash_prefill(q, k, v),
                  lambda: ref.mha_ref(q, k, v),
                  lambda: F.scaled_dot_product_attention(
                      q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                      is_causal=True, enable_gqa=True).transpose(1, 2)))
    rng = np.random.default_rng(11)
    for b, s, positions, seed in (
            (8, 2048, SERVE_POSITIONS, 6),
            *((b, 512, rng.integers(128, 144, b), 20 + b) for b in (2, 3, 8))):
        qd, kd, vd = cs.attn_operands(b, 1, s, 16, 8, 128, bf, seed=seed)
        pos = torch.tensor(np.asarray(positions, np.int32),
                           device=cs.DEVICE)
        mask = (torch.arange(s, device=cs.DEVICE)[None, :]
                <= pos[:, None].long())[:, None, None, :]
        cases.append((
            f"flash_decode_b{b}_s{s}",
            lambda qd=qd, kd=kd, vd=vd, pos=pos: flash.flash_decode(
                qd, kd, vd, position=pos),
            lambda qd=qd, kd=kd, vd=vd, pos=pos: ref.decode_ref(
                qd, kd, vd, position=pos),
            lambda qd=qd, kd=kd, vd=vd, mask=mask:
                F.scaled_dot_product_attention(
                    qd.transpose(1, 2), kd.transpose(1, 2), vd.transpose(1, 2),
                    attn_mask=mask, enable_gqa=True).transpose(1, 2)))
    out = {}
    for name, kern, plain, lib in cases:
        err = (kern().float() - plain().float()).abs().max().item()
        ms, lib_ms = cs.time_ms(kern), cs.time_ms(lib)
        (dev, ahead), (lib_dev, lib_ahead) = cs.queued_ms(kern), \
            cs.queued_ms(lib)
        out[name] = dict(ms=ms, device_ms=dev, library_ms=lib_ms,
                         library_device_ms=lib_dev, max_abs_err=err,
                         queued_ahead=[ahead, lib_ahead])
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="an unpacked tree of another commit")
    ap.add_argument("--out", help="write the runs and summary here")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker)), flush=True)
        return 0
    if not args.other:
        ap.error("--other is required")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    trees = {"other": os.path.abspath(args.other), "this": ROOT}
    runs = {"other": [], "this": []}
    for which in ("other", "this", "this", "other"):
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--worker", trees[which]], capture_output=True,
                             text=True, timeout=900)
        if res.returncode != 0:
            sys.stderr.write(res.stderr)
            raise RuntimeError(f"the {which} tree's run failed")
        row = json.loads(res.stdout.strip().splitlines()[-1])
        print(json.dumps({"tree": which, **row}), flush=True)
        runs[which].append(row)
    summary = {"card": smi, "trees": trees, "runs": runs, "mean": {}}
    for which, rows in runs.items():
        summary["mean"][which] = {
            case: {key: sum(r[case][key] for r in rows) / len(rows)
                   for key in ("ms", "device_ms", "library_ms",
                               "library_device_ms")}
            for case in rows[0]}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps(summary["mean"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
