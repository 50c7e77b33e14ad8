"""Time kernels of two trees of this repo on one card, with both yardsticks
of ``chip_smoke.py``: ``ms`` (one synchronized call, ``time_ms``) and
``device_ms`` (calls queued back to back, ``queued_ms``).

    python3 tools/flash_ab.py --other DIR [--kernels flash,ssd,mega]
                              [--out FILE.json]

* ``flash``: B4 (flash prefill) and B5 (flash decode) at the shapes
  ``chip_smoke.py::attn_times`` uses, beside
  ``scaled_dot_product_attention`` on the same inputs;
* ``ssd``: B6 at the mamba serve phase's prefill (mamba2-2.7b's widths,
  b=1, S=1024, bf16), as ``chip_smoke.py::ssd_times`` times it;
* ``mega``: B3 at the mega slice's fleet (R=4096, float32 slots) from the
  slice's states at window starts t0 = 0, 150 and 290, as
  ``chip_smoke.py::mega_times`` builds them; each run also hashes every
  output of the timed window (on a copy of the state), so the summary says
  whether the two trees' B3 agree to the bit.  Each tree reaches t0 through
  its own B3, so equal hashes also say that every earlier window agreed.

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


KERNELS = ("flash", "ssd", "mega")


def worker(tree: str, kernels: tuple) -> dict:
    """Times of ``tree``'s kernels (imported from ``tree/src``)."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs                   # puts ROOT/src on sys.path
    sys.path.insert(0, os.path.join(tree, "src"))
    import torch
    import repro_torch
    if not os.path.abspath(repro_torch.__file__).startswith(
            os.path.abspath(tree)):
        raise RuntimeError(f"imported {repro_torch.__file__}, not from {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    if "flash" in kernels:
        out.update(flash_times(cs))
    if "ssd" in kernels:
        out.update(ssd_times(cs))
    if "mega" in kernels:
        out.update(mega_times(cs))
    return out


def timed(cs, kern, lib=None) -> dict:
    """Both yardsticks of ``kern`` (and of ``lib`` beside it)."""
    row = dict(ms=cs.time_ms(kern))
    row["device_ms"], ahead = cs.queued_ms(kern)
    row["queued_ahead"] = [ahead]
    if lib is not None:
        row["library_ms"] = cs.time_ms(lib)
        row["library_device_ms"], lib_ahead = cs.queued_ms(lib)
        row["queued_ahead"].append(lib_ahead)
    return row


def ssd_times(cs) -> dict:
    """B6 at the mamba serve phase's prefill shape."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels.ssd import ref, ssd
    cfg = get_arch(cs.MAMBA_ARCH).full
    x, dt, a, b, c, _ = cs.ssd_operands(
        1, 1024, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_ngroups,
        cfg.ssm_state, torch.bfloat16, seed=9)
    kern = lambda: ssd.ssd_scan(x, dt, a, b, c, cfg.ssm_chunk)  # noqa: E731
    y, _ = kern()
    y_p, _ = ref.ssd_chunked(x, dt, a, b, c, cfg.ssm_chunk)
    err = (y.float() - y_p.float()).abs().max().item()
    return {"ssd_scan_b1_s1024": dict(
        timed(cs, kern), max_abs_err=err,
        scaled_err=err / max(1.0, y_p.float().abs().max().item()))}


def output_hash(out, t0: int) -> str:
    """sha256 over the bytes of every output of a B3 window, in order: the
    router carries, the tape's in-window columns, the env state, the
    telemetry carry and the traces."""
    import hashlib
    import torch
    state, est, obs, traces = out
    cols = slice(t0, t0 + traces[0].shape[0])
    h = hashlib.sha256()

    def walk(v):
        if isinstance(v, torch.Tensor):
            h.update(v.detach().contiguous().cpu().view(-1).view(
                torch.uint8).numpy().tobytes())
        elif isinstance(v, (tuple, list)):
            for u in v:
                walk(u)
    walk([state.belief, state.prev_action, state.dt_since_change,
          state.error_ema, state.unstable,
          [x[:, cols] for x in state.slots], est, obs, traces])
    return h.hexdigest()


def mega_times(cs) -> dict:
    """B3 at the mega slice's fleet from its states at t0 = 0, 150, 290."""
    import torch
    from repro_torch.kernels.efe import mega as mega_kernel
    rows = {}
    for t0 in (0, cs.T0_MEGA, cs.T_FULL - 10):
        router, env_step, state, est, obs, noise = cs.mega_midrun(
            cs.R_MEGA, t0, "float32")
        args, kw = cs.mega_window_inputs(router, env_step, noise, cs.R_MEGA,
                                         t0)
        digest = output_hash(mega_kernel.mega_window_cuda(
            cs.clone_state(state), est, obs, *args, **kw), t0)
        kern = lambda: mega_kernel.mega_window_cuda(  # noqa: E731
            state, est, obs, *args, **kw)
        rows[f"mega_window_r{cs.R_MEGA}_t0_{t0}"] = dict(timed(cs, kern),
                                                        output_sha256=digest)
        del state, est, obs, args, kern
        torch.cuda.empty_cache()
    return rows


def flash_times(cs) -> dict:
    """B4 and B5 at the serve and multitier phases' shapes, beside SDPA."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.attention import flash, ref
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
        out[name] = dict(timed(cs, kern, lib), max_abs_err=err)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="an unpacked tree of another commit")
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help="comma-separated subset of " + ",".join(KERNELS))
    ap.add_argument("--out", help="write the runs and summary here")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    kernels = tuple(k for k in args.kernels.split(",") if k)
    if not set(kernels) <= set(KERNELS):
        ap.error(f"--kernels takes {KERNELS}, got {kernels}")
    if args.worker:
        print(json.dumps(worker(args.worker, kernels)), flush=True)
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
                              "--worker", trees[which],
                              "--kernels", ",".join(kernels)],
                             capture_output=True, text=True, timeout=900)
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
                               "library_device_ms") if key in rows[0][case]}
            for case in rows[0]}
    # B3: every run of both trees hashed the same outputs
    summary["mega_bits_equal"] = {
        case: len({r[case]["output_sha256"] for rs in runs.values()
                   for r in rs}) == 1
        for case in runs["this"][0] if case.startswith("mega_window")}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps({"mean": summary["mean"],
                      "mega_bits_equal": summary["mega_bits_equal"]}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
