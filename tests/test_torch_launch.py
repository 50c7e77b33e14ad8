"""The port's dry-run cost counter against the reference's HLO analyzer.

* the counter's twins of ``tests/test_sharding_launch.py``'s ``hlo_cost``
  tests: a matmul in a 7-step loop counts 7 times, a product's FLOPs are
  exact;
* at one device, ``prefill`` and ``decode_step`` of the dense, MoE,
  mamba2, hybrid (jamba) and encoder-decoder (seamless) smoke configs
  count exactly the FLOPs of ``repro.launch.hlo_cost.analyze_text`` on
  the reference's jitted step;
* the train step (dense, hybrid, encoder-decoder) counts the reference's
  FLOPs plus :func:`train_terms`, the port's extra and missing products,
  each named by op and stated in the shapes (ROADMAP C), and seamless's
  prefill its FLOPs plus :func:`prefill_terms`;
* on the reference's mini config and (4, 2) mesh (a subprocess with 8
  virtual CPU devices), the port's per-device argument bytes equal XLA's
  ``argument_size_in_bytes`` for train, prefill and decode, its
  per-device FLOPs are 1/8 of its one-device count, and prefill's and
  decode's equal XLA's per-device count;
* the dry run's per-period shortcut equals a trace of the whole stack,
  and internlm2-1.8b's train_4k cell ends ``ok`` on ``meta``;
* on ``meta`` the kernels' plain versions stand in for their launches,
  recorded by name, and the wrappers' launch counts do not move.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.launch.hlo_cost import analyze_text
from repro.models import build_model as ref_build_model
from repro.training.train_step import TrainConfig as RefTrainConfig
from repro.training.train_step import init_train_state as ref_init_state
from repro.training.train_step import make_train_step as ref_train_step
from repro_torch.configs import get_arch
from repro_torch.configs.base import ArchSpec, ShapeCell
from repro_torch.kernels.attention import flash
from repro_torch.launch import dryrun, op_cost, specs
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import Mesh
from repro_torch.training.train_step import TrainConfig

ONE = Mesh((1, 1), ("data", "model"))
MINI = Mesh((4, 2), ("data", "model"))
B, S = 2, 64
# LLVM's passes do not change the HLO the counts read, only compile time
FAST = {"xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True}
FAMILIES = ["internlm2-1.8b", "mixtral-8x7b", "mamba2-2.7b",
            "jamba-1.5-large-398b", "seamless-m4t-medium"]


def _count(cell, mesh=ONE) -> op_cost.Stats:
    _, tr = op_cost.trace(cell.fn, cell.inputs, batch_rows=cell.batch_rows,
                          microbatches=cell.microbatches,
                          train_gathers=cell.train_gathers)
    return op_cost.resolve(tr, mesh)


def _smoke(arch_id: str) -> ArchSpec:
    a = get_arch(arch_id)
    return dataclasses.replace(a, full=a.smoke)


# ------------------------------------------------------------ the counter
def test_matmul_in_a_loop_counts_each_trip():
    n = 64
    x = torch.empty((n, n), device="meta")
    w = torch.empty((n, n), device="meta")

    def f():
        y = x
        for _ in range(7):
            y = y @ w
        return y
    _, tr = op_cost.trace(f, [])
    assert op_cost.resolve(tr, ONE).flops == 7 * 2 * n ** 3


def test_product_flops_exact():
    m, k, n = 32, 48, 16
    a = torch.empty((m, k), device="meta")
    b = torch.empty((k, n), device="meta")
    _, tr = op_cost.trace(lambda: a @ b, [])
    st = op_cost.resolve(tr, ONE)
    assert st.flops == 2 * m * k * n
    assert st.hbm_bytes == 4 * (m * k + k * n + m * n)


# ------------------------------------------------ one device: FLOPs parity
def _ref_batch(cfg):
    batch = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32),
             "labels": jax.ShapeDtypeStruct((B, S), jnp.int32)}
    if cfg.input_mode == "embeddings":
        batch["embeds"] = jax.ShapeDtypeStruct((B, S, cfg.d_model),
                                               jnp.bfloat16)
    return batch


@pytest.mark.parametrize("arch_id", FAMILIES)
def test_serving_flops_equal_reference(arch_id):
    cfg = ref_get_arch(arch_id).smoke
    model = ref_build_model(cfg)
    params = jax.eval_shape(model.init, jax.random.key(0))
    batch = _ref_batch(cfg)
    pre = jax.jit(lambda p, b: model.prefill(p, b)).lower(
        params, batch).compile(FAST)
    caches = jax.eval_shape(lambda: model.init_caches(B, S))
    dec = jax.jit(lambda p, t, c, pos: model.decode_step(p, t, c, pos)
                  ).lower(params, jax.ShapeDtypeStruct((B, 1), jnp.int32),
                          caches, jax.ShapeDtypeStruct((), jnp.int32)
                          ).compile(FAST)
    arch = _smoke(arch_id)
    got_pre = _count(specs.build_cell(arch, ShapeCell("p", S, B, "prefill")))
    got_dec = _count(specs.build_cell(arch, ShapeCell("d", S, B, "decode")))
    assert got_pre.flops == analyze_text(pre.as_text()).flops + \
        prefill_terms(get_arch(arch_id).smoke, B, S)
    assert got_dec.flops == analyze_text(dec.as_text()).flops
    # the kernels' plain versions stood in, once a layer of their kind
    kinds = [cfg.layer_kind(i) for i in range(cfg.n_layers)]
    n_attn = sum("mamba" not in k for k in kinds) * (
        2 if cfg.is_encoder_decoder else 1)
    n_ssd = sum("mamba" in k for k in kinds)
    assert got_pre.launches.get("flash_prefill", 0) == n_attn + (
        cfg.n_enc_layers if cfg.is_encoder_decoder else 0)
    assert got_dec.launches.get("flash_decode", 0) == n_attn
    assert got_pre.launches.get("ssd_scan", 0) == n_ssd


def prefill_terms(cfg, b: int, s: int) -> int:
    """The port's prefill FLOPs less the reference's at one device: the
    encoder-decoder's cross K/V.  The reference projects the encoder
    memory to each decoder layer's K and V twice (in the block and again in
    ``_cross_caches``), the port once (``Attention.project_kv``):
    - 2 x 2 b S_enc d Hkv hd per decoder layer."""
    if not cfg.is_encoder_decoder:
        return 0
    return -cfg.n_layers * 2 * 2 * b * s * cfg.d_model * (
        cfg.n_kv_heads * cfg.head_dim)


def train_terms(cfg, b: int, s: int) -> int:
    """The port's train-step FLOPs less the reference's at one device
    (stacks of two or more periods), three products:

    * ``blockwise_attention``'s score product ``einsum("bqhgd,bkhd->
      bhgqk")`` runs once more per attention call (self and cross): the
      port runs it in the forward, the block's recompute and the
      attention's own recompute; the reference's HLO holds one fewer:
      + 2 b Hq S S_kv hd per call;
    * the gradient of the SSD scan's ``einsum("bclhn,bclh,bchpn->
      bclhp")`` with respect to its (b, c, l, h) operand: two dots a
      layer contracting P in the reference's HLO, a product and a sum in
      torch's autograd: - 4 b S H P per Mamba layer;
    * the MLP's output product ``(h * g) @ wo`` of a layer that is not the
      last of its period: the reference's checkpoint spans the period and
      recomputes it for the next layer; the port checkpoints each block,
      whose recompute stops before its last product:
      - 2 b S d F per such layer (none for a period of one)."""
    kinds = [cfg.layer_kind(i) for i in range(cfg.n_layers)]
    period = cfg.period()
    calls = sum("mamba" not in k for k in kinds)
    if cfg.is_encoder_decoder:
        calls += cfg.n_layers + cfg.n_enc_layers   # cross + encoder
    mamba = sum("mamba" in k for k in kinds)
    mlp = sum(k.endswith("_mlp") and period > 1 and i % period != period - 1
              for i, k in enumerate(kinds))
    return (calls * 2 * b * cfg.n_heads * s * s * cfg.head_dim
            - mamba * 4 * b * s * cfg.ssm_heads * cfg.ssm_head_dim
            - mlp * 2 * b * s * cfg.d_model * cfg.d_ff)


# jamba's MoE and Mamba layers stand for mixtral's and mamba2's (its
# reference compile is the longest of the file, so theirs are not repeated)
@pytest.mark.parametrize("arch_id", ["internlm2-1.8b", "jamba-1.5-large-398b",
                                     "seamless-m4t-medium"])
def test_train_flops_equal_reference_plus_named_terms(arch_id):
    cfg = ref_get_arch(arch_id).smoke
    model = ref_build_model(cfg)
    tcfg = RefTrainConfig()
    step = ref_train_step(model, tcfg)
    state = jax.eval_shape(
        lambda: ref_init_state(model, jax.random.key(0), tcfg))
    ref = analyze_text(jax.jit(step).lower(
        state, _ref_batch(cfg)).compile(FAST).as_text()).flops
    cell = specs.build_train_cell(_smoke(arch_id), ShapeCell(
        "t", S, B, "train"), tcfg=TrainConfig())
    got = _count(cell)
    assert got.flops == ref + train_terms(get_arch(arch_id).smoke, B, S)
    assert got.launches == {}          # training launches no kernel


# ----------------------------------------------------------- the mini mesh
MINI_CFG = dict(name="t", family="dense", n_layers=2, d_model=32, n_heads=4,
                n_kv_heads=2, d_ff=64, vocab_size=128, param_dtype="float32")

_MINI_SCRIPT = textwrap.dedent(f"""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json, jax, numpy as np
    from jax.sharding import Mesh
    from repro import sharding as shd
    from repro.configs.base import ArchSpec, ShapeCell
    from repro.launch import hlo_cost, specs
    from repro.models import ModelConfig
    cfg = ModelConfig(**{MINI_CFG!r})
    arch = ArchSpec("mini", cfg, cfg, False)
    mesh = Mesh(np.asarray(jax.devices()).reshape(4, 2), ("data", "model"))
    out = {{}}
    for step, build in (("train", specs.build_train_cell),
                        ("prefill", specs.build_prefill_cell),
                        ("decode", specs.build_decode_cell)):
        c = build(arch, ShapeCell(step, 16, 8, step), mesh)
        with mesh, shd.activation_constraints(mesh, "train"):
            comp = jax.jit(c.fn, in_shardings=c.in_shardings,
                           out_shardings=c.out_shardings).lower(
                               *c.args).compile({FAST!r})
        st = hlo_cost.analyze_text(comp.as_text())
        out[step] = {{"args": comp.memory_analysis().argument_size_in_bytes,
                      "flops": st.flops, "counts": st.coll_counts,
                      "link": st.link_bytes}}
    print("MINI " + json.dumps(out))
""")


def test_mini_mesh_argument_bytes_equal_xla():
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, PYTHONPATH=src, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _MINI_SCRIPT], env=env,
                         capture_output=True, text=True, timeout=300)
    line = [x for x in out.stdout.splitlines() if x.startswith("MINI ")]
    assert line, out.stderr[-2000:]
    xla = json.loads(line[0][5:])
    cfg = ModelConfig(**MINI_CFG)
    arch = ArchSpec("mini", cfg, cfg, False)
    for step in ("train", "prefill", "decode"):
        cell = specs.build_cell(arch, ShapeCell(step, 16, 8, step))
        assert op_cost.argument_bytes(specs.arguments(cell), MINI) == \
            xla[step]["args"], step
        one, eight = _count(cell), _count(cell, MINI)
        assert one.flops == 8 * eight.flops, step
        if step != "train":
            assert eight.flops == xla[step]["flops"], step
    assert xla["train"]["args"] == 34532


# ------------------------------------------------------------- the dry run
def test_per_period_shortcut_equals_whole_stack():
    """gemma3-smoke: a period of 3 with a tail of 2 (a period of one is in
    the accumulation test below)."""
    arch = _smoke("gemma3-1b")
    assert len(dryrun.depth_plan(arch.full)) == 2
    for step in ("train", "prefill", "decode"):
        cell = ShapeCell(step, 32, 8, step)
        cut, _ = dryrun.resolve_cell(dryrun.trace_cell(arch, cell), MINI)
        whole = _count(specs.build_cell(arch, cell), MINI)
        for f in ("flops", "link_bytes", "link_bytes_nvlink",
                  "link_bytes_ib", "coll_counts", "coll_bytes", "launches",
                  "kernel_flops"):
            assert getattr(cut, f) == getattr(whole, f), (step, f)
        assert cut.hbm_bytes == pytest.approx(whole.hbm_bytes, rel=1e-9)


def test_accumulation_shortcut_equals_whole_step():
    """Four microbatches over three layers from the 2 x 2 cuts (1 and 2
    layers, 2 and 3 microbatches: the dryrun_card train run's plan),
    against the whole step."""
    a = get_arch("internlm2-1.8b")
    arch = dataclasses.replace(a, full=dataclasses.replace(a.smoke,
                                                           n_layers=3))
    cell = ShapeCell("t", 32, 8, "train")
    parts = [(dryrun.count(dryrun.build(arch, ShapeCell(*j.shape),
                                        j.n_layers, j.accum), ["one"]),
              w, pw)
             for j, w, pw in dryrun.cell_jobs(arch, cell, ["one"], accum=4)]
    assert len(parts) == 4
    cut = dryrun.combine(parts, "one")
    whole = _count(dryrun.build(arch, cell, None, 4))
    assert cut.flops == whole.flops
    assert cut.hbm_bytes == pytest.approx(whole.hbm_bytes, rel=1e-9)
    assert cut.peak_bytes == pytest.approx(whole.peak_bytes, rel=0.05)


def test_full_cell_on_meta_ends_ok():
    (rec,), _ = dryrun.sweep("internlm2-1.8b", "train_4k", "single",
                             outdir=None, echo=lambda line: None)
    assert rec["ok"], rec.get("error")
    roof = rec["roofline"]
    assert roof["memory_analysis"]["fits"]
    assert roof["flops_per_chip"] > 0 and roof["dominant"] in (
        "compute", "memory", "collective")


def test_kernels_stand_in_on_meta_without_counting():
    before = (flash.flash_prefill.launches, flash.flash_decode.launches)
    arch = _smoke("gemma3-1b")
    st = _count(specs.build_cell(arch, ShapeCell("p", 32, 2, "prefill")))
    assert st.launches == {"flash_prefill": arch.full.n_layers}
    assert st.kernel_flops["flash_prefill"] > 0
    assert (flash.flash_prefill.launches,
            flash.flash_decode.launches) == before
    meta = torch.empty((1, 4, 2, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        flash.flash_prefill(meta, meta, meta)
