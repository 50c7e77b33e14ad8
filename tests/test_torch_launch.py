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
  decode's equal XLA's per-device count; its collectives, item by item,
  per kind and in link bytes, equal XLA's plus :func:`mini_terms`, the
  named differences (ROADMAP C5);
* the dry run's per-period shortcut equals a trace of the whole stack,
  and internlm2-1.8b's train_4k cell ends ``ok`` on ``meta``;
* on ``meta`` the kernels' plain versions stand in for their launches,
  recorded by name, and the wrappers' launch counts do not move.
"""
import collections
import dataclasses
import importlib.util
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
    (stacks of two or more periods), four products:

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
      - 2 b S d F per such layer (none for a period of one);
    * the tail, the n_layers % period layers after the last whole period
      (gemma3-smoke: 8 layers in periods of 3, a tail of 2): the reference
      applies it outside its per-period checkpoint, so it recomputes none
      of its products; the port checkpoints every block, so each tail
      block's forward runs once more (the two terms above count the tail
      too: its attention's own recompute, and its recompute stopping
      before wo): + 2 b S d (Hq + 2 Hkv) hd + 2 x 2 b Hq S S hd
      + 2 b S Hq hd d + 3 x 2 b S d F per tail layer (attention and MLP
      layers; no config has another kind in a tail)."""
    kinds = [cfg.layer_kind(i) for i in range(cfg.n_layers)]
    period = cfg.period()
    tail = kinds[len(kinds) - len(kinds) % period:]
    assert all(k.endswith("attn_mlp") for k in tail), tail
    hd, d = cfg.head_dim, cfg.d_model
    block = (2 * b * s * d * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
             + 2 * 2 * b * cfg.n_heads * s * s * hd
             + 2 * b * s * cfg.n_heads * hd * d + 3 * 2 * b * s * d * cfg.d_ff)
    calls = sum("mamba" not in k for k in kinds)
    if cfg.is_encoder_decoder:
        calls += cfg.n_layers + cfg.n_enc_layers   # cross + encoder
    mamba = sum("mamba" in k for k in kinds)
    mlp = sum(k.endswith("_mlp") and period > 1 and i % period != period - 1
              for i, k in enumerate(kinds))
    return (calls * 2 * b * cfg.n_heads * s * s * cfg.head_dim
            - mamba * 4 * b * s * cfg.ssm_heads * cfg.ssm_head_dim
            - mlp * 2 * b * s * cfg.d_model * cfg.d_ff
            + len(tail) * block)


# jamba's MoE and Mamba layers stand for mixtral's and mamba2's (its
# reference compile is the longest of the file, so theirs are not
# repeated); gemma3's stack ends in a tail after its last period
@pytest.mark.parametrize("arch_id", ["internlm2-1.8b", "jamba-1.5-large-398b",
                                     "seamless-m4t-medium", "gemma3-1b"])
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
    import json, re, jax, numpy as np
    from jax.sharding import Mesh
    from repro import sharding as shd
    from repro.configs.base import ArchSpec, ShapeCell
    from repro.launch import hlo_cost, specs
    from repro.models import ModelConfig

    # every collective of the HLO, as hlo_cost counts it: kind, group size
    # (0 for a collective-permute), per-device bytes, times a step (the
    # trip counts of the loops around it) and its op_name
    def items(text):
        mod, out = hlo_cost.HloModule(text), []

        def walk(comp, mult):
            for line in mod.comps.get(comp, []):
                dm = hlo_cost._DEF_RE.match(line)
                op = mod._operands_of(line)[0] if dm else ""
                if op == "while":
                    body = re.search(r"body=(%[\\w\\.\\-]+)", line).group(1)
                    cond = re.search(r"condition=(%[\\w\\.\\-]+)",
                                     line).group(1)
                    walk(body, mult * mod.trip_count(cond))
                elif op == "call":
                    walk(re.search(r"to_apply=(%[\\w\\.\\-]+)", line).group(1),
                         mult)
                elif op == "conditional":
                    raise AssertionError("a conditional in the mini HLO")
                base = op[:-6] if op.endswith("-start") else op
                if base in hlo_cost._COLLECTIVES:
                    src = re.search(r'op_name="([^"]*)"', line)
                    out.append([base, 0 if base == "collective-permute"
                                else mod._group_size(line),
                                hlo_cost.shape_bytes(dm.group(2)), mult,
                                src.group(1) if src else ""])
        walk(mod.entry, 1)
        return out

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
                      "link": st.link_bytes,
                      "items": items(comp.as_text())}}
    print("MINI " + json.dumps(out))
""")


@pytest.fixture(scope="module")
def mini_xla() -> dict:
    """XLA's compile of the mini config's three steps on the (4, 2) mesh,
    in one subprocess of 8 virtual CPU devices: argument bytes, FLOPs,
    hlo_cost's collective counts and link bytes, and every collective."""
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, PYTHONPATH=src, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _MINI_SCRIPT], env=env,
                         capture_output=True, text=True, timeout=300)
    line = [x for x in out.stdout.splitlines() if x.startswith("MINI ")]
    assert line, out.stderr[-2000:]
    return json.loads(line[0][5:])


def test_mini_mesh_argument_bytes_equal_xla(mini_xla):
    xla = mini_xla
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


AR, AG, RS, A2A, CP = ("all-reduce", "all-gather", "reduce-scatter",
                       "all-to-all", "collective-permute")
F32, BF16, I32 = 4, 2, 4


def mini_terms(step: str, cfg, b: int, s: int, data: int,
               model: int) -> list:
    """The port's collectives less XLA's on the mini (data, model) mesh
    (ROADMAP C5), as named terms: (name, XLA's items, the port's items),
    an item (kind, group size, per-device bytes, times a step), the group
    0 for a collective-permute (source-target pairs).  Every other
    collective of the two programs is the same item on both sides: the
    FSDP gathers of every leaf (forward, and the backward's), the LM
    head's table and the row-parallel outputs.

    * XLA:CPU runs bf16 dots in float32, so its activation collectives
      carry float32; on the card they are bf16, as the port counts.
    * XLA:CPU all-reduces the gradients over data (each layer's
      model-shards in one merged all-reduce) and slices them, where FSDP
      on the card reduce-scatters each leaf: twice the ring's link bytes.
      Its combiner merges into these (and into the lookup's gradient) the
      float32 partial sums of the loss and the gradient norm, 19 scalars.
    * The loss's max, sum and the label's logit over the vocab-split
      logits: reductions over a split dimension, which ``op_cost`` does
      not follow (its rule 3's caveat): the port's count is low by these.
    * The embedding lookup and decode's row-parallel products are
      programs XLA's partitioner chose otherwise: it gathers the table's
      vocab shards and the token ids, and in decode moves the small
      activations instead of gathering the weights.
    No collective comes from GQA's grouped heads: the all-to-alls and the
    permute are the lookup's and decode's reshards."""
    L, d, V, F = cfg.n_layers, cfg.d_model, cfg.vocab_size, cfg.d_ff
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rows = b * s
    act = rows // data * d            # a (rows, d) activation, batch-split
    table = V * d // model            # the table's model-shard
    out = []
    if step == "train":
        out += [
            ("row-parallel outputs (forward, attention's recompute) and "
             "the column-parallel inputs' gradients (q/k/v, wi/wg, the LM "
             "head): float32 on XLA:CPU; XLA merges q/k/v's into one and "
             "wi/wg's into one",
             [(AR, model, act * F32, 3 * L), (AR, model, 3 * act * F32, L),
              (AR, model, 2 * act * F32, L), (AR, model, act * F32, 1)],
             [(AR, model, act * BF16, 8 * L + 1)]),
            ("gradients over data: XLA all-reduces each layer's "
             "model-shards merged, the table's and the final norm's, with "
             "19 float32 partial sums; the port reduce-scatters each leaf",
             [(AR, data, ((2 * hq + 2 * hkv) * hd * d + 3 * d * F) // model
               * F32 + 2 * d * F32, L),
              (AR, data, table * F32 + 4 * F32, 1),
              (AR, data, d * F32 + 6 * F32, 1), (AR, data, 2 * F32, 1)],
             [(RS, data, n * F32 // data, L)
              for n in (d * hq * hd // model, d * hkv * hd // model,
                        d * hkv * hd // model, hq * hd * d // model,
                        d * F // model, d * F // model, F * d // model, d,
                        d)]
             + [(RS, data, table * F32 // data, 1),
                (RS, data, d * F32 // data, 1)]),
            ("XLA gathers each layer's two RMSNorm scales twice in the "
             "backward (the recompute's use and the transpose's)",
             [(AG, data, d * F32, 2 * L)], []),
            ("the loss's max, sum and label logit over the vocab-split "
             "logits: reductions over a split dimension, not followed by "
             "op_cost",
             [(AR, model, rows // data * F32, 2),
              (AR, model, rows // data * F32 + F32, 1)], []),
        ]
    elif step == "prefill":
        out.append(("row-parallel outputs: float32 on XLA:CPU",
                    [(AR, model, act * F32, 2 * L)],
                    [(AR, model, act * BF16, 2 * L)]))
    else:
        out.append((
            "decode's row-parallel products: XLA keeps wo's and the MLP's "
            "wo's d split over data and moves the activations; the port "
            "gathers the weights",
            [(AG, data, b * hq // model * hd * F32, L),
             (AR, model, b * d // data * F32, 2 * L),
             (A2A, data, b * d // data * F32, 2 * L),
             (AG, data, b * F // model * F32, L)],
            [(AG, data, hq * hd // model * d * F32, L),
             (AG, data, F // model * d * F32, L),
             (AR, model, act * BF16, 2 * L)]))
    if step == "decode":
        out.append((
            "decode's lookup: XLA also moves the token ids and their fill "
            "mask, and reshards the rows to the batch layout",
            [(CP, 0, b // data * I32, 1), (AG, data, b, 1),
             (AG, model, b // data * model * I32, 1), (AG, model, b * I32, 1),
             (A2A, data, b * d // data * F32, 1)], []))
    else:
        xla = [(AG, model, V * d // data * F32, 1),
               (CP, 0, rows // data * I32, 1),
               (AG, model, rows // data * model * I32, 1),
               (AG, model, rows * d // data * F32, 1),
               (A2A, data, rows * d // data * F32, 1)]
        if step == "train":
            xla += [(A2A, data, rows * d // data * F32, 1),
                    (AR, model, V * d // data * F32 + 7 * F32, 1)]
        out.append((
            "the lookup: XLA gathers the table's vocab shards over model "
            "(and the token ids), looks up with d split over data and "
            "reshards the rows (the gradient back the same way); the port "
            "looks up vocab-parallel and all-reduces the rows",
            xla, [(AR, model, rows // data * d * F32, 1)]))
    return out


def _multiset(items) -> collections.Counter:
    c = collections.Counter()
    for kind, group, n, times in items:
        c[(kind, group, float(n))] += times
    return c


def _link(key, times) -> float:
    kind, k, n = key
    return times * (n if kind == CP else op_cost.ring_link_bytes(kind, n, k))


@pytest.mark.parametrize("step", ["train", "prefill", "decode"])
def test_mini_mesh_collectives_equal_xla_plus_named_terms(mini_xla, step):
    """Per kind, the count and the link bytes equal XLA's plus
    :func:`mini_terms`, and so does every item: taking each term's items
    away from both sides leaves the same collectives."""
    cfg = ModelConfig(**MINI_CFG)
    arch = ArchSpec("mini", cfg, cfg, False)
    st = _count(specs.build_cell(arch, ShapeCell(step, 16, 8, step)), MINI)
    port = _multiset((i["kind"], i["group"], i["bytes"], i["times"])
                     for i in op_cost.collective_items(st))
    xla = _multiset((k, g, n, t) for k, g, n, t, _ in mini_xla[step]["items"])
    assert sum(_link(k, t) for k, t in xla.items()) == \
        mini_xla[step]["link"]
    terms = mini_terms(step, cfg, 8, 1 if step == "decode" else 16, 4, 2)
    common_xla, common_port = xla.copy(), port.copy()
    for _, x_items, p_items in terms:
        common_xla.subtract(_multiset(x_items))
        common_port.subtract(_multiset(p_items))
    assert min(common_xla.values()) >= 0 and min(common_port.values()) >= 0
    assert +common_xla == +common_port
    term_x = sum((_multiset(x) for _, x, _ in terms), collections.Counter())
    term_p = sum((_multiset(p) for _, _, p in terms), collections.Counter())
    for kind in (AR, AG, RS, A2A, CP):
        delta = sum(t for k, t in term_p.items() if k[0] == kind) - sum(
            t for k, t in term_x.items() if k[0] == kind)
        assert st.coll_counts.get(kind, 0) == \
            mini_xla[step]["counts"].get(kind, 0) + delta, kind
    assert st.link_bytes == mini_xla[step]["link"] + sum(
        _link(k, t) for k, t in term_p.items()) - sum(
        _link(k, t) for k, t in term_x.items())


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


def test_debug_bytes_tool_itemizes_a_cell():
    """``tools/debug_bytes_torch.py`` on a serving cell: its items sum to
    the cell's totals, and it prints each table's top 12 in order."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "debug_bytes_torch.py")
    spec = importlib.util.spec_from_file_location("debug_bytes_torch", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    st = tool.contributors("internlm2-1.8b", "prefill_32k", "serve")
    items = op_cost.collective_items(st)
    assert sum(st.op_flops.values()) == st.flops > 0
    assert sum(st.op_bytes.values()) == pytest.approx(st.hbm_bytes, rel=1e-12)
    assert sum(i["link_bytes"] for i in items) == pytest.approx(
        st.link_bytes, rel=1e-12)
    assert st.link_bytes > 0
    lines = tool.main(["internlm2-1.8b", "prefill_32k", "serve"])
    assert lines[0].startswith("total FLOPs")
    heads = [i for i, x in enumerate(lines) if x.startswith("-- top ")]
    assert [lines[i] for i in heads] == [
        "-- top FLOPs by op", "-- top HBM bytes by op",
        "-- top link bytes by collective"]
    counts = [sum(1 for v in st.op_flops.values() if v),
              sum(1 for v in st.op_bytes.values() if v),
              sum(1 for i in items if i["times"])]
    for a, b, n in zip(heads, heads[1:] + [len(lines)], counts):
        values = [float(x.split()[0]) for x in lines[a + 1:b]]
        assert len(values) == min(tool.TOP, n) > 0
        assert values == sorted(values, reverse=True)
    assert float(lines[heads[0] + 1].split()[0]) == pytest.approx(
        max(st.op_flops.values()), rel=1e-3)


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
