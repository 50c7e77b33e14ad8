"""The port's training slice against the reference's, on the CPU:

* twins of the nine tests of ``tests/test_training.py`` on the port alone
  (loss falls, preemption and restart resume exactly, Adafactor learns and
  its state is factored, both compressions learn, accumulation matches the
  big batch, and the data pipeline's determinism, resume and LCG signal);
* teacher-forced steps: from a reference train state carried across by
  ``torch_port_ref.train_state_to_port`` and the reference's batch, one
  port step equals one reference ``make_train_step`` step (parameters,
  optimizer state, error-feedback buffers and metrics), for AdamW with
  ``accum_steps`` 1 and 2, compression none / bf16 / int8_ef, and
  Adafactor, also with the stacked norm scales factored (L >=
  ``factored_min_dim``) and the update-RMS clip active, and Adafactor on
  jamba's hybrid smoke model, whose four period positions (``mamba_mlp``,
  ``mamba_moe``, ``mamba_mlp``, ``attn_moe``) each stack two layers;
* the data pipeline fed the reference's draws gives the reference's
  batches, and its own draws depend on (seed, step, host) alone;
* ``chunked_lm_loss`` with ``loss_chunk`` > 0 and its gradient;
* the kernels' entry points refuse inputs that need gradients.

Tolerance rtol 1e-4 / atol 1e-5 (both sides float32, summed in other
orders); the parity configs compute in float32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import DataConfig as RefDataConfig
from repro.data import SyntheticPipeline as RefPipeline
from repro.models import ModelConfig as RefModelConfig
from repro.models import build_model as ref_build_model
from repro.models import layers as ref_layers
from repro.training import OptimizerConfig as RefOptimizerConfig
from repro.training import TrainConfig as RefTrainConfig
from repro.training.grad_compression import \
    CompressionConfig as RefCompressionConfig
from repro.training.train_step import make_train_step as ref_make_step
from repro_torch.data import DataConfig, SyntheticPipeline
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.models import ModelConfig, build_model, convert, layers
from repro_torch.training import (FailureInjector, OptimizerConfig,
                                  TrainConfig, Trainer, TrainerConfig,
                                  init_train_state, make_train_step,
                                  run_with_restarts)
from repro_torch.training import optimizer as opt_mod
from repro_torch.training.grad_compression import CompressionConfig
from torch_port_ref import batch_to_port, t2n, train_state_to_port

RTOL, ATOL = 1e-4, 1e-5
TINY_FIELDS = dict(name="tiny", family="dense", n_layers=2, d_model=64,
                   n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=211,
                   param_dtype="float32")
TINY = ModelConfig(**TINY_FIELDS)
# the parity configs compute in float32 (TINY computes in bf16)
TINY32 = ModelConfig(**TINY_FIELDS, compute_dtype="float32")
REF_TINY32 = RefModelConfig(**TINY_FIELDS, compute_dtype="float32")


def _trainer(tmpdir, total=40, tcfg=None, injector=None):
    model = build_model(TINY, "cpu")
    dcfg = DataConfig(vocab_size=211, seq_len=32, global_batch=8)
    tcfg = tcfg or TrainConfig(optimizer=OptimizerConfig(
        peak_lr=3e-3, warmup_steps=5, total_steps=100))
    return Trainer(model, tcfg, SyntheticPipeline(dcfg, device="cpu"),
                   TrainerConfig(total_steps=total, checkpoint_every=10,
                                 log_every=1000, ckpt_dir=str(tmpdir)),
                   failure_injector=injector, log_fn=lambda s: None)


def _params(state):
    return [t2n(p) for leaf in state.params.values()
            for p in opt_mod.members(leaf)]


# ------------------------------------------------ twins of test_training.py
def test_loss_decreases(tmp_path):
    tr = _trainer(tmp_path / "a", total=50)
    tr.run()
    assert np.mean(tr.losses[-5:]) < 0.7 * np.mean(tr.losses[:5])


def test_preemption_restart_resumes_exactly(tmp_path):
    """Kill at step 25, restart, final state == uninterrupted run."""
    d1, d2 = tmp_path / "x", tmp_path / "y"
    inj = FailureInjector(fail_at_steps=(25,))
    state_r, restarts = run_with_restarts(
        lambda: _trainer(d1, total=40, injector=inj))
    assert restarts == 1
    state_c = _trainer(d2, total=40).run()
    for a, b in zip(_params(state_r), _params(state_c)):
        np.testing.assert_allclose(a, b, atol=1e-5)


def test_adafactor_reduces_loss(tmp_path):
    tcfg = TrainConfig(optimizer=OptimizerConfig(
        name="adafactor", peak_lr=3e-3, warmup_steps=5, total_steps=100,
        factored_min_dim=32))
    tr = _trainer(tmp_path / "af", total=40, tcfg=tcfg)
    tr.run()
    assert np.mean(tr.losses[-5:]) < np.mean(tr.losses[:5])


def test_adafactor_state_is_factored():
    model = build_model(TINY, "cpu")
    params = convert.group_params(model)
    ocfg = OptimizerConfig(name="adafactor", factored_min_dim=4)
    st = opt_mod.adafactor_init(ocfg, params)
    n_p = sum(p.numel() for p in model.parameters())
    n_s = sum(x.numel() for leaf in st.inner.values() for x in leaf.values())
    # factored stats keep the leading (layer-stack) dims, as the
    # reference's; ~0.15 of the full state at these widths
    assert n_s < 0.2 * n_p


def test_grad_compression_paths(tmp_path):
    for mode in ("bf16", "int8_ef"):
        tcfg = TrainConfig(
            optimizer=OptimizerConfig(peak_lr=3e-3, warmup_steps=5,
                                      total_steps=100),
            compression=CompressionConfig(mode=mode))
        tr = _trainer(tmp_path / mode, total=25, tcfg=tcfg)
        tr.run()
        assert np.isfinite(tr.losses).all()
        assert np.mean(tr.losses[-5:]) < np.mean(tr.losses[:5])


def test_accum_steps_match_big_batch():
    """2 microbatches of 4 ~ one batch of 8 (same grads up to fp error)."""
    dcfg = DataConfig(vocab_size=211, seq_len=32, global_batch=8)
    batch = next(SyntheticPipeline(dcfg, device="cpu"))
    out = []
    for a in (1, 2):
        model = build_model(TINY, "cpu", seed=0)
        tcfg = TrainConfig(optimizer=OptimizerConfig(clip_norm=0.0),
                           accum_steps=a)
        state, m = make_train_step(model, tcfg)(
            init_train_state(model, tcfg), batch)
        out.append((_params(state), float(m.loss)))
    (p1, l1), (p2, l2) = out
    assert abs(l1 - l2) < 1e-3
    for a, b in zip(p1, p2):
        np.testing.assert_allclose(a, b, atol=2e-3)


def test_data_determinism_and_host_disjointness():
    dcfg = DataConfig(vocab_size=97, seq_len=16, global_batch=8)
    a = next(SyntheticPipeline(dcfg, host_id=0, n_hosts=2, device="cpu"))
    b = next(SyntheticPipeline(dcfg, host_id=0, n_hosts=2, device="cpu"))
    assert torch.equal(a["tokens"], b["tokens"])
    c = next(SyntheticPipeline(dcfg, host_id=1, n_hosts=2, device="cpu"))
    assert not torch.equal(a["tokens"], c["tokens"])


def test_data_resume_mid_stream():
    dcfg = DataConfig(vocab_size=97, seq_len=16, global_batch=4)
    p = SyntheticPipeline(dcfg, device="cpu")
    batches = [next(p) for _ in range(5)]
    assert p.state_dict() == {"step": 5, "seed": 0}
    p2 = SyntheticPipeline.restore(dcfg, {"step": 3, "seed": 0},
                                   device="cpu")
    assert torch.equal(batches[3]["tokens"], next(p2)["tokens"])


def test_data_is_learnable_lcg():
    dcfg = DataConfig(vocab_size=97, seq_len=16, global_batch=4)
    t = next(SyntheticPipeline(dcfg, device="cpu"))["tokens"].numpy()
    # successor property: token_{t+1} = (131 token_t + 17) mod V
    np.testing.assert_array_equal(t[:, 1:], (131 * t[:, :-1] + 17) % 97)


# ------------------------------------------------------------------ data
@pytest.mark.parametrize("mode", ["tokens", "embeddings"])
def test_pipeline_on_reference_draws_gives_reference_batches(mode):
    kw = dict(vocab_size=97, seq_len=16, global_batch=8, seed=3,
              input_mode=mode, d_model=8)
    ref = RefPipeline(RefDataConfig(**kw), host_id=1, n_hosts=2)

    def draws(step, host_id):
        b = ref._batch_for(step)
        embeds = b.get("embeds")
        return (np.array(b["tokens"])[:, :1],
                None if embeds is None else np.array(embeds))

    port = SyntheticPipeline(DataConfig(**kw), host_id=1, n_hosts=2,
                             start_step=2, device="cpu", draws=draws)
    for step in (2, 3):
        want, got = ref._batch_for(step), next(port)
        assert sorted(want) == sorted(got)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_pipeline_draws_depend_on_step_and_host_alone():
    dcfg = DataConfig(vocab_size=1000, seq_len=8, global_batch=4, seed=5,
                      input_mode="embeddings", d_model=4)
    a = SyntheticPipeline(dcfg, device="cpu")
    first = [next(a) for _ in range(3)]
    resumed = next(SyntheticPipeline(dcfg, start_step=2, device="cpu"))
    for k in ("tokens", "labels", "embeds"):
        assert torch.equal(first[2][k], resumed[k])
    # labels are the tokens rolled left, the last wrapping to the first
    assert torch.equal(first[0]["labels"], torch.roll(first[0]["tokens"],
                                                      -1, dims=1))
    other = next(SyntheticPipeline(dataclasses.replace(dcfg, seed=6),
                                   device="cpu"))
    assert not torch.equal(first[0]["tokens"], other["tokens"])


# ------------------------------------------------ teacher-forced steps
def _opt(**kw):
    # Peak 3e-4: Adam's and Adafactor's normalization turns the float32
    # noise of a gradient near eps (1e-8) into a ~10 % change of its
    # update, which at the twins' 3e-3 can reach the parameters' bar;
    # here it stays under a third of it, while an update of the wrong size
    # or sign would miss the bar tenfold (ROADMAP C, "Training").
    base = dict(peak_lr=3e-4, warmup_steps=5, total_steps=100)
    base.update(kw)
    return base


STEP_CASES = {
    "adamw": dict(optimizer=_opt()),
    "adamw_accum2_bf16": dict(optimizer=_opt(), accum_steps=2,
                              compression="bf16"),
    "adamw_int8_ef": dict(optimizer=_opt(), compression="int8_ef"),
    "adafactor": dict(optimizer=_opt(name="adafactor",
                                     factored_min_dim=32)),
    # factored_min_dim 2 <= L = 2: the stacked norm scales (2, 64) are
    # factored, their column statistics spanning both layers
    "adafactor_stacked": dict(optimizer=_opt(name="adafactor",
                                             factored_min_dim=2)),
}


@pytest.fixture(scope="module")
def ref_tiny_params():
    """Initial TINY32 parameters for the reference (the port's random
    weights as the reference's tree)."""
    return jax.tree.map(jnp.asarray, convert.params_to_numpy(
        build_model(TINY32, "cpu", seed=0)))


@pytest.fixture(scope="module")
def ref_tiny_grad():
    """The reference TINY32's loss gradient (dense: no aux loss)."""
    model = ref_build_model(REF_TINY32)
    return jax.jit(jax.grad(lambda p, b: model.train_loss(p, b)[0]))


def _ref_tcfg(case):
    spec = STEP_CASES[case]
    return RefTrainConfig(
        optimizer=RefOptimizerConfig(**spec["optimizer"]),
        compression=RefCompressionConfig(
            mode=spec.get("compression", "none")),
        accum_steps=spec.get("accum_steps", 1))


def _assert_tree_close(got, want, path=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), (path, sorted(got), sorted(want))
        for k in want:
            _assert_tree_close(got[k], want[k], f"{path}/{k}")
    elif want is None:
        assert got is None, path
    else:
        want = np.asarray(want)
        assert got.shape == want.shape, (path, got.shape, want.shape)
        np.testing.assert_allclose(got, want.astype(got.dtype), rtol=RTOL,
                                   atol=ATOL, err_msg=path)


def _assert_ef_close(got, want, state, grads):
    """The error-feedback residuals at the bar, except where the
    reference's scaled gradient sits on a rounding tie of the int8
    quantizer (within 1e-3 of a half-integer, where float32 noise picks the
    side): there the two residuals differ by one quantum."""
    flat_g = jax.tree_util.tree_leaves_with_path(grads)
    flat_r = jax.tree_util.tree_leaves(state.ef_residual)
    flips = 0
    for (path, g), r in zip(flat_g, flat_r):
        key = [k.key for k in path]
        g32 = np.asarray(g) + np.asarray(r)
        scale = max(np.abs(g32).max(), 1e-12) / 127.0
        t = np.abs(g32 / scale)
        tie = np.abs(t - np.floor(t) - 0.5) < 1e-3
        got_l, want_l = got, want
        for k in key:
            got_l, want_l = got_l[k], want_l[k]
        want_l = np.asarray(want_l)
        off = ~np.isclose(got_l, want_l, rtol=RTOL, atol=ATOL)
        assert not (off & ~tie).any(), (key, np.argwhere(off & ~tie))
        np.testing.assert_allclose(np.abs(got_l - want_l)[off], scale,
                                   rtol=1e-3, err_msg=str(key))
        flips += int(off.sum())
    assert flips <= 3, flips


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_teacher_forced_step_matches_reference(case, ref_tiny_params,
                                               ref_tiny_grad):
    from repro.training import optimizer as ref_opt
    from repro.training.grad_compression import init_error_feedback
    from repro.training.train_step import TrainState as RefTrainState
    tcfg = _ref_tcfg(case)
    ref_model = ref_build_model(REF_TINY32)
    step = jax.jit(ref_make_step(ref_model, tcfg))
    pipe = RefPipeline(RefDataConfig(vocab_size=211, seq_len=32,
                                     global_batch=8))
    state = RefTrainState(
        ref_tiny_params, ref_opt.init(tcfg.optimizer, ref_tiny_params),
        init_error_feedback(ref_tiny_params)
        if tcfg.compression.mode == "int8_ef" else None)
    state, _ = step(state, next(pipe))       # a carried, non-zero state
    batch = next(pipe)
    want_state, want_m = step(state, batch)

    model, pstate, ptcfg = train_state_to_port(TINY32, tcfg, state)
    got_state, got_m = make_train_step(model, ptcfg)(pstate,
                                                     batch_to_port(batch))
    for name in ("loss", "aux_loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(getattr(got_m, name)),
                                   float(getattr(want_m, name)), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    got = convert.train_state_to_numpy(got_state)
    want = jax.tree.map(np.asarray, want_state)
    _assert_tree_close(got["params"], want.params, "params")
    assert int(got["opt"]["step"]) == int(want.opt.step) == 2
    _assert_tree_close(got["opt"]["inner"], want.opt.inner, "opt")
    if case == "adamw_int8_ef":
        _assert_ef_close(got["ef_residual"], want.ef_residual, state,
                         ref_tiny_grad(state.params, batch))
    else:
        _assert_tree_close(got["ef_residual"], want.ef_residual, "ef")
    if case == "adafactor_stacked":
        # the norm scales' state is factored over the stack, and the RMS
        # clip is active on them (their raw update's RMS exceeds 1)
        vc = got["opt"]["inner"]["stack"]["pos0"]["norm_mixer"]["scale"]
        assert sorted(vc) == ["vc", "vr"] and vc["vr"].shape == (2,)
        grads, _ = jax.jit(ref_opt.clip_by_global_norm, static_argnums=1)(
            ref_tiny_grad(state.params, batch), 1.0)
        g = grads["stack"]["pos0"]["norm_mixer"]["scale"]
        st = state.opt.inner["stack"]["pos0"]["norm_mixer"]["scale"]
        beta2 = 1.0 - 2.0 ** -0.8
        g2 = np.asarray(g, np.float64) ** 2 + 1e-30
        vr = beta2 * np.asarray(st["vr"]) + (1 - beta2) * g2.mean(-1)
        vc_ = beta2 * np.asarray(st["vc"]) + (1 - beta2) * g2.mean(-2)
        u = np.asarray(g) / np.sqrt(vr[:, None] * vc_[None, :] / vr.mean())
        assert np.sqrt(np.mean(u * u)) > 1.0


def test_teacher_forced_hybrid_step_with_stacked_adafactor():
    """jamba's smoke model in float32 under Adafactor with
    ``factored_min_dim`` 2: every leaf of the four period stacks (the
    Mamba mixers, the MLPs, the experts and the attention) is factored
    over its stacked shape, as the reference stacks it; one port step from
    a carried reference state equals one reference step, the MoE aux loss
    included."""
    from repro.configs import get_arch as ref_get_arch
    from repro.training import optimizer as ref_opt
    from repro.training.train_step import TrainState as RefTrainState
    from repro_torch.configs import get_arch

    def f32(c):
        return dataclasses.replace(c, param_dtype="float32",
                                   compute_dtype="float32")
    cfg = f32(get_arch("jamba-1.5-large-398b").smoke)
    ref_model = ref_build_model(f32(ref_get_arch("jamba-1.5-large-398b")
                                    .smoke))
    tcfg = RefTrainConfig(optimizer=RefOptimizerConfig(
        **_opt(name="adafactor", factored_min_dim=2)))
    step = jax.jit(ref_make_step(ref_model, tcfg))
    params = jax.tree.map(jnp.asarray, convert.params_to_numpy(
        build_model(cfg, "cpu", seed=0)))
    pipe = RefPipeline(RefDataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                     global_batch=4))
    state = RefTrainState(params, ref_opt.init(tcfg.optimizer, params),
                          None)
    state, _ = step(state, next(pipe))       # a carried, non-zero state
    batch = next(pipe)
    want_state, want_m = step(state, batch)

    model, pstate, ptcfg = train_state_to_port(cfg, tcfg, state)
    got_state, got_m = make_train_step(model, ptcfg)(pstate,
                                                     batch_to_port(batch))
    for name in ("loss", "aux_loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(getattr(got_m, name)),
                                   float(getattr(want_m, name)), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    assert float(got_m.aux_loss) > 0
    got = convert.train_state_to_numpy(got_state)
    want = jax.tree.map(np.asarray, want_state)
    assert sorted(got["params"]["stack"]) == [f"pos{p}" for p in range(4)]
    _assert_tree_close(got["params"], want.params, "params")
    assert int(got["opt"]["step"]) == int(want.opt.step) == 2
    _assert_tree_close(got["opt"]["inner"], want.opt.inner, "opt")
    inner = got["opt"]["inner"]["stack"]
    for pos, leaf, vr in (("pos0", "norm_mlp/scale", (2,)),
                          ("pos1", "mamba/a_log", (2,)),
                          ("pos1", "moe/wi", (2, 4, 64)),
                          ("pos3", "attn/wq", (2, 64, 4))):
        st = inner[pos]
        for key in leaf.split("/"):
            st = st[key]
        assert sorted(st) == ["vc", "vr"] and st["vr"].shape == vr, \
            (pos, leaf, st["vr"].shape)


def test_optimizer_pieces_match_reference():
    """schedule at warmup, decay and the floor; global-norm clipping."""
    from repro.training import optimizer as ref_opt
    ocfg = dict(peak_lr=3e-4, warmup_steps=10, total_steps=50)
    for s in (0, 1, 9, 10, 11, 30, 50, 80):
        np.testing.assert_allclose(
            float(opt_mod.schedule(OptimizerConfig(**ocfg), s)),
            float(ref_opt.schedule(RefOptimizerConfig(**ocfg), s)),
            rtol=1e-6)
    rng = np.random.default_rng(0)
    leaves = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": rng.standard_normal((2, 5)).astype(np.float32)}
    port = {"a": torch.from_numpy(leaves["a"]),
            "b": list(torch.from_numpy(leaves["b"]).unbind(0))}
    for max_norm in (0.5, 100.0):
        got, gn = opt_mod.clip_by_global_norm(port, max_norm)
        want, wn = ref_opt.clip_by_global_norm(
            jax.tree.map(jnp.asarray, leaves), max_norm)
        np.testing.assert_allclose(float(gn), float(wn), rtol=1e-6)
        np.testing.assert_allclose(t2n(got["a"]), np.asarray(want["a"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(t2n(torch.stack(got["b"])),
                                   np.asarray(want["b"]), rtol=1e-6)


# ------------------------------------------------------------------ loss
def test_chunked_lm_loss_matches_reference():
    """loss_chunk 8 over S = 32: four chunks in order, the mean of their
    means; the loss and its gradients in x and the head."""
    cfg = dataclasses.replace(TINY32, loss_chunk=8, tie_embeddings=False)
    ref_cfg = dataclasses.replace(REF_TINY32, loss_chunk=8,
                                  tie_embeddings=False)
    emb = ref_layers.init_embedding(jax.random.key(0), ref_cfg)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 32, 64)).astype(np.float32)
    labels = rng.integers(0, 211, (2, 32)).astype(np.int32)
    (want, (gx, gemb)) = jax.value_and_grad(
        lambda x_, e_: ref_layers.chunked_lm_loss(e_, x_, labels, ref_cfg),
        argnums=(0, 1))(jnp.asarray(x), emb)
    port_emb = layers.Embedding(cfg, "cpu")
    port_emb.load_state_dict({k: torch.from_numpy(np.array(v))
                              for k, v in emb.items()})
    port_emb.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = layers.chunked_lm_loss(port_emb, xt, torch.from_numpy(labels), cfg)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)
    np.testing.assert_allclose(t2n(xt.grad), np.asarray(gx), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(t2n(port_emb.head.grad),
                               np.asarray(gemb["head"]), rtol=RTOL,
                               atol=ATOL)
    # unchunked, the same function
    whole = layers.chunked_lm_loss(port_emb, xt,
                                   torch.from_numpy(labels), TINY32)
    np.testing.assert_allclose(whole.item(), got.item(), rtol=1e-5)


# -------------------------------------------------- the gradient guard
def _needs_grad(*shape):
    return torch.randn(*shape).requires_grad_(True)


def test_kernel_entry_points_refuse_inputs_that_need_gradients():
    q, k, v = _needs_grad(1, 4, 2, 16), torch.randn(1, 4, 2, 16), \
        torch.randn(1, 4, 2, 16)
    with pytest.raises(RuntimeError, match="blockwise_attention"):
        attn_ops.attention(q, k, v)
    with pytest.raises(RuntimeError, match="blockwise_attention"):
        attn_ops.decode_attention(q[:, :1], k, v, position=3)
    x, dt = torch.randn(1, 8, 2, 4), torch.rand(1, 8, 2)
    a = -torch.rand(2).requires_grad_(True)
    b, c = torch.randn(1, 8, 1, 4), torch.randn(1, 8, 1, 4)
    with pytest.raises(RuntimeError, match="ssd_chunked"):
        ssd_ops.ssd(x, dt, a, b, c, 4)
    # serving runs under no_grad, and inputs that need no gradient pass
    with torch.no_grad():
        assert attn_ops.attention(q, k, v).shape == q.shape
        assert ssd_ops.ssd(x, dt, a, b, c, 4)[0].shape == x.shape
    assert attn_ops.attention(q.detach(), k, v).shape == q.shape


def test_unfrozen_model_serves_and_trains_through_separate_paths(
        monkeypatch):
    """After init_train_state the parameters take gradients; prefill and
    decode still run (under no_grad) through the kernels' entry points,
    and train_loss reaches none of them."""
    model = build_model(TINY32, "cpu", seed=0)
    init_train_state(model, TrainConfig())
    toks = torch.randint(0, 211, (2, 16))
    logits, caches = model.prefill(toks, max_len=20)
    assert not logits.requires_grad
    model.decode_step(toks[:, :1], caches, 16)
    called = []
    orig = attn_ops.flash_prefill

    def spy(*a, **k):
        called.append(1)
        return orig(*a, **k)
    monkeypatch.setattr(attn_ops, "flash_prefill", spy)
    loss, _ = model.train_loss({"tokens": toks,
                                "labels": torch.roll(toks, -1, 1)})
    assert loss.requires_grad and not called
