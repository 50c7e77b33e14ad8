"""The port's decoder-only LM against the reference's, on the five dense
smoke configs, the two MoE ones (mixtral: top-2 with a window; llama4-scout:
top-1 with a shared expert), mamba2's and jamba's (the hybrid: ``mamba_mlp``,
``mamba_moe`` and ``attn_moe`` layers in a period of 4) in float32, with the
reference's parameters carried across by
``repro_torch.models.convert.params_from_numpy``:

* ``prefill`` logits and every layer's cache (ring caches included; a
  Mamba layer's conv and SSM states, after a ragged last chunk; the
  hybrid's Mamba states and attention caches side by side); the MoE
  layers at the default capacity factor, where the second layer drops
  pairs past its capacity, every MoE layer's expert indices equal to the
  reference's at prefill and at decode;
* ``decode_step`` at a per-batch position vector, logits and caches;
* the reference's own contract inside the port: prefill(S) + decode(S)
  equals prefill(S + 1) at the last position (``tests/test_models.py``,
  at capacity factor 16 as there, so no token is dropped), also with a
  prefix shorter than the window, decoding into a ring not yet filled;
* a block kind that no config produces raises ``NotImplementedError``.

Tolerance rtol 1e-4 / atol 1e-5: both sides compute in float32 but sum in
different orders (XLA dots against PyTorch matmuls), through up to 8
layers.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_archs as ref_all_archs
from repro.models import ModelConfig as RefModelConfig
from repro.models import build_model as ref_build_model
from repro_torch.configs import PORT_ONLY, REGISTRY, all_archs, get_arch
from repro_torch.models import ModelConfig, blocks, build_model, convert, moe
from torch_port_ref import expert_indices, lm_to_port, t2n

DENSE = ["chameleon-34b", "gemma-2b", "gemma3-1b", "internlm2-1.8b",
         "qwen1.5-32b"]
MOE = ["mixtral-8x7b", "llama4-scout-17b-16e"]
HYBRID = "jamba-1.5-large-398b"
ARCHS = DENSE + MOE + ["mamba2-2.7b", HYBRID]
RTOL, ATOL = 1e-4, 1e-5
SEQ, MAX_LEN = 24, 32


def _cfgs(arch_id):
    def f32(c):
        return dataclasses.replace(c, param_dtype="float32",
                                   compute_dtype="float32")
    ref_cfg = {a.arch_id: a for a in ref_all_archs()}[arch_id].smoke
    return f32(ref_cfg), f32(get_arch(arch_id).smoke)


def _tokens(cfg, seed, seq):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (2, seq)).astype(np.int32)


def _close(port, ref, msg=""):
    np.testing.assert_allclose(t2n(port), np.asarray(ref, np.float32),
                               rtol=RTOL, atol=ATOL, err_msg=msg)


def _caches_close(port, ref_tree, cfg):
    _, want = lm_to_port(cfg, caches=ref_tree)
    assert len(port) == len(want) == cfg.n_layers
    for i, (p, w) in enumerate(zip(port, want)):
        assert sorted(p) == sorted(w), (i, sorted(p), sorted(w))
        for name in w:
            assert p[name].shape == w[name].shape, (i, name)
            _close(p[name], t2n(w[name]), f"layer {i} {name}")


@pytest.mark.parametrize("arch_id", ARCHS)
def test_prefill_and_ragged_decode_match_reference(arch_id, monkeypatch):
    ref_cfg, cfg = _cfgs(arch_id)
    dropped = []          # pairs each MoE layer drops past its capacity
    dispatch = moe.Moe.dispatch

    def counting_dispatch(self, xf, gates, expert_idx):
        c = moe.capacity(xf.shape[0], self.cfg)
        slot = self.slots(expert_idx, c)
        dropped.append(int((slot == cfg.n_experts * c).sum()))
        return dispatch(self, xf, gates, expert_idx)
    monkeypatch.setattr(moe.Moe, "dispatch", counting_dispatch)
    ref_model = ref_build_model(ref_cfg)
    params = jax.jit(ref_model.init)(jax.random.key(1))
    sd, _ = lm_to_port(cfg, params)
    model = convert.model_from_state_dict(cfg, sd, "cpu")

    toks = _tokens(cfg, 2, SEQ + 1)
    pos = np.array([SEQ, SEQ - 5], np.int32)
    with expert_indices() as (ref_idx, port_idx):
        lg_ref, c_ref = jax.jit(ref_model.prefill,
                                static_argnames="max_len")(
            params, {"tokens": jnp.asarray(toks[:, :SEQ])}, max_len=MAX_LEN)
        lg, caches = model.prefill(torch.from_numpy(toks[:, :SEQ]),
                                   max_len=MAX_LEN)
        _close(lg, lg_ref, "prefill logits")
        _caches_close(caches, c_ref, cfg)
        assert (sum(dropped) > 0) == (cfg.n_experts > 0), dropped

        # continuous batching: each sequence decodes at its own position
        lg2_ref, c2_ref = jax.jit(ref_model.decode_step)(
            params, jnp.asarray(toks[:, SEQ:]), c_ref, jnp.asarray(pos))
        lg2, caches2 = model.decode_step(torch.from_numpy(toks[:, SEQ:]),
                                         caches, torch.from_numpy(pos))
    _close(lg2, lg2_ref, "decode logits")
    _caches_close(caches2, c2_ref, cfg)
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
    assert len(ref_idx) == len(port_idx) == 2 * n_moe
    for i, (r, p) in enumerate(zip(ref_idx, port_idx)):
        np.testing.assert_array_equal(p, r, err_msg=f"MoE call {i}")


# (arch, prefix S): every arch at S = 24, past the smoke windows of 16, so
# the windowed ones decode into warm rings; and the two windowed ones at S
# = 10, so decode writes into a ring of 16 slots that has not filled
PREFIXES = [(a, SEQ) for a in ARCHS] + [("mixtral-8x7b", 10),
                                        ("gemma3-1b", 10)]


@pytest.mark.parametrize("arch_id, seq", PREFIXES,
                         ids=ARCHS + ["mixtral-8x7b-short", "gemma3-1b-short"])
def test_decode_matches_full_prefill(arch_id, seq):
    """prefill(S) + decode(S) == prefill(S + 1) at the last position, in
    the port alone (random weights from its own generator)."""
    _, cfg = _cfgs(arch_id)
    cfg = dataclasses.replace(cfg, capacity_factor=16.0)
    model = build_model(cfg, "cpu", seed=1)
    toks = torch.from_numpy(_tokens(cfg, 3, seq + 1))
    lg_full, _ = model.prefill(toks)
    _, caches = model.prefill(toks[:, :seq], max_len=SEQ + 8)
    lg_dec, _ = model.decode_step(toks[:, seq:], caches, seq)
    a, d = t2n(lg_full), t2n(lg_dec)
    err = np.max(np.abs(a - d)) / (np.max(np.abs(a)) + 1e-9)
    assert err < 1e-4, f"{arch_id}: rel err {err:.2e}"


def test_prefill_last_index_picks_the_true_last_token():
    """Right-padded prompts (the serving engine's buckets) read the logits
    of their true last position."""
    _, cfg = _cfgs("internlm2-1.8b")
    model = build_model(cfg, "cpu", seed=0)
    toks = torch.from_numpy(_tokens(cfg, 4, 16))
    lg_short, _ = model.prefill(toks[:, :11])
    padded = torch.cat([toks[:, :11], torch.zeros_like(toks[:, :5])], 1)
    lg_pad, _ = model.prefill(padded, max_len=32, last_index=10)
    np.testing.assert_allclose(t2n(lg_pad), t2n(lg_short), rtol=RTOL,
                               atol=ATOL)


def test_registry_and_configs_are_the_references():
    """The reference's ten archs, field for field over the reference's
    fields, with the port's own fields at their defaults; Granite-4.0-H is
    the one arch of the port alone."""
    ref_archs = {a.arch_id: a for a in ref_all_archs()}
    assert sorted(REGISTRY) == sorted([*ref_archs, *PORT_ONLY])
    assert PORT_ONLY == ("granite-4.0-h-small",)
    ref_fields = {f.name for f in dataclasses.fields(RefModelConfig)}
    own = {f.name: f.default for f in dataclasses.fields(ModelConfig)
           if f.name not in ref_fields}
    assert sorted(own) == sorted(["position_embedding", "attn_scale",
                                  "shared_d_ff", "attn_offset", "embed_scale",
                                  "residual_scale", "logit_divisor"])
    for a in all_archs():
        if a.arch_id in PORT_ONLY:
            continue
        r = ref_archs[a.arch_id]
        for size in ("full", "smoke"):
            got = dataclasses.asdict(getattr(a, size))
            assert {k: got[k] for k in ref_fields} == dataclasses.asdict(
                getattr(r, size))
            assert {k: got[k] for k in own} == own
        assert a.full.param_count() == r.full.param_count()
        assert a.full.active_param_count() == r.full.active_param_count()
    full = get_arch("internlm2-1.8b").full
    assert (full.n_layers, full.d_model, full.head_dim) == (24, 2048, 128)


def test_hybrid_stack_holds_each_kind_with_its_leaves():
    """jamba's smoke stack: layer i attention iff i % 4 == 3, MoE iff i is
    odd; every hybrid layer keeps its FFN's norm (a bare ``mamba`` has
    none, as in the reference), and its caches sit side by side."""
    _, cfg = _cfgs(HYBRID)
    model = build_model(cfg, "cpu", seed=0)
    kinds = [blk.kind for blk in model.layers]
    assert kinds == ["mamba_mlp", "mamba_moe", "mamba_mlp", "attn_moe"] * 2
    for blk in model.layers:
        names = {n.split(".")[0] for n, _ in blk.named_parameters()}
        mixer = "mamba" if blk.kind.startswith("mamba") else "attn"
        assert names == {"norm_mixer", mixer, "norm_mlp",
                         blk.kind.split("_")[1]}, blk.kind
    assert not hasattr(blocks.Block(cfg, "mamba", "meta"), "norm_mlp")
    caches = model.init_caches(2, 16)
    assert [sorted(c) for c in caches[:4]] == [
        ["conv_b", "conv_c", "conv_x", "ssm"]] * 3 + [["k", "v"]]


@pytest.mark.parametrize("kind", ["mamba_swa", "ssm_mlp", "attn",
                                  "gattn_dense", "mamba_moe_mlp"])
def test_block_kinds_no_config_produces_raise(kind):
    kinds = {a.full.layer_kind(i) for a in all_archs()
             for i in range(a.full.n_layers)}
    assert kind not in kinds
    with pytest.raises(NotImplementedError, match=kind):
        blocks.check_kind(kind)
    _, cfg = _cfgs(HYBRID)
    with pytest.raises(NotImplementedError):
        blocks.Block(cfg, kind, "meta")


def test_model_from_state_dict_shares_the_tensors():
    _, cfg = _cfgs("gemma-2b")
    a = build_model(cfg, "cpu", seed=5)
    b = convert.model_from_state_dict(cfg, a.state_dict(), "cpu")
    assert b.layers[1].attn.wq.data_ptr() == a.layers[1].attn.wq.data_ptr()
    c = build_model(cfg, "cpu", seed=5)
    assert torch.equal(c.embed.table, a.embed.table)
    assert not torch.equal(build_model(cfg, "cpu", seed=6).embed.table,
                           a.embed.table)
