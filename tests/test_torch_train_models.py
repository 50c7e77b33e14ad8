"""The models' training path against the reference's, on the CPU:

* ``train_loss`` and the gradient of every parameter (of loss + 0.01 aux,
  the train step's objective) against ``jax.value_and_grad`` of the
  reference's ``train_loss``, with the reference's weights carried across,
  on every smoke arch in float32: the five dense ones, the two MoE ones
  (every expert index equal, layer by layer), mamba2 (through the plain
  ``ssd_chunked``), the encoder-decoder and jamba's hybrid stack (its
  ``mamba_mlp``, ``mamba_moe`` and ``attn_moe`` layers, expert indices
  equal);
* ``blockwise_attention`` forward and input gradients against the
  reference's in causal, window and full modes, over several query and
  key chunks, with per-batch ``q_offset`` and ``kv_valid_len``;
* the hybrid family still raises naming its ROADMAP item.

Tolerance rtol 1e-4 / atol 1e-5 (both sides float32, summed in other
orders).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_archs as ref_all_archs
from repro.models import attention as ref_attention
from repro.models import build_model as ref_build_model
from repro_torch.configs import get_arch
from repro_torch.models import build_model, convert
from repro_torch.models.attention import blockwise_attention
from repro_torch.training.train_step import unfreeze
from torch_port_ref import expert_indices, lm_to_port, t2n

RTOL, ATOL = 1e-4, 1e-5
ARCHS = ["chameleon-34b", "gemma-2b", "gemma3-1b", "internlm2-1.8b",
         "qwen1.5-32b", "mixtral-8x7b", "llama4-scout-17b-16e",
         "mamba2-2.7b", "seamless-m4t-medium", "jamba-1.5-large-398b"]
AUX_WEIGHT = 0.01
B, S = 2, 32


def _cfgs(arch_id):
    def f32(c):
        return dataclasses.replace(c, param_dtype="float32",
                                   compute_dtype="float32")
    ref_cfg = {a.arch_id: a for a in ref_all_archs()}[arch_id].smoke
    return f32(ref_cfg), f32(get_arch(arch_id).smoke)


def _batch(cfg):
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    if cfg.input_mode == "embeddings":
        batch["embeds"] = rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch_id", ARCHS)
def test_train_loss_and_gradients_match_reference(arch_id):
    ref_cfg, cfg = _cfgs(arch_id)
    ref_model = ref_build_model(ref_cfg)
    # the port's random weights, carried to the reference and back
    params = jax.tree.map(jnp.asarray, convert.params_to_numpy(
        build_model(cfg, "cpu", seed=1)))
    batch = _batch(cfg)
    jbatch = jax.tree.map(jnp.asarray, batch)

    def objective(p, b):
        loss, aux = ref_model.train_loss(p, b)
        return loss + AUX_WEIGHT * aux, (loss, aux)
    (_, (loss, aux)), grads = jax.jit(jax.value_and_grad(
        objective, has_aux=True))(params, jbatch)

    sd, _ = lm_to_port(cfg, params)
    model = convert.model_from_state_dict(cfg, sd, "cpu")
    flat = [p for leaf in unfreeze(model).values()
            for p in (leaf if isinstance(leaf, list) else [leaf])]
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    p_loss, p_aux = model.train_loss(tbatch)
    got = torch.autograd.grad(p_loss + AUX_WEIGHT * p_aux, flat)
    np.testing.assert_allclose(p_loss.item(), float(loss), rtol=RTOL)
    np.testing.assert_allclose(p_aux.item(), float(aux), rtol=RTOL,
                               atol=ATOL)
    assert (float(aux) > 0) == (cfg.n_experts > 0)

    want, _ = lm_to_port(cfg, grads)
    names = {id(p): n for n, p in model.named_parameters()}
    assert len(flat) == len(want)
    for p, g in zip(flat, got):
        name = names[id(p)]
        np.testing.assert_allclose(t2n(g), t2n(want[name]), rtol=RTOL,
                                   atol=ATOL, err_msg=name)

    if cfg.n_experts:
        with expert_indices() as (ref_idx, port_idx):
            jax.block_until_ready(jax.jit(ref_model.train_loss)(params,
                                                                jbatch))
            with torch.no_grad():
                model.train_loss(tbatch)
        n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
        assert len(ref_idx) == len(port_idx) == n_moe
        for i, (r, p) in enumerate(zip(ref_idx, port_idx)):
            np.testing.assert_array_equal(p, r, err_msg=f"MoE layer {i}")


# ------------------------------------------------------------ attention
ATTN_CASES = {
    "causal": dict(mask_mode="causal"),
    "window": dict(mask_mode="window", window=6),
    "full": dict(mask_mode="full"),
    "causal_ragged": dict(mask_mode="causal", q_offset=[16, 9],
                          kv_valid_len=[32, 21]),
    "window_ragged": dict(mask_mode="window", window=7, q_offset=[16, 3]),
    "full_kv_valid": dict(mask_mode="full", kv_valid_len=[32, 12]),
    "causal_offset": dict(mask_mode="causal", q_offset=16,
                          kv_valid_len=28),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_blockwise_attention_matches_reference(case):
    """Sq = 16 in 2 query chunks against Skv = 32 in 4 key chunks, GQA
    4:2, D = 8; the output and the gradients of <out, ct> in q, k and v."""
    kw = dict(ATTN_CASES[case], q_chunk=8, kv_chunk=8)
    rng = np.random.default_rng(7)
    sq = 32 if "q_offset" not in kw else 16
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in
               ((B, sq, 4, 8), (B, 32, 2, 8), (B, 32, 2, 8)))
    ct = rng.standard_normal((B, sq, 4, 8)).astype(np.float32)
    ref_kw = {n: (jnp.asarray(x, jnp.int32) if isinstance(x, list) else x)
              for n, x in kw.items()}
    port_kw = {n: (torch.tensor(x) if isinstance(x, list) else x)
               for n, x in kw.items()}

    @jax.jit
    def ref_fn(q_, k_, v_, ct_):
        out, vjp = jax.vjp(lambda *a: ref_attention.blockwise_attention(
            *a, **ref_kw), q_, k_, v_)
        return out, vjp(ct_)
    want, want_g = ref_fn(*(jnp.asarray(x) for x in (q, k, v, ct)))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, v))
    got = blockwise_attention(qt, kt, vt, **port_kw)
    got_g = torch.autograd.grad(got, (qt, kt, vt), torch.from_numpy(ct))
    np.testing.assert_allclose(t2n(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    for name, g, w in zip("qkv", got_g, want_g):
        np.testing.assert_allclose(t2n(g), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=f"d{name}")


def test_blockwise_attention_keeps_bf16_products_in_float32():
    """bf16 operands: both products take float32 results (as the
    reference's ``preferred_element_type``), so the bf16 output is the
    float32 computation on the same bf16 values, rounded once, with the
    probabilities rounded to bf16 before the second product."""
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .bfloat16() for s in ((1, 16, 2, 16), (1, 16, 2, 16),
                                     (1, 16, 2, 16)))
    got = blockwise_attention(q, k, v)
    ref_fn = ref_attention.blockwise_attention
    want = ref_fn(*(jnp.asarray(t2n(x)).astype(jnp.bfloat16)
                    for x in (q, k, v)))
    assert got.dtype == torch.bfloat16
    # one bf16 ulp at most, from the order of the float32 sums
    np.testing.assert_allclose(t2n(got), np.asarray(want, np.float32),
                               rtol=2 ** -7, atol=1e-6)
