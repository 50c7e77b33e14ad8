"""The port's encoder-decoder (``EncoderDecoderLM``, seamless-m4t's family)
against the reference's on ``seamless-smoke`` in float32, with the
reference's parameters carried across by
``repro_torch.models.convert.params_from_numpy`` (its ``encoder`` and
``decoder`` stacks):

* ``prefill`` over frame embeddings and a target prefix: the logits, every
  decoder layer's self cache and cross cache (the K/V of the encoder
  output);
* ``decode_step`` at a per-batch position vector, logits and self caches;
  then a greedy loop of decode steps, tokens equal;
* prefill(S) + decode(S) equals prefill(S + 1) on the same source, in the
  port alone (``tests/test_models.py``'s contract);
* ``init_caches`` gives the reference's shapes.

Tolerance rtol 1e-4 / atol 1e-5, as for the decoder-only models.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_arch as ref_get_arch
from repro.models import build_model as ref_build_model
from repro_torch.configs import get_arch
from repro_torch.models import EncoderDecoderLM, build_model, convert
from torch_port_ref import lm_to_port, t2n

RTOL, ATOL = 1e-4, 1e-5
ARCH = "seamless-m4t-medium"
S_ENC, SEQ, MAX_LEN = 20, 12, 24


def _f32(c):
    return dataclasses.replace(c, param_dtype="float32",
                               compute_dtype="float32")


def _inputs(cfg, seed, seq=SEQ):
    rng = np.random.default_rng(seed)
    embeds = rng.standard_normal((2, S_ENC, cfg.d_model)).astype(np.float32)
    return embeds, rng.integers(0, cfg.vocab_size, (2, seq)).astype(np.int32)


def _close(port, ref, msg=""):
    np.testing.assert_allclose(t2n(port), np.asarray(ref, np.float32),
                               rtol=RTOL, atol=ATOL, err_msg=msg)


def _caches_close(port, ref_tree, cfg, parts=("self", "cross")):
    _, want = lm_to_port(cfg, caches=ref_tree)
    for part in parts:
        assert len(port[part]) == len(want[part]) == cfg.n_layers
        for i, (p, w) in enumerate(zip(port[part], want[part])):
            assert sorted(p) == sorted(w) == ["k", "v"]
            for name in w:
                assert p[name].shape == w[name].shape, (part, i, name)
                _close(p[name], t2n(w[name]), f"{part} layer {i} {name}")


def _models(seed=1):
    ref_cfg, cfg = _f32(ref_get_arch(ARCH).smoke), _f32(get_arch(ARCH).smoke)
    ref_model = ref_build_model(ref_cfg)
    params = jax.jit(ref_model.init)(jax.random.key(seed))
    sd, _ = lm_to_port(cfg, params)
    return cfg, ref_model, params, convert.model_from_state_dict(cfg, sd,
                                                                 "cpu")


def test_prefill_and_decode_match_reference():
    cfg, ref_model, params, model = _models()
    assert isinstance(model, EncoderDecoderLM)
    embeds, toks = _inputs(cfg, 2, SEQ + 1)
    batch = {"embeds": jnp.asarray(embeds), "tokens": jnp.asarray(
        toks[:, :SEQ])}
    lg_ref, c_ref = jax.jit(ref_model.prefill, static_argnames="max_len")(
        params, batch, max_len=MAX_LEN)
    lg, caches = model.prefill(torch.from_numpy(embeds),
                               torch.from_numpy(toks[:, :SEQ]),
                               max_len=MAX_LEN)
    _close(lg, lg_ref, "prefill logits")
    _caches_close(caches, c_ref, cfg)

    pos = np.array([SEQ, SEQ - 3], np.int32)
    decode_ref = jax.jit(ref_model.decode_step)
    lg2_ref, c2_ref = decode_ref(params, jnp.asarray(toks[:, SEQ:]), c_ref,
                                 jnp.asarray(pos))
    lg2, caches2 = model.decode_step(torch.from_numpy(toks[:, SEQ:]),
                                     caches, torch.from_numpy(pos))
    _close(lg2, lg2_ref, "decode logits")
    _caches_close(caches2, c2_ref, cfg, parts=("self",))

    # greedy from the prefix, both sides on their own caches
    _, c_ref = jax.jit(ref_model.prefill, static_argnames="max_len")(
        params, batch, max_len=MAX_LEN)
    _, caches = model.prefill(torch.from_numpy(embeds),
                              torch.from_numpy(toks[:, :SEQ]),
                              max_len=MAX_LEN)
    t_ref = jnp.asarray(toks[:, SEQ:])
    t = torch.from_numpy(toks[:, SEQ:])
    for step in range(6):
        lg_r, c_ref = decode_ref(params, t_ref, c_ref, SEQ + step)
        lg_p, caches = model.decode_step(t, caches, SEQ + step)
        _close(lg_p, lg_r, f"greedy step {step}")
        t_ref = jnp.argmax(lg_r[:, -1], -1).astype(jnp.int32)[:, None]
        t = torch.argmax(lg_p[:, -1], -1)[:, None]
        np.testing.assert_array_equal(t2n(t), np.asarray(t_ref))


def test_decode_matches_full_prefill():
    """prefill(S) + decode(S) == prefill(S + 1) on the same source frames,
    in the port alone (random weights from its own generator)."""
    cfg = _f32(get_arch(ARCH).smoke)
    model = build_model(cfg, "cpu", seed=1)
    embeds, toks = (torch.from_numpy(a) for a in _inputs(cfg, 3, SEQ + 1))
    lg_full, _ = model.prefill(embeds, toks)
    _, caches = model.prefill(embeds, toks[:, :SEQ], max_len=SEQ + 8)
    lg_dec, _ = model.decode_step(toks[:, SEQ:], caches, SEQ)
    a, d = t2n(lg_full), t2n(lg_dec)
    err = np.max(np.abs(a - d)) / (np.max(np.abs(a)) + 1e-9)
    assert err < 1e-4, f"rel err {err:.2e}"


def test_init_caches_have_the_references_shapes():
    ref_cfg, cfg = ref_get_arch(ARCH).smoke, get_arch(ARCH).smoke
    want = ref_build_model(ref_cfg).init_caches(3, MAX_LEN, S_ENC)
    got = build_model(cfg, "cpu").init_caches(3, MAX_LEN, S_ENC)
    _, want = lm_to_port(cfg, caches=want)
    for part in ("self", "cross"):
        assert [{k: (v.shape, v.dtype) for k, v in c.items()}
                for c in got[part]] == [
            {k: (v.shape, v.dtype) for k, v in c.items()} for c in want[part]]
