"""Whole runs on the CPU with the timed path broken underneath: each fault
a cell can have makes ``correct`` come out false, and the sound run true.
(One card, so no exchange between chips is left out.)"""

import pytest
from perfbench_cells import run_small, small_cell


def ok(out) -> bool:
    return bool(out.checks) and all(c.ok for c in out.checks)


# ------------------------------------------------------------ served model
def _serve_fault(kind, monkeypatch):
    from repro_torch.models import attention
    from repro_torch.models.model import DecoderOnlyLM
    if kind == "state_unchanged":
        # the decode wave never writes its token's K/V into the cache
        monkeypatch.setattr(attention, "cache_write_decode",
                            lambda cache, k, v, position: cache)
        return
    real = DecoderOnlyLM.decode_step

    def broken(self, tokens, caches, position):
        logits, caches = real(self, tokens, caches, position)
        logits = logits.clone()
        if kind == "token_altered":
            top = logits.argmax(-1, keepdim=True)
            logits.scatter_(-1, top, float("-inf"))
        elif kind == "half_batch":
            logits[logits.shape[0] // 2:] = 0.0
        return logits, caches
    monkeypatch.setattr(DecoderOnlyLM, "decode_step", broken)


@pytest.mark.parametrize("workload", ["mixtral-longdoc", "mixtral-code"])
def test_serve_sound_run_is_correct(workload):
    out = run_small(small_cell(workload), seconds=4.0)
    assert ok(out), out.checks
    assert out.values["tokens_per_s"] > 0 and out.attempted >= 2
    assert out.values["ttft_p95_ms"] > 0 and out.values["itl_p95_ms"] > 0


@pytest.mark.parametrize("workload", ["mixtral-longdoc", "mixtral-code"])
@pytest.mark.parametrize("fault", ["state_unchanged", "token_altered",
                                   "half_batch"])
def test_serve_fault_is_not_correct(fault, workload, monkeypatch):
    _serve_fault(fault, monkeypatch)
    out = run_small(small_cell(workload), seconds=4.0)
    assert not ok(out), (fault, out.checks)
