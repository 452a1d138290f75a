"""The port's ``resilience.chaos`` against the JAX package's: the same
spec parses to the same clauses, and one spec and seed draw the same
sequence of faults at every site; the port's error is an
``MXNetError``, and the seam's counters tick."""
from __future__ import annotations

import pytest

from mxnet_tpu.base import MXNetError as JaxMXNetError
from mxnet_tpu.resilience import chaos as jchaos

from mxnet_tpu_torch import telemetry as ttel
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.resilience import chaos as tchaos

SPECS = [
    "serve.prefill_transfer:error:1.0",
    "serve.prefill_transfer:error:0.3",
    "serve.prefill_transfer:delay:0.5:3, engine.push:torn:0.25",
    "ckpt.write:torn:0.7:2,dist.barrier:error:0.1,obs.scrape:delay:1",
]


@pytest.fixture(autouse=True)
def no_chaos():
    yield
    jchaos.reset()
    tchaos.reset()


@pytest.mark.parametrize("spec", SPECS)
def test_parse_equals_jax(spec):
    got = [(f.site, f.kind, f.prob, f.after) for f in tchaos.parse(spec)]
    want = [(f.site, f.kind, f.prob, f.after) for f in jchaos.parse(spec)]
    assert got == want and got
    assert repr(tchaos.parse(spec)) == repr(jchaos.parse(spec))


@pytest.mark.parametrize("bad", ["a:b", "s:error:x", "s:melt:0.5",
                                 "s:error:1.5", "s:error:0.5:-1",
                                 "s:error:0.5:1:2"])
def test_bad_clauses_raise_in_both(bad):
    with pytest.raises(JaxMXNetError):
        jchaos.parse(bad)
    with pytest.raises(MXNetError):
        tchaos.parse(bad)


@pytest.mark.parametrize("seed", [0, 7, 12345])
@pytest.mark.parametrize("spec", SPECS)
def test_draw_sequence_equals_jax(spec, seed):
    sites = [f.site for f in jchaos.parse(spec)] + ["never.configured"]
    seqs = []
    for mod in (jchaos, tchaos):
        mod.configure(spec, seed=seed)
        assert mod.active()
        seqs.append([mod.draw(site) for _ in range(40) for site in sites])
    assert seqs[0] == seqs[1]
    assert any(k is not None for k in seqs[1])


def test_configure_from_env_and_duplicate_site(monkeypatch):
    monkeypatch.setenv("MXNET_FAULT_INJECT", "serve.prefill_transfer:error:0.5")
    monkeypatch.setenv("MXNET_FAULT_SEED", "3")
    specs = tchaos.configure()
    assert [s.site for s in specs] == ["serve.prefill_transfer"]
    jchaos.configure()
    assert [tchaos.draw("serve.prefill_transfer") for _ in range(30)] == \
        [jchaos.draw("serve.prefill_transfer") for _ in range(30)]
    with pytest.raises(MXNetError, match="duplicate"):
        tchaos.configure("a:error:1,a:delay:1")
    # a refused spec leaves the installed one in place
    assert tchaos.active()
    tchaos.reset()
    assert not tchaos.active() and tchaos.draw("a") is None


def test_maybe_fail_and_wrap(monkeypatch):
    prev = ttel.set_enabled(True)
    ttel.reset()
    try:
        monkeypatch.setenv("MXNET_FAULT_DELAY", "0")
        tchaos.configure("serve.prefill_transfer:error:1.0:1,"
                         "slow.site:delay:1.0")
        tchaos.maybe_fail("serve.prefill_transfer")     # the first is free
        with pytest.raises(tchaos.ChaosError) as info:
            tchaos.maybe_fail("serve.prefill_transfer")
        assert isinstance(info.value, MXNetError)
        assert "call #2" in str(info.value)
        tchaos.maybe_fail("slow.site")                  # delay: no raise
        wrapped = tchaos.wrap("serve.prefill_transfer", lambda: 5)
        with pytest.raises(tchaos.ChaosError):
            wrapped()
        assert tchaos.wrap("other.site", lambda: 5)() == 5
        snap = ttel.snapshot()
        assert snap["chaos.injected"]["value"] == 3
        assert snap["chaos.injected.serve.prefill_transfer"]["value"] == 2
        assert snap["chaos.injected.slow.site"]["value"] == 1
    finally:
        ttel.reset()
        ttel.set_enabled(prev)
