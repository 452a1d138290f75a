"""``HybridBlock.hybridize()`` of the port against the JAX package's, on the
CPU.

Every case runs one call sequence through a JAX block and through the
port's block of the same structure and weights (``convert.load_into``),
and holds the two against each other: the outputs (1e-5), the
``hybridize.*`` counters, the captured signature counts, the retrace
guard's J001 / J002 and the padded-then-sliced outputs of a bucketer.
The cases are those of ``tests/test_hybridize_cache.py``, the warmup and
bucketer cases of ``tests/test_jit.py`` that need no
``ShardedTrainer.compile``, and the retrace cases of
``tests/test_analysis.py``.  On the CPU the port's cached op keeps the
signature table and runs the block eagerly; the card's captured graphs
are held against eager in ``test_torch_cuda_kernels.py -k hybridize``.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import telemetry as jtel
from mxnet_tpu.analysis import retrace as jretrace
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon import rnn as jrnn
from mxnet_tpu.jit import ShapeBucketer as JBucketer

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import convert
from mxnet_tpu_torch import telemetry as ttel
from mxnet_tpu_torch.analysis import retrace as tretrace
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon import rnn as trnn
from mxnet_tpu_torch.gluon.model_zoo import get_model
from mxnet_tpu_torch.jit import ShapeBucketer as TBucketer

COUNTERS = ("hybridize.cache_misses", "hybridize.cache_hits",
            "hybridize.warmup_compiles", "hybridize.retrace_warnings",
            "hybridize.shape_churn_warnings")


class Pkg:
    """One package's side of a case: arrays in and out, its layers, its
    telemetry and retrace guard."""

    def __init__(self, jax: bool):
        self.jax = jax
        self.mx = jmx if jax else tmx
        self.tel = jtel if jax else ttel
        self.retrace = jretrace if jax else tretrace
        self.Error = jmx.MXNetError if jax else tmx.MXNetError

    def A(self, x):
        x = np.asarray(x)
        return jmx.np.array(x) if self.jax else torch.from_numpy(x.copy())

    @staticmethod
    def N(x):
        if hasattr(x, "asnumpy"):
            return x.asnumpy()
        return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)

    def record(self, train_mode=True):
        return self.mx.autograd.record(train_mode=train_mode)

    def counts(self) -> dict:
        snap = self.tel.snapshot()
        return {k: snap.get(k, {}).get("value", 0) for k in COUNTERS}

    def traced(self, net) -> int:
        return len(net._cached_op._traced) if net._cached_op else 0


J, T = Pkg(True), Pkg(False)


@pytest.fixture(autouse=True)
def fresh_state():
    prev = (jtel.set_enabled(True), ttel.set_enabled(True))
    for p in (J, T):
        p.tel.reset()
        p.retrace.reset()
    yield
    for p, was in zip((J, T), prev):
        p.tel.reset()
        p.tel.set_enabled(was)
        p.retrace.reset()


def twin(jnet, tnet, *samples, seed=0):
    """Initialize ``jnet`` from ``seed`` (a forward on ``samples`` infers
    its shapes) and load its values into ``tnet``."""
    jmx.random.seed(seed)
    jnet.initialize(jmx.init.Xavier())
    jnet(*(J.A(s) for s in samples))
    convert.load_into(tnet, {n: p.data().asnumpy()
                             for n, p in jnet.collect_params().items()})
    return jnet, tnet


def dense_twins(units=3, in_units=4, seed=0):
    return twin(jnn.Dense(units), tnn.Dense(units, in_units=in_units,
                                            device="cpu"),
                np.ones((1, in_units), "f4"), seed=seed)


def both(fn, *nets):
    """Run ``fn(pkg, net)`` on the JAX net and on the port's."""
    return fn(J, nets[0]), fn(T, nets[1])


def close(a, b, tol=1e-5):
    np.testing.assert_allclose(np.asarray(a, "f8"), np.asarray(b, "f8"),
                               rtol=tol, atol=tol)


def warm(P, net, *args):
    """The first call after ``hybridize()`` runs eagerly in both packages;
    drive it so later calls reach the cached op."""
    net(*args)
    return net


# ----------------------------------------- tests/test_hybridize_cache.py
def test_dtype_change_creates_new_entry_and_correct_output():
    x32 = np.random.RandomState(0).rand(2, 4).astype("float32")

    def run(P, net):
        net.hybridize()
        warm(P, net, P.A(x32))
        out32 = P.N(net(P.A(x32)))
        before = P.traced(net)
        out16 = P.N(net(P.A(x32.astype("float16"))))
        return out32, out16, P.traced(net) - before, P.counts()

    (j32, j16, jd, jc), (t32, t16, td, tc) = both(run, *dense_twins())
    assert jd == td == 1
    assert jc == tc
    close(j32, t32)
    close(j16.astype("f4"), t16.astype("f4"), 2e-2)
    close(t16.astype("f4"), t32, 2e-2)


def test_shape_change_reuses_params_not_graph():
    def run(P, net):
        net.hybridize()
        outs = []
        for rows in (1, 2, 7):
            x = np.random.RandomState(rows).rand(rows, 4).astype("float32")
            outs.append(P.N(net(P.A(x))))
        return outs, P.traced(net), P.counts()

    (jo, jt, jc), (to, tt, tc) = both(run, *dense_twins())
    for a, b in zip(jo, to):
        close(a, b)
    assert jt == tt and jc == tc


def test_param_value_update_without_retrace():
    x = np.random.RandomState(1).rand(2, 4).astype("float32")
    new_w = np.full((3, 4), 0.5, "float32")
    new_b = np.zeros(3, "float32")

    def run(P, net):
        net.hybridize()
        warm(P, net, P.A(x))
        P.N(net(P.A(x)))
        sigs = P.traced(net)
        if P.jax:
            net.weight.set_data(J.A(new_w))
            net.bias.set_data(J.A(new_b))
        else:
            with torch.no_grad():       # an update in place
                net.weight.copy_(torch.from_numpy(new_w))
                net.bias.copy_(torch.from_numpy(new_b))
        out = P.N(net(P.A(x)))
        return out, P.traced(net) - sigs, P.counts()

    (jo, jd, jc), (to, td, tc) = both(run, *dense_twins())
    assert jd == td == 0
    assert jc == tc
    close(jo, to)
    close(to, x @ new_w.T + new_b)


def test_force_reinit_then_forward():
    def run(P, net):
        net.hybridize()
        x = P.A(np.ones((2, 4), "f4"))
        a = P.N(net(x))
        P.mx.random.seed(99)
        net.initialize(P.mx.init.Xavier(), force_reinit=True)
        b = P.N(net(x))
        w = P.N(net.weight.data() if P.jax else net.weight)
        bias = P.N(net.bias.data() if P.jax else net.bias)
        return a, b, np.ones((2, 4)) @ w.T + bias, P.counts()

    (ja, jb, jw, jc), (ta, tb, tw, tc) = both(run, *dense_twins())
    close(ja, ta)
    for a, b, want in ((ja, jb, jw), (ta, tb, tw)):
        assert not np.allclose(a, b), "reinit must change the output"
        close(b, want)
    assert jc == tc


def test_rehybridize_clears_cache():
    def run(P, net):
        net.hybridize()
        warm(P, net, P.A(np.ones((2, 4), "f4")))
        net(P.A(np.ones((2, 4), "f4")))
        assert net._cached_op._traced
        net.hybridize()
        cleared = net._cached_op is None or not net._cached_op._traced
        out = P.N(net(P.A(np.ones((2, 4), "f4"))))
        return cleared, out, P.counts()

    (jcl, jo, jc), (tcl, to, tc) = both(run, *dense_twins())
    assert jcl and tcl
    close(jo, to)
    assert jc == tc


def test_hybridize_off_matches_on():
    x = np.random.RandomState(2).rand(3, 4).astype("float32")

    def run(P, net):
        eager = P.N(net(P.A(x)))
        net.hybridize()
        hybrid = P.N(net(P.A(x)))
        net.hybridize(False)
        eager2 = P.N(net(P.A(x)))
        return eager, hybrid, eager2

    jr, tr = both(run, *dense_twins())
    for a, b in zip(jr, tr):
        close(a, b)
    close(tr[0], tr[1], 1e-6)
    close(tr[0], tr[2], 1e-6)


def test_train_eval_mode_are_distinct_signatures():
    jnet = jnn.HybridSequential()
    jnet.add(jnn.Dense(16), jnn.Dropout(0.5))
    tnet = tnn.HybridSequential().add(tnn.Dense(16, in_units=8, device="cpu"),
                                      tnn.Dropout(0.5))
    twin(jnet, tnet, np.ones((4, 8), "f4"))

    def run(P, net):
        net.hybridize()
        x = P.A(np.ones((4, 8), "f4"))
        warm(P, net, x)
        infer = P.N(net(x))
        with P.record(train_mode=True):
            train = P.N(net(x))
        keys = {k[0] for k in net._cached_op._traced}
        return infer, (infer != 0).all(), (train == 0).any(), len(keys), \
            P.counts()

    (ji, jall, jany, jk, jc), (ti, tall, tany, tk, tc) = both(run, jnet, tnet)
    close(ji, ti)
    assert jall and tall and jany and tany
    assert jk == tk == 2
    assert jc == tc


def test_batchnorm_running_stats_mutate_through_cache():
    jnet, tnet = twin(jnn.BatchNorm(), tnn.BatchNorm(in_channels=5,
                                                     device="cpu"),
                      np.ones((2, 5), "f4"))

    def run(P, net):
        net.hybridize()
        mean = (lambda: P.N(net.running_mean.data())) if P.jax else \
            (lambda: P.N(net.running_mean))
        before = mean().copy()
        rs = np.random.RandomState(5)
        with P.record(train_mode=True):
            for _ in range(3):
                net(P.A(rs.rand(8, 5).astype("float32") + 2.0))
        return before, mean(), P.counts()

    (jb, ja, jc), (tb, ta, tc) = both(run, jnet, tnet)
    close(jb, tb)
    close(ja, ta)
    assert not np.allclose(tb, ta) and (ta > 0.1).all()
    assert jc == tc


def test_cast_of_another_block_makes_no_capture_here():
    """Each block's signature reads its own parameters: casting another
    block leaves this one's signatures (and its graphs, on the card)."""
    x = np.random.RandomState(1).rand(2, 4).astype("float32")

    def run(P, nets):
        a, b = nets
        a.hybridize()
        b.hybridize()
        warm(P, a, P.A(x))
        a(P.A(x))
        warm(P, b, P.A(x))
        before = P.counts()["hybridize.cache_misses"]
        b.cast("float16")
        out = P.N(a(P.A(x)))
        return out, P.counts()["hybridize.cache_misses"] - before

    (ja, ta), (jb, tb) = dense_twins(seed=0), dense_twins(seed=1)
    (jo, jm), (to, tm) = both(run, (ja, jb), (ta, tb))
    assert jm == tm == 0
    close(jo, to)


def test_amp_convert_after_hybridized_calls_captures_once():
    """``amp.convert_hybrid_block`` on a block already called twice
    hybridized: one new signature in both packages, the bf16 output as
    the JAX block's (the JAX amp casts the input in a pre-hook; the
    port's caller passes bf16)."""
    x = np.random.RandomState(2).rand(3, 4).astype("float32")

    def run(P, net):
        net.hybridize()
        warm(P, net, P.A(x))
        net(P.A(x))
        before = P.counts()["hybridize.cache_misses"]
        P.mx.amp.convert_hybrid_block(net, "bfloat16")
        xb = P.A(x) if P.jax else torch.from_numpy(x).to(torch.bfloat16)
        outs = [net(xb) for _ in range(2)]
        out = outs[-1] if P.jax else outs[-1].float()
        return (np.asarray(P.N(out), "f4"),
                P.counts()["hybridize.cache_misses"] - before)

    (jo, jm), (to, tm) = both(run, *dense_twins())
    assert jm == tm == 1
    close(jo, to, 2e-2)


def test_save_load_parameters_through_hybridized_net(tmp_path):
    x = np.random.RandomState(7).rand(2, 4).astype("float32")

    def run(P, nets):
        net, net2 = nets
        net.hybridize()
        want = P.N(net(P.A(x)))
        path = str(tmp_path / f"dense_{P.jax}.params")
        net.save_parameters(path)
        net2.hybridize()
        warm(P, net2, P.A(x))
        P.N(net2(P.A(x)))
        sigs = P.traced(net2)
        net2.load_parameters(path)
        got = P.N(net2(P.A(x)))
        return want, got, P.traced(net2) - sigs

    j1, t1 = dense_twins(seed=0)
    j2, t2 = dense_twins(seed=1)
    (jw, jg, jd), (tw, tg, td) = run(J, (j1, j2)), run(T, (t1, t2))
    close(jw, tw)
    close(jg, tg)
    close(tg, tw, 1e-6)
    assert jd == td == 0


def test_child_block_replacement_recomputes_param_set():
    class JOuter(jmx.gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self.body = jnn.Dense(3)

        def forward(self, x):
            return self.body(x)

    class TOuter(tmx.gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self.body = tnn.Dense(3, in_units=4, device="cpu")

        def forward(self, x):
            return self.body(x)

    jnet, tnet = twin(JOuter(), TOuter(), np.ones((1, 4), "f4"))
    jb, tb = twin(jnn.Dense(5), tnn.Dense(5, in_units=4, device="cpu"),
                  np.ones((1, 4), "f4"), seed=4)

    def run(P, net, body):
        net.hybridize()
        P.N(net(P.A(np.ones((2, 4), "f4"))))
        net.body = body
        net.hybridize()
        return P.N(net(P.A(np.ones((2, 4), "f4"))))

    jo, to = run(J, jnet, jb), run(T, tnet, tb)
    assert jo.shape == to.shape == (2, 5)
    close(jo, to)


def test_kwargs_in_hybrid_forward_raise():
    def run(P, net):
        net.hybridize()
        warm(P, net, P.A(np.ones((2, 4), "f4")))
        net(P.A(np.ones((2, 4), "f4")))
        with pytest.raises(P.Error):
            net._cached_op((P.A(np.ones((2, 4), "f4")),), {"extra": 1})
        return True

    assert both(run, *dense_twins()) == (True, True)


def test_concurrent_shapes_interleaved():
    xs = {s: np.random.RandomState(s).rand(s, 4).astype("float32")
          for s in (1, 4)}

    def run(P, net):
        net.hybridize()
        return [P.N(net(P.A(x))) for _ in range(4) for x in xs.values()], \
            P.counts()

    (jo, jc), (to, tc) = both(run, *dense_twins())
    for a, b in zip(jo, to):
        close(a, b)
    assert jc == tc


def test_telemetry_compile_and_hit_counters_tick():
    def run(P, net):
        net.hybridize()
        x = P.A(np.ones((2, 4), "f4"))
        warm(P, net, x)
        trail = []
        P.N(net(x))
        snap = P.tel.snapshot()
        trail.append((P.counts(), snap["hybridize.compile_seconds"]["count"]))
        assert snap["hybridize.compile_seconds"]["total"] > 0
        for _ in range(3):
            P.N(net(x))
        trail.append((P.counts(), None))
        P.N(net(P.A(np.ones((5, 4), "f4"))))
        trail.append((P.counts(),
                      P.tel.snapshot()["hybridize.compile_seconds"]["count"]))
        return trail

    jt, tt = both(run, *dense_twins())
    assert jt == tt
    assert tt[0][0]["hybridize.cache_misses"] == 1 and tt[0][1] == 1
    assert tt[1][0]["hybridize.cache_hits"] == 3
    assert tt[2][0]["hybridize.cache_misses"] == 2 and tt[2][1] == 2


# --------------------------------------- tests/test_jit.py (warmup, pad)
def lenet_twins(seed=0):
    return twin(jmx.gluon.model_zoo.get_model("lenet"),
                get_model("lenet", device="cpu"),
                np.zeros((2, 1, 28, 28), "f4"), seed=seed)


def test_lenet_batch_pad_matches_unpadded():
    x = np.random.RandomState(3).rand(17, 1, 28, 28).astype("f4")

    def run(P, net):
        eager = P.N(net(P.A(x)))
        net.hybridize()
        net.warmup((17, 1, 28, 28))
        ref = P.N(net(P.A(x)))
        net.hybridize(bucketer={0: [32]})
        net.warmup((32, 1, 28, 28))
        out = P.N(net(P.A(x)))
        return eager, ref, out, P.counts()

    (je, jr, jo, jc), (te, tr, to, tc) = both(run, *lenet_twins())
    assert jo.shape == to.shape == (17, 10)
    close(jo, to)
    close(to, tr, 1e-6)
    close(to, te, 1e-6)
    assert jc == tc


class _JLM(jmx.gluon.HybridBlock):
    def __init__(self):
        super().__init__()
        self.embedding = jnn.Embedding(50, 8)
        self.lstm = jrnn.LSTM(8, num_layers=1)
        self.decoder = jnn.Dense(50, flatten=False)

    def forward(self, x):
        e = self.embedding(x).transpose(1, 0, 2)
        return self.decoder(self.lstm(e)).transpose(1, 0, 2)


class _TLM(tmx.gluon.HybridBlock):
    def __init__(self):
        super().__init__()
        self.embedding = tnn.Embedding(50, 8, device="cpu")
        self.lstm = trnn.LSTM(8, num_layers=1, input_size=8, device="cpu")
        self.decoder = tnn.Dense(50, flatten=False, in_units=8,
                                 device="cpu")

    def forward(self, x):
        e = self.embedding(x).permute(1, 0, 2)
        return self.decoder(self.lstm(e)).permute(1, 0, 2)


def test_lstm_seqlen_pad_matches_unpadded():
    toks = np.random.RandomState(5).randint(0, 50, size=(4, 17)).astype("i4")

    def run(P, net):
        eager = P.N(net(P.A(toks)))
        net.hybridize()
        net.warmup(((4, 17), "int32"))
        ref = P.N(net(P.A(toks)))
        net.hybridize(bucketer={1: [32]})
        net.warmup(((4, 32), "int32"))
        out = P.N(net(P.A(toks)))
        return eager, ref, out, P.counts()

    jnet, tnet = twin(_JLM(), _TLM(), np.zeros((2, 8), "i4"), seed=1)
    (je, jr, jo, jc), (te, tr, to, tc) = both(run, jnet, tnet)
    assert jo.shape == to.shape == (4, 17, 50)
    close(jo, to)
    close(to, tr, 1e-6)
    close(to, te, 1e-6)
    assert jc == tc


def test_multi_input_ambiguous_axis_left_padded():
    class JTwoHead(jmx.gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self.a = jnn.Dense(3)
            self.b = jnn.Dense(3)

        def forward(self, x, z):
            return self.a(x), self.b(z)

    class TTwoHead(tmx.gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self.a = tnn.Dense(3, in_units=4, device="cpu")
            self.b = tnn.Dense(3, in_units=4, device="cpu")

        def forward(self, x, z):
            return self.a(x), self.b(z)

    rs = np.random.RandomState(0)
    x, z = rs.rand(7, 4).astype("f4"), rs.rand(3, 4).astype("f4")

    def run(P, net):
        ref = [P.N(o) for o in net(P.A(x), P.A(z))]
        net.hybridize(bucketer={0: [16]})
        net.warmup((P.A(x), P.A(z)))
        out = [P.N(o) for o in net(P.A(x), P.A(z))]
        out2 = [P.N(o) for o in net(P.A(x), P.A(x))]
        return ref, out, out2, P.counts()

    jnet, tnet = twin(JTwoHead(), TTwoHead(), np.ones((1, 4), "f4"),
                      np.ones((1, 4), "f4"))
    (jr, jo, jo2, jc), (tr, to, to2, tc) = both(run, jnet, tnet)
    for a, b in zip(jo + jo2, to + to2):
        assert a.shape == b.shape
        close(a, b)
    assert to[0].shape == to[1].shape == (16, 3)   # ambiguous: stays padded
    assert to2[0].shape == to2[1].shape == (7, 3)  # one size: sliced back
    close(to[0][:7], tr[0], 1e-6)
    close(to[1][:3], tr[1], 1e-6)
    assert jc == tc


def test_varlen_stream_compiles_once_per_bucket():
    class JTagger(jmx.gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self.embedding = jnn.Embedding(100, 16)
            self.dense = jnn.Dense(5, flatten=False)

        def forward(self, x):
            return self.dense(self.embedding(x))

    class TTagger(tmx.gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self.embedding = tnn.Embedding(100, 16, device="cpu")
            self.dense = tnn.Dense(5, flatten=False, in_units=16,
                                   device="cpu")

        def forward(self, x):
            return self.dense(self.embedding(x))

    def run(P, net):
        bucketer = (JBucketer if P.jax else TBucketer)(
            {1: ("pow2", 32, 64)})
        net.hybridize(bucketer=bucketer)
        n = net.warmup(((2, 17), "int32"))
        assert n == bucketer.n_buckets((2, 17)) if P.jax else n == 2
        rs = np.random.RandomState(0)
        P.tel.reset()
        outs = []
        for length in range(17, 65):
            toks = rs.randint(0, 100, size=(2, length)).astype("i4")
            outs.append(P.N(net(P.A(toks))))
            assert outs[-1].shape == (2, length, 5)
        return n, outs, P.traced(net), P.counts()

    jnet, tnet = twin(JTagger(), TTagger(), np.zeros((2, 8), "i4"), seed=2)
    (jn, jo, jt, jc), (tn, to, tt, tc) = both(run, jnet, tnet)
    assert jn == tn == 2 and jt == tt == 2
    assert tc["hybridize.cache_misses"] == 0
    assert tc["hybridize.cache_hits"] == 48
    assert jc == tc
    for a, b in zip(jo, to):
        close(a, b)


def test_warmup_then_call_zero_additional_misses():
    def run(P, net):
        net.hybridize()
        first = net.warmup((8, 1, 28, 28))
        snap = P.tel.snapshot()
        c0 = P.counts()
        timer = snap["jit.warmup_seconds"]["count"]
        out = P.N(net(P.A(np.zeros((8, 1, 28, 28), "f4"))))
        again = net.warmup((8, 1, 28, 28))
        return first, c0, timer, out, P.counts(), again

    jr, tr = both(run, *lenet_twins())
    assert jr[0] == tr[0] == 1 and jr[5] == tr[5] == 0
    assert jr[1] == tr[1] and jr[2] == tr[2] == 1
    assert tr[1]["hybridize.warmup_compiles"] == 1
    assert jr[4] == tr[4]
    assert tr[4]["hybridize.cache_misses"] == tr[1]["hybridize.cache_misses"]
    assert tr[4]["hybridize.cache_hits"] >= 1
    close(jr[3], tr[3])


def test_warmup_background_handle():
    def run(P, net):
        net.hybridize()
        h = net.warmup([(4, 1, 28, 28), (8, 1, 28, 28)], background=True)
        n = h.wait(300)
        done = h.done()
        P.tel.reset()
        out = P.N(net(P.A(np.zeros((4, 1, 28, 28), "f4"))))
        return n, done, P.counts()["hybridize.cache_misses"], out

    jr, tr = both(run, *lenet_twins())
    assert jr[:3] == tr[:3] == (2, True, 0)
    close(jr[3], tr[3])


def test_warmup_requires_hybridize():
    def run(P, net):
        with pytest.raises(P.Error):
            net.warmup((2, 1, 28, 28))
        return True

    assert both(run, *lenet_twins()) == (True, True)


def test_warmup_train_mode_compiles_training_graph():
    jnet = jnn.HybridSequential()
    jnet.add(jnn.Dense(16), jnn.Dropout(0.5))
    tnet = tnn.HybridSequential().add(tnn.Dense(16, in_units=8, device="cpu"),
                                      tnn.Dropout(0.5))
    twin(jnet, tnet, np.ones((2, 8), "f4"))

    def run(P, net):
        net.hybridize()
        net.warmup((4, 8), train_mode=True)
        P.tel.reset()
        with P.record(train_mode=True):
            out = P.N(net(P.A(np.ones((4, 8), "f4"))))
        return (out == 0).any(), P.counts()["hybridize.cache_misses"]

    assert both(run, jnet, tnet) == ((True, 0), (True, 0))


# -------------------------------- tests/test_analysis.py (retrace guard)
def retrace_case(limit=None, churn=None):
    """Run ``fn(pkg, net)`` on twin Dense(4) nets with the guard's limits
    set in both packages; returns each side's diagnostics and counters."""
    def deco(fn):
        def run():
            for P in (J, T):
                P.prev = (P.retrace.set_limit(limit) if limit else None,
                          P.retrace.set_churn_params(*churn)
                          if churn else None)
            try:
                jnet, tnet = dense_twins(4, 8)
                res = []
                for P, net in ((J, jnet), (T, tnet)):
                    fn(P, net)
                    res.append(([(d.code, d.symbol) for d in
                                 P.retrace.report()],
                                [d.message for d in P.retrace.report()],
                                P.counts(), P.traced(net)))
                return res
            finally:
                for P in (J, T):
                    if P.prev[0] is not None:
                        P.retrace.set_limit(P.prev[0])
                    if P.prev[1] is not None:
                        P.retrace.set_churn_params(*P.prev[1])
        return run
    return deco


def test_retrace_guard_flags_signature_growth_and_culprit():
    @retrace_case(limit=3)
    def case(P, net):
        net.hybridize()
        for n in (1, 2, 3, 4):
            net(P.A(np.ones((n, 8), "f4")))

    (jd, jm, jc, jt), (td, tm, tc, tt) = case()
    assert jd == td == [("J001", "Dense")]
    assert "argument leaf #0" in tm[0] and "state/param" not in tm[0]
    assert jc == tc and jt == tt


def test_retrace_guard_silent_under_limit():
    @retrace_case(limit=50)
    def case(P, net):
        net.hybridize()
        for n in (1, 2, 3):
            net(P.A(np.ones((n, 8), "f4")))

    (jd, _, jc, _), (td, _, tc, _) = case()
    assert jd == td == [] and jc == tc


def test_retrace_telemetry_counter_ticks():
    @retrace_case(limit=2)
    def case(P, net):
        net.hybridize()
        for n in (1, 2, 3):
            net(P.A(np.ones((n, 8), "f4")))

    (_, _, jc, _), (_, _, tc, _) = case()
    assert jc == tc and tc["hybridize.retrace_warnings"] == 1


def test_shape_churn_storm_repro():
    @retrace_case(limit=50, churn=(3, 2))
    def case(P, net):
        net.hybridize()
        for n in range(1, 10):
            net(P.A(np.ones((n, 8), "f4")))
        assert [d.code for d in P.retrace.report()] == ["J002"]
        net(P.A(np.ones((20, 8), "f4")))     # once per block type

    (jd, jm, jc, _), (td, tm, tc, _) = case()
    assert jd == td == [("J002", "Dense")]
    assert "argument leaf #0" in tm[0] and "bucketer" in tm[0]
    assert jc == tc and tc["hybridize.shape_churn_warnings"] == 1


@pytest.mark.parametrize("twin_kind", ["loader_bucketed", "bucketed",
                                       "stable_shapes", "warmup_exempt"])
def test_shape_churn_clean_twins(twin_kind):
    churn = {"loader_bucketed": (3, 4), "bucketed": (3, 4),
             "stable_shapes": (4, 4), "warmup_exempt": (2, 4)}[twin_kind]

    @retrace_case(churn=churn)
    def case(P, net):
        if twin_kind == "loader_bucketed":
            net.hybridize()
            for _ in range(10):
                for b in (8, 16, 32, 64):
                    net(P.A(np.ones((b, 8), "f4")))
        elif twin_kind == "bucketed":
            net.hybridize(bucketer={0: [4, 8]})
            for n in (1, 2, 3, 4, 5, 6):
                net(P.A(np.ones((n, 8), "f4")))
            assert P.traced(net) <= 2
        elif twin_kind == "stable_shapes":
            net.hybridize()
            for _ in range(10):
                for n in (2, 4, 6):
                    net(P.A(np.ones((n, 8), "f4")))
        else:
            net.hybridize()
            net.warmup([(2, 8), (3, 8), (4, 8), (5, 8)])

    (jd, _, jc, jt), (td, _, tc, tt) = case()
    assert jd == td == []
    assert jc == tc and jt == tt


def test_j_rules_in_the_ports_catalog():
    from mxnet_tpu_torch import analysis

    for code in ("J001", "J002"):
        assert code in analysis.RULES
    assert "shape-churn-storm" in analysis.rule_doc("J002")
    assert "bucket" in analysis.rule_doc("J002")
