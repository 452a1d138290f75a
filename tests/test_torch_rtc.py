"""The port's ``rtc`` and ``library`` and the extension kernels' plain
versions, against the JAX package, on the CPU.

The kernels: the plain versions of ``kernels/ext_ops.py`` against the
Pallas kernels of ``example/extensions/pallas_ops.py`` (imported by
path) in interpret mode, on the same numpy inputs from a seed.  Bar:
equal bits, except f32 ``axpb``, where the plain version rounds a
float64 result once and may sit 1 ulp from the fused multiply-add.

The ops: ``example/extensions/torch_ops.py`` loaded through
``library.load`` and called through ``autograd.record()`` /
``backward``, the assertions of ``tests/test_extensions.py``'s rtc test
held against the JAX package's results on the same inputs (forward and
gradients equal: the same elementwise arithmetic on both sides).

Registries are global: each test that registers a name removes what it
added (``_forget``; ``jax_pallas_ops`` for the JAX package's), so no
test depends on the order the files run in.
"""
from __future__ import annotations

import contextlib
import importlib.util
import os
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import library as jlibrary
from mxnet_tpu import rtc as jrtc
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd, library, rtc
from mxnet_tpu_torch import numpy_extension as tnpx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.kernels import ext_ops, registry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PALLAS_OPS = os.path.join(REPO, "example", "extensions", "pallas_ops.py")
TORCH_OPS = os.path.join(REPO, "example", "extensions", "torch_ops.py")
MNIST_AB = (1 / 0.3081, -0.1307 / 0.3081)
EXT = ("pallas_squared_relu", "pallas_axpb")


def _pallas_ops():
    spec = importlib.util.spec_from_file_location("pallas_ops_by_path",
                                                  PALLAS_OPS)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


PO = _pallas_ops()


@contextlib.contextmanager
def jax_pallas_ops():
    """``mx.npx.pallas_squared_relu`` / ``pallas_axpb`` of the JAX
    example for the block: loaded when absent and removed again after,
    so that ``tests/test_extensions.py``, which loads them itself, can
    run later in the same process."""
    names = ("pallas_squared_relu", "pallas_axpb")
    added = not hasattr(mx.npx, names[0])
    if added:
        mx.library.load(PALLAS_OPS)
    try:
        yield
    finally:
        if added:
            for name in names:
                jrtc._KERNELS.pop(name, None)
                jlibrary._LOADED.pop(name, None)
                if hasattr(mx.npx, name):
                    delattr(mx.npx, name)


def _forget(*names):
    """Remove ``names`` from the port's registries and ``npx``."""
    for name in names:
        rtc._KERNELS.pop(name, None)
        library._LOADED.pop(name, None)
        if name in vars(tnpx):
            delattr(tnpx, name)


@pytest.fixture()
def ext():
    """``torch_ops.py`` loaded afresh; removed again afterwards."""
    _forget(*EXT)
    ops = library.load(TORCH_OPS)
    yield ops
    _forget(*EXT)


# ------------------------------------------------------------ kernels
SHAPES = [(3,), (7, 13), (2, 3, 5, 7), ()]
DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16),
          (torch.float16, jnp.float16)]


def _pair(shape, seed, tdt, jdt):
    x = np.asarray(np.random.RandomState(seed).randn(*shape), np.float32)
    return torch.from_numpy(x.copy()).to(tdt), jnp.asarray(x).astype(jdt)


def _bits(t):
    return t.float().numpy().view(np.uint32)


def _jbits(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32)).view(np.uint32)


@pytest.mark.parametrize("tdt,jdt", DTYPES, ids=lambda d: str(d))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_squared_relu_plain_matches_pallas_bits(shape, tdt, jdt):
    tx, jx = _pair(shape, 1, tdt, jdt)
    tg, jg = _pair(shape, 2, tdt, jdt)
    y = ext_ops.sqrelu(tx)
    assert y.shape == tx.shape and y.dtype == tdt
    np.testing.assert_array_equal(_bits(y), _jbits(PO._sqrelu(jx)))
    dx = ext_ops.sqrelu_grad(tg, tx)
    np.testing.assert_array_equal(_bits(dx), _jbits(PO._sqrelu_grad(jg, jx)))


@pytest.mark.parametrize("ab", [MNIST_AB, (3.0, 1.0)], ids=["mnist", "3x+1"])
@pytest.mark.parametrize("tdt,jdt", DTYPES, ids=lambda d: str(d))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_axpb_plain_matches_pallas(shape, tdt, jdt, ab):
    tx, jx = _pair(shape, 3, tdt, jdt)
    got = ext_ops.axpb(tx, *ab)
    want = PO._axpb(jx, a=ab[0], b=ab[1])
    assert got.shape == tx.shape and got.dtype == tdt
    if tdt != torch.float32:
        np.testing.assert_array_equal(_bits(got), _jbits(want))
        return
    g, w = got.numpy(), np.asarray(want)
    assert (np.abs(g - w) <= np.spacing(np.maximum(np.abs(g), np.abs(w)))
            ).all()                             # within 1 ulp


def test_kernel_wrappers_on_the_cpu_launch_nothing_and_check_inputs():
    registry.reset_launches()
    x = torch.randn(4, 5)
    ext_ops.sqrelu(x.t())                       # any strides on the CPU
    ext_ops.axpb(torch.zeros(0))
    assert not any(registry.launches().values())
    with pytest.raises(MXNetError, match="dtype"):
        ext_ops.sqrelu(torch.zeros(3, dtype=torch.float64))
    with pytest.raises(MXNetError, match="differ"):
        ext_ops.sqrelu_grad(torch.zeros(3), torch.zeros(4))
    with pytest.raises(MXNetError, match="no kernel"):
        ext_ops.axpb(torch.zeros(3, device="meta"))


def test_extension_kernels_are_registered_with_their_pallas_bodies():
    for name, body in (("ext_sqrelu_fwd", ":37 _sqrelu_fwd_kernel"),
                       ("ext_sqrelu_bwd", ":43 _sqrelu_bwd_kernel"),
                       ("ext_axpb", ":64 _axpb_kernel")):
        source, replaces = registry.KERNELS[name]
        assert source == "ext_ops.cu"
        assert replaces == "example/extensions/pallas_ops.py" + body


# ---------------------------------------------------------------- rtc
def test_rtc_ops_match_the_jax_ops_with_gradients(ext):
    """``tests/test_extensions.py``'s rtc test on the port, each value
    held against the JAX package's on the same input."""
    with jax_pallas_ops():
        _rtc_ops_match_the_jax_ops(ext)


def _rtc_ops_match_the_jax_ops(ext):
    assert set(ext) == set(EXT) and hasattr(tmx.npx, "pallas_squared_relu")
    x = np.array([-2.0, 0.5, 3.0], "f4")
    got = tmx.npx.pallas_squared_relu(torch.from_numpy(x))
    np.testing.assert_array_equal(
        got.numpy(), mx.npx.pallas_squared_relu(mx.nd.array(x)).asnumpy())
    np.testing.assert_allclose(got.numpy(), np.maximum(x, 0) ** 2, atol=1e-6)

    # hand-written backward through the tape
    tx = torch.from_numpy(x.copy()).requires_grad_()
    with autograd.record():
        loss = tmx.npx.pallas_squared_relu(tx).sum()
    loss.backward()
    jx = mx.nd.array(x)
    jx.attach_grad()
    with mx.autograd.record():
        jloss = mx.nd.sum(mx.npx.pallas_squared_relu(jx))
    jloss.backward()
    np.testing.assert_array_equal(tx.grad.numpy(), jx.grad.asnumpy())
    np.testing.assert_allclose(tx.grad.numpy(), 2 * np.maximum(x, 0),
                               atol=1e-6)

    # kernel forward, grad = g * a
    z = torch.from_numpy(x.copy()).requires_grad_()
    with autograd.record():
        loss = tmx.npx.pallas_axpb(z, a=3.0, b=1.0).sum()
    loss.backward()
    jz = mx.nd.array(x)
    jz.attach_grad()
    with mx.autograd.record():
        jloss = mx.nd.sum(mx.npx.pallas_axpb(jz, a=3.0, b=1.0))
    jloss.backward()
    total = float(loss.detach())
    np.testing.assert_allclose(total, float(jloss.asnumpy()), rtol=1e-6)
    np.testing.assert_allclose(total, (3 * x + 1).sum(), atol=1e-5)
    np.testing.assert_array_equal(z.grad.numpy(), jz.grad.asnumpy())
    np.testing.assert_allclose(z.grad.numpy(), np.full(3, 3.0), atol=1e-6)

    # inside a hybridized block
    class Net(tmx.gluon.HybridBlock):
        def forward(self, v):
            return tmx.npx.pallas_squared_relu(v)

    net = Net()
    net.hybridize()
    np.testing.assert_allclose(net(torch.from_numpy(x)).numpy(),
                               np.maximum(x, 0) ** 2, atol=1e-6)

    # a taken name is refused; NVRTC entry points refuse clearly
    with pytest.raises(MXNetError, match="already registered"):
        rtc.register("pallas_axpb", lambda v: v)
    with pytest.raises(MXNetError, match="rtc.register"):
        rtc.CudaModule("__global__ void k() {}")
    with pytest.raises(MXNetError):
        rtc.CudaKernel()


def test_rtc_op_writes_its_result_into_out(ext):
    """``out=``: the op computes its one result, copies it into ``out``
    and returns ``out``, as the JAX op writes into its ``out``; a
    multi-output op refuses ``out``."""
    x = np.array([-2.0, 0.5, 3.0, 7.25], "f4")
    with jax_pallas_ops():
        jy = mx.nd.array(np.zeros(4, "f4"))
        jr = mx.npx.pallas_axpb(mx.nd.array(x), a=3.0, b=1.0, out=jy)
    ty = torch.zeros(4)
    tr = tmx.npx.pallas_axpb(torch.from_numpy(x), a=3.0, b=1.0, out=ty)
    assert tr is ty and jr is jy
    np.testing.assert_array_equal(ty.numpy(), jy.asnumpy())
    np.testing.assert_allclose(ty.numpy(), 3 * x + 1, atol=1e-6)
    sq = torch.zeros(4)
    assert tmx.npx.pallas_squared_relu(torch.from_numpy(x), out=sq) is sq
    np.testing.assert_allclose(sq.numpy(), np.maximum(x, 0) ** 2, atol=1e-6)
    _forget("_two_out")
    try:
        two = rtc.register("_two_out", lambda v: (v, v + 1),
                           attach_npx=False)
        with pytest.raises(MXNetError, match="single-output"):
            two(torch.from_numpy(x), out=torch.zeros(4))
    finally:
        _forget("_two_out")


def test_failed_npx_attach_leaves_no_registry_entry():
    assert hasattr(tnpx, "convolution")
    with pytest.raises(MXNetError, match="already exists in npx"):
        rtc.register("convolution", lambda v: v)
    assert "convolution" not in rtc.kernels()
    try:
        op = rtc.register("convolution", lambda v: v * 2, attach_npx=False)
        assert rtc.kernels()["convolution"] is op
        assert tnpx.convolution is not op
        assert float(op(torch.ones(()))) == 2.0
    finally:
        rtc._KERNELS.pop("convolution", None)


def test_kernel_op_without_grad_raises_on_backward():
    """A ``fn`` that leaves no graph (a kernel; here numpy) registered
    without ``grad=``: recording works, the backward raises naming
    ``grad=``.  A plain-torch ``fn`` stays differentiable."""
    name, plain = "test_rtc_host_relu", "test_rtc_torch_cube"
    try:
        op = rtc.register(name, lambda v: torch.from_numpy(
            np.maximum(v.detach().numpy(), 0)))
        cube = rtc.register(plain, lambda v, k=3: v ** k)
        assert getattr(tnpx, name) is op
        x = torch.tensor([-1.0, 2.0], requires_grad=True)
        with autograd.record():
            y = op(x)
        np.testing.assert_array_equal(y.detach().numpy(), [0.0, 2.0])
        with pytest.raises(MXNetError, match="grad="):
            y.sum().backward()
        with autograd.record():
            c = cube(x, k=3)
        autograd.backward(c)
        np.testing.assert_allclose(x.grad.numpy(), [3.0, 12.0])
        with autograd.pause():                  # no graph: nothing to guard
            assert op(x).grad_fn is None
    finally:
        _forget(name, plain)


def test_grad_may_return_one_tensor_per_input_and_config_reaches_it():
    name = "test_rtc_mul"
    seen = {}

    def grad(g, a, b, scale=1.0):
        seen["scale"] = scale
        return g * b * scale, g * a * scale

    try:
        op = rtc.register(name, lambda a, b, scale=1.0: a * b * scale,
                          grad=grad, attach_npx=False)
        a = torch.tensor([1.0, 2.0], requires_grad=True)
        b = torch.tensor([3.0, 4.0], requires_grad=True)
        with autograd.record():
            y = op(a, b, scale=2.0)
        autograd.backward(y)
        assert seen["scale"] == 2.0
        np.testing.assert_allclose(a.grad.numpy(), [6.0, 8.0])
        np.testing.assert_allclose(b.grad.numpy(), [2.0, 4.0])
    finally:
        _forget(name)


# ------------------------------------------------------------ library
@pytest.fixture(scope="module")
def native_ext(tmp_path_factory):
    src = os.path.join(REPO, "example", "extensions", "custom_ops.c")
    so = str(tmp_path_factory.mktemp("text") / "libcustom_ops_torch.so")
    try:
        res = subprocess.run(["gcc", "-shared", "-fPIC", "-O2", "-o", so, src,
                              "-lm"], capture_output=True, text=True)
    except FileNotFoundError as e:
        pytest.skip(f"no C toolchain: {e}")
    if res.returncode != 0:
        pytest.skip(f"no C toolchain: {res.stderr}")
    return so


def test_load_native_extension(native_ext):
    names = ("ext_gelu_fast", "ext_softsign")
    _forget(*names)
    try:
        ops = library.load(native_ext)
        assert set(ops) == set(names)
        assert set(names) <= set(library.loaded_ops())
        v = np.linspace(-3, 3, 7).astype("f4")
        out = tnpx.ext_softsign(torch.from_numpy(v))
        np.testing.assert_allclose(out.numpy(), v / (1 + np.abs(v)),
                                   atol=1e-6)
        assert out.dtype == torch.float32
        g = tnpx.ext_gelu_fast(torch.from_numpy(v).double())
        assert g.dtype == torch.float32        # the C interface is f32
        want = 0.5 * v * (1 + np.tanh(0.7978845608 * (v + 0.044715 * v ** 3)))
        np.testing.assert_allclose(g.numpy(), want, atol=1e-5)
        x = torch.from_numpy(v.copy()).requires_grad_()
        with autograd.record():
            y = tnpx.ext_softsign(x)
        with pytest.raises(MXNetError, match="no gradient"):
            y.sum().backward()
    finally:
        _forget(*names)


def test_load_python_extension(tmp_path):
    p = str(tmp_path / "pyext.py")
    with open(p, "w") as f:
        f.write("def register_ops(mx):\n"
                "    def double(x):\n"
                "        return x * 2\n"
                "    return {'ext_double_torch': double}\n")
    try:
        ops = library.load(p)
        assert "ext_double_torch" in ops
        assert float(tnpx.ext_double_torch(torch.tensor([3.0]))[0]) == 6.0
        with pytest.raises(MXNetError, match="already exists"):
            library.load(p)
    finally:
        _forget("ext_double_torch")


def test_load_errors(tmp_path):
    with pytest.raises(MXNetError, match="not found"):
        library.load("/nope/missing.so")
    p = str(tmp_path / "bad.py")
    with open(p, "w") as f:
        f.write("x = 1\n")
    with pytest.raises(MXNetError, match="register_ops"):
        library.load(p)
    q = str(tmp_path / "ext.txt")
    with open(q, "w") as f:
        f.write("")
    with pytest.raises(MXNetError, match="unsupported"):
        library.load(q)
