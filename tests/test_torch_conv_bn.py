"""The PyTorch port's eval conv+BN folds (``analytics_zoo_tpu_torch.ops.
conv_bn``) against the JAX package's on the same numpy inputs.

The JAX side runs as its own CPU tests run it: the Pallas kernels in
interpret mode (the odd stride-2 extent takes its reference
expression). The port side runs its plain versions: on CPU tensors the
wrappers take them and launch nothing. The CUDA kernels are held
against the plain versions on the card in
tests/test_torch_kernels_cuda.py.

Tolerances: f32 rtol/atol 1e-4 for the 1x1 fold (one f32 product, sums
in another order) and atol 1e-3 for the 3x3 (nine taps, the bound of
tests/test_conv_bn.py); bf16 compares in f32 with rtol/atol 2e-2, as
the output is rounded once to bf16 (2^-8 relative) and the two sides
may round a value on either side of a tie.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.ops import conv_bn as jcb
from analytics_zoo_tpu_torch.ops import conv_bn as tcb
from analytics_zoo_tpu_torch.ops import cuda_build

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a, dtype="float32"):
    """The same numpy values as a JAX array and a torch tensor."""
    jdt, tdt = DTYPES[dtype]
    a = np.asarray(a, np.float32)
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _f32(y):
    if isinstance(y, torch.Tensor):
        return y.float().numpy()
    return np.asarray(y.astype(jnp.float32))


def _vectors(rs, n):
    return (rs.rand(n).astype(np.float32) + 0.5,
            (rs.randn(n) * 0.1).astype(np.float32))


# residual, relu_out, prologue: each on and off at least once
FOLDS = [(False, False, False), (True, True, False), (False, True, True),
         (True, False, True)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("residual,relu_out,prologue", FOLDS)
def test_matmul_bn_apply_matches_jax(dtype, residual, relu_out, prologue):
    rs = np.random.RandomState(0)
    m, k, n = 100, 128, 256          # ragged M: the kernel masks it
    x = rs.randn(m, k)
    w = (rs.randn(k, n) * 0.1).astype(np.float32)
    s, t = _vectors(rs, k)
    os_, ot = _vectors(rs, n)
    r = rs.randn(m, n)
    jx, tx = _pair(x, dtype)
    jr, tr = _pair(r, dtype)
    kw = dict(relu_in=prologue, relu_out=relu_out)
    jkw = dict(kw, out_scale=jnp.asarray(os_), out_shift=jnp.asarray(ot))
    tkw = dict(kw, out_scale=torch.from_numpy(os_),
               out_shift=torch.from_numpy(ot))
    if prologue:
        jkw.update(in_scale=jnp.asarray(s), in_shift=jnp.asarray(t))
        tkw.update(in_scale=torch.from_numpy(s),
                   in_shift=torch.from_numpy(t))
    before = dict(tcb.launches)
    want = jcb.matmul_bn_apply(jx, jnp.asarray(w),
                               residual=jr if residual else None, **jkw)
    got = tcb.matmul_bn_apply(tx, torch.from_numpy(w),
                              residual=tr if residual else None, **tkw)
    assert got.shape == (m, n) and got.dtype == DTYPES[dtype][1]
    tol = 1e-4 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)
    # CPU tensors run the plain version: no kernel launched
    assert tcb.launches == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("prologue", [False, True])
def test_conv3x3_bn_apply_matches_jax(dtype, stride, prologue):
    rs = np.random.RandomState(1)
    b, h, wd, cin, cout = 2, 8, 8, 64, 64
    x = rs.randn(b, h, wd, cin)
    w = (rs.randn(3, 3, cin, cout) * 0.1).astype(np.float32)
    s, t = _vectors(rs, cin)
    os_, ot = _vectors(rs, cout)
    jx, tx = _pair(x, dtype)
    jkw = dict(out_scale=jnp.asarray(os_), out_shift=jnp.asarray(ot),
               relu_out=True, stride=stride, relu_in=prologue)
    tkw = dict(out_scale=torch.from_numpy(os_),
               out_shift=torch.from_numpy(ot), relu_out=True,
               stride=stride, relu_in=prologue)
    if prologue:
        jkw.update(in_scale=jnp.asarray(s), in_shift=jnp.asarray(t))
        tkw.update(in_scale=torch.from_numpy(s),
                   in_shift=torch.from_numpy(t))
    want = jcb.conv3x3_bn_apply(jx, jnp.asarray(w), **jkw)
    got = tcb.conv3x3_bn_apply(tx, torch.from_numpy(w), **tkw)
    assert tuple(got.shape) == (b, h // stride, wd // stride, cout)
    tol = dict(rtol=1e-4, atol=1e-3) if dtype == "float32" else \
        dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)


def test_conv3x3_bn_apply_odd_stride2_extent():
    # 7x7 at stride 2: TF SAME pads (1, 1) to a 4x4 map; the TPU takes
    # its reference expression here, the CUDA kernel takes any extent
    rs = np.random.RandomState(2)
    x = rs.randn(2, 7, 7, 64)
    w = (rs.randn(3, 3, 64, 128) * 0.1).astype(np.float32)
    s, t = _vectors(rs, 64)
    os_, ot = _vectors(rs, 128)
    jx, tx = _pair(x)
    want = jcb.conv3x3_bn_apply(
        jx, jnp.asarray(w), in_scale=jnp.asarray(s),
        in_shift=jnp.asarray(t), relu_in=True, out_scale=jnp.asarray(os_),
        out_shift=jnp.asarray(ot), relu_out=True, stride=2)
    got = tcb.conv3x3_bn_apply(
        tx, torch.from_numpy(w), in_scale=torch.from_numpy(s),
        in_shift=torch.from_numpy(t), relu_in=True,
        out_scale=torch.from_numpy(os_), out_shift=torch.from_numpy(ot),
        relu_out=True, stride=2)
    assert tuple(got.shape) == (2, 4, 4, 128)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("stride", [1, 2])
def test_conv1x1_bn_apply_strided_matches_jax(stride):
    # the strided shortcut reads every other pixel (x[:, ::2, ::2])
    rs = np.random.RandomState(3)
    x = rs.randn(2, 8, 8, 64)
    w = (rs.randn(1, 1, 64, 256) * 0.1).astype(np.float32)
    os_, ot = _vectors(rs, 256)
    r = rs.randn(2, 8 // stride, 8 // stride, 256)
    jx, tx = _pair(x)
    jr, tr = _pair(r)
    want = jcb.conv1x1_bn_apply(jx, jnp.asarray(w), stride=stride,
                                residual=jr, out_scale=jnp.asarray(os_),
                                out_shift=jnp.asarray(ot), relu_out=True)
    got = tcb.conv1x1_bn_apply(tx, torch.from_numpy(w), stride=stride,
                               residual=tr, out_scale=torch.from_numpy(os_),
                               out_shift=torch.from_numpy(ot),
                               relu_out=True)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-4, atol=1e-4)


def test_fold_dtype_rules_pinned():
    # bf16 activations with the f32 weights the model keeps: the 1x1
    # fold multiplies in f32 (x cast to w.dtype), the 3x3 fold in bf16
    # (w cast to x.dtype); both accumulate in f32 and return bf16
    rs = np.random.RandomState(4)
    x = torch.from_numpy(rs.randn(2, 4, 4, 64).astype(np.float32)).to(
        torch.bfloat16)
    w1 = torch.from_numpy((rs.randn(64, 64) * 0.1).astype(np.float32))
    w3 = torch.from_numpy((rs.randn(3, 3, 64, 64) * 0.1).astype(
        np.float32))
    y1 = tcb.conv1x1_bn_apply(x, w1)
    assert y1.dtype == torch.bfloat16
    f32_product = torch.matmul(x.float().reshape(-1, 64), w1)
    assert torch.equal(y1.reshape(-1, 64), f32_product.to(torch.bfloat16))
    y3 = tcb.conv3x3_bn_apply(x, w3)
    assert y3.dtype == torch.bfloat16
    bf16_weights = tcb.conv3x3_bn_apply(x.float(),
                                        w3.to(torch.bfloat16).float())
    assert torch.equal(y3, bf16_weights.to(torch.bfloat16))
    # and the JAX package follows the same rules
    want1 = jcb.conv1x1_bn_apply(jnp.asarray(x.float().numpy(),
                                             jnp.bfloat16),
                                 jnp.asarray(w1.numpy()))
    np.testing.assert_allclose(_f32(y1), _f32(want1), rtol=2e-2, atol=2e-2)


def test_tf_same_pads():
    assert tcb.tf_same_pads(224, 7, 2) == (2, 3, 112)   # stem
    assert tcb.tf_same_pads(112, 3, 2) == (0, 1, 56)    # max pool
    assert tcb.tf_same_pads(56, 3, 2) == (0, 1, 28)     # 3x3/s2
    assert tcb.tf_same_pads(56, 3, 1) == (1, 1, 56)
    assert tcb.tf_same_pads(7, 3, 2) == (1, 1, 4)
    assert tcb.tf_same_pads(56, 1, 2) == (0, 0, 28)


def test_wrappers_validate_like_jax():
    x = torch.zeros(10, 96)
    with pytest.raises(ValueError, match="64-multiples"):
        tcb.matmul_bn_apply(x, torch.zeros(96, 64))
    with pytest.raises(ValueError, match="64-multiples"):
        jcb.matmul_bn_apply(jnp.zeros((10, 96)), jnp.zeros((96, 64)))
    with pytest.raises(ValueError, match="stride"):
        tcb.conv3x3_bn_apply(torch.zeros(1, 4, 4, 64),
                             torch.zeros(3, 3, 64, 64), stride=3)
    with pytest.raises(ValueError, match="3x3"):
        tcb.conv3x3_bn_apply(torch.zeros(1, 4, 4, 64),
                             torch.zeros(5, 5, 64, 64))
    with pytest.raises(ValueError, match="64-multiples"):
        tcb.conv3x3_bn_apply(torch.zeros(1, 4, 4, 32),
                             torch.zeros(3, 3, 32, 64))
    with pytest.raises(TypeError, match="unexpected keyword"):
        tcb.conv1x1_bn_apply(torch.zeros(1, 4, 4, 64),
                             torch.zeros(64, 64), out_scal=None)


def test_no_kernel_for_other_devices():
    # neither CPU nor CUDA: no plain fallback, no kernel — raise
    x = torch.empty(64, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        tcb.matmul_bn_apply(x, torch.empty(64, 64, device="meta"))


def test_modules_import_without_nvcc_and_build_lazily(monkeypatch):
    # without a card, nothing loaded a kernel library; the build
    # itself needs nvcc and says so where it is missing
    if not torch.cuda.is_available():
        assert cuda_build._libs == {} and tcb._fns == {}
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(cuda_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(cuda_build.os.path, "isfile", lambda _: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.nvcc_path()
    # the library name hashes its sources: stable across calls
    p = cuda_build.library_path("matmul_bn_apply")
    assert p == cuda_build.library_path("matmul_bn_apply")
    assert p != cuda_build.library_path("conv3x3_bn_apply")


def _resnet50_3x3_shapes():
    """(H, W, Cin, Cout, stride) of every 3x3 of a ResNet-50 forward, from
    the port's fused model (each bottleneck's c2)."""
    from analytics_zoo_tpu_torch.models.image.imageclassification import (
        FusedBottleneck, ImageClassifier)
    net = ImageClassifier("resnet-50", input_shape=(224, 224, 3),
                          classes=1000, fused=True).model
    net.init(torch.Generator().manual_seed(0))
    shapes = [lyr.input_shape[:2] + (lyr.filters, lyr.filters, lyr.stride)
              for lyr in net.layers if isinstance(lyr, FusedBottleneck)]
    assert len(shapes) == 16
    return sorted(set(shapes))


@pytest.mark.parametrize("batch", [1, 8, 32])
def test_b6_kernel_and_tile_are_legal_at_serving_shapes(monkeypatch, batch):
    # B6's bf16 kernel and tile at every ResNet-50 3x3 of a serving
    # forward: the window kernel only at stride 1 and where its shared
    # memory fits, 128 or 64 columns; the generic one 256, 128 or 64;
    # the width divides Cout; and the wrapper hands the C entry point
    # that choice
    launched, chosen = [], {}
    monkeypatch.setattr(tcb, "_device_kind", lambda name, x: "cuda")
    monkeypatch.setattr(tcb, "_check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(tcb, "_launch",
                        lambda name, dev, *args: launched.append(args))
    for h, w, cin, cout, stride in _resnet50_3x3_shapes():
        window, bn = tcb.conv3x3_apply_tile(batch, h, w, cin, cout, stride)
        assert cout % bn == 0
        if window:
            assert stride == 1 and bn in (64, 128)
            assert tcb._window_smem(bn, cin, w) <= tcb._SMEM_PER_BLOCK
        else:
            assert bn in (64, 128, 256)
        launched.clear()
        tcb.conv3x3_bn_apply(
            torch.empty(batch, h, w, cin, dtype=torch.bfloat16),
            torch.empty(3, 3, cin, cout), stride=stride)
        assert launched[0][-2:] == (int(window), bn)
        chosen[(h, w, cin, cout, stride)] = (window, bn)
    # wide tiles only where their blocks nearly fill the 132 SMs: at
    # batch 32 the 28x28 stride-1 (98 window blocks) and both early
    # stride-2 shapes (196 and 98 generic blocks)
    wide = {k for k, (_, bn) in chosen.items() if bn == 128}
    assert wide == ({(28, 28, 128, 128, 1), (56, 56, 128, 128, 2),
                     (28, 28, 256, 256, 2)} if batch == 32 else set())


@pytest.mark.parametrize("x_dtype,w_dtype,prologue,route", [
    (torch.float32, torch.float32, False, "tf32x3"),
    (torch.float32, torch.float32, True, "tf32x3"),
    (torch.bfloat16, torch.float32, False, "tf32x2"),
    (torch.bfloat16, torch.float32, True, "tf32x3"),
    (torch.float32, torch.bfloat16, False, "tf32x1"),
    (torch.float32, torch.bfloat16, True, "tf32x1"),
    (torch.bfloat16, torch.bfloat16, False, "bf16"),
    (torch.bfloat16, torch.bfloat16, True, "bf16")])
def test_b5_route_follows_the_weights_type(monkeypatch, x_dtype, w_dtype,
                                           prologue, route):
    # B5 multiplies in the weights' type: f32 weights take the
    # f32-accurate tf32 split in three passes, or two where a bf16 x
    # without a prologue is exact in tf32; bf16 weights take B1's kernel
    # with the fold epilogue for a bf16 x, and the tf32 kernel in one
    # pass for an f32 x (rounded to bf16 after the prologue, exact in
    # tf32, as is W). The wrapper hands the C entry point x's
    # type and that route, and the weights as they are
    assert tcb.fold_route(x_dtype, w_dtype, prologue) == route
    launched = []
    monkeypatch.setattr(tcb, "_device_kind", lambda name, x: "cuda")
    monkeypatch.setattr(tcb, "_check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(tcb, "_launch",
                        lambda name, dev, *args: launched.append(args))
    w = torch.zeros(64, 128, dtype=w_dtype)
    vec = torch.ones(64) if prologue else None
    tcb.conv1x1_bn_apply(torch.zeros(2, 4, 4, 64, dtype=x_dtype), w,
                         in_scale=vec, relu_in=prologue)
    assert launched[0][1] == w.data_ptr()
    assert launched[0][-2:] == (int(x_dtype == torch.bfloat16),
                                tcb.FOLD_ROUTES.index(route))
