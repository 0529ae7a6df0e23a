"""The PyTorch port's training conv+BN ops (``analytics_zoo_tpu_torch.ops.
conv_bn``: ``matmul_bn``, ``conv1x1_bn``, ``conv3x3_bn``) against the
JAX package's, outputs and gradients, on the same numpy inputs.

The JAX side runs as its own CPU tests run it: the Pallas kernels in
interpret mode, the 1x1's backward pinned to the Pallas kernels
(``ZOO_TPU_CONV_BN_PALLAS_BWD=1``). The port side runs the plain
versions of its CUDA kernels (CPU tensors launch nothing); the kernels
are held against those on the card in tests/test_torch_kernels_cuda.py.

The loss is linear in the three outputs, ``sum(y cy) + sum(sum cs) +
sum(sumsq cq)``, so the cotangents (dy, dsum, dsq) are the random
coefficients and every term of the augmented cotangent matters.

Tolerances, as a fraction of max(1, max|ref|): f32 1e-4 (the same
products and sums in another order); bf16 2e-2 (one bf16 rounding of
an output, of g or of dW: 2^-8 relative, and the two sides may round a
value on either side of a tie). The 3x3's bf16 weight grad carries one
rounding more on the port (PyTorch's conv backward returns bf16 where
XLA returned f32), inside the same bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.ops import conv_bn as jcb
from analytics_zoo_tpu_torch.ops import conv_bn as tcb

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.fixture(autouse=True)
def _pallas_backward(monkeypatch):
    monkeypatch.setenv("ZOO_TPU_CONV_BN_PALLAS_BWD", "1")


def _close(got, want, dtype, what):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = TOL[dtype] * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=tol,
                               err_msg=what)


def _run_both(jfn, tfn, arrays, dtype, coef):
    """``jfn``/``tfn`` map the named inputs to (y, sum, sumsq); returns
    both sides' outputs and grads of the linear loss w.r.t. every
    input. Activations go in as ``dtype``, vectors and weights as f32."""
    jdt, tdt = DTYPES[dtype]
    act = {"x", "r"}
    names = list(arrays)
    jargs = [jnp.asarray(arrays[k], jdt if k in act else jnp.float32)
             for k in names]
    targs = [torch.from_numpy(arrays[k]).to(tdt if k in act else
                                             torch.float32)
             .requires_grad_(True) for k in names]
    cy, cs, cq = coef

    def jloss(*a):
        y, s, q = jfn(**dict(zip(names, a)))
        return (jnp.sum(y.astype(jnp.float32) * cy) + jnp.sum(s * cs) +
                jnp.sum(q * cq)), (y, s, q)

    (_, jout), jgrads = jax.value_and_grad(
        jloss, argnums=tuple(range(len(names))), has_aux=True)(*jargs)
    tout = tfn(**dict(zip(names, targs)))
    tloss = (torch.sum(tout[0].float() * torch.from_numpy(cy)) +
             torch.sum(tout[1] * torch.from_numpy(cs)) +
             torch.sum(tout[2] * torch.from_numpy(cq)))
    tgrads = torch.autograd.grad(tloss, targs)
    return names, jout, tout, jgrads, tgrads


def _coef(rs, y_shape, n):
    return (rs.randn(*y_shape).astype(np.float32),
            (rs.randn(n) * 0.1).astype(np.float32),
            (rs.randn(n) * 0.01).astype(np.float32))


MATMUL_CASES = [
    # dtype, affine, relu, residual, m (ragged M: the kernel masks it)
    ("float32", True, True, False, 100),
    ("float32", False, False, False, 128),
    ("float32", True, False, True, 100),
    ("float32", True, True, True, 200),
    ("bfloat16", True, True, False, 100),
    ("bfloat16", True, True, True, 100),
    ("bfloat16", False, False, False, 64),
]


@pytest.mark.parametrize("dtype,affine,relu,residual,m", MATMUL_CASES)
def test_matmul_bn_matches_jax(dtype, affine, relu, residual, m):
    rs = np.random.RandomState(0)
    k, n = 128, 64
    arrays = {"x": rs.randn(m, k).astype(np.float32),
              "w": (rs.randn(k, n) * 0.1).astype(np.float32)}
    if affine:
        arrays["s"] = (rs.rand(k) + 0.5).astype(np.float32)
        arrays["t"] = (rs.randn(k) * 0.1).astype(np.float32)
    if residual:
        arrays["r"] = rs.randn(m, k).astype(np.float32)
    sh = (rs.randn(n) * 0.1).astype(np.float32)

    def call(lib, sh_, x, w, s=None, t=None, r=None):
        return lib.matmul_bn(x, w, in_scale=s, in_shift=t, relu_in=relu,
                             stat_shift=sh_, in_residual=r)

    before = dict(tcb.launches)
    names, jout, tout, jg, tg = _run_both(
        lambda **a: call(jcb, jnp.asarray(sh), **a),
        lambda **a: call(tcb, torch.from_numpy(sh), **a), arrays, dtype,
        _coef(rs, (m, n), n))
    assert tout[0].dtype == DTYPES[dtype][1]
    for what, a, b in zip(("y", "sum", "sumsq"), tout, jout):
        _close(a, b, dtype, what)
    for name, a, b in zip(names, tg, jg):
        _close(a, b, dtype, "d" + name)
    # CPU tensors run the plain versions: no kernel launched
    assert tcb.launches == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv1x1_bn_strided_matches_jax(dtype):
    # the strided shortcut: every other pixel forward, a scatter into
    # zeros backward
    rs = np.random.RandomState(1)
    arrays = {"x": rs.randn(2, 7, 7, 64).astype(np.float32),
              "w": (rs.randn(1, 1, 64, 128) * 0.1).astype(np.float32)}
    sh = (rs.randn(128) * 0.1).astype(np.float32)
    names, jout, tout, jg, tg = _run_both(
        lambda x, w: jcb.conv1x1_bn(x, w, stride=2,
                                    stat_shift=jnp.asarray(sh)),
        lambda x, w: tcb.conv1x1_bn(x, w, stride=2,
                                    stat_shift=torch.from_numpy(sh)),
        arrays, dtype, _coef(rs, (2, 4, 4, 128), 128))
    assert tuple(tout[0].shape) == (2, 4, 4, 128)
    for what, a, b in zip(("y", "sum", "sumsq"), tout, jout):
        _close(a, b, dtype, what)
    for name, a, b in zip(names, tg, jg):
        _close(a, b, dtype, "d" + name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stride", [1, 2])
def test_conv3x3_bn_matches_jax(dtype, stride):
    rs = np.random.RandomState(2)
    cin, cout = 64, 64
    arrays = {"x": rs.randn(2, 8, 8, cin).astype(np.float32),
              "w": (rs.randn(3, 3, cin, cout) * 0.05).astype(np.float32),
              "s": (rs.rand(cin) + 0.5).astype(np.float32),
              "t": (rs.randn(cin) * 0.1).astype(np.float32)}
    sh = (rs.randn(cout) * 0.1).astype(np.float32)
    ho = 8 // stride
    names, jout, tout, jg, tg = _run_both(
        lambda x, w, s, t: jcb.conv3x3_bn(
            x, w, in_scale=s, in_shift=t, relu_in=True,
            stat_shift=jnp.asarray(sh), stride=stride),
        lambda x, w, s, t: tcb.conv3x3_bn(
            x, w, in_scale=s, in_shift=t, relu_in=True,
            stat_shift=torch.from_numpy(sh), stride=stride),
        arrays, dtype, _coef(rs, (2, ho, ho, cout), cout))
    for what, a, b in zip(("y", "sum", "sumsq"), tout, jout):
        _close(a, b, dtype, what)
    for name, a, b in zip(names, tg, jg):
        _close(a, b, dtype, "d" + name)


def test_bf16_dw_rounding_pinned():
    # the 1x1 casts W to the activation's type before its custom VJP, so
    # with bf16 activations dW comes back rounded to bf16 and the cast's
    # backward lifts it to the f32 master weight: every entry of the f32
    # weight grad is a bf16 value, on the port as in the JAX package
    rs = np.random.RandomState(3)
    x = rs.randn(96, 64).astype(np.float32)
    w = (rs.randn(64, 128) * 0.1).astype(np.float32)
    cy = rs.randn(96, 128).astype(np.float32)
    tw = torch.from_numpy(w).requires_grad_(True)
    y, _, _ = tcb.matmul_bn(torch.from_numpy(x).bfloat16(), tw)
    (dw,) = torch.autograd.grad(torch.sum(y.float() * torch.from_numpy(cy)),
                                [tw])
    assert dw.dtype == torch.float32
    assert torch.equal(dw, dw.bfloat16().float())
    # and it is the plain version's bf16-product dW, rounded once
    xb = torch.from_numpy(x).bfloat16()
    want = torch.matmul(xb.float().t(), torch.from_numpy(cy).bfloat16()
                        .float()).bfloat16().float()
    assert torch.equal(dw, want)
    jdw = jax.grad(lambda w_: jnp.sum(jcb.matmul_bn(
        jnp.asarray(x, jnp.bfloat16), w_)[0].astype(jnp.float32) * cy))(
            jnp.asarray(w))
    jdw = np.asarray(jdw)
    assert np.array_equal(jdw, np.asarray(jnp.asarray(jdw, jnp.bfloat16),
                                          np.float32))
    _close(dw, jdw, "bfloat16", "dW")


def test_training_wrappers_validate_like_jax():
    with pytest.raises(ValueError, match="64-multiples"):
        tcb.matmul_bn(torch.zeros(10, 96), torch.zeros(96, 64))
    with pytest.raises(ValueError, match="64-multiples"):
        jcb.matmul_bn(jnp.zeros((10, 96)), jnp.zeros((96, 64)))
    with pytest.raises(ValueError, match="in_residual"):
        tcb.matmul_bn(torch.zeros(10, 64), torch.zeros(64, 64),
                      in_residual=torch.zeros(9, 64))
    with pytest.raises(ValueError, match="stride"):
        tcb.conv3x3_bn(torch.zeros(1, 4, 4, 64), torch.zeros(3, 3, 64, 64),
                       stride=3)
    with pytest.raises(TypeError, match="unexpected keyword"):
        tcb.conv1x1_bn(torch.zeros(1, 4, 4, 64), torch.zeros(64, 64),
                       stat_shfit=None)


@pytest.mark.parametrize("m,k,n", [(401408, 64, 64), (100, 64, 128),
                                   (6272, 1024, 2048), (31, 64, 64)])
def test_dw_splits_cover_m_in_32_row_chunks(m, k, n):
    # f32 (the FMA kernel): 64x64 tiles, 32-row chunks, about four blocks
    # per SM; bf16 (the wgmma kernel): dw_tile's tiles, chunks of its
    # 64-row slices (so of 32 rows too), at most one wave of blocks (two
    # per SM for 64-column tiles, else one) unless the tiles alone exceed
    # it
    for dtype in (torch.float32, torch.bfloat16):
        splits, chunk = tcb.dw_splits(m, k, n, dtype)
        if dtype == torch.float32:
            (bk, bn), depth, blocks = (64, 64), 32, 4 * 132
        else:
            (bk, bn), depth = tcb.dw_tile(k, n), 64
            blocks = 132 * (2 if bn == 64 else 1)
        tiles = (k // bk) * (n // bn)
        assert chunk % depth == 0 and chunk % 32 == 0
        assert splits * chunk >= m > (splits - 1) * chunk
        assert tiles * splits <= blocks + tiles
        if dtype == torch.bfloat16:
            assert splits == 1 or tiles * splits <= blocks


def test_b4_tiles_and_b2_partial_rows():
    # B4's bf16 tile follows K and N (128 where they allow, else 64); B2's
    # statistics partials hold one row per M tile: 128 rows in bf16, 64
    # in f32
    assert tcb.dw_tile(64, 64) == (64, 64)
    assert tcb.dw_tile(64, 256) == (64, 128)
    assert tcb.dw_tile(256, 64) == (128, 64)
    assert tcb.dw_tile(2048, 512) == (128, 128)
    assert tcb.dw_splits(401408, 64, 64, torch.bfloat16) == (262, 1536)
    assert tcb.dw_splits(6272, 1024, 2048, torch.bfloat16) == (1, 6272)
    assert tcb.dw_splits(25088, 1024, 256, torch.bfloat16) == (8, 3136)
    assert tcb.conv3x3_bn_partial_rows(401408, torch.bfloat16) == 3136
    assert tcb.conv3x3_bn_partial_rows(147, torch.bfloat16) == 2
    assert tcb.conv3x3_bn_partial_rows(147, torch.float32) == 3
    assert tcb.conv3x3_bn_partial_rows(128, torch.bfloat16) == 1


def test_colsum_work_floats():
    # one pass folds 64 rows into one; only passes before the last need
    # scratch
    assert tcb.colsum_work_floats(1, 128) == 0
    assert tcb.colsum_work_floats(64, 128) == 0
    assert tcb.colsum_work_floats(65, 128) == 2 * 128
    assert tcb.colsum_work_floats(6272, 128) == (98 + 2) * 128


def _resnet50_1x1_shapes(batch=128):
    """(M, K, N) of every 1x1 of a ResNet-50 train step at ``batch``,
    from the port's fused model (c1, c3 and the downsample of each
    bottleneck)."""
    from analytics_zoo_tpu_torch.models.image.imageclassification import (
        FusedBottleneck, resnet50)
    net = resnet50(input_shape=(224, 224, 3), classes=1000, fused=True)
    net.init(torch.Generator().manual_seed(0))
    shapes = []
    for lyr in net.layers:
        if not isinstance(lyr, FusedBottleneck):
            continue
        h, w, c = lyr.input_shape
        f, s = lyr.filters, lyr.stride
        mo = batch * -(-h // s) * -(-w // s)
        shapes += [(batch * h * w, c, f), (mo, f, 4 * f)]
        if lyr.downsample:
            shapes.append((mo, c, 4 * f))
    assert len(shapes) == 36
    return sorted(set(shapes))


def test_b3_tile_is_legal_at_every_train_shape(monkeypatch):
    # B3's bf16 tile at every ResNet-50 1x1 of a batch-128 step: a
    # multiple of 64, at most 256, dividing K: min(K, 256). The wrapper
    # hands
    # the C entry point that width and allocates one ds/dt partial row
    # per M tile of the kernel (128 rows in bf16, 64 in f32)
    launched, rows = [], []
    real_partials = tcb._partials
    monkeypatch.setattr(tcb, "_device_kind", lambda name, x: "cuda")
    monkeypatch.setattr(tcb, "_check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(tcb, "_launch",
                        lambda name, dev, *args: launched.append(args))
    monkeypatch.setattr(tcb, "_partials", lambda r, c, like: (
        rows.append((r, c)), real_partials(1, c, like))[1])
    for m, k, n in _resnet50_1x1_shapes():
        bk = tcb.dx_tile(k)
        assert bk in (64, 128, 256) and bk <= k and k % bk == 0
        assert bk == min(k, 256)
        for dtype, tile_rows in ((torch.bfloat16, 128), (torch.float32, 64)):
            assert tcb.dx_partial_rows(m, dtype) == -(-m // tile_rows)
            launched.clear()
            rows.clear()
            vec = torch.zeros(k)
            tcb._matmul_bn_dx(torch.empty(m, k, dtype=dtype),
                              torch.empty(k, n, dtype=dtype), vec, vec, None,
                              torch.zeros(n), torch.empty(m, n, dtype=dtype),
                              torch.empty(m, n, dtype=dtype), torch.zeros(n),
                              torch.zeros(n), True, True)
            assert rows == [(-(-m // tile_rows), 2 * k)]
            assert launched[0][15:21] == (m, k, n, 1, 1, bk)
    assert (tcb.dx_tile(64), tcb.dx_tile(128), tcb.dx_tile(512),
            tcb.dx_tile(2048)) == (64, 128, 256, 256)


def test_b1_tile_is_legal_at_every_train_shape(monkeypatch):
    # B1's bf16 tile at every ResNet-50 1x1 of a batch-128 step: the
    # widest of 256, 128 and 64 that divides N; 64 wide with an
    # in_residual. The wrapper hands the C entry point the dtype flag and
    # that width, and allocates
    # one statistics partial row per M tile of the kernel (128 rows in
    # bf16, 64 in f32)
    launched, rows = [], []
    real_partials = tcb._partials
    monkeypatch.setattr(tcb, "_device_kind", lambda name, x: "cuda")
    monkeypatch.setattr(tcb, "_check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(tcb, "_launch",
                        lambda name, dev, *args: launched.append(args))
    monkeypatch.setattr(tcb, "_partials", lambda r, c, like: (
        rows.append((r, c)), real_partials(1, c, like))[1])
    for m, k, n in _resnet50_1x1_shapes():
        bn = tcb.fwd_tile(n)
        assert bn == min(n, 256) and n % bn == 0
        assert tcb.fwd_tile(n, residual=True) == 64
        for dtype, tile_rows in ((torch.bfloat16, 128), (torch.float32, 64)):
            assert tcb.matmul_bn_partial_rows(m, dtype) == -(-m // tile_rows)
            launched.clear()
            rows.clear()
            vec = torch.zeros(k)
            tcb._matmul_bn_fwd(torch.empty(m, 1, 1, k, dtype=dtype),
                               torch.empty(k, n, dtype=dtype), vec, vec,
                               None, torch.zeros(n), 1, True, True)
            assert rows == [(-(-m // tile_rows), 2 * n)]
            assert launched[0][10:] == (m, 1, 1, k, 1, 1, n, 1, 1, 1,
                                        int(dtype == torch.bfloat16), bn)
    assert [tcb.fwd_tile(n) for n in (64, 128, 512, 2048)] == \
        [64, 128, 256, 256]
