"""The recommendation slice of the port on the card: the id batches'
way through the Estimator's pinned ring, the Embedding lookup's
out-of-range ids, and NeuralCF's first training steps against the same
steps on the CPU.

Every test needs a CUDA card: it carries the ``cuda`` marker and skips
where there is none (the card is looked for inside the fixture). This
file imports no JAX, so it runs on a machine that has none:

    python -m pytest --noconftest tests/test_torch_recommendation_cuda.py -q

Tolerances: bit for bit where nothing is computed (copies, gathers,
NaN rows); the loss of each NCF step within 1e-4 relative of the CPU's
(f32 with TF32 off; sums in another order on the card).
"""

import numpy as np
import pytest
import torch

import analytics_zoo_tpu_torch as tzoo


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    tzoo.reset_nncontext()


@pytest.mark.cuda
@pytest.mark.parametrize("fdt", [None, torch.bfloat16])
def test_int_ids_and_labels_cross_the_pinned_ring_bit_for_bit(cuda, fdt):
    # int32 (user, item) ids and int32 labels through the prefetch
    # worker's pinned ring and copy stream, each batch equal to the
    # synchronous copy; under mixed_bfloat16 ints are not cast
    from analytics_zoo_tpu_torch.pipeline import estimator as em
    rs = np.random.RandomState(0)
    x = np.stack([rs.randint(0, 6040, 1000), rs.randint(0, 3706, 1000)],
                 axis=1).astype(np.int32)
    x[:4] = [[0, 0], [6039, 3705], [2 ** 31 - 1, -1], [-2 ** 31, 7]]
    y = rs.randint(0, 5, (1000, 1)).astype(np.int32)
    ds = em.ArrayDataset(x, y)
    n = 0
    for epoch in (1, 2):
        place = em._CardPlacer(cuda, 2, fdt)
        items = ((ds, sel) for sel in ds.iter_indices(128, seed=epoch))
        it = em._prefetch_iter(items, place, 2)
        try:
            for batch, sel in zip(it, ds.iter_indices(128, seed=epoch)):
                xb, yb = place.take(batch)
                assert xb.dtype == yb.dtype == torch.int32
                assert torch.equal(xb.cpu(), torch.from_numpy(x[sel]))
                assert torch.equal(yb.cpu(), torch.from_numpy(y[sel]))
                n += 1
        finally:
            it.close()
        assert all(b.is_pinned() for ring in place._ring.values()
                   for b in ring)
    assert n == 2 * (1000 // 128)


@pytest.mark.cuda
def test_embedding_out_of_range_ids_on_the_card(cuda):
    # ids -1 (wraps to n-1), n-1, n and -n-1 (NaN rows, no gradient):
    # the card's rows and table gradient equal the CPU port's, and no
    # device-side assert fired (a later CUDA op runs)
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers.embedding \
        import take_rows
    n = 3706
    table = torch.randn(n, 20, generator=torch.Generator().manual_seed(0))
    ids = torch.tensor([[-1, n - 1, n, -n - 1], [0, 5, n + 100, -n]],
                       dtype=torch.int32)
    w = torch.randn(2, 4, 20, generator=torch.Generator().manual_seed(1))
    outs = []
    for dev in ("cpu", cuda):
        t = table.to(dev).requires_grad_(True)
        out = take_rows(t, ids.to(dev))
        loss = torch.sum(torch.where(torch.isnan(out), 0.0, out) *
                         w.to(dev))
        (g,) = torch.autograd.grad(loss, [t])
        outs.append((out.detach().cpu(), g.cpu()))
    (cpu_out, cpu_g), (gpu_out, gpu_g) = outs
    assert torch.equal(torch.isnan(gpu_out), torch.isnan(cpu_out))
    assert torch.isnan(gpu_out[0, 2:]).all() and \
        torch.isnan(gpu_out[1, 2]).all()
    assert torch.equal(gpu_out[0, 0], table[n - 1])
    assert torch.equal(torch.nan_to_num(gpu_out), torch.nan_to_num(cpu_out))
    torch.testing.assert_close(gpu_g, cpu_g, rtol=1e-6, atol=1e-6)
    # the clamped rows (0 and n-1) got only their valid lookups' grads
    assert torch.equal(gpu_g[0], w[1, 0] + w[1, 3])
    assert torch.equal(gpu_g[n - 1], w[0, 0] + w[0, 1])
    after = torch.arange(10, device=cuda).sum()
    torch.cuda.synchronize()
    assert after.item() == 45


@pytest.mark.cuda
def test_neuralcf_first_three_losses_match_the_cpu(cuda):
    from analytics_zoo_tpu_torch.bridge import params_to_numpy
    from analytics_zoo_tpu_torch.models.recommendation import NeuralCF
    kw = dict(user_count=6040, item_count=3706, num_classes=5)
    rs = np.random.RandomState(0)
    users, items = rs.randint(0, 6040, 4096), rs.randint(0, 3706, 4096)
    x = np.stack([users, items], 1).astype(np.int32)
    y = ((users + items) % 5)[:, None].astype(np.int32)
    losses, params = {}, None
    for dev in (cuda, "cpu"):
        tzoo.init_nncontext(seed=0, device=dev)
        ncf = NeuralCF(**kw).compile(optimizer="adam", loss="class_nll")
        if params is None:
            ncf.model.estimator._ensure_initialized()
            params = params_to_numpy(ncf.model)
        else:
            ncf.model.estimator.params = params
        # the whole set is one batch: three Adam steps, one per epoch
        hist = ncf.fit(x, y, batch_size=4096, nb_epoch=3).history
        losses[str(dev)] = [h["loss"] for h in hist]
        assert ncf.model.device.type == torch.device(dev).type
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)
    assert losses["cuda"][2] < losses["cuda"][0]
