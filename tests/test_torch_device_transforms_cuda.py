"""The batched augmentation of the port on the card, held against the
CPU port on the same drawn parameters: each op's ``sample`` on the card,
its ``apply`` there, and the same ``apply`` on the CPU with those
parameters copied to the host. Crops, flips and cutout bit for bit; the
colour ops, normalisation and the resized crop within 1e-3 on the 0-255
scale (f32, TF32 off). Then the ResNet-50 recipe's pipeline (257 x 257
to 224 x 224) runs under ``torch.cuda.set_sync_debug_mode("error")``,
which raises on any read back to the host, and an augmented Estimator
step does too.

Every test needs a CUDA card: it carries the ``cuda`` marker and skips
where there is none (the card is looked for inside the fixture). This
file imports no JAX, so it runs on a machine that has none:

    python -m pytest --noconftest tests/test_torch_device_transforms_cuda.py -q
"""

import numpy as np
import pytest
import torch

import analytics_zoo_tpu_torch as tzoo
from analytics_zoo_tpu_torch.feature.image import device_transforms as D
from analytics_zoo_tpu_torch.ops.rng import fold_in

pytestmark = pytest.mark.cuda

EXACT = {"random_crop", "center_crop", "random_hflip", "cutout"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.cuda.set_sync_debug_mode("default")
    tzoo.reset_nncontext()


def _ops():
    return [D.random_crop((200, 210)), D.center_crop((224, 224)),
            D.random_hflip(), D.cutout(40, fill=7.0),
            D.random_brightness(32.0), D.random_contrast(0.4),
            D.random_saturation(0.3), D.random_hue(),
            D.normalize((123.68, 116.779, 103.939), (58.393, 57.12, 57.375)),
            D.random_resized_crop((224, 224), scale=(0.32, 1.0)),
            D.random_resized_crop((300, 280), scale=(0.02, 0.1))]


def _images(dev, n=16, size=257):
    g = torch.Generator(device=dev).manual_seed(0)
    return torch.rand((n, size, size, 3), generator=g, device=dev) * 255


@pytest.mark.parametrize("i", range(11))
def test_op_on_card_matches_cpu(cuda, i):
    op = _ops()[i]
    x = _images(cuda)
    params = op.sample(fold_in(3, i), x)
    got = op.apply(x, params).cpu()
    want = op.apply(x.cpu(), {k: v.cpu() for k, v in params.items()})
    assert got.shape == want.shape
    err = float((got - want).abs().max())
    assert err <= (0.0 if op.name in EXACT else 1e-3), (op.name, err)


def test_recipe_pipeline_makes_no_host_sync(cuda):
    from analytics_zoo_tpu_torch.examples.resnet_imagenet import \
        device_augment
    aug = device_augment(224)
    x = _images(cuda, n=32)
    aug(1, x)                       # builds the constants once
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    out = aug(2, x)
    torch.cuda.set_sync_debug_mode("default")
    assert out.shape == (32, 224, 224, 3) and out.device.type == "cuda"
    assert torch.isfinite(out).all()


def test_augmented_estimator_step_makes_no_host_sync(cuda):
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as L
    from analytics_zoo_tpu_torch.pipeline.api.keras.models import Sequential
    from analytics_zoo_tpu_torch.pipeline.estimator import Estimator
    tzoo.init_nncontext(seed=0)
    m = Sequential()
    m.add(L.Convolution2D(8, 3, 3, activation="relu",
                          input_shape=(24, 24, 3)))
    m.add(L.Flatten())
    m.add(L.Dense(4, activation="softmax"))
    aug = D.augment_pipeline(D.random_resized_crop((24, 24)),
                             D.random_hflip(), D.cutout(4),
                             D.normalize((128.0,) * 3, (64.0,) * 3))
    est = Estimator(m, optimizer="sgd",
                    loss="sparse_categorical_crossentropy",
                    dtype_policy="mixed_bfloat16", augment=aug)
    est._ensure_initialized()
    x = _images(cuda, n=8, size=32)
    y = torch.randint(0, 4, (8, 1), device=cuda)
    est._train_step(x, y, 1)        # warm: the augment's constants
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    loss = est._train_step(x, y, 2)
    torch.cuda.set_sync_debug_mode("default")
    assert np.isfinite(float(loss))
