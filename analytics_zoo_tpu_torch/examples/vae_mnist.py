"""Variational autoencoder example (the reference app
``apps/variational-autoencoder``'s notebook, which builds the VAE from
BigDL's ``GaussianSampler`` and ``KLDCriterion``).

The reparameterization and the ELBO are autograd Variable expressions:
the model takes [image, eps] and outputs the per-sample loss (the BCE
reconstruction plus the KL term), trained with an identity objective.
After training, the decoder layers are rebuilt into a generator
(weights copied by layer name) and digits are sampled from the prior.

    python -m analytics_zoo_tpu_torch.examples vae_mnist
    python -m analytics_zoo_tpu_torch.examples vae_mnist --device cpu \\
        --n-train 128 --epochs 1 --hidden 32
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--latent", type=int, default=2)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--n-train", type=int, default=512)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA card)")
    args = p.parse_args(argv)

    from analytics_zoo_tpu_torch import init_nncontext
    from analytics_zoo_tpu_torch.ops.optimizers import Adam
    from analytics_zoo_tpu_torch.pipeline.api import autograd as A
    from analytics_zoo_tpu_torch.pipeline.api.autograd import CustomLoss
    from analytics_zoo_tpu_torch.pipeline.api.keras.datasets import mnist
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Input
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense
    from analytics_zoo_tpu_torch.pipeline.api.keras.models import Model

    init_nncontext(device=args.device)
    (x_train, _), _ = mnist.load_data()
    x = (x_train[:args.n_train].reshape(-1, 784) / 255.0).astype(np.float32)
    rs = np.random.RandomState(0)
    eps = rs.randn(len(x), args.latent).astype(np.float32)

    # encoder -> reparameterized z -> decoder, the ELBO as the output
    x_in = Input((784,), name="image")
    eps_in = Input((args.latent,), name="eps")
    h = Dense(args.hidden, activation="relu", name="enc_h")(x_in)
    z_mean = Dense(args.latent, name="enc_mean")(h)
    z_logvar = Dense(args.latent, name="enc_logvar")(h)
    z = z_mean + A.exp(z_logvar * 0.5) * eps_in   # reparameterization
    dec_h = Dense(args.hidden, activation="relu", name="dec_h")
    dec_out = Dense(784, activation="sigmoid", name="dec_out")
    recon = A.clip(dec_out(dec_h(z)), 1e-6, 1.0 - 1e-6)
    bce = -A.sum(x_in * A.log(recon) + (1.0 - x_in) * A.log(1.0 - recon),
                 axis=1, keepdims=True)
    kl = A.sum(A.square(z_mean) + A.exp(z_logvar) - z_logvar - 1.0,
               axis=1, keepdims=True) * 0.5
    vae = Model([x_in, eps_in], bce + kl, name="vae")
    # identity objective (the ELBO is the output); y_true * 0 keeps the
    # loss graph connected to both of its inputs
    vae.compile(optimizer=Adam(lr=1e-3),
                loss=CustomLoss(lambda y_true, y_pred: y_pred + y_true * 0.0,
                                y_pred_shape=(1,)))
    dummy_y = np.zeros((len(x), 1), np.float32)
    res = vae.fit([x, eps], dummy_y, batch_size=args.batch_size,
                  nb_epoch=args.epochs)
    elbo = res.history[-1]["loss"]
    print(f"vae: final per-sample loss (BCE+KL) = {elbo:.2f}")

    # the generator: the same decoder layers, weights copied by name
    z_in = Input((args.latent,), name="z")
    gen = Model(z_in, dec_out(dec_h(z_in)), name="generator")
    gen.compile(optimizer="sgd", loss="mse")
    gen.copy_weights_from(vae)
    samples = gen.predict(rs.randn(4, args.latent).astype(np.float32),
                          batch_size=4)
    print(f"generated {samples.shape[0]} digits, pixel range "
          f"[{samples.min():.2f}, {samples.max():.2f}]")
    return {"loss": float(elbo), "samples": samples}


if __name__ == "__main__":
    main()
