"""Recurrent layers: SimpleRNN, LSTM, GRU, Bidirectional and
TimeDistributed (port of
``analytics_zoo_tpu/pipeline/api/keras/layers/recurrent.py``).

Keras-1 semantics, as the reference's: gate order i, f, c, o (LSTM) and
z, r, h (GRU), the inner activation ``hard_sigmoid`` (``clip(0.2 x +
0.5, 0, 1)``), one bias per gate, and a GRU whose reset gate scales the
state before its recurrent product, ``(r * h) @ U_h``. ``nn.LSTM``,
``nn.GRU`` and cuDNN's RNN compute other functions (a logistic inner
activation, two biases, ``r * (h @ U_h + b)``), so none is used.

The structure is the reference's: the input projection of every
timestep is one ``(B*T, F) @ (F, G*H)`` product with the bias, then a
Python loop over T takes one ``h @ U`` and the gate arithmetic per step
(the reference's ``lax.scan``). Nothing in the loop reads a value back
to the host. The params keep the reference's names and layouts:
``kernel`` (F, G*H), ``recurrent`` (H, G*H), ``bias`` (G*H,), the gates
concatenated on the last axis.
"""

from __future__ import annotations

import copy

import torch

from analytics_zoo_tpu_torch.ops import (activations, initializers,
                                         regularizers)
from analytics_zoo_tpu_torch.pipeline.api.keras.engine import (
    KerasLayer, Shape)


class _RNNBase(KerasLayer):
    n_gates = 1

    def __init__(self, output_dim: int, activation="tanh",
                 inner_activation="hard_sigmoid", init="glorot_uniform",
                 inner_init="orthogonal", return_sequences: bool = False,
                 go_backwards: bool = False, w_regularizer=None,
                 u_regularizer=None, b_regularizer=None,
                 input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.output_dim = int(output_dim)
        self.activation = activations.get(activation) or activations.linear
        self.inner_activation = (activations.get(inner_activation)
                                 or activations.linear)
        self.kernel_init = initializers.get(init)
        self.inner_init = initializers.get(inner_init)
        self.return_sequences = return_sequences
        self.go_backwards = go_backwards
        self.w_regularizer = regularizers.get(w_regularizer)
        self.u_regularizer = regularizers.get(u_regularizer)
        self.b_regularizer = regularizers.get(b_regularizer)

    def build(self, generator, input_shape: Shape) -> dict:
        h, g = self.output_dim, self.n_gates
        kernel = self.kernel_init(generator, (input_shape[-1], h * g))
        # one (H, H) draw per gate, concatenated on the last axis
        recurrent = torch.cat([self.inner_init(generator, (h, h))
                               for _ in range(g)], dim=-1)
        return {"kernel": kernel, "recurrent": recurrent,
                "bias": torch.zeros((h * g,))}

    def carry_init(self, batch: int, dtype, device):
        return torch.zeros((batch, self.output_dim), dtype=dtype,
                           device=device)

    def step_inputs(self, u, zx):
        """``(u, per-step inputs)``: ``recurrent`` as :meth:`step` takes
        it and each step's input projection, views of ``zx`` (B, T, G*H)
        taken once, so the backward stacks their gradients once instead
        of a full-size zero tensor per step."""
        return u, zx.unbind(1)

    def step(self, u, carry, z):
        """One timestep: the carry and this step's input projection
        ``z`` (B, G*H) -> (new carry, output)."""
        raise NotImplementedError

    def call_with_state(self, params, x, initial_carry=None, *,
                        training=False, rng=None):
        """Run over ``x`` (B, T, F): ``(outputs (B, T, H), final
        carry)``. ``initial_carry`` hands a state in (an encoder's to a
        decoder, the reference Seq2seq's bridge); default zeros in x's
        dtype."""
        if self.go_backwards:
            x = torch.flip(x, dims=(1,))
        b, t = x.shape[0], x.shape[1]
        # the input projection of every step in one product
        zx = torch.addmm(params["bias"].to(x.dtype),
                         x.reshape(b * t, x.shape[2]),
                         params["kernel"].to(x.dtype)).reshape(b, t, -1)
        # the reference casts ``recurrent`` to the carry's dtype in every
        # step; once here is the same cast
        u = params["recurrent"].to(x.dtype)
        carry = (initial_carry if initial_carry is not None
                 else self.carry_init(b, x.dtype, x.device))
        u, zs = self.step_inputs(u, zx)
        outs = []
        for z in zs:
            carry, out = self.step(u, carry, z)
            outs.append(out)
        return torch.stack(outs, dim=1), carry

    def call(self, params, x, *, training=False, rng=None):
        outs, _ = self.call_with_state(params, x, training=training,
                                       rng=rng)
        if self.return_sequences:
            return outs
        return outs[:, -1]

    def compute_output_shape(self, input_shape: Shape) -> Shape:
        if self.return_sequences:
            return (input_shape[0], self.output_dim)
        return (self.output_dim,)

    def regularizers(self):
        out = []
        if self.w_regularizer is not None:
            out.append(("kernel", self.w_regularizer))
        if self.u_regularizer is not None:
            out.append(("recurrent", self.u_regularizer))
        if self.b_regularizer is not None:
            out.append(("bias", self.b_regularizer))
        return out


class SimpleRNN(_RNNBase):
    """Vanilla RNN: ``h = activation(x W + b + h U)``."""

    n_gates = 1

    def step(self, u, h, z):
        h_new = self.activation(torch.addmm(z, h, u))
        return h_new, h_new


class LSTM(_RNNBase):
    """Keras-1 LSTM, gate order i, f, c, o; the carry is ``(h, c)``."""

    n_gates = 4

    def carry_init(self, batch, dtype, device):
        h = torch.zeros((batch, self.output_dim), dtype=dtype, device=device)
        return (h, torch.zeros_like(h))

    def step(self, u, carry, z):
        h, c = carry
        gates = torch.addmm(z, h, u)
        i, f, g, o = torch.chunk(gates, 4, dim=-1)
        i = self.inner_activation(i)
        f = self.inner_activation(f)
        g = self.activation(g)
        o = self.inner_activation(o)
        c_new = f * c + i * g
        h_new = o * self.activation(c_new)
        return (h_new, c_new), h_new


class GRU(_RNNBase):
    """Keras-1 GRU, gates z, r, h; the reset gate scales the state
    before the candidate's recurrent product."""

    n_gates = 3

    def step_inputs(self, u, zx):
        n = 2 * self.output_dim
        return ((u[:, :n], u[:, n:]),
                list(zip(zx[..., :n].unbind(1), zx[..., n:].unbind(1))))

    def step(self, u, h, zin):
        (u_zr, u_h), (z_zr, z_h) = u, zin
        zr = self.inner_activation(torch.addmm(z_zr, h, u_zr))
        z, r = torch.chunk(zr, 2, dim=-1)
        hh = self.activation(torch.addmm(z_h, r * h, u_h))
        h_new = z * h + (1.0 - z) * hh
        return h_new, h_new


class Bidirectional(KerasLayer):
    """Run a recurrent layer forward and a copy of it backward, merging
    the outputs (``concat``, ``sum``, ``mul`` or ``ave``); params
    ``{"forward", "backward"}``. With sequences, the backward outputs
    are flipped back to forward time order."""

    def __init__(self, layer: _RNNBase, merge_mode: str = "concat",
                 input_shape=None, name=None, **kwargs):
        super().__init__(input_shape=input_shape or
                         layer._given_input_shape, name=name, **kwargs)
        if merge_mode not in ("concat", "sum", "mul", "ave"):
            raise ValueError(f"bad merge_mode {merge_mode}")
        self.merge_mode = merge_mode
        self.forward_layer = layer
        self.backward_layer = copy.deepcopy(layer)
        self.forward_layer.go_backwards = False
        self.backward_layer.go_backwards = True
        self.backward_layer.name = layer.name + "_bw"

    def build(self, generator, input_shape: Shape) -> dict:
        # the inner layers' trees live in this layer's, not in theirs
        return {"forward": self.forward_layer.build(generator, input_shape),
                "backward": self.backward_layer.build(generator,
                                                      input_shape)}

    def call(self, params, x, *, training=False, rng=None):
        fwd = self.forward_layer.call(params["forward"], x,
                                      training=training, rng=rng)
        bwd = self.backward_layer.call(params["backward"], x,
                                       training=training, rng=rng)
        if self.forward_layer.return_sequences:
            bwd = torch.flip(bwd, dims=(1,))
        if self.merge_mode == "concat":
            return torch.cat([fwd, bwd], dim=-1)
        if self.merge_mode == "sum":
            return fwd + bwd
        if self.merge_mode == "mul":
            return fwd * bwd
        return (fwd + bwd) / 2.0

    def compute_output_shape(self, input_shape: Shape) -> Shape:
        base = self.forward_layer.compute_output_shape(input_shape)
        if self.merge_mode == "concat":
            return tuple(base[:-1]) + (base[-1] * 2,)
        return base

    def regularization_loss(self, params):
        return (self.forward_layer.regularization_loss(
                    params.get("forward", {})) +
                self.backward_layer.regularization_loss(
                    params.get("backward", {})))


class TimeDistributed(KerasLayer):
    """Apply a layer to every timestep, time folded into the batch (one
    batched call, not T); params ``{"layer"}``."""

    def __init__(self, layer: KerasLayer, input_shape=None, name=None,
                 **kwargs):
        super().__init__(input_shape=input_shape, name=name, **kwargs)
        self.layer = layer

    def build(self, generator, input_shape: Shape) -> dict:
        inner_shape = tuple(input_shape[1:])
        params = self.layer.build(generator, inner_shape)
        self.layer._build_input_shape = inner_shape
        self.layer._output_shape = self.layer.compute_output_shape(
            inner_shape)
        return {"layer": params}

    def call(self, params, x, *, training=False, rng=None):
        b, t = x.shape[0], x.shape[1]
        y = self.layer.call(params["layer"],
                            x.reshape((b * t,) + tuple(x.shape[2:])),
                            training=training, rng=rng)
        return y.reshape((b, t) + tuple(y.shape[1:]))

    def compute_output_shape(self, input_shape: Shape) -> Shape:
        inner = self.layer.compute_output_shape(tuple(input_shape[1:]))
        return (input_shape[0],) + tuple(inner)

    def regularization_loss(self, params):
        return self.layer.regularization_loss(params.get("layer", {}))
