"""Seq2seq (port of ``analytics_zoo_tpu/models/seq2seq/seq2seq.py``): a
recurrent encoder-decoder with a state bridge, teacher-forced training
on ``[encoder_input, decoder_input]``, and greedy, sampled and beam
decoding.

The encoder and decoder stacks are the port's LSTM/GRU layers; the
encoder's final carries reach the decoder through ``call_with_state``.
The params keep the reference's names and layouts (``enc_rnn_{i}``,
``dec_rnn_{i}``, ``bridge_{i}``, the generator's own name), so a JAX
param tree loads as it is.

Decoding steps the decoder through each layer's own ``step_inputs`` and
``step``, the primitives ``call_with_state`` loops over, so one stepped
token is one step of the full forward. ``generate`` and
``generate_tokens`` are the reference's ``lax.while_loop`` as a Python
loop of ``max_new`` steps whose writes are masked as the reference's
are: a row that is done writes nothing more, so running past the step
where every row is done changes neither the buffer nor the counts.
Nothing in the loop reads a value back to the host (the reference
stops the loop early once every row is done, which needs that read).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from analytics_zoo_tpu_torch.models.common import ZooModel
from analytics_zoo_tpu_torch.ops.rng import fold_in
from analytics_zoo_tpu_torch.ops.sampling import sample_tokens
from analytics_zoo_tpu_torch.pipeline.api.keras.engine import (
    KerasLayer, Shape)
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
    GRU, LSTM, Dense)
from analytics_zoo_tpu_torch.pipeline.api.keras.models import KerasNet


def _make_rnn(rnn_type: str, hidden: int, name: str):
    t = rnn_type.lower()
    if t == "lstm":
        return LSTM(hidden, return_sequences=True, name=name)
    if t == "gru":
        return GRU(hidden, return_sequences=True, name=name)
    raise ValueError(f"unsupported rnn type {rnn_type}")


class RNNEncoder:
    """A stack of recurrent layers whose final carries go to the
    decoder."""

    def __init__(self, rnn_type: str = "lstm", num_layers: int = 1,
                 hidden_size: int = 128):
        self.rnn_type = rnn_type
        self.num_layers = int(num_layers)
        self.hidden_size = int(hidden_size)
        self.rnns = [_make_rnn(rnn_type, hidden_size, f"enc_rnn_{i}")
                     for i in range(self.num_layers)]


class RNNDecoder:
    """A stack of recurrent layers started from the bridged carries."""

    def __init__(self, rnn_type: str = "lstm", num_layers: int = 1,
                 hidden_size: int = 128):
        self.rnn_type = rnn_type
        self.num_layers = int(num_layers)
        self.hidden_size = int(hidden_size)
        self.rnns = [_make_rnn(rnn_type, hidden_size, f"dec_rnn_{i}")
                     for i in range(self.num_layers)]


class Bridge:
    """Maps the encoder's final states to the decoder's initial ones:
    "passthrough", "dense" (one linear Dense per state) or
    "densenonlinear" (tanh)."""

    def __init__(self, bridge_type: str = "passthrough"):
        if bridge_type not in ("passthrough", "dense", "densenonlinear"):
            raise ValueError(f"unsupported bridge type {bridge_type}")
        self.bridge_type = bridge_type
        self.denses: "list[Dense]" = []

    def make_layers(self, num_states: int, hidden: int) -> "list[Dense]":
        if self.bridge_type == "passthrough":
            self.denses = []
        else:
            act = None if self.bridge_type == "dense" else "tanh"
            self.denses = [Dense(hidden, activation=act, name=f"bridge_{i}")
                           for i in range(num_states)]
        return self.denses


class _Seq2seqNet(KerasNet):
    """The compiled container: inputs ``[enc_seq, dec_seq]``."""

    def __init__(self, encoder: RNNEncoder, decoder: RNNDecoder,
                 bridge: Bridge, generator: Optional[KerasLayer],
                 input_shape: Shape, output_shape: Shape):
        super().__init__(name="seq2seq")
        self.encoder = encoder
        self.decoder = decoder
        self.bridge = bridge
        self.generator = generator
        self._enc_shape = tuple(input_shape)
        self._dec_shape = tuple(output_shape)
        self._given_input_shape = [self._enc_shape, self._dec_shape]
        states_per_layer = 2 if encoder.rnn_type.lower() == "lstm" else 1
        self._n_states = decoder.num_layers * states_per_layer
        self.bridge.make_layers(self._n_states, decoder.hidden_size)
        layers = (list(encoder.rnns) + list(decoder.rnns) +
                  list(self.bridge.denses))
        if generator is not None:
            layers.append(generator)
        self._register(layers)

    def init(self, generator: torch.Generator, input_shape=None) -> dict:
        del input_shape     # the shapes are the constructor's
        shape = self._enc_shape
        for r in self.encoder.rnns:
            r.init(generator, shape)
            shape = (shape[0], r.output_dim)
        shape = self._dec_shape
        for r in self.decoder.rnns:
            r.init(generator, shape)
            shape = (shape[0], r.output_dim)
        for d in self.bridge.denses:
            d.init(generator, (self.encoder.hidden_size,))
        if self.generator is not None:
            self.generator.init(generator, shape)
        self._build_input_shape = [self._enc_shape, self._dec_shape]
        self._output_shape = self.compute_output_shape(None)
        return self.params()

    @staticmethod
    def _flatten_states(carries):
        flat = []
        for c in carries:
            if isinstance(c, tuple):
                flat.extend(c)
            else:
                flat.append(c)
        return flat

    def _unflatten_states(self, flat):
        lstm = self.decoder.rnn_type.lower() == "lstm"
        out = []
        i = 0
        for _ in range(self.decoder.num_layers):
            if lstm:
                out.append((flat[i], flat[i + 1]))
                i += 2
            else:
                out.append(flat[i])
                i += 1
        return out

    def _bridged(self, params, carries):
        flat = self._flatten_states(carries)
        if self.bridge.denses:
            flat = [d.call(params[d.name], s)
                    for d, s in zip(self.bridge.denses, flat)]
        return self._unflatten_states(flat)

    def apply(self, params, inputs, *, training=False, rng=None):
        enc_in, dec_in = inputs
        x = enc_in
        carries = []
        for r in self.encoder.rnns:
            x, carry = r.call_with_state(params[r.name], x,
                                         training=training, rng=rng)
            carries.append(carry)
        y = dec_in
        for r, state in zip(self.decoder.rnns,
                            self._bridged(params, carries)):
            y, _ = r.call_with_state(params[r.name], y, initial_carry=state,
                                     training=training, rng=rng)
        if self.generator is not None:
            y = self.generator.call(params[self.generator.name], y,
                                    training=training, rng=rng)
        return y, {}

    # -- decoding -----------------------------------------------------------
    # An RNN's cache is its carry: one (B, H) state (two for the LSTM)
    # per decoder layer. ``encode`` runs the encoder and the bridge once;
    # ``decode_step`` advances every decoder layer one timestep.

    def encode(self, params, enc_in):
        """The encoder and the bridge once: the decoder's initial
        carries."""
        x = enc_in
        carries = []
        for r in self.encoder.rnns:
            x, carry = r.call_with_state(params[r.name], x)
            carries.append(carry)
        return self._bridged(params, carries)

    def decode_step(self, params, carries, x):
        """One decoder timestep: x (B, F) -> (new carries, y (B, F'))
        with the generator applied; per layer the input projection,
        ``step_inputs`` and ``step``, as ``call_with_state`` takes a
        one-step sequence."""
        y = x
        new_carries = []
        for r, c in zip(self.decoder.rnns, carries):
            p = params[r.name]
            z = torch.addmm(p["bias"].to(y.dtype), y,
                            p["kernel"].to(y.dtype))
            u, zs = r.step_inputs(p["recurrent"].to(y.dtype), z[:, None])
            c2, y = r.step(u, c, zs[0])
            new_carries.append(c2)
        if self.generator is not None:
            y = self.generator.call(params[self.generator.name], y)
        return new_carries, y

    def generate(self, params, enc_in, start, max_new: int,
                 stop_sign=None, atol: float = 1e-8, rtol: float = 1e-5):
        """Greedy continuous-vector generation, ``Seq2seq.infer``'s
        loop: ``outputs[:, 0]`` is ``start`` (F,) or (B, F), each step
        appends the decoder's output, and a row stops (its stop vector
        not appended) when the output matches ``stop_sign`` within
        ``allclose(atol, rtol)``. Returns ``(outputs (B, 1 + max_new,
        F), counts (B,))``, both on the device."""
        b, dev, dt = enc_in.shape[0], enc_in.device, enc_in.dtype
        start = torch.as_tensor(start, dtype=dt, device=dev)
        f = start.shape[-1]
        start = start.expand(b, f)
        carries = self.encode(params, enc_in)
        max_new = int(max_new)
        buf = torch.zeros((b, 1 + max_new, f), dtype=dt, device=dev)
        buf[:, 0] = start
        stop = (None if stop_sign is None
                else torch.as_tensor(stop_sign, dtype=dt, device=dev))
        last = start
        done = torch.zeros((b,), dtype=torch.bool, device=dev)
        n = torch.ones((b,), dtype=torch.int64, device=dev)
        for _ in range(max_new):
            carries, y = self.decode_step(params, carries, last)
            if stop is None:
                hit = torch.zeros_like(done)
            else:
                hit = torch.all((y - stop).abs() <=
                                atol + rtol * stop.abs(), dim=-1)
            write = ~done & ~hit
            pos = n.clamp(0, max_new)[:, None, None].expand(b, 1, f)
            cur = buf.gather(1, pos)
            buf.scatter_(1, pos, torch.where(write[:, None, None],
                                             y[:, None], cur))
            n = n + write.long()
            last = torch.where(write[:, None], y, last)
            done = done | hit
        return buf, n.int()

    def generate_tokens(self, params, enc_in, start_token: int,
                        max_new: int, *, temperature=0.0, top_k: int = 0,
                        eos_id=None, rng: Optional[int] = None):
        """Generation over a vocabulary-sized softmax generator (the
        chatbot's): ids feed back as one-hot rows and are picked by
        :func:`~analytics_zoo_tpu_torch.ops.sampling.sample_tokens`
        (greedy where ``temperature <= 0``; else a draw seeded with
        ``fold_in(rng, step)``). Returns ``(ids (B, 1 + max_new),
        counts (B,))`` int32 on the device, with ``ids[:, 0] =
        start_token``; an emitted ``eos_id`` is appended."""
        if self.generator is None:
            raise ValueError("generate_tokens needs a categorical "
                             "generator (vocab-sized softmax)")
        b, dev, dt = enc_in.shape[0], enc_in.device, enc_in.dtype
        vocab = int(self._dec_shape[-1])
        seed = 0 if rng is None else int(rng)
        max_new = int(max_new)
        carries = self.encode(params, enc_in)
        buf = torch.full((b, 1 + max_new), int(start_token),
                         dtype=torch.int32, device=dev)
        last = torch.full((b,), int(start_token), dtype=torch.int32,
                          device=dev)
        done = torch.zeros((b,), dtype=torch.bool, device=dev)
        n = torch.ones((b,), dtype=torch.int64, device=dev)
        for i in range(max_new):
            # one-hot rows by a scatter: F.one_hot reads the ids' range
            # back to the host on some devices
            x = torch.zeros((b, vocab), dtype=dt, device=dev).scatter_(
                1, last[:, None].long(), 1.0)
            carries, y = self.decode_step(params, carries, x)
            logits = torch.log(y.float().clamp(1e-20, 1.0))
            nxt = sample_tokens(fold_in(seed, i), logits, temperature,
                                top_k)
            active = ~done
            pos = n.clamp(0, max_new)[:, None]
            cur = buf.gather(1, pos)
            buf.scatter_(1, pos, torch.where(active[:, None],
                                             nxt[:, None], cur))
            n = n + active.long()
            if eos_id is not None:
                done = done | (active & (nxt == int(eos_id)))
            last = torch.where(active, nxt, last)
        return buf, n.int()

    def compute_output_shape(self, input_shape):
        shape = (self._dec_shape[0], self.decoder.hidden_size)
        if self.generator is not None:
            shape = tuple(self.generator.compute_output_shape(shape))
        return shape


class Seq2seq(ZooModel):
    def __init__(self, encoder: "RNNEncoder | None" = None,
                 decoder: "RNNDecoder | None" = None,
                 input_shape: Sequence[int] = (10, 32),
                 output_shape: Sequence[int] = (10, 32),
                 bridge: "Bridge | str | None" = None,
                 generator: Optional[KerasLayer] = None):
        super().__init__()
        self.encoder = encoder or RNNEncoder()
        self.decoder = decoder or RNNDecoder(
            rnn_type=self.encoder.rnn_type,
            num_layers=self.encoder.num_layers,
            hidden_size=self.encoder.hidden_size)
        if self.encoder.rnn_type.lower() != self.decoder.rnn_type.lower():
            raise ValueError("encoder/decoder rnn types must match")
        if isinstance(bridge, str):
            bridge = Bridge(bridge)
        self.bridge = bridge or Bridge("passthrough")
        self.generator = generator
        self.input_shape = tuple(input_shape)
        self.output_shape = tuple(output_shape)

    def hyper_parameters(self):
        # the encoder, decoder, bridge and generator rebuild as defaults,
        # as in the reference
        return {"encoder": None, "decoder": None,
                "input_shape": self.input_shape,
                "output_shape": self.output_shape}

    def build_model(self) -> _Seq2seqNet:
        return _Seq2seqNet(self.encoder, self.decoder, self.bridge,
                           self.generator, self.input_shape,
                           self.output_shape)

    def _net_params(self):
        return self._initialized_estimator().model.params()

    def infer(self, input_seq: np.ndarray, start_sign: np.ndarray,
              max_seq_len: int = 30,
              stop_sign: Optional[np.ndarray] = None) -> np.ndarray:
        """Greedy generation (the reference's ``infer``): from
        ``start_sign``, append the decoder's output each step, stop at
        ``stop_sign`` or ``max_seq_len``. The encoder runs once and
        each token is one decoder step (:meth:`_Seq2seqNet.generate`);
        returns ``(B, n, F)`` on the host, n the longest row's count."""
        net = self.model
        params = self._net_params()
        if input_seq.ndim == 2:
            input_seq = input_seq[None]
        enc = torch.from_numpy(np.asarray(input_seq, np.float32)).to(
            net.device)
        start = np.asarray(start_sign, np.float32).reshape(
            (1,) + np.asarray(start_sign).shape[-1:])
        stop = (None if stop_sign is None
                else np.asarray(stop_sign, np.float32))
        with torch.inference_mode():
            out, counts = net.generate(params, enc, start, int(max_seq_len),
                                       stop_sign=stop)
            n = int(counts.max())
            return out[:, :n].cpu().numpy()

    def infer_beam(self, input_seq: np.ndarray, start_token: int,
                   beam_size: int = 4, max_seq_len: int = 30,
                   stop_token: Optional[int] = None,
                   length_penalty: float = 0.6
                   ) -> "tuple[list[int], float]":
        """Beam search over a categorical generator (a vocabulary-sized
        softmax); tokens feed back as one-hot rows. Returns ``(token_ids,
        score)`` of the best finished hypothesis, ids without the start
        token, scored ``logp / ((5 + L) / 6) ** length_penalty``.

        A host loop over one step of fixed shapes: every step forwards
        ``(beam_size, max_seq_len)`` decoder rows and reads the column
        ``t`` (the recurrence is causal, so the zero rows past ``t``
        change nothing); candidates come from ``np.argsort`` of the
        float32 log-probabilities, as in the reference."""
        net = self.model
        params = self._net_params()
        if input_seq.ndim == 2:
            input_seq = input_seq[None]
        vocab = self.output_shape[-1]

        def norm(logp, length):
            return logp / (((5.0 + length) / 6.0) ** length_penalty)

        input_seq = np.asarray(input_seq, np.float32)
        enc_rep = torch.from_numpy(
            np.repeat(input_seq, beam_size, axis=0)).to(net.device)
        dec_buf = np.zeros((beam_size, max_seq_len, vocab), np.float32)

        beams = [([start_token], 0.0)]          # (ids with start, logp)
        finished: "list[tuple[list[int], float]]" = []
        for t in range(max_seq_len):
            if not beams:
                break
            # one step for every live hypothesis (the other rows are
            # computed and dropped)
            dec_buf[:] = 0.0
            for row, (ids, _) in enumerate(beams):
                dec_buf[row, np.arange(len(ids)), ids] = 1.0
            with torch.inference_mode():
                out = net.call(params, [enc_rep, torch.from_numpy(
                    dec_buf).to(net.device)])[:, t, :].float().cpu().numpy()
            out = out[:len(beams)]
            logp_next = np.log(np.clip(out, 1e-20, 1.0))
            cand = []
            for (ids, lp), row in zip(beams, logp_next):
                for tok in np.argsort(row)[-beam_size:]:
                    cand.append((ids + [int(tok)], lp + row[tok]))
            cand.sort(key=lambda c: c[1], reverse=True)
            beams = []
            for ids, lp in cand[: beam_size * 2]:
                if stop_token is not None and ids[-1] == stop_token:
                    finished.append((ids[1:-1], norm(lp, len(ids) - 1)))
                elif len(beams) < beam_size:
                    beams.append((ids, lp))
            if len(finished) >= beam_size:
                break
        # unfinished hypotheses score over their scored tokens only
        # (len(ids) - 1 leaves out the start token, as the stop branch)
        finished.extend((ids[1:], norm(lp, len(ids) - 1))
                        for ids, lp in beams)
        if not finished:
            return [], float("-inf")
        best = max(finished, key=lambda c: c[1])
        return list(best[0]), float(best[1])
