"""Seq2seq of the port: the encoder-decoder and its chatbot decoding."""

from analytics_zoo_tpu_torch.models.seq2seq.seq2seq import (
    Bridge, RNNDecoder, RNNEncoder, Seq2seq)

__all__ = ["Seq2seq", "RNNEncoder", "RNNDecoder", "Bridge"]
