"""Keras-style model API of the port."""
