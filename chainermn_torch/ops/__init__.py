"""Tensor ops of the port: rotary embeddings and flash attention."""
