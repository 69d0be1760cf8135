"""The plain float32 reference of the captioner: its model, decoding and training step. It imports neither the captioner nor JAX."""
