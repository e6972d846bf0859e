"""JAX-free copies of the in-repo test-stream encoders (tools/encoder.py,
tools/encoder_vardct.py): the same arguments, the same bytes, numpy
only. The CLI's `generate-fixture` writes through them, and a host
without JAX makes seeded streams with them."""
