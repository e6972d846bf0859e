"""The benchmark's inputs: seeded JPEG XL streams from frozen copies of the
in-repo encoders (`encoder.py`, `encoder_vardct.py`, `_support.py`), one
recipe module per kind of stream (`natural_rgb_vardct.py`), and
`pool.py`, which makes a seed's pool in worker processes and caches it
inside the checkout. Nothing here imports the port."""
