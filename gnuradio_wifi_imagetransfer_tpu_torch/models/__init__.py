"""The JSCE inference codec (PyTorch port of the JAX package's models/):
the SOMA-DSCN encoder and the PE-conditioned decoder, their weight
carrier, and the ``JSCE`` facade of the Mode-1 apps."""
