"""Device, wire-format, tracing, image, metrics and training helpers
(PyTorch port)."""
