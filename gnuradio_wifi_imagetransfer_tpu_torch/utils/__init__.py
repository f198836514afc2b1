"""Device, wire-format and tracing helpers (PyTorch port)."""
