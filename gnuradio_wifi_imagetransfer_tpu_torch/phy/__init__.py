"""802.11a PHY: TX/RX chain stages (PyTorch port)."""
