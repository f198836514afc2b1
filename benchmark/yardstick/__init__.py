"""The benchmark's yardstick: the reference TX and the traffic made from
it, the plain reference that decides ``correct``, the peaks and kernel
bounds, and the statistics. It imports NumPy and the standard library
only: nothing of the program under test, of torch or of JAX."""
