"""The JSCE codec (PyTorch port of the JAX package's models/): the SOMA-DSCN
encoder and the PE-conditioned decoder with their GDN-ResNet, CSI, SNR and
depthwise variants, the SOMANet multi-user models, the weight carriers (npz
and the reference's .pth), and the ``JSCE`` facade of the Mode-1 apps."""
