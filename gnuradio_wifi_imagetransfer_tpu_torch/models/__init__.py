"""The model zoo (PyTorch port of the JAX package's models/): the JSCE codec
(the SOMA-DSCN encoder and the PE-conditioned decoder with their
GDN-ResNet, CSI, SNR and depthwise variants, the weight carriers (npz and
the reference's .pth) and the ``JSCE`` facade of the Mode-1 apps), the
SOMANet multi-user models, and the research model families of the
reference's codec/models tree (ViT, Swin, MAE, CVAE, GNN, PropagNet, CSA,
the ViT codec)."""

from gnuradio_wifi_imagetransfer_tpu_torch.models.jsce import JSCE  # noqa: F401
from gnuradio_wifi_imagetransfer_tpu_torch.models.encoder import (  # noqa: F401
    Encoder, EncoderCSI, EncoderPE)
from gnuradio_wifi_imagetransfer_tpu_torch.models.decoder import (  # noqa: F401
    Decoder, DecoderDSCN, DecoderOriginal, DecoderPE, DecoderSA)
from gnuradio_wifi_imagetransfer_tpu_torch.models.somanet import SOMANet, SOMANetPE  # noqa: F401
from gnuradio_wifi_imagetransfer_tpu_torch.models.vit import (  # noqa: F401
    Attention, CrossAttention, FeedForward, Transformer, ViT)
from gnuradio_wifi_imagetransfer_tpu_torch.models.mae import (  # noqa: F401
    MAE, MaskedAutoencoderViT, mae_vit_base_patch16, mae_vit_huge_patch14,
    mae_vit_large_patch16)
from gnuradio_wifi_imagetransfer_tpu_torch.models.swin import (  # noqa: F401
    DimReducePatchExpand, FinalPatchExpandX4, PatchEmbed, PatchExpand,
    PatchExpand2X, PatchMerging, SwinTransformerBlock, WindowAttention)
from gnuradio_wifi_imagetransfer_tpu_torch.models.vae import ConditionalVAE, vae_loss  # noqa: F401
from gnuradio_wifi_imagetransfer_tpu_torch.models.gnn import GCNConv, GNN  # noqa: F401
from gnuradio_wifi_imagetransfer_tpu_torch.models.propagnet import PropagNet  # noqa: F401
from gnuradio_wifi_imagetransfer_tpu_torch.models.csa import CSAAFB  # noqa: F401
from gnuradio_wifi_imagetransfer_tpu_torch.models.vit_codec import ViTDecoder, ViTEncoder  # noqa: F401
