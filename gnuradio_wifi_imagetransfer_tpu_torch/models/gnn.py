"""Graph neural network: a 2-layer GCN over user-position graphs (PyTorch
port of the JAX package's models/gnn.py, codec/models/basic_blocks/
GNN.py:8-19, a torch_geometric GCNConv stack). GCNConv's propagation rule
x' = D^-1/2 (A+I) D^-1/2 x W + b is a dense product at the reference's
scale (user graphs of about 6 nodes). Runs on ``device`` ("cuda" unless
the caller asks for the CPU)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from gnuradio_wifi_imagetransfer_tpu_torch.utils.device import resolve


def normalized_adjacency(edge_index, num_nodes: int, device=None) -> torch.Tensor:
    """Dense D^-1/2 (A + I) D^-1/2 from a (2, E) COO edge list
    (torch_geometric GCNConv's defaults: self loops, symmetric
    normalisation). Duplicate edges accumulate, as in a scatter-add
    message pass."""
    edge_index = torch.as_tensor(edge_index, dtype=torch.long, device=device)
    a = torch.zeros((num_nodes, num_nodes), device=edge_index.device)
    a.index_put_((edge_index[0], edge_index[1]),
                 torch.ones(edge_index.shape[1], device=a.device), accumulate=True)
    a = a + torch.eye(num_nodes, device=a.device)
    d_inv_sqrt = torch.clamp(a.sum(dim=1), min=1e-12) ** -0.5
    return d_inv_sqrt[:, None] * a * d_inv_sqrt[None, :]


class GCNConv(nn.Module):
    """One graph-convolution layer: project, then aggregate neighbours."""

    def __init__(self, in_features: int, features: int, device="cuda"):
        super().__init__()
        self.lin = nn.Linear(in_features, features)
        self.to(resolve(device))

    def forward(self, x: torch.Tensor, adj_norm: torch.Tensor) -> torch.Tensor:
        # x: (..., N, F); leading batch dims broadcast through the product
        return torch.einsum("ij,...jf->...if", adj_norm, self.lin(x))


class GNN(nn.Module):
    """conv -> ReLU -> conv (GNN.py:9-19); node features of ``in_channels``
    (the users' 3-D positions in the reference's smoke run)."""

    def __init__(self, hidden_channels: int, out_channels: int, in_channels: int = 3,
                 device="cuda"):
        super().__init__()
        self.conv1 = GCNConv(in_channels, hidden_channels, device)
        self.conv2 = GCNConv(hidden_channels, out_channels, device)
        self.to(resolve(device))

    def forward(self, node_features: torch.Tensor, edge_index) -> torch.Tensor:
        adj = normalized_adjacency(edge_index, node_features.shape[-2], node_features.device)
        return self.conv2(F.relu(self.conv1(node_features, adj)), adj)
