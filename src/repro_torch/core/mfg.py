"""Assemble sampled neighbourhoods + fetched features into model-ready
batches ("MFG"s, message-flow graphs, following TGL's terminology).

Counterpart of ``repro.core.mfg``: the paper's *feature fetching*
phase.  Node/edge features come through the device ``FeatureCache``
(or straight from the ``StateService``); TGN node memories are always
fetched fresh.  Every tensor lands on the device of the sampled layers,
which is the caches' device.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.sampling import SampledLayer


def _rows(x, device) -> torch.Tensor:
    """A fetched feature block (numpy from the state service, or a
    tensor from a cache) as float32 on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.asarray(x, np.float32)).to(device)


def assemble(layers: List[SampledLayer],
             fetch_node: Callable[[np.ndarray], object],
             fetch_edge: Callable[[np.ndarray], object],
             fetch_memory: Optional[Callable[[np.ndarray], object]]
             = None) -> List[Dict[str, torch.Tensor]]:
    """Returns hops[l] dicts for repro_torch.models.gnn.gnn_embed."""
    hops = []
    for layer in layers:
        device = layer.nbr_ids.device
        dst_ids = layer.dst_nodes.cpu().numpy().astype(np.int64)
        nbr_ids = layer.nbr_ids.cpu().numpy().astype(np.int64)
        eids = layer.nbr_eids.cpu().numpy().astype(np.int64)
        N, K = nbr_ids.shape

        dst_feat = _rows(fetch_node(dst_ids), device)
        nbr_feat = _rows(fetch_node(nbr_ids.reshape(-1)), device) \
            .reshape(N, K, -1)
        edge_feat = _rows(fetch_edge(eids.reshape(-1)), device) \
            .reshape(N, K, -1)
        if fetch_memory is not None:
            dst_mem = _rows(fetch_memory(dst_ids), device)
            nbr_mem = _rows(fetch_memory(nbr_ids.reshape(-1)), device) \
                .reshape(N, K, -1)
            dst_feat = torch.cat([dst_feat, dst_mem], dim=-1)
            nbr_feat = torch.cat([nbr_feat, nbr_mem], dim=-1)

        dt = layer.dst_times[:, None] - layer.nbr_ts
        dt = torch.where(layer.mask, dt.clamp_min(0.0), 0.0)

        hops.append({
            "dst_feat": dst_feat,
            "nbr_feat": nbr_feat,
            "edge_feat": edge_feat,
            "dt": dt.to(torch.float32),
            "mask": layer.mask,
        })
    return hops
