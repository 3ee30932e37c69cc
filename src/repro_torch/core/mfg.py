"""Assemble sampled neighbourhoods + fetched features into model-ready
batches ("MFG"s, message-flow graphs, following TGL's terminology).

Counterpart of ``repro.core.mfg``: the paper's *feature fetching*
phase.  Node/edge features come through the device ``FeatureCache``
(or straight from the ``StateService``); TGN node memories are always
fetched fresh.  Every tensor lands on the device of the sampled layers,
which is the caches' device; layers the distributed schedule routed
through the host (numpy arrays) land on the ``device`` given.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.sampling import SampledLayer


def host_ids(x) -> np.ndarray:
    """Ids of a sampled layer (a tensor on any device, or numpy) as an
    int64 host array."""
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x).astype(np.int64)


def _on(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.asarray(x)).to(device)


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
             = None, device=None) -> List[Dict[str, torch.Tensor]]:
    """Returns hops[l] dicts for repro_torch.models.gnn.gnn_embed, on
    the layers' device (tensors) or on ``device`` (numpy layers)."""
    hops = []
    for layer in layers:
        if isinstance(layer.nbr_ids, torch.Tensor):
            device = layer.nbr_ids.device
        dst_ids = host_ids(layer.dst_nodes)
        nbr_ids = host_ids(layer.nbr_ids)
        eids = host_ids(layer.nbr_eids)
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

        mask = _on(layer.mask, device)
        dt = _on(layer.dst_times, device)[:, None] - _on(layer.nbr_ts,
                                                          device)
        dt = torch.where(mask, dt.clamp_min(0.0), 0.0)

        hops.append({
            "dst_feat": dst_feat,
            "nbr_feat": nbr_feat,
            "edge_feat": edge_feat,
            "dt": dt.to(torch.float32),
            "mask": mask,
        })
    return hops
