from repro_torch.configs.tgn_gdelt import GNN_MODELS, GNNConfig  # noqa: F401
