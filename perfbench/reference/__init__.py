"""The plain reference: the cells' models and optimizer in plain PyTorch."""
