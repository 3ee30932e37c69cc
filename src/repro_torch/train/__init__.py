"""Training substrate: functional optimizers, checkpointing, the elastic
policy and the LM train loop."""
