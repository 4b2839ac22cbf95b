"""Training: the weight bridge to the JAX parameter layout, checkpoints,
RMSprop and its schedule, the train and eval steps."""
