"""The adversarial training of the port: the train state (modules,
optimizers, appearance pool) and the one-step update."""
