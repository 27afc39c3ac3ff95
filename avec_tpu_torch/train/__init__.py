"""Training of the port: losses, schedulers, optimizer and the train step."""
