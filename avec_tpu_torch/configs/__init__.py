"""Training setups of the port, each citing the config it follows."""
