"""The tanh MLP model (port of ``pinns_tpu.models``)."""
