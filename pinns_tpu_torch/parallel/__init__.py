"""Ensembles and sweeps (port of ``pinns_tpu/parallel``'s ``ensemble`` and
``sweep``), and since slice 6 the process mesh (``mesh``) and collocation
data parallelism (``sharding``) over several cards."""
