"""Ensembles and sweeps on one card (port of ``pinns_tpu/parallel``'s
``ensemble`` and ``sweep``); device meshes come with slice 6."""
