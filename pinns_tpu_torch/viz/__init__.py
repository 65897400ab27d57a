"""Figures and animations of a trained model against its grid (port of
``pinns_tpu/viz``); matplotlib is imported at the call, not here."""

from pinns_tpu_torch.viz.animate import animate_snapshots
from pinns_tpu_torch.viz.plots import plot_from_snapshots, plot_solution, plot_uncertainty
