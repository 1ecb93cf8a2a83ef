"""Datasets: the synthetic parametric point-cloud set."""
