"""Perturbations, the batched temporal-mask search and Grad-CAM."""
