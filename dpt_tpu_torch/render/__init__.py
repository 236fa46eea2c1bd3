"""Rays, sampling, intersection, sorting, integrator and render drivers."""
