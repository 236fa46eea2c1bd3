"""Gradients of rendered images and the inverse-rendering loop."""
