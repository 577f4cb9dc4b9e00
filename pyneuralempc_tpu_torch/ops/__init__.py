"""Integrators, rollouts and kernels."""
