"""Dynamics models: the model contract, MLPs, training and weight transfer."""
