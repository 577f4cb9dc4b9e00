"""The benchmark's plain references: the dynamics, costs, fits, initial
weights and operation counts of its configurations, and the NLP residuals
that decide whether a run's plans are correct.

Plain PyTorch only.  Nothing here imports JAX, the JAX package or the
package under test (``pyneuralempc_tpu_torch``): each reference works out
for itself what the program derives from the benchmark's inputs.
"""
