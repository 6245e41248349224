"""The paper's experiments on the port (counterpart of the JAX repo's
``benchmarks/`` folder of paper scripts): the M-worker simulator, Tables
1-3 and Figures 2-4. ``python -m repro_torch.benchmarks.run`` runs them."""
