"""The plain references of the benchmark's configurations: float32 PyTorch,
independent of the program (nothing here imports it), one module a model
family with ``stages(vision, tree, device)``, run by ``run.reference_rows``."""
