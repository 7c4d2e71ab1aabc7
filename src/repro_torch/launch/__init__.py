"""Entry points of the torch port (``python -m repro_torch.launch.serve``)."""
