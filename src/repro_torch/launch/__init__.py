"""Entry points of the port: ``serve_gp``, the GP field server on one
device (``python -m repro_torch.launch.serve_gp``). Nothing is imported
here, so that ``-m`` runs the module once."""
