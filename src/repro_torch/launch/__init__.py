"""Entry points of the port: ``serve_gp``, the GP field server on one
device or a mesh of slots (``python -m repro_torch.launch.serve_gp``);
``serve``, the batched LM server (``python -m repro_torch.launch.serve``);
``mesh``, the mesh of slots; ``_dist_icr_check``, the sharded square
root against the unsharded one. Nothing is imported here, so that ``-m``
runs a module once."""
