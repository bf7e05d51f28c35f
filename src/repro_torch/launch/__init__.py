"""Command-line entry points (``python -m repro_torch.launch.serve``,
``python -m repro_torch.launch.train``, ``train_lm``, ``dryrun``) and
the mesh and roofline model the dry run uses."""
