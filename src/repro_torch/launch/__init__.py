"""Launch recipes and launchers.

``profile`` is the environment a run of the port is brought up in (the
twin of ``repro.launch.profile``); it imports nothing of torch, so a
recipe can be applied before torch initialises CUDA.  ``steps`` builds
the train, prefill and decode steps of a model API and the dry-run's
abstract trees, ``mesh`` the production meshes, ``train`` is the LM
training launcher (``python -m repro_torch.launch.train``) and
``dryrun`` the multi-pod dry-run (``python -m
repro_torch.launch.dryrun``)."""
