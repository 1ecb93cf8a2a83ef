"""Launch recipes: the environment a run of the port is brought up in
(``profile``; the twin of ``repro.launch.profile``).  Nothing here
imports torch, so a recipe can be applied before torch initialises
CUDA."""
