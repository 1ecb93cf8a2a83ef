"""Reproducible launch recipes: the environment a measurement ran under.

The twin of ``repro.launch.profile``.  A number is comparable to another
only if both processes were brought up alike: the CUDA allocator's
settings and how the CUDA driver loads kernels move what a run measures.
Each supported platform's recipe is frozen as a :class:`LaunchProfile`
so a run can print (and a rerun reproduce) exactly how it started::

    from repro_torch.launch.profile import PROFILES, launch_profile

    prof = launch_profile()            # "cuda" unless asked for another
    prof.apply()                       # os.environ, idempotent: BEFORE
                                       # torch initialises CUDA
    print(prof.shell_prefix())         # "CUDA_MODULE_LOADING=LAZY ..."

A profile only adds settings the environment does not already pin (an
explicit variable from the caller always wins), and ``apply()`` returns
what it changed so tests can undo it.  There are no XLA flags, and no
device detection: ``cpu-ci`` is asked for by name.  This module imports
nothing of torch.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class LaunchProfile:
    """One platform's frozen launch recipe: environment variables, each
    set only where the caller has not set it."""
    name: str
    env: Tuple[Tuple[str, str], ...] = ()

    def launch_env(self, base: Optional[Dict[str, str]] = None
                   ) -> Dict[str, str]:
        """The variables this profile adds on top of ``base``
        (``os.environ`` when None): what a launcher should export.
        Changes nothing."""
        cur = os.environ if base is None else base
        return {k: v for k, v in self.env if k not in cur}

    def apply(self) -> Dict[str, str]:
        """Export :meth:`launch_env` into ``os.environ`` (idempotent: a set
        variable is never overwritten) and return what was set, so a test
        can pop the keys back off.  Call it before torch initialises CUDA:
        the CUDA driver and the caching allocator read these at start-up."""
        changes = self.launch_env()
        os.environ.update(changes)
        return changes

    def shell_prefix(self) -> str:
        """The recipe as a ``VAR=... VAR=...`` shell prefix, for the line
        in front of ``python``."""
        return " ".join(f"{k}={v}"
                        for k, v in self.launch_env(base={}).items())


#: The supported recipes.  ``cuda`` is a run on the card (the default);
#: ``cpu-ci`` is the CPU test runner.
PROFILES: Dict[str, LaunchProfile] = {
    "cuda": LaunchProfile(
        name="cuda",
        env=(
            # Load each kernel's module at its first launch, not every
            # module of torch's CUDA libraries when the context is made:
            # a shorter start-up and less device memory held idle.
            ("CUDA_MODULE_LOADING", "LAZY"),
            # Let the caching allocator grow a segment in place: the
            # dispatches' ragged batch sizes then reuse memory instead of
            # fragmenting it into blocks of each size.
            ("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True"),
        )),
    "cpu-ci": LaunchProfile(
        name="cpu-ci",
        env=(
            # No card visible: the CPU tests see the same (empty) device
            # list on every runner, so no test's path depends on a GPU
            # being present.
            ("CUDA_VISIBLE_DEVICES", ""),
        )),
}


def launch_profile(platform: Optional[str] = None) -> LaunchProfile:
    """The :class:`LaunchProfile` named ``platform`` (a ``PROFILES`` key),
    ``cuda`` when None.  Unknown keys raise ``KeyError`` with the known
    names."""
    key = "cuda" if platform is None else platform
    try:
        return PROFILES[key]
    except KeyError:
        raise KeyError(f"unknown launch profile {key!r}; known: "
                       f"{', '.join(sorted(PROFILES))}") from None
