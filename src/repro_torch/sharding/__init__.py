"""Sharding: the active mesh (``context``) and the logical-axis to
mesh-axis rules (``rules``), as ``repro.sharding``."""
