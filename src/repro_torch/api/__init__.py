"""Pipeline API of the port: spec, registries, plan lowering and build."""
from repro_torch.api.build import FrozenPipeline, build
from repro_torch.api.registry import (BACKENDS, FUSED_OPS, GROUPERS,
                                      SAMPLERS, register_backend,
                                      register_fused_op, register_grouper,
                                      register_sampler)
from repro_torch.api.spec import PipelineSpec, elite_spec, lite_spec, m2_spec

__all__ = ["BACKENDS", "FUSED_OPS", "GROUPERS", "SAMPLERS", "FrozenPipeline",
           "PipelineSpec", "build", "elite_spec", "lite_spec", "m2_spec",
           "register_backend", "register_fused_op", "register_grouper",
           "register_sampler"]
