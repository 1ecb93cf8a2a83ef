"""Pipeline API of the port: spec, registries, plan lowering and build."""
from repro_torch.api.build import FrozenPipeline, build
from repro_torch.api.registry import (BACKENDS, FUSED_OPS, GROUPERS,
                                      SAMPLERS, Registry, make_ball_grouper,
                                      register_backend, register_fused_op,
                                      register_grouper, register_sampler)
from repro_torch.api.spec import (PipelineSpec, compression_ladder_specs,
                                  elite_spec, lite_spec, m2_spec)

__all__ = ["BACKENDS", "FUSED_OPS", "GROUPERS", "SAMPLERS", "FrozenPipeline",
           "PipelineSpec", "Registry", "build", "compression_ladder_specs",
           "elite_spec", "lite_spec", "m2_spec", "make_ball_grouper",
           "register_backend", "register_fused_op", "register_grouper",
           "register_sampler"]
