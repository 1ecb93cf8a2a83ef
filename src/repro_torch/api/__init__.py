"""Pipeline API of the port: spec, registries, plan lowering and build."""
from repro_torch.api.build import FrozenPipeline, build, build_pool
from repro_torch.api.registry import (BACKENDS, FUSED_OPS, GROUPERS,
                                      SAMPLERS, Registry, make_ball_grouper,
                                      register_backend, register_fused_op,
                                      register_grouper, register_sampler)
from repro_torch.api.spec import (FleetSpec, PipelineSpec, TenantSpec,
                                  compression_ladder_specs, elite_spec,
                                  lite_spec, m2_spec)

__all__ = ["BACKENDS", "FUSED_OPS", "FleetSpec", "GROUPERS", "SAMPLERS",
           "FrozenPipeline", "PipelineSpec", "Registry", "TenantSpec",
           "build", "build_pool", "compression_ladder_specs",
           "elite_spec", "lite_spec", "m2_spec", "make_ball_grouper",
           "register_backend", "register_fused_op", "register_grouper",
           "register_sampler"]
