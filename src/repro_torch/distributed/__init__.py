"""Distributed layer of the port: process meshes and the world launcher
(:mod:`.process_mesh`), the collectives of tensor-parallel serving
(:mod:`.collectives`), int8 quantizers and ``compressed_psum``
(:mod:`.compression`), ring attention (:mod:`.ring_attention`), the
layout plans' sharding rules and their ``DTensor`` placements
(:mod:`.sharding`) and the fault tolerance state machines the trainer
drives (:mod:`.fault_tolerance`).  :func:`.process_mesh.fake_world`
starts the fake world of hundreds of ranks that the dry run
(:mod:`repro_torch.launch.dryrun`) places the rules' layouts in."""
from .compression import (compress_roundtrip_error, compressed_psum,
                          dequantize_int8, quantize_int8)
from .fault_tolerance import (HeartbeatMonitor, RemeshPlan,
                              StragglerWatchdog, plan_remesh)
from .process_mesh import Mesh, make_mesh, run_world
from .ring_attention import make_ring_attention, ring_collective_bytes
from .sharding import (batch_shardings, cache_shardings, choose_plan_name,
                       layer_param_specs, make_plan, make_serving_mesh,
                       param_shardings)

__all__ = ["quantize_int8", "dequantize_int8", "compressed_psum",
           "compress_roundtrip_error", "HeartbeatMonitor", "RemeshPlan",
           "StragglerWatchdog", "plan_remesh", "make_plan",
           "param_shardings", "batch_shardings", "cache_shardings",
           "choose_plan_name", "layer_param_specs", "make_ring_attention",
           "ring_collective_bytes", "Mesh", "make_mesh", "run_world",
           "make_serving_mesh"]
