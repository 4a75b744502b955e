"""The ranks' side of the memory plan's mesh test
(tests/test_torch_memplan.py): each rank of a gloo world builds the
paged engine over a tp mesh and plans its own decode round. Imports
torch, numpy and the port only, never JAX."""

import torch

from veles_tpu_torch.serve import PagedGenerativeEngine
from veles_tpu_torch.serve.sharding import serve_mesh


def plan_world(rank, config, params):
    """This rank's ``plan_footprint()`` and its K/V bytes; rank 0 then
    stops the follower, which follows until then."""
    torch.manual_seed(0)
    mesh = serve_mesh(torch.distributed.get_world_size(), device="cpu")
    engine = PagedGenerativeEngine(config, params, max_slots=4,
                                   page_size=16, device="cpu", mesh=mesh)
    plan = engine.plan_footprint()
    kv_bytes = sum(t.numel() * t.element_size()
                   for t in engine._cache.values())
    if rank == 0:
        engine.stop_followers()
    else:
        engine.follow()
    return {"rank": rank, "plan": {k: v for k, v in plan.items()
                                   if k != "top_buffers"},
            "kv_bytes": kv_bytes}
