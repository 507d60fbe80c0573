"""A rank of the four-rank gloo job of tests/test_torch_roofline.py,
which the spawned ranks import by name (this module imports no JAX)."""
import torch

from repro_torch.launch.mesh import make_mesh
from repro_torch.parallel import sharding


def placement_rank(rank, world):
    from torch.distributed.tensor import distribute_tensor
    mesh = make_mesh((2, 2), ("data", "model"))
    dm = mesh.device_mesh("cpu")
    w = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    names = {"layers.0.attn.wq": w, "embed": w, "layers.0.norm1.scale":
             w[0]}
    specs = sharding.param_partition_specs(names, mesh)
    placed = sharding.named_shardings(None, specs, dm)
    coords = dm.get_coordinate()
    out = {}
    for n, t in names.items():
        local = distribute_tensor(t, dm, placed[n]).to_local()
        want = t
        for d, part in enumerate(specs[n]):
            if part is None:
                continue
            axis = mesh.axis_names.index(part)
            size = t.shape[d] // mesh.dims[axis]
            want = want.narrow(d, coords[axis] * size, size)
        out[n] = bool(torch.equal(local, want)) and tuple(local.shape) \
            == sharding.shard_shape(tuple(t.shape), specs[n], mesh)
    ok = torch.tensor([all(out.values())], dtype=torch.int32)
    torch.distributed.all_reduce(ok, op=torch.distributed.ReduceOp.MIN)
    return {"ok": bool(ok.item()), "specs": {k: tuple(v) for k, v in
                                             specs.items()}}
