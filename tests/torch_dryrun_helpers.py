"""The gloo ranks that ``test_torch_dryrun.py`` spawns.  Not a test module
(pytest does not collect it).

    python tests/torch_dryrun_helpers.py RANK WORLD STORE OUT.json

Each rank builds ``repro_torch.launch.mesh.init_mesh("cpu", shape=MESH)``
on a gloo ``FileStore`` and runs every job of ``JOBS`` once: the cell's
sharded step (``launch.dryrun.build_cell``, the smoke config, seeded
random params and batch on the CPU) under a ``launch.roofline.Counter``.
Rank 0 writes each job's counts (``Counter.as_dict``) to ``OUT.json``.

Imports no jax.
"""
import json
import sys

MESH = (2, 2)
ARCHS = ("qwen3-1.7b", "granite-moe-1b-a400m")
# (name, kind, seq_len, global batch): 16 tokens divide the model axis, so
# the train and prefill steps shard the sequence as the production cells do
SHAPES = (("smoke_train", "train", 16, 4), ("smoke_prefill", "prefill", 16, 4),
          ("smoke_decode", "decode", 16, 4))
JOBS = [(a, s) for a in ARCHS for s in SHAPES]


def smoke_cfg(arch):
    from repro_torch import configs
    return configs.get_smoke_config(arch)


def shape_spec(s):
    from repro_torch.configs.shapes import ShapeSpec
    return ShapeSpec(*s)


def main(rank, world, store_path, out_path):
    import torch
    import torch.distributed as dist
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import init_mesh

    torch.set_num_threads(1)
    out = {}
    store = dist.FileStore(store_path, world)
    with init_mesh("cpu", shape=MESH, store=store, rank=rank) as mesh:
        for arch, s in JOBS:
            cell = dryrun.build_cell(arch, shape_spec(s), mesh, device="cpu",
                                     seed=1, cfg=smoke_cfg(arch))
            counter, _, _ = dryrun.count_cell(cell, only_device="cpu")
            out[f"{arch}|{s[0]}"] = counter.as_dict()
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(out, f)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
