"""Process-group helpers of the port's multi-process tests (gloo on the
CPU).  Spawned children import this module by name, so it imports
neither JAX nor the reference package."""

import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def spawn(fn, world: int, rendezvous, *args) -> None:
    """Run ``fn(rank, world, init_method, *args)`` in ``world`` spawned
    processes that join a gloo group through the file ``rendezvous`` (a
    fresh path); raises if any of them fails."""
    mp.start_processes(fn, args=(world, f"file://{rendezvous}") + args,
                       nprocs=world, start_method="spawn", join=True)


def _join(rank, world, init):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=world,
                            rank=rank)


def ring_worker(rank, world, init, inputs, out):
    """Each array of ``inputs`` holds one contribution per rank along
    axis 0, for a ring of 2 or of 4.  A ring of 4 reduces over the
    default group, a ring of 2 over the pairs (0, 1) and (2, 3) as
    subgroups; each runs twice, the second time with the ring's rank 1
    sleeping before it joins.  Rank r writes ``{out}.{r}.npz``."""
    from repro_torch.optim import ordered_ring_reduce
    _join(rank, world, init)
    pairs = [dist.new_group(r) for r in ([0, 1], [2, 3])]
    pair = pairs[rank // 2]
    got = {}
    with np.load(inputs) as data:
        for name in data.files:
            x = data[name]
            group = None if x.shape[0] == world else pair
            me = dist.get_rank(group)
            for tag, delay in (("", 0.0), ("_delayed", 0.2)):
                if me == 1:
                    time.sleep(delay)
                got[name + tag] = ordered_ring_reduce(
                    torch.from_numpy(x[me]), group).numpy()
    np.savez(f"{out}.{rank}.npz", **got)
    dist.destroy_process_group()


def dp_worker(rank, world, init, states, out, steps, lr):
    """For each optimizer of ``states`` (name -> the path of a pickled
    numpy initial state, the reference's): ``steps`` of
    ``make_pot_dp_step`` on stablelm-smoke, twice from that state; rank 0
    writes both runs' state leaves, counters and losses to
    ``{out}.{optimizer}.npz``."""
    import pickle

    from repro_torch import convert
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.train import make_pot_dp_step
    from repro_torch.tree import leaves
    _join(rank, world, init)
    cfg = get_smoke_config("stablelm-12b")
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=8)
    for optimizer, path in states.items():
        with open(path, "rb") as f:
            ref_state = pickle.load(f)
        step = make_pot_dp_step(cfg, optimizer=optimizer, n_microbatches=2,
                                lr=lr)
        arrays = {}
        for r in range(2):
            state = convert.train_state_from_numpy(ref_state, cfg,
                                                   device="cpu")
            losses = []
            for i in range(steps):
                state, loss = step(state, batch_at(dcfg, i, device="cpu"))
                losses.append(float(loss))
            arrays[f"losses_{r}"] = np.asarray(losses, np.float32)
            arrays[f"counters_{r}"] = np.asarray(
                [int(state.gv), int(state.step)])
            for j, t in enumerate(leaves([state.params, state.opt])):
                arrays[f"leaf_{r}_{j}"] = t.numpy()
        if rank == 0:
            np.savez(f"{out}.{optimizer}.npz", **arrays)
    dist.destroy_process_group()


def dp_kinds_worker(rank, world, init, cases, out, lr):
    """For each case of ``cases`` (the path of a pickled dict: (arch,
    optimizer) -> (the reference's initial state, the global batch), as
    numpy), one ``make_pot_dp_step`` step of 2 microbatches a rank on the
    smoke configuration, twice from that state, with ``C`` set to
    float32 in the port's model modules; rank r writes both runs' state
    leaves, counters and losses to ``{out}.{arch}.{optimizer}.{r}.npz``."""
    import pickle

    from repro_torch import convert
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import blocks, lm, moe, rglru, ssm
    from repro_torch.train import make_pot_dp_step
    from repro_torch.tree import leaves
    for m in (blocks, lm, ssm, rglru, moe):
        m.C = torch.float32
    _join(rank, world, init)
    with open(cases, "rb") as f:
        cases = pickle.load(f)
    for (arch, optimizer), (initial, batch) in cases.items():
        cfg = get_smoke_config(arch)
        step = make_pot_dp_step(cfg, optimizer=optimizer, n_microbatches=2,
                                lr=lr)
        arrays = {}
        for r in range(2):
            state = convert.train_state_from_numpy(initial, cfg, device="cpu")
            state, loss = step(state, {k: torch.from_numpy(v)
                                       for k, v in batch.items()})
            arrays[f"loss_{r}"] = loss.numpy()
            arrays[f"counters_{r}"] = np.asarray(
                [int(state.gv), int(state.step)])
            for j, t in enumerate(leaves([state.params, state.opt])):
                arrays[f"leaf_{r}_{j}"] = t.numpy()
        np.savez(f"{out}.{arch}.{optimizer}.{rank}.npz", **arrays)
    dist.destroy_process_group()


def placement_worker(rank, world, init, out):
    """Every leaf of stablelm-smoke's and deepseek-moe-smoke's parameters
    (seeded draws, the same on both ranks) distributed by its spec under
    a single-pod profile on (1, 2) and (2, 1) meshes and under a
    multi-pod ``pure_dp`` profile on (1, 2, 1) (tuple entries), each
    gathered back and checked bitwise, its local shard's shape checked
    against ``local_shape``; ``cons`` to a replicated spec gathers too.
    Rank r writes the file ``{out}.{r}`` when all hold."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm
    from repro_torch.runtime.shardings import (P, Profile, cons,
                                               local_shape, to_placements)
    from repro_torch.tree import flatten_up_to, leaves
    _join(rank, world, init)
    meshes = [((1, 2), ("data", "model"), {}),
              ((2, 1), ("data", "model"), {}),
              ((1, 2, 1), ("pod", "data", "model"),
               {"data_axes": ("pod", "data"), "pure_dp": True})]
    for arch in ("stablelm-12b", "deepseek-moe-16b"):
        cfg = get_smoke_config(arch)
        params = lm.init_params(torch.Generator().manual_seed(0), cfg,
                                dtype=torch.float32)
        for shape, names, kw in meshes:
            mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
            prof = Profile(mesh=mesh, **kw)
            sizes = dict(zip(names, shape))
            specs = flatten_up_to(params, lm.param_specs(cfg, prof))
            for t, spec in zip(leaves(params), specs, strict=True):
                if kw.get("pure_dp") and spec.count("model") and any(
                        isinstance(e, tuple) for e in spec):
                    continue   # pure_dp experts: the model axis twice
                d = distribute_tensor(t, mesh,
                                      to_placements(spec, mesh, t.ndim))
                if rank == 0:
                    assert tuple(d.to_local().shape) == local_shape(
                        tuple(t.shape), spec, sizes), (spec, t.shape)
                assert torch.equal(d.full_tensor(), t), (arch, spec)
                back = cons(d, P(), prof)
                assert torch.equal(back.to_local(), t), (arch, spec)
    open(f"{out}.{rank}", "w").close()
    dist.destroy_process_group()


def mesh_worker(rank, world, init, out):
    """``make_host_mesh`` over the gloo world: one ``"data"`` axis of
    ``world`` ranks that an all-reduce over its group spans.  Rank r
    writes the file ``{out}.{r}`` when all hold."""
    from repro_torch.launch.mesh import make_host_mesh
    _join(rank, world, init)
    mesh = make_host_mesh(device_type="cpu")
    assert mesh.mesh_dim_names == ("data",) and mesh.size() == world
    assert mesh.get_local_rank("data") == rank
    x = torch.tensor([rank + 1.0])
    dist.all_reduce(x, group=mesh.get_group("data"))
    assert x.item() == world * (world + 1) / 2
    named = make_host_mesh(world, axis="shard", device_type="cpu")
    assert named.mesh_dim_names == ("shard",)
    open(f"{out}.{rank}", "w").close()
    dist.destroy_process_group()
